"""Train and eval steps for the port's GPT on one device (counterpart of
``ray_tpu/models/training.py`` without a mesh).

* ``default_optimizer`` is the reference's optax chain written out:
  ``clip_by_global_norm(grad_clip)`` as optax applies it, then AdamW with
  b1 0.9, b2 0.95, eps 1e-8 and decoupled weight decay.
* ``make_train_step`` builds ``step(state, tokens) -> (state, metrics)``:
  the blockwise next-token loss of ``GPT(..., return_hidden=True)`` plus
  ``moe_aux_weight`` times the MoE aux loss (the blocks' mean; 0 for a
  dense config, where the sum is the blockwise loss bit for bit), its
  gradients, and the optimizer's update. Metrics are ``loss`` (that sum,
  as in the reference), ``grad_norm`` (the global norm before clipping),
  ``step``, and the port's own diagnostics ``moe_aux`` and ``moe_dropped``
  (the share of assignments dropped for capacity; both 0 when dense). The
  tensors are 0-d float32 on the device, so a step does not wait for the
  card.
* ``make_eval_step`` builds ``eval_step(params, tokens) -> loss``, the
  blockwise loss without the aux term, as the reference's.

Dtype policy: compute in ``cfg.dtype``; master parameters, gradients and
the Adam moments in ``cfg.param_dtype``. The update runs in place on the
state's tensors (``torch._foreach_*``) with one temporary the size of the
parameters (the denominator), where a functional update would copy
parameters and both moments. ``init_params`` stays in
``models/inference.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
from torch.func import functional_call

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.gpt import GPT, GPTConfig, blockwise_next_token_loss

Params = Dict[str, torch.Tensor]
# AdamW's constants in the reference's default_optimizer
B1, B2, EPS = 0.9, 0.95, 1e-8


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: List[torch.Tensor]  # first moments, in the order of params.values()
    nu: List[torch.Tensor]  # second moments


@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    b1=B1, b2=B2, eps=EPS, weight_decay=weight_decay))``.

    With g the gradients, n = ||g|| over all of them: g <- g * (grad_clip /
    n) where n >= grad_clip (optax's rule, no epsilon); then
    mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, count += 1, and
    p <- p - lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p) with
    mu_hat = mu / (1 - b1^count), nu_hat = nu / (1 - b2^count)."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params: Params) -> AdamWState:
        with torch.no_grad():
            return AdamWState(0, [torch.zeros_like(p) for p in params.values()],
                              [torch.zeros_like(p) for p in params.values()])

    @torch.no_grad()
    def update(self, params: Params, grads: List[torch.Tensor],
               state: AdamWState) -> Tuple[AdamWState, torch.Tensor]:
        """Update ``params`` (and ``state``'s moments) in place from
        ``grads`` (consumed: clipped in place). Returns the new state and
        the global norm of the gradients before clipping."""
        ps = list(params.values())
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)).float())
        clip = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                           self.grad_clip / norm)
        torch._foreach_mul_(grads, clip)
        count = state.count + 1
        torch._foreach_lerp_(state.mu, grads, 1.0 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - B2)
        bc1 = 1.0 - B1 ** count
        bc2 = 1.0 - B2 ** count
        # sqrt(nu_hat) + eps = sqrt(nu) / sqrt(bc2) + eps, the one temporary
        denom = torch._foreach_sqrt(state.nu)
        torch._foreach_div_(denom, bc2 ** 0.5)
        torch._foreach_add_(denom, EPS)
        if self.weight_decay:
            torch._foreach_mul_(ps, 1.0 - self.learning_rate * self.weight_decay)
        torch._foreach_addcdiv_(ps, state.mu, denom, value=-self.learning_rate / bc1)
        return AdamWState(count, state.mu, state.nu), norm


def default_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.0,
                      grad_clip: float = 1.0) -> ClippedAdamW:
    return ClippedAdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                        grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: AdamWState


def init_train_state(params: Params, optimizer: ClippedAdamW) -> TrainState:
    """A step-0 state over ``params`` (the port's ``state_dict``; the step
    updates these tensors in place)."""
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def _loss_fn(cfg: GPTConfig, model: GPT
             ) -> Callable[[Params, torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``loss_fn(params, tokens) -> (train loss, {"ce", "aux", "dropped"})``:
    the blockwise next-token loss ``ce`` plus ``moe_aux_weight * aux``."""
    def loss_fn(params: Params, tokens: torch.Tensor):
        (hidden, weight, bias), moe = functional_call(
            model, params, (tokens,), {"return_hidden": True, "return_moe": True})
        ce = blockwise_next_token_loss(hidden, weight, bias, tokens, chunk=cfg.ce_chunk)
        return ce + cfg.moe_aux_weight * moe["aux"], dict(moe, ce=ce)
    return loss_fn


def make_train_step(cfg: GPTConfig, optimizer: ClippedAdamW, device=None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, tokens [b, t]) -> (state, {"loss", "grad_norm",
    "step", "moe_aux", "moe_dropped"})``. ``state.params`` live on
    ``device`` (default CUDA) and are updated in place; the returned state
    holds the same tensors."""
    dev = resolve_device(device)
    loss_fn = _loss_fn(cfg, GPT(cfg, device="meta"))

    def step(state: TrainState, tokens: torch.Tensor):
        params = state.params
        leaves = list(params.values())
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, stats = loss_fn(params, tokens.to(dev))
            grads = list(torch.autograd.grad(loss, leaves))
        opt_state, grad_norm = optimizer.update(params, grads, state.opt_state)
        new = TrainState(step=state.step + 1, params=params, opt_state=opt_state)
        return new, {"loss": loss.detach(), "grad_norm": grad_norm, "step": new.step,
                     "moe_aux": stats["aux"].detach(), "moe_dropped": stats["dropped"]}

    return step


def make_eval_step(cfg: GPTConfig, device=None
                   ) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """``eval_step(params, tokens) -> loss``: the blockwise loss without
    gradients and without the aux term, as the reference's."""
    dev = resolve_device(device)
    loss_fn = _loss_fn(cfg, GPT(cfg, device="meta"))

    def eval_step(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return loss_fn(params, tokens.to(dev))[1]["ce"]

    return eval_step
