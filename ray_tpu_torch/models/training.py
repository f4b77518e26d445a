"""Train and eval steps for the port's GPT, on one device or sharded over a
mesh (counterpart of ``ray_tpu/models/training.py``).

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

On a mesh (``make_train_step(..., mesh=...)``, every rank calling it):

* ``state_shardings`` gives each parameter's DTensor placements from the
  rule table (``parallel.sharding``) and the model's logical axes
  (``gpt.param_logical_axes``); the Adam moments mirror them.
  ``init_sharded_state`` builds the state as DTensors of those placements,
  each rank holding its block only: from a seed (each parameter drawn as
  ``init_params`` draws it, its block kept and the rest dropped, so one
  parameter at a time is whole) or from a full ``state_dict`` (the tests
  start from JAX's weights).
* The step takes the global batch (the same tokens on every rank); each
  rank trains on its block: rows cut over (dp, fsdp), the sequence over sp,
  with the next token across each chunk's end as its last target. The
  model gets the rank's blocks and gathers each parameter over the axes it
  does not keep cut in compute (``gpt.param_compute_axes``: tp over heads
  and mlp, ep over experts) where it is used: a block's parameters inside
  the block's checkpointed call, so with remat on only one block's
  gathered weights exist at a time and the backward's recompute gathers
  them again (without remat autograd keeps them to the end of the
  backward). A gather over fsdp reduce-scatters its gradient in the
  backward, so gradients are never whole: each is this rank's block,
  summed over the data axes (dp, fsdp, sp), whose ranks hold different
  tokens, the rest of them by an all-reduce of the block. Over tp and ep
  the model's collectives already give every rank its block's gradient
  (the replicated parts get equal gradients on every rank). The loss is
  each rank's share of the global mean (the sum of its targets' losses
  over the global count), so the sum over the data axes is the
  reference's loss.
* The clip's norm is the norm of the whole gradient: each block counts
  once (a block replicated over some axes counts on the rank at index 0 of
  each of them), summed over all ranks. The update runs on the local blocks.
* The flash kernels see plain local tensors only.

With every axis of size 1 (one rank) no collective runs but the norm's
one-scalar sum, and the step computes what the single-device step does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.func import functional_call

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    blockwise_next_token_loss,
    blockwise_nll_sum,
    param_compute_axes,
    param_logical_axes,
)
from ray_tpu_torch.models.inference import init_draws
from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DATA_AXES,
    MeshGroups,
    mesh_device,
    subgroup,
)
from ray_tpu_torch.parallel.sharding import (
    Rules,
    local_slices,
    params_shardings,
    replicated,
    rules_dict,
    spec_axes,
    spec_of,
)

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
               state: AdamWState, norm: Optional[torch.Tensor] = None
               ) -> Tuple[AdamWState, torch.Tensor]:
        """Update ``params`` (and ``state``'s moments) in place from
        ``grads`` (consumed: clipped in place). Returns the new state and
        the global norm of the gradients before clipping: ``norm`` where
        the caller gives it (the sharded step, whose gradients are blocks
        of the whole), else the norm of ``grads``."""
        ps = list(params.values())
        if norm is None:
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
            # the whole update, mu_hat / denom + weight_decay * p, in the
            # temporary and then one add, so the parameters round once as
            # optax's apply_updates rounds them (in bf16 a decay multiply of
            # its own rounds away)
            torch._foreach_reciprocal_(denom)
            torch._foreach_mul_(denom, state.mu)
            torch._foreach_div_(denom, bc1)
            torch._foreach_add_(denom, ps, alpha=self.weight_decay)
            torch._foreach_add_(ps, denom, alpha=-self.learning_rate)
        else:
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


def make_train_step(cfg: GPTConfig, optimizer: ClippedAdamW, device=None, *,
                    mesh=None, rules: Optional[Rules] = None,
                    state_shardings_tree: Optional[TrainState] = None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, tokens [b, t]) -> (state, {"loss", "grad_norm",
    "step", "moe_aux", "moe_dropped"})``. ``state.params`` live on
    ``device`` (default CUDA) and are updated in place; the returned state
    holds the same tensors.

    With ``mesh`` (a ``DeviceMesh`` over ``AXIS_ORDER``; every rank calls
    this, and then the step, alike) the state is ``init_sharded_state``'s,
    its DTensors placed as ``state_shardings_tree`` says (default
    ``state_shardings(mesh, cfg, rules)``; a state placed otherwise raises),
    ``tokens`` the global batch and the metrics global; ``device`` must be
    None or the mesh's device type. The sharded step carries ``model``, the
    rank's module skeleton (on the meta device), whose blocks a caller may
    hook."""
    if mesh is not None:
        return _sharded_train_step(cfg, optimizer, device, mesh, rules,
                                   state_shardings_tree)
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


def make_eval_step(cfg: GPTConfig, device=None, *, mesh=None,
                   rules: Optional[Rules] = None
                   ) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """``eval_step(params, tokens) -> loss``: the blockwise loss without
    gradients and without the aux term, as the reference's. With ``mesh``,
    ``params`` are ``init_sharded_state``'s DTensors, ``tokens`` the global
    batch, and the loss global (sp > 1 evaluates through ring or Ulysses
    attention, as training does)."""
    if mesh is not None:
        return _sharded_eval_step(cfg, device, mesh, rules)
    dev = resolve_device(device)
    loss_fn = _loss_fn(cfg, GPT(cfg, device="meta"))

    def eval_step(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return loss_fn(params, tokens.to(dev))[1]["ce"]

    return eval_step


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------


def state_shardings(mesh, cfg: GPTConfig, rules: Optional[Rules] = None) -> TrainState:
    """The placements of a sharded ``TrainState``: each parameter's from
    the rule table, the Adam moments' the same (ZeRO-style: fsdp cuts the
    moments as it cuts the weights), the step replicated."""
    params = params_shardings(mesh, param_logical_axes(cfg), rules)
    return TrainState(step=replicated(mesh), params=params,
                      opt_state=AdamWState(0, list(params.values()),
                                           list(params.values())))


def _mesh_device(mesh, device) -> torch.device:
    """The mesh's device; raises where ``device`` names another type."""
    dev = mesh_device(mesh)
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's ({mesh.device_type})")
    return dev


def init_sharded_state(cfg: GPTConfig, mesh, optimizer: ClippedAdamW, seed: int = 0,
                       rules: Optional[Rules] = None,
                       params: Optional[Params] = None) -> Tuple[TrainState, TrainState]:
    """``(state, shardings)``: a step-0 state whose parameters and Adam
    moments are DTensors placed as ``state_shardings`` says, each rank
    holding its blocks only, and those placements. The weights are
    ``init_params(cfg, seed=seed)``'s (each drawn whole in turn, its block
    kept) or, where given, the full ``params`` (a ``state_dict``, e.g.
    ``convert.params_from_jax``'s; copied, never updated). Collective only
    in that every rank calls it alike."""
    shardings = state_shardings(mesh, cfg, rules)
    dev = mesh_device(mesh)
    coord = dict(zip(AXIS_ORDER, mesh.get_coordinate()))
    source = params.items() if params is not None else init_draws(cfg, dev, seed)
    out: Params = {}
    with torch.no_grad():
        for name, full in source:
            place = shardings.params[name]
            block = full[local_slices(full.shape, spec_of(place, full.ndim), mesh, coord)]
            # a copy: a view would keep the whole tensor alive, and the
            # step's in-place updates would write into the caller's params
            local = block.to(device=dev, dtype=cfg.param_dtype,
                             memory_format=torch.contiguous_format, copy=True)
            out[name] = DTensor.from_local(
                local, mesh, place, run_check=False, shape=full.shape,
                stride=torch.empty(full.shape, device="meta").stride())
    missing = set(shardings.params) - set(out)
    if missing:
        raise ValueError(f"params lack {sorted(missing)}")
    return init_train_state(out, optimizer), shardings


@dataclasses.dataclass(frozen=True)
class _Plan:
    """One parameter on the mesh: its placements; the (dim, mesh axis)
    pairs gathered into the model's view of it, where the block using it
    runs; the data axes over which its gradient is summed after the
    backward (those its gathers do not reduce-scatter); and the mesh axes
    over which its block is replicated (size > 1)."""

    placements: Tuple[Any, ...]
    gather: Tuple[Tuple[int, str], ...]
    sum_axes: Tuple[str, ...]
    replicated: Tuple[str, ...]


def _plans(cfg: GPTConfig, groups: MeshGroups, rules: Optional[Rules],
           shardings: TrainState) -> Dict[str, _Plan]:
    table = rules_dict(rules)
    logical = param_logical_axes(cfg)
    plans = {}
    for name, keep_names in param_compute_axes(cfg).items():
        place = shardings.params[name]
        spec = spec_of(place, len(logical[name]))
        keep = set()
        for n in keep_names:
            keep.update(spec_axes(table.get(n)))
        gather = []
        for dim, entry in enumerate(spec):
            axes = spec_axes(entry)
            if len(axes) > 1 and set(axes) - keep:
                raise ValueError(f"{name}: dim {dim} is cut over {axes}; a parameter's "
                                 f"dim may be gathered over one mesh axis only")
            gather += [(dim, a) for a in axes if a not in keep]
        gathered = {a for _, a in gather}
        sum_axes = tuple(a for a in DATA_AXES if groups.sizes[a] > 1 and a not in gathered)
        cut = {a for e in spec for a in spec_axes(e)}
        rep = tuple(a for a in AXIS_ORDER if groups.sizes[a] > 1 and a not in cut)
        plans[name] = _Plan(tuple(place), tuple(gather), sum_axes, rep)
    return plans


def _view(local: torch.Tensor, plan: _Plan, groups: MeshGroups) -> torch.Tensor:
    """The model's view of a parameter: its block gathered over ``plan``'s
    axes (the block itself where there are none). Differentiable: over a
    data axis the gradient is reduce-scattered (the ranks' partial sums),
    over any other it is this rank's block (the ranks computed alike)."""
    for dim, axis in plan.gather:
        gather = comm.gather_summed if axis in DATA_AXES else comm.gather_from
        local = gather(local, groups.group(axis), dim)
    return local


def _global_norm(grads: List[torch.Tensor], plans: List[_Plan],
                 groups: MeshGroups) -> torch.Tensor:
    """||g|| over every parameter's whole gradient: each block counts on one
    rank of those that hold it, and the squares are summed over the world."""
    mine = [g for g, plan in zip(grads, plans)
            if all(groups.coord[a] == 0 for a in plan.replicated)]
    dev = grads[0].device
    sq = (torch.stack(torch._foreach_norm(mine)).float().square().sum() if mine
          else torch.zeros((), dtype=torch.float32, device=dev))
    return comm.all_reduce(sq, dist.group.WORLD).sqrt()


def _local_batch(tokens: torch.Tensor, groups: MeshGroups, dev: torch.device):
    """``(tokens, positions, targets, valid)`` of this rank's block of the
    global batch [B, T]: rows cut over (dp, fsdp), the sequence over sp;
    positions are global; each position's target is the next token, across
    the chunk's end, and the sequence's last position has none (valid 0)."""
    b_all, t_all = tokens.shape
    blocks, sp = groups.batch_blocks, groups.sizes["sp"]
    if b_all % blocks or t_all % sp:
        raise ValueError(f"batch {tuple(tokens.shape)} does not split into {blocks} "
                         f"row blocks and {sp} sequence chunks")
    b, t = b_all // blocks, t_all // sp
    t0 = groups.coord["sp"] * t
    rows = tokens[groups.batch_index * b:(groups.batch_index + 1) * b].to(dev).long()
    nxt = rows[:, t0 + 1:t0 + t + 1]
    targets = torch.zeros(b, t, dtype=torch.long, device=dev)
    valid = torch.zeros(b, t, dtype=torch.float32, device=dev)
    targets[:, :nxt.shape[1]] = nxt
    valid[:, :nxt.shape[1]] = 1.0
    positions = (t0 + torch.arange(t, device=dev)).expand(b, t)
    return rows[:, t0:t0 + t], positions, targets, valid


class _ShardedLoss:
    """The rank's share of the loss, computed from its blocks."""

    def __init__(self, cfg: GPTConfig, mesh, rules: Optional[Rules], shardings):
        self.cfg = cfg
        self.model = GPT(cfg, device="meta", mesh=mesh)  # builds the groups
        self.groups = self.model.groups
        self.dev = self.groups.device
        self.shardings = shardings or state_shardings(mesh, cfg, rules)
        self.plans = _plans(cfg, self.groups, rules, self.shardings)
        # the group of each set of axes a gradient is summed over; collective,
        # so every rank creates them in the same order
        self.sum_groups = {axes: subgroup(mesh, axes) for axes in
                           sorted({p.sum_axes for p in self.plans.values()})}

    def locals(self, params: Params) -> List[torch.Tensor]:
        for name, p in params.items():
            if not isinstance(p, DTensor) or tuple(p.placements) != self.plans[name].placements:
                raise ValueError(f"{name} is not a DTensor placed as {self.plans[name].placements}")
        return [p.to_local() for p in params.values()]

    def view(self, name: str, local: torch.Tensor) -> torch.Tensor:
        return _view(local, self.plans[name], self.groups)

    def sum_grad(self, name: str, grad: torch.Tensor) -> torch.Tensor:
        """The gradient of this rank's block: ``grad`` (already summed over
        the data axes its gathers reduce-scatter) summed over the rest."""
        return comm.all_reduce(grad, self.sum_groups[self.plans[name].sum_axes])

    def __call__(self, blocks: Params, tokens: torch.Tensor):
        """(the rank's share of ce + aux weight * aux, {"ce", "aux",
        "dropped"}: the rank's shares); the model gathers each parameter
        from ``blocks`` where it uses it (``view``)."""
        cfg = self.cfg
        tok, positions, targets, valid = _local_batch(tokens, self.groups, self.dev)
        (hidden, weight, bias), moe = functional_call(
            self.model, blocks, (tok, positions),
            {"return_hidden": True, "return_moe": True, "param_view": self.view})
        n_targets = tokens.shape[0] * (tokens.shape[1] - 1)
        ce = blockwise_nll_sum(hidden, weight, bias, targets, valid, cfg.ce_chunk) / n_targets
        return ce + cfg.moe_aux_weight * moe["aux"], dict(moe, ce=ce)


def _sharded_train_step(cfg, optimizer, device, mesh, rules, shardings):
    loss_fn = _ShardedLoss(cfg, mesh, rules, shardings)
    _mesh_device(mesh, device)
    g, plans = loss_fn.groups, loss_fn.plans

    def step(state: TrainState, tokens: torch.Tensor):
        names = list(state.params)
        blocks = loss_fn.locals(state.params)
        leaves = {n: b.detach().requires_grad_(True) for n, b in zip(names, blocks)}
        with torch.enable_grad():
            loss, stats = loss_fn(leaves, tokens)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        del leaves
        with torch.no_grad():
            grads = [loss_fn.sum_grad(n, gr).contiguous() for n, gr in zip(names, grads)]
            norm = _global_norm(grads, [plans[n] for n in names], g)
            opt = state.opt_state
            local_opt = AdamWState(opt.count, [m.to_local() for m in opt.mu],
                                   [v.to_local() for v in opt.nu])
            local_opt, grad_norm = optimizer.update(dict(zip(names, blocks)), grads,
                                                    local_opt, norm=norm)
            new = TrainState(step=state.step + 1, params=state.params,
                             opt_state=AdamWState(local_opt.count, opt.mu, opt.nu))
            metrics = {"loss": comm.all_reduce(loss.detach(), g.data),
                       "grad_norm": grad_norm, "step": new.step,
                       "moe_aux": comm.all_reduce(stats["aux"].detach(), g.data),
                       "moe_dropped": comm.all_reduce(stats["dropped"], g.data) / g.data_size}
        return new, metrics

    step.model = loss_fn.model
    return step


def _sharded_eval_step(cfg, device, mesh, rules):
    loss_fn = _ShardedLoss(cfg, mesh, rules, None)
    _mesh_device(mesh, device)

    def eval_step(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            blocks = dict(zip(params, loss_fn.locals(params)))
            return comm.all_reduce(loss_fn(blocks, tokens)[1]["ce"], loss_fn.groups.data)

    return eval_step
