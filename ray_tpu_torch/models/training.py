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

A feeder may give a step this rank's ``LocalBatch`` (``local_batch``,
the cut the step makes of a global batch) in place of the global batch, so
that each rank uploads only its block (``train.session.iter_device_batches``).
``gather_state`` makes a sharded state one whole host tree of numpy arrays
on every rank (a checkpoint), and ``restore_sharded_state`` cuts such a tree
back into a rank's blocks on any mesh and layout.

``make_pp_train_step`` is the pipelined step over ``pp`` (counterpart of
``ray_tpu/parallel/pipeline.py``'s): its state is in the stacked layout
(``init_sharded_state(..., stacked=True)``, ``gpt.stack_layers``), each
stage's layers run through ``parallel.pipeline.pipeline_apply``, and the
rest is the sharded step's machinery (the plans, the gathers, the gradient
sums, the norm and the update).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.func import functional_call

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.gpt import (
    GPT,
    LN_EPS,
    STACKED_PREFIX,
    Block,
    GPTConfig,
    blockwise_next_token_loss,
    blockwise_nll_sum,
    param_compute_axes,
    param_logical_axes,
    stack_layers,
)
from ray_tpu_torch.models.inference import init_draws
from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DATA_AXES,
    MeshGroups,
    mesh_device,
    mesh_sizes,
    subgroup,
)
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stage_split
from ray_tpu_torch.parallel.sharding import (
    Rules,
    local_slices,
    params_shardings,
    pp_rules,
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
    b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))``; the moments'
    constants default to the reference's ``default_optimizer`` (B1, B2,
    EPS), and with ``weight_decay`` 0 it is ``adam``'s chain (the RL
    learners pass b2 0.999).

    With g the gradients, n = ||g|| over all of them: g <- g * (grad_clip /
    n) where n >= grad_clip (optax's rule, no epsilon), and no clip at all
    where ``grad_clip`` is None (optax's ``adam`` alone); then
    mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, count += 1, and
    p <- p - lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p) with
    mu_hat = mu / (1 - b1^count), nu_hat = nu / (1 - b2^count)."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    b1: float = B1
    b2: float = B2
    eps: float = EPS

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
        of the whole), else the norm of ``grads`` (None without a clip)."""
        ps = list(params.values())
        if self.grad_clip is not None:
            if norm is None:
                norm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads)).float())
            clip = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                               self.grad_clip / norm)
            torch._foreach_mul_(grads, clip)
        count = state.count + 1
        torch._foreach_lerp_(state.mu, grads, 1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        # sqrt(nu_hat) + eps = sqrt(nu) / sqrt(bc2) + eps, the one temporary
        denom = torch._foreach_sqrt(state.nu)
        torch._foreach_div_(denom, bc2 ** 0.5)
        torch._foreach_add_(denom, self.eps)
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


def state_shardings(mesh, cfg: GPTConfig, rules: Optional[Rules] = None,
                    stacked: bool = False) -> TrainState:
    """The placements of a sharded ``TrainState``: each parameter's from
    the rule table, the Adam moments' the same (ZeRO-style: fsdp cuts the
    moments as it cuts the weights), the step replicated. ``stacked``: the
    pipelined step's layout (``gpt.stack_layers``), whose layer leaves have
    a leading "layers" axis (cut over pp under ``sharding.pp_rules``).
    ``mesh`` may be a ``DeviceMesh`` or {axis: size}."""
    params = params_shardings(mesh, param_logical_axes(cfg, stacked), rules)
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
                       params: Optional[Params] = None,
                       stacked: bool = False) -> Tuple[TrainState, TrainState]:
    """``(state, shardings)``: a step-0 state whose parameters and Adam
    moments are DTensors placed as ``state_shardings`` says, each rank
    holding its blocks only, and those placements. The weights are
    ``init_params(cfg, seed=seed)``'s (each drawn whole in turn, its block
    kept) or, where given, the full ``params`` (a per-layer ``state_dict``,
    e.g. ``convert.params_from_jax``'s; copied, never updated). ``stacked``
    places them in the pipelined step's layout (``gpt.stack_layers``; the
    weights are whole until stacked). Collective only in that every rank
    calls it alike."""
    shardings = state_shardings(mesh, cfg, rules, stacked)
    dev = mesh_device(mesh)
    source = params.items() if params is not None else init_draws(cfg, dev, seed)
    if stacked:
        source = stack_layers(dict(source), cfg).items()
    out = {name: _place(full, shardings.params[name], mesh, cfg.param_dtype)
           for name, full in source}
    _check_names(shardings.params, out, "params")
    return init_train_state(out, optimizer), shardings


def _place(full: torch.Tensor, place, mesh, dtype: torch.dtype) -> DTensor:
    """This rank's block of the whole tensor ``full``, as a DTensor placed
    ``place`` on ``mesh`` (a copy on the mesh's device, in ``dtype``)."""
    coord = dict(zip(AXIS_ORDER, mesh.get_coordinate()))
    with torch.no_grad():
        block = full[local_slices(full.shape, spec_of(place, full.ndim), mesh, coord)]
        # a copy: a view would keep the whole tensor alive, and the step's
        # in-place updates would write into the caller's tensors
        local = block.to(device=mesh_device(mesh), dtype=dtype,
                         memory_format=torch.contiguous_format, copy=True)
        return DTensor.from_local(local, mesh, place, run_check=False, shape=full.shape,
                                  stride=torch.empty(full.shape, device="meta").stride())


def _check_names(want, got, what: str) -> None:
    missing = set(want) - set(got)
    if missing:
        raise ValueError(f"{what} lack {sorted(missing)}")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a whole tensor as numpy (the state's tensors are updated
    in place after); bf16, which numpy lacks, as its raw bits (uint16; the
    tree's "dtype" names the type)."""
    t = t.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def gather_state(state: TrainState, mesh=None) -> Dict[str, Any]:
    """The whole state as a host tree of numpy arrays, on every rank:
    ``{"step", "count", "dtype", "params", "mu", "nu"}``, the last three
    {name: array} in the state's layout (stacked where the state is),
    ``dtype`` the parameters' and moments' (bf16 leaves are their raw bits,
    uint16). A sharded state's blocks are gathered over ``mesh``
    (collective: every rank calls it alike); a single-device state's
    tensors are copied to the host. The counterpart of the reference's
    ``multihost_utils.process_allgather(x, tiled=True)`` of a checkpoint;
    ``restore_sharded_state`` cuts it back."""
    names = list(state.params)

    def whole(t):
        if isinstance(t, DTensor):
            if mesh is not None and t.device_mesh != mesh:
                raise ValueError("the state does not live on the given mesh")
            t = t.full_tensor()
        return _to_host(t)

    dtypes = {t.dtype for t in state.params.values()}
    if len(dtypes) != 1:
        raise ValueError(f"the state's parameters mix dtypes {sorted(map(str, dtypes))}")
    opt = state.opt_state
    return {"step": int(state.step), "count": int(opt.count),
            "dtype": str(dtypes.pop()).removeprefix("torch."),
            "params": {n: whole(t) for n, t in state.params.items()},
            "mu": {n: whole(t) for n, t in zip(names, opt.mu)},
            "nu": {n: whole(t) for n, t in zip(names, opt.nu)}}


def restore_sharded_state(host_tree: Dict[str, Any], cfg: GPTConfig, mesh,
                          optimizer: ClippedAdamW, *, rules: Optional[Rules] = None,
                          stacked: bool = False) -> Tuple[TrainState, TrainState]:
    """``(state, shardings)`` from ``gather_state``'s tree: each rank's
    blocks of the parameters and both moments cut from the whole arrays and
    placed as ``state_shardings(mesh, cfg, rules, stacked)`` says, the step
    and the optimizer's count as saved. The mesh may differ from the one
    the state was gathered on; the blocks are then the new mesh's. The
    counterpart of ``jax.device_put(host_params, shardings.params)``.
    ``optimizer`` is the step's, as for ``init_sharded_state``; it keeps
    no state of its own (the moments are the tree's)."""
    shardings = state_shardings(mesh, cfg, rules, stacked)
    dtype = getattr(torch, host_tree["dtype"])
    if dtype != cfg.param_dtype:
        raise ValueError(f"the tree holds {dtype}, the config wants {cfg.param_dtype}")

    def place(part: str) -> Params:
        tree = host_tree[part]
        _check_names(shardings.params, tree, part)
        return {n: _place(_from_host(tree[n], dtype), p, mesh, dtype)
                for n, p in shardings.params.items()}

    params, mu, nu = place("params"), place("mu"), place("nu")
    state = TrainState(step=int(host_tree["step"]), params=params,
                       opt_state=AdamWState(int(host_tree["count"]), list(mu.values()),
                                            list(nu.values())))
    return state, shardings


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
           shardings: TrainState, stacked: bool = False) -> Dict[str, _Plan]:
    table = rules_dict(rules)
    logical = param_logical_axes(cfg, stacked)
    plans = {}
    for name, keep_names in param_compute_axes(cfg, stacked).items():
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


@dataclasses.dataclass
class LocalBatch:
    """One rank's block of a global token batch [B, T], as the sharded
    steps cut it (``local_batch``): ``tokens`` [b, t] (its rows and its
    sequence chunk), ``targets`` [b, t] (each position's next token, across
    the chunk's end), ``valid`` [b, t] (0 at the sequence's last position,
    which has no target), ``t0`` the chunk's first position,
    ``global_shape`` (B, T), and the microbatch count the rows were ordered
    for (the pipelined step's). A step given one skips its own cut, so a
    feeder can upload a rank's block only."""

    tokens: torch.Tensor
    targets: torch.Tensor
    valid: torch.Tensor
    t0: int
    global_shape: Tuple[int, int]
    num_microbatches: int = 1

    def to(self, device) -> "LocalBatch":
        return LocalBatch(*(t.to(device) for t in self.tensors()), self.t0, self.global_shape,
                          self.num_microbatches)

    def tensors(self) -> List[torch.Tensor]:
        return [self.tokens, self.targets, self.valid]


def _cut(tokens: torch.Tensor, sizes, coord, num_microbatches: int) -> LocalBatch:
    b_all, t_all = tokens.shape
    blocks = sizes["dp"] * sizes["fsdp"]
    index = coord["dp"] * sizes["fsdp"] + coord["fsdp"]
    sp = sizes["sp"]
    if b_all % (blocks * num_microbatches) or t_all % sp:
        raise ValueError(f"batch {tuple(tokens.shape)} does not split into {num_microbatches} "
                         f"microbatches over {blocks} row blocks and {sp} sequence chunks")
    if num_microbatches > 1:
        # microbatch i is global rows [i * B / M, (i + 1) * B / M), spread
        # over the data ranks (the reference's [M, mb] reshape with mb cut
        # over dp and fsdp): order the rows so that each rank's block is its
        # share of every microbatch, microbatch-major
        tokens = (tokens.reshape(num_microbatches, blocks, -1, t_all).transpose(0, 1)
                  .reshape(b_all, t_all))
    b, t = b_all // blocks, t_all // sp
    t0 = coord["sp"] * t
    rows = tokens[index * b:(index + 1) * b].long()
    nxt = rows[:, t0 + 1:t0 + t + 1]
    targets = torch.zeros(b, t, dtype=torch.long, device=rows.device)
    valid = torch.zeros(b, t, dtype=torch.float32, device=rows.device)
    targets[:, :nxt.shape[1]] = nxt
    valid[:, :nxt.shape[1]] = 1.0
    return LocalBatch(rows[:, t0:t0 + t], targets, valid, t0, (b_all, t_all), num_microbatches)


def local_batch(tokens: torch.Tensor, mesh, num_microbatches: int = 1) -> LocalBatch:
    """This rank's ``LocalBatch`` of the global batch ``tokens`` [B, T] on
    ``mesh`` (a ``DeviceMesh`` over ``AXIS_ORDER``), on ``tokens``' device:
    rows cut over (dp, fsdp), the sequence over sp, and, with
    ``num_microbatches`` M > 1, the rows first ordered as the pipelined step
    with M microbatches orders them. No collective."""
    return _cut(tokens, mesh_sizes(mesh), dict(zip(AXIS_ORDER, mesh.get_coordinate())),
                num_microbatches)


def _local_batch(tokens, groups: MeshGroups, dev: torch.device, num_microbatches: int = 1):
    """``(LocalBatch on dev, positions)`` of this rank's block of the global
    batch [B, T] (or of the ``LocalBatch`` a feeder cut already); positions
    are global."""
    if isinstance(tokens, LocalBatch):
        if tokens.num_microbatches != num_microbatches:
            raise ValueError(f"the batch was cut for {tokens.num_microbatches} microbatches, "
                             f"the step runs {num_microbatches}")
        lb = tokens.to(dev)
    else:
        lb = _cut(tokens.to(dev), groups.sizes, groups.coord, num_microbatches)
    b, t = lb.tokens.shape
    return lb, (lb.t0 + torch.arange(t, device=dev)).expand(b, t)


class _ShardedParams:
    """A sharded state's parameters on this rank: each one's plan, its
    view, the sum of its gradient, and the update from the gradients."""

    def __init__(self, cfg: GPTConfig, mesh, groups: MeshGroups, rules: Optional[Rules],
                 shardings, stacked: bool = False):
        self.cfg = cfg
        self.groups = groups
        self.dev = groups.device
        self.shardings = shardings or state_shardings(mesh, cfg, rules, stacked)
        self.plans = _plans(cfg, groups, rules, self.shardings, stacked)
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

    @torch.no_grad()
    def update(self, optimizer: ClippedAdamW, state: TrainState, blocks: List[torch.Tensor],
               grads) -> Tuple[TrainState, torch.Tensor]:
        """The optimizer's step on the local ``blocks`` of ``state.params``
        (in place) from the backward's ``grads``; (new state, the whole
        gradient's norm before clipping)."""
        names = list(state.params)
        grads = [self.sum_grad(n, gr).contiguous() for n, gr in zip(names, grads)]
        norm = _global_norm(grads, [self.plans[n] for n in names], self.groups)
        opt = state.opt_state
        local_opt = AdamWState(opt.count, [m.to_local() for m in opt.mu],
                               [v.to_local() for v in opt.nu])
        local_opt, grad_norm = optimizer.update(dict(zip(names, blocks)), grads, local_opt,
                                                norm=norm)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=AdamWState(local_opt.count, opt.mu, opt.nu)), grad_norm


class _ShardedLoss(_ShardedParams):
    """The rank's share of the loss, computed from its blocks."""

    def __init__(self, cfg: GPTConfig, mesh, rules: Optional[Rules], shardings):
        self.model = GPT(cfg, device="meta", mesh=mesh)  # builds the groups
        super().__init__(cfg, mesh, self.model.groups, rules, shardings)

    def __call__(self, blocks: Params, tokens: torch.Tensor):
        """(the rank's share of ce + aux weight * aux, {"ce", "aux",
        "dropped"}: the rank's shares); the model gathers each parameter
        from ``blocks`` where it uses it (``view``)."""
        cfg = self.cfg
        lb, positions = _local_batch(tokens, self.groups, self.dev)
        (hidden, weight, bias), moe = functional_call(
            self.model, blocks, (lb.tokens, positions),
            {"return_hidden": True, "return_moe": True, "param_view": self.view})
        b_all, t_all = lb.global_shape
        ce = (blockwise_nll_sum(hidden, weight, bias, lb.targets, lb.valid, cfg.ce_chunk)
              / (b_all * (t_all - 1)))
        return ce + cfg.moe_aux_weight * moe["aux"], dict(moe, ce=ce)


def _sharded_train_step(cfg, optimizer, device, mesh, rules, shardings):
    loss_fn = _ShardedLoss(cfg, mesh, rules, shardings)
    _mesh_device(mesh, device)
    g = loss_fn.groups

    def step(state: TrainState, tokens: torch.Tensor):
        names = list(state.params)
        blocks = loss_fn.locals(state.params)
        leaves = {n: b.detach().requires_grad_(True) for n, b in zip(names, blocks)}
        with torch.enable_grad():
            loss, stats = loss_fn(leaves, tokens)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        del leaves
        new, grad_norm = loss_fn.update(optimizer, state, blocks, grads)
        with torch.no_grad():
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


# ---------------------------------------------------------------------------
# pipelined over pp
# ---------------------------------------------------------------------------


class _PipelinedLoss(_ShardedParams):
    """The rank's share of the pipelined step's loss, from its blocks in the
    stacked layout: the layers of its stage, the replicated leaves."""

    def __init__(self, cfg: GPTConfig, mesh, num_microbatches: int, rules: Optional[Rules],
                 shardings):
        groups = MeshGroups.build(mesh)
        stages = groups.sizes["pp"]
        if cfg.tie_embeddings:
            raise ValueError("the pipelined step needs an untied lm_head (the reference's "
                             "reads params['lm_head'])")
        if stages > 1 and (groups.sizes["sp"] > 1 or groups.sizes["ep"] > 1):
            raise NotImplementedError("pp > 1 with sp > 1 or ep > 1: the reference never "
                                      "runs them under pp")
        if cfg.num_layers % stages:
            raise ValueError(f"num_layers={cfg.num_layers} not divisible by pp={stages}")
        super().__init__(cfg, mesh, groups, rules, shardings, stacked=True)
        self.num_microbatches = num_microbatches
        self.block = Block(cfg, device="meta", groups=groups)
        # a stacked leaf's plan for one of its layers: the layer axis indexed
        # away, so each gathered dim one lower
        self.layer_plans = {
            name[len(STACKED_PREFIX):]: dataclasses.replace(
                plan, gather=tuple((dim - 1, axis) for dim, axis in plan.gather))
            for name, plan in self.plans.items() if name.startswith(STACKED_PREFIX)}

    def _layer(self, layer: Params, xp):
        """One block on (x, positions): its fsdp shards gathered here, inside
        the layer's checkpointed call, as the sharded step gathers a block's."""
        x, positions = xp
        views = {n: _view(p, self.layer_plans[n], self.groups) for n, p in layer.items()}
        out = functional_call(self.block, views, (x, positions))
        return (out[0] if self.block.moe else out), positions

    def __call__(self, blocks: Params, tokens) -> torch.Tensor:
        cfg, g, m = self.cfg, self.groups, self.num_microbatches
        # each rank's block is its share of every microbatch (_cut)
        lb, positions = _local_batch(tokens, g, self.dev, m)
        b_all, t_all = lb.global_shape
        b, t = lb.tokens.shape
        x = F.embedding(lb.tokens, self.view("wte.weight", blocks["wte.weight"]).to(cfg.dtype))
        stage = {name[len(STACKED_PREFIX):]: stage_split(p, 1) for name, p in blocks.items()
                 if name.startswith(STACKED_PREFIX)}
        y, _ = pipeline_apply(g, self._layer, stage,
                              (x.view(m, b // m, t, -1), positions.reshape(m, b // m, t)),
                              remat=cfg.remat)
        y = y.reshape(b, t, -1)
        # the reference's own final norm (pipeline.py:254-258): in the blocks'
        # dtype, with a two-pass variance, not the model's float32 LayerNorm
        mean = y.mean(-1, keepdim=True)
        var = ((y - mean) ** 2).mean(-1, keepdim=True)
        y = (y - mean) * torch.rsqrt(var + LN_EPS)
        y = (y * self.view("ln_f.weight", blocks["ln_f.weight"]).to(y.dtype)
             + self.view("ln_f.bias", blocks["ln_f.bias"]).to(y.dtype))
        nll = blockwise_nll_sum(y, self.view("lm_head.weight", blocks["lm_head.weight"]),
                                self.view("lm_head.bias", blocks["lm_head.bias"]),
                                lb.targets, lb.valid, cfg.ce_chunk)
        return nll / (b_all * (t_all - 1))


def make_pp_train_step(cfg: GPTConfig, optimizer: ClippedAdamW, mesh, *,
                       num_microbatches: int = 4, rules: Optional[Rules] = None,
                       state_shardings_tree: Optional[TrainState] = None
                       ) -> Callable[[TrainState, torch.Tensor],
                                     Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The pipelined GPT train step (counterpart of
    ``ray_tpu/parallel/pipeline.py:192`` ``make_pp_train_step``):
    ``step(state, tokens [b, t]) -> (state, {"loss", "grad_norm", "step"})``.

    Every rank of ``mesh`` (a ``DeviceMesh`` over ``AXIS_ORDER``) calls it,
    and then the step, alike. The state is ``init_sharded_state(...,
    rules=rules, stacked=True)``'s, placed as ``state_shardings_tree`` says
    (default ``state_shardings(mesh, cfg, rules, stacked=True)``), ``rules``
    defaulting to ``sharding.pp_rules()``: each layer leaf cut over pp
    along its layer axis, so a pp rank holds only its L/S layers'
    parameters, gradients and moments, and fsdp and tp cut the rest as in
    the sharded step. ``tokens`` is the global batch, the metrics global.

    What it computes is the reference's step: the embedding
    ``wte.astype(cfg.dtype)[tokens]`` (``:237``), replicated over pp; the
    batch cut into ``num_microbatches`` microbatches of b / M rows, each
    microbatch's rows spread over dp and fsdp (``:244-245``); the blocks
    through ``parallel.pipeline.pipeline_apply``, each layer under
    ``torch.utils.checkpoint`` where ``cfg.remat`` is set (every layer
    recomputed whole, whatever ``cfg.remat_policy`` says, as the reference's
    ``jax.checkpoint``); the reference's own final norm in the blocks'
    dtype (``:254-258``; a two-pass variance, eps 1e-6: not the model's
    float32 LayerNorm, so in bf16 the loss is not the sharded step's bit for
    bit); the blockwise cross-entropy over ``cfg.ce_chunk`` (``:260-262``);
    then the optimizer. The loss is the cross-entropy alone: the
    reference's pp step drops its blocks' MoE aux term, and so does this one.

    Where the gradients lie: each layer leaf's on its own stage; ``wte``'s
    on every pp rank alike (the embedding enters the pipeline through
    ``comm.copy_to``, whose backward sums stage 0's gradient over pp);
    ``ln_f``'s and ``lm_head``'s on every pp rank alike, since each computes
    the head on the replicated output, so they are not summed over pp.
    The clip's norm counts each block once (``_global_norm``).

    Raises ``ValueError`` without ``cfg.scan_layers`` (the reference's
    stacked layer tree, which the stages cut), for a tied embedding (the
    reference reads ``lm_head``) and where num_layers does not divide by pp,
    and
    ``NotImplementedError`` for pp > 1 with sp > 1 or ep > 1, which the
    reference never runs. A batch that does not split into M microbatches
    over the data ranks raises at the step."""
    if not cfg.scan_layers:
        raise ValueError("pipeline parallelism requires cfg.scan_layers=True")
    loss_fn = _PipelinedLoss(cfg, mesh, num_microbatches,
                             pp_rules() if rules is None else rules, state_shardings_tree)
    g = loss_fn.groups

    def step(state: TrainState, tokens: torch.Tensor):
        blocks = loss_fn.locals(state.params)
        leaves = {n: b.detach().requires_grad_(True) for n, b in zip(state.params, blocks)}
        with torch.enable_grad():
            loss = loss_fn(leaves, tokens)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        del leaves
        new, grad_norm = loss_fn.update(optimizer, state, blocks, grads)
        return new, {"loss": comm.all_reduce(loss.detach(), g.data), "grad_norm": grad_norm,
                     "step": new.step}

    return step
