"""Learner / LearnerGroup: the SGD half of the RL stack (counterpart of
``ray_tpu/rl/learner.py``).

Reference: rllib/core/learner/learner.py:122 (compute_gradients:454,
update:894) + learner_group.py:59 (remote learner actors :128-136) +
torch_learner.py:287 (DDP wrap). The learner's network and optimizer state
live on its device; the batch goes there once per update and is shuffled
and cut there by the row order the reference's numpy generator draws. Data
parallelism comes from a ``parallel`` mesh over ``dp`` (each rank computes
its rows of every minibatch and the gradients are summed over the ranks,
what the reference's ``P("dp")`` batch sharding gives) or, across learner
actors, from a host all-reduce through the runtime's collective, the
analogue of the reference's DDP process group.

The optimizer is the reference's ``optax.chain(clip_by_global_norm(c),
adam(lr))``: ``models.training.ClippedAdamW`` with b2 0.999 and no weight
decay.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models.training import ClippedAdamW
from ray_tpu_torch.parallel.mesh import mesh_sizes
from ray_tpu_torch.rl.rl_module import host_state_dict, make_policy
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks
from ray_tpu_torch.util import collective

logger = logging.getLogger(__name__)

Tensors = Dict[str, torch.Tensor]
Grads = List[torch.Tensor]

#: optax.adam's moment constants (the RL learners' optimizer)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def log_probs(logits: torch.Tensor, actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_softmax(logits), the log-probability of each taken action)."""
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)


def mean_entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


def normalized(adv: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8) with the population std (jnp.std's)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def host_metrics(metrics: Tensors) -> Dict[str, float]:
    """The metrics as floats, read from their device in one copy."""
    values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def to_device(batch, device: torch.device) -> Tensors:
    """The batch's columns as tensors on ``device`` (copies: a batch that
    came through an object store may be read-only views of it), float64
    columns as float32, as ``jnp.asarray`` gives them to the reference's
    jitted updates (32-bit JAX)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = torch.tensor(v.astype(np.float32) if v.dtype == np.float64 else v,
                              device=device)
    return out


def host_draws_to(device: torch.device, *draws: np.ndarray) -> List[torch.Tensor]:
    """Arrays drawn on the host (the reference's noise, from ``rl.prng``),
    each as a tensor of its shape on ``device``, in one copy."""
    flat = torch.from_numpy(np.concatenate([d.reshape(-1) for d in draws])).to(device)
    return [t.view(d.shape) for t, d in zip(flat.split([d.size for d in draws]), draws)]


class AdamParams:
    """A network's parameters on its device with their optimizer state:
    optax's ``adam(lr)`` (b2 0.999), behind ``clip_by_global_norm`` when
    ``grad_clip`` is given."""

    def __init__(self, net: torch.nn.Module, lr: float, grad_clip: Optional[float] = None):
        self.net = net
        self.params = dict(net.named_parameters())
        self.optimizer = ClippedAdamW(learning_rate=lr, grad_clip=grad_clip, b1=ADAM_B1,
                                      b2=ADAM_B2, eps=ADAM_EPS)
        self.opt_state = self.optimizer.init(self.params)

    def grads(self, loss: torch.Tensor) -> Grads:
        """The gradients of ``loss``; a parameter it does not reach gets
        zeros (jax.grad's)."""
        params = list(self.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]

    def step(self, grads: Grads) -> None:
        self.opt_state, _ = self.optimizer.update(self.params, grads, self.opt_state)


@torch.no_grad()
def polyak_(target: torch.nn.Module, online: torch.nn.Module, tau: float) -> None:
    """target <- (1 - tau) * target + tau * online, leaf by leaf."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_((1 - tau) * t + tau * o)


class PolicyLearner:
    """What the on-policy learners share: a ``DiscretePolicyModule`` drawn
    from ``seed`` and its optimizer state on ``device``, one optimizer
    step over a loss, and the weights in and out. A subclass gives
    ``loss(batch) -> (total, metrics)``."""

    def __init__(self, observation_size: int, num_actions: int, *,
                 hidden: Sequence[int], lr: float, grad_clip: float, seed: int,
                 device: DeviceLike):
        self.device = resolve_device(device)
        self.net = make_policy(observation_size, num_actions, hidden, seed, self.device)
        self.opt = AdamParams(self.net, lr, grad_clip)
        self.params = self.opt.params

    @property
    def opt_state(self):
        return self.opt.opt_state

    def loss(self, batch: Tensors) -> Tuple[torch.Tensor, Tensors]:
        raise NotImplementedError

    def grad_step(self, batch: Tensors, *loss_args) -> Tuple[Grads, Tensors]:
        """The gradients of ``loss(batch, *loss_args)`` and its metrics with
        ``total_loss``."""
        total, metrics = self.loss(batch, *loss_args)
        # a parameter the loss does not reach (PG's value head) gets a zero
        # gradient, as jax.grad gives it, and Adam leaves it where it is
        return self.opt.grads(total), {**metrics, "total_loss": total.detach()}

    def apply_step(self, grads: Grads) -> None:
        self.opt.step(grads)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        """One optimizer step over the whole batch."""
        grads, metrics = self.grad_step(to_device(batch, self.device))
        self.apply_step(grads)
        return host_metrics(metrics)

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The weights on the host (the reference's ``jax.device_get``)."""
        return host_state_dict(self.net)

    def set_weights(self, state_dict) -> None:
        self.net.load_state_dict(state_dict)


@dataclasses.dataclass
class PPOLossConfig:
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 0.5


def minibatch_slices(n: int, size: int):
    """The rows of each minibatch of a shuffled batch of ``n``, as
    ``SampleBatch.minibatches`` cuts them: the whole batch when it is
    smaller than one minibatch, else whole minibatches (the tail dropped)."""
    if 0 < n < size:
        return [slice(0, n)]
    return [slice(start, start + size) for start in range(0, n - size + 1, size)]


class PPOLearner(PolicyLearner):
    """PPO's clipped surrogate, value and entropy terms over minibatch
    epochs.

    ``mesh``: a ``parallel`` mesh whose only axis larger than 1 is ``dp``
    (one process per rank, every rank given the same batch): each rank
    takes its block of every minibatch's rows, the advantages are
    normalised over the whole minibatch, and the loss's gradients and
    metrics are summed over dp, so every rank takes the one-rank step."""

    def __init__(self, observation_size: int, num_actions: int, *,
                 hidden=(64, 64), lr: float = 3e-4,
                 loss_config: Optional[PPOLossConfig] = None, seed: int = 0,
                 mesh=None, device: DeviceLike = None):
        self.loss_cfg = loss_config or PPOLossConfig()
        super().__init__(observation_size, num_actions, hidden=hidden, lr=lr,
                         grad_clip=self.loss_cfg.grad_clip, seed=seed, device=device)
        self.mesh = mesh
        self._dp_group, self._dp_size, self._dp_rank = None, 1, 0
        if mesh is not None:
            sizes = mesh_sizes(mesh)
            if any(s > 1 for a, s in sizes.items() if a != "dp"):
                raise ValueError(f"PPOLearner shards its batch over dp only; mesh {sizes}")
            if sizes["dp"] > 1:
                self._dp_group = mesh.get_group("dp")
                self._dp_size = sizes["dp"]
                self._dp_rank = mesh.get_local_rank("dp")

    def loss(self, batch: Tensors, adv: Optional[torch.Tensor] = None,
             n: Optional[int] = None) -> Tuple[torch.Tensor, Tensors]:
        """The loss over ``batch``'s rows with their normalised advantages
        ``adv`` (default: ``batch``'s own, normalised), each mean a sum
        over these rows divided by ``n`` (default: their count)."""
        cfg = self.loss_cfg
        adv = normalized(batch["advantages"]) if adv is None else adv
        n = len(adv) if n is None else n
        mean = lambda x: x.sum() / n  # noqa: E731
        logits, values = self.net(batch["obs"])
        logp_all, logp = log_probs(logits, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        policy_loss = -mean(torch.minimum(unclipped, clipped))
        vf_loss = mean((values - batch["returns"]) ** 2)
        entropy = -mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = policy_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"policy_loss": policy_loss.detach(), "vf_loss": vf_loss.detach(),
                       "entropy": entropy.detach()}

    def minibatch_grads(self, data: Tensors, rows: torch.Tensor) -> Tuple[Grads, Tensors]:
        """The gradients and metrics of the minibatch of rows ``rows`` of
        ``data`` (summed over dp under a mesh)."""
        mb = {k: v[rows] for k, v in data.items()}
        adv = normalized(mb["advantages"])
        if self._dp_group is None:
            return self.grad_step(mb, adv, len(rows))
        m = len(rows)
        if m % self._dp_size:
            raise ValueError(f"a minibatch of {m} rows does not split over dp={self._dp_size}")
        block = slice(self._dp_rank * m // self._dp_size, (self._dp_rank + 1) * m // self._dp_size)
        grads, metrics = self.grad_step({k: v[block] for k, v in mb.items()}, adv[block], m)
        # one reduction for the gradients and the metrics together
        flat = torch.cat([g.reshape(-1) for g in grads] + [v.reshape(1) for v in metrics.values()])
        dist.all_reduce(flat, group=self._dp_group)
        sizes = [g.numel() for g in grads] + [1] * len(metrics)
        parts = flat.split(sizes)
        grads = [p.view_as(g) for p, g in zip(parts, grads)]
        return grads, {k: p[0] for k, p in zip(metrics, parts[len(grads):])}

    def update(self, batch: SampleBatch, *, minibatch_size: int = 128, num_epochs: int = 4,
               seed: int = 0, grad_sync: Optional[Callable[[Grads], Grads]] = None
               ) -> Dict[str, float]:
        """One PPO update over the batch: ``num_epochs`` passes, each over
        the batch in the order ``np.random.default_rng(seed)``'s
        permutations give (the reference's ``shuffled`` draws), a step per
        minibatch. ``grad_sync(grads) -> grads`` is applied to every
        minibatch gradient before the optimizer step — cross-learner
        allreduce plugs in here so all replicas take identical optimizer
        steps. Returns the last minibatch's metrics, read from the device
        once, after it."""
        rng = np.random.default_rng(seed)
        data = to_device(batch, self.device)
        n = len(batch)
        metrics: Tensors = {}
        for _ in range(num_epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for rows in minibatch_slices(n, minibatch_size):
                grads, metrics = self.minibatch_grads(data, perm[rows])
                if grad_sync is not None:
                    grads = grad_sync(grads)
                self.apply_step(grads)
        return host_metrics(metrics)


class _RemoteLearner:
    """One learner actor of a LearnerGroup; gradients are averaged through
    the runtime's host collective (``allreduce``, after
    ``init_collective_group``), the analogue of the reference's DDP
    process group. The collective functions come as arguments: a runtime's
    module-level functions travel to the actor by reference."""

    def __init__(self, rank: int, world: int, group: str, learner_kwargs,
                 init_collective_group: Optional[Callable] = None,
                 allreduce: Optional[Callable] = None):
        self.rank, self.world, self.group = rank, world, group
        self.allreduce = allreduce
        self.learner = PPOLearner(**learner_kwargs)
        if world > 1:
            init_collective_group(world, rank, group_name=group)

    def _grad_sync(self, grads: Grads) -> Grads:
        # one allreduce per minibatch: every gradient in a single f32 vector
        # (fewer, larger host-plane collectives)
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        summed = collective.allreduce(self.allreduce, flat, group_name=self.group)
        parts = summed.split([g.numel() for g in grads])
        return [(p / self.world).to(g.dtype).view_as(g) for p, g in zip(parts, grads)]

    def update(self, batch: SampleBatch, **kw) -> Dict[str, float]:
        if self.world > 1:
            return self.learner.update(batch, grad_sync=self._grad_sync, **kw)
        return self.learner.update(batch, **kw)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, state_dict):
        self.learner.set_weights(state_dict)
        return True


class LearnerGroup:
    """1 local learner, or N learner actors with host-collective sync
    (reference: learner_group.py:59), started through ``hooks``."""

    def __init__(self, learner_kwargs: Dict[str, Any], num_learners: int = 1,
                 group_name: str = "ppo_learners", hooks: Optional[RuntimeHooks] = None):
        self.hooks = hooks or RuntimeHooks()
        self.num_learners = num_learners
        self.actors: List[Any] = []
        self.local: Optional[PPOLearner] = None
        if num_learners <= 1:
            self.local = PPOLearner(**learner_kwargs)
            return
        missing = [name for name in ("init_collective_group", "allreduce")
                   if getattr(self.hooks, name) is None]
        if missing:
            raise ValueError(
                f"LearnerGroup(num_learners={num_learners}) needs a collective: the hooks' "
                f"{' and '.join(missing)} are None (the default hooks run actors one after "
                "another in this process, where an all-reduce would deadlock)")
        cls = self.hooks.remote(_RemoteLearner)
        self.actors = [
            cls.remote(i, num_learners, group_name, learner_kwargs,
                       self.hooks.init_collective_group, self.hooks.allreduce)
            for i in range(num_learners)
        ]

    def update(self, batch: SampleBatch, **kw) -> Dict[str, float]:
        if self.local is not None:
            return self.local.update(batch, **kw)
        n = len(batch)
        # shards must be EQUAL: each minibatch gradient is a collective, so
        # every learner must take the same number of optimizer steps or the
        # allreduce deadlocks — the tail is dropped, loudly
        shard, dropped = divmod(n, self.num_learners)
        if dropped:
            logger.warning(
                "LearnerGroup: dropping %d/%d tail samples (batch not "
                "divisible by %d learners)", dropped, n, self.num_learners
            )
        refs = [
            a.update.remote(
                SampleBatch({k: v[i * shard:(i + 1) * shard] for k, v in batch.items()}), **kw)
            for i, a in enumerate(self.actors)
        ]
        return self.hooks.get(refs, timeout=300)[0]

    def get_weights(self):
        if self.local is not None:
            return self.local.get_weights()
        return self.hooks.get(self.actors[0].get_weights.remote(), timeout=60)

    def shutdown(self):
        for a in self.actors:
            self.hooks.kill(a)
