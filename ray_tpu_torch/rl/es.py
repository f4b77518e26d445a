"""ES: evolution strategies (OpenAI-ES) — gradient-free policy search
(counterpart of ``ray_tpu/rl/es.py``).

Reference surface: rllib/algorithms/es/ (es.py: perturbation sampling with
shared noise table, rank-normalized fitness, mirrored sampling; rollout
workers evaluate perturbed policies). Perturbations are generated from
SEEDS (an int crosses the wire, not a parameter vector), episode
evaluation fans out over eval-worker actors (``config.hooks``), each
evaluating with its policy's forward on ``config.device``, and the update
is a weighted sum of perturbations on the driver, in float64 numpy.

The flat parameter vector is the reference's: the leaves in
``jax.tree_util`` order (module names sorted, ``bias`` before ``kernel``,
kernels ``[in, out]``), so a noise seed perturbs the same weights on both
sides.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl.convert import params_to_state_dict, state_dict_to_params
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.rl_module import make_policy
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["ES", "ESConfig", "ESEvalWorker"]

Spec = List[Tuple[Tuple[str, ...], Tuple[int, ...]]]


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    """(path, leaf) in jax.tree_util's order: dict keys sorted."""
    for name in sorted(tree):
        value = tree[name]
        if isinstance(value, Mapping):
            yield from _leaves(value, (*path, name))
        else:
            yield (*path, name), np.asarray(value)


def _flatten_params(state_dict) -> Tuple[np.ndarray, Spec]:
    """The reference's flat vector of a port state dict, and its layout."""
    leaves = list(_leaves(state_dict_to_params(state_dict)))
    flat = np.concatenate([leaf.ravel() for _, leaf in leaves])
    return flat, [(path, leaf.shape) for path, leaf in leaves]


def _unflatten_params(flat: np.ndarray, spec: Spec) -> Dict[str, torch.Tensor]:
    """The port state dict of a flat vector (each leaf cast to float32)."""
    tree: Dict[str, Any] = {}
    pos = 0
    for path, shape in spec:
        n = int(np.prod(shape)) if shape else 1
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = flat[pos: pos + n].reshape(shape).astype(np.float32)
        pos += n
    return params_to_state_dict(tree)


class ESEvalWorker:
    """Evaluates perturbed policies: receives (base_version, seed, sign),
    regenerates the perturbation locally from the seed, runs one episode."""

    def __init__(self, env_name: str, hidden: Tuple[int, ...], seed: int,
                 device: DeviceLike = None):
        self.env_name = env_name
        self.device = resolve_device(device)
        probe = make_env(env_name)
        # the reference's eval workers init from PRNGKey(0) whatever the seed
        self.net = make_policy(probe.observation_size, probe.num_actions, hidden, 0,
                               self.device)
        self.flat, self.spec = _flatten_params(self.net.state_dict())
        self._episode_seed = seed

    def set_flat(self, flat: np.ndarray) -> bool:
        self.flat = np.asarray(flat, np.float64)
        return True

    @torch.no_grad()
    def evaluate(self, noise_seed: int, sign: float, sigma: float,
                 episodes: int = 1) -> float:
        rng = np.random.default_rng(noise_seed)
        eps = rng.standard_normal(self.flat.shape[0])
        self.net.load_state_dict(_unflatten_params(self.flat + sign * sigma * eps, self.spec))
        total = 0.0
        for ep in range(episodes):
            env = make_env(self.env_name)
            obs, _ = env.reset(seed=self._episode_seed + noise_seed + ep)
            done = False
            while not done:
                logits, _ = self.net(torch.as_tensor(np.asarray(obs, np.float32)[None],
                                                     device=self.device))
                obs, r, term, trunc, _ = env.step(int(torch.argmax(logits[0], -1)))
                total += r
                done = term or trunc
        return total / episodes


@dataclasses.dataclass
class ESConfig:
    env: str = "CartPole-v1"
    num_workers: int = 4
    population: int = 16       # perturbation PAIRS per iteration (mirrored)
    sigma: float = 0.05
    lr: float = 0.05
    episodes_per_eval: int = 1
    hidden: tuple = (32, 32)
    seed: int = 0
    device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "ES":
        return ES(self)


class ES:
    def __init__(self, config: ESConfig):
        self.config = config
        self.hooks = config.hooks
        probe = make_env(config.env)
        net = make_policy(probe.observation_size, probe.num_actions, config.hidden,
                          config.seed, torch.device("cpu"))
        self.flat, self.spec = _flatten_params(net.state_dict())
        self.flat = self.flat.astype(np.float64)
        worker = self.hooks.remote(ESEvalWorker)
        self.workers = [
            worker.remote(config.env, tuple(config.hidden), config.seed + 7919 * i,
                          device=config.device)
            for i in range(config.num_workers)
        ]
        self._rng = np.random.default_rng(config.seed)
        self._iteration = 0
        self._episodes = 0

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        cfg = self.config
        self.hooks.get([w.set_flat.remote(self.flat) for w in self.workers], timeout=120)
        seeds = [int(s) for s in self._rng.integers(0, 2**31, cfg.population)]
        # mirrored sampling: each seed evaluated at +sigma and -sigma
        refs = []
        jobs = [(s, sign) for s in seeds for sign in (+1.0, -1.0)]
        for i, (s, sign) in enumerate(jobs):
            w = self.workers[i % len(self.workers)]
            refs.append(w.evaluate.remote(s, sign, cfg.sigma, cfg.episodes_per_eval))
        fitness = np.array(self.hooks.get(refs, timeout=600), np.float64)
        self._episodes += len(jobs) * cfg.episodes_per_eval
        # rank normalization (reference: es.py compute_centered_ranks)
        all_f = fitness
        ranks = np.empty_like(all_f)
        ranks[np.argsort(all_f)] = np.arange(len(all_f))
        centered = (ranks / (len(all_f) - 1) - 0.5).reshape(-1, 2)
        weights = centered[:, 0] - centered[:, 1]  # f(+) rank minus f(-) rank
        grad = np.zeros_like(self.flat)
        for s, wgt in zip(seeds, weights):
            eps = np.random.default_rng(s).standard_normal(self.flat.shape[0])
            grad += wgt * eps
        grad /= cfg.population * cfg.sigma
        self.flat += cfg.lr * grad
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episodes_total": self._episodes,
            "episode_return_mean": float(fitness.mean()),
            "episode_return_max": float(fitness.max()),
            "grad_norm": float(np.linalg.norm(grad)),
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def get_flat_weights(self) -> np.ndarray:
        return self.flat.copy()

    def stop(self):
        for w in self.workers:
            self.hooks.kill(w)
