"""DQN: off-policy Q-learning over a (prioritized) replay buffer
(counterpart of ``ray_tpu/rl/dqn.py``).

Reference: rllib/algorithms/dqn/dqn.py (training_step: sample rollouts →
store → replay → train → target-net sync) with double-Q targets
(dqn_torch_policy.py) and PER. The learner's online and target networks
and its optimizer state live on its ``device``; rollouts run
epsilon-greedy (or on noisy nets) with the forward on the worker's device
and the envs on the host. The reference's randomness is kept: every
network starts from its ``init(PRNGKey(seed))`` weights, the noisy nets'
noise comes from the same JAX keys (``rl.prng``, drawn on the host and
copied to the device, one copy per forward), and epsilon-greedy draws from
the same numpy generators.
"""

from __future__ import annotations

import copy
import dataclasses
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl import prng
from ray_tpu_torch.rl.env import EpisodeReturnTracker, VectorEnv, make_env
from ray_tpu_torch.rl.learner import AdamParams, Tensors, host_draws_to, to_device
from ray_tpu_torch.rl.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rl.rl_module import drawn, host_state_dict
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["DQN", "DQNConfig", "DQNLearner", "DQNRolloutWorker", "NoisyDense", "QNetwork",
           "RainbowDQNConfig", "atom_support", "categorical_projection", "expected_q",
           "make_q_network"]


def _signed_sqrt(e: np.ndarray) -> np.ndarray:
    return (np.sign(e) * np.sqrt(np.abs(e))).astype(np.float32)


class NoisyDense(nn.Module):
    """Factorized-Gaussian noisy linear layer (Fortunato et al.; reference:
    rllib's noisy nets in the rainbow-configured DQN), with flax's
    parameters and layout: ``w_mu``/``w_sigma`` ``[in, out]``,
    ``b_mu``/``b_sigma`` ``[out]``. ``forward(x, noise)`` takes the
    factorised noise ``(f(eps_in), f(eps_out))`` or None for the mean
    weights (evaluation)."""

    def __init__(self, in_features: int, features: int, sigma0: float = 0.5):
        super().__init__()
        self.in_features, self.features, self.sigma0 = in_features, features, sigma0
        self.w_mu = nn.Parameter(torch.empty(in_features, features))
        self.b_mu = nn.Parameter(torch.empty(features))
        self.w_sigma = nn.Parameter(torch.empty(in_features, features))
        self.b_sigma = nn.Parameter(torch.empty(features))

    def flax_init_(self, key: np.ndarray, path: Tuple[str, ...]) -> None:
        """The reference's draws: the means U[-bound, bound] with bound =
        1/sqrt(in) (the scope's draws 1 and 2), the sigmas sigma0 * bound
        (draws 3 and 4)."""
        bound = np.float32(1.0) / np.sqrt(np.float32(self.in_features))
        w = prng.uniform(prng.param_key(key, path, 1), self.w_mu.shape, -bound, bound)
        b = prng.uniform(prng.param_key(key, path, 2), self.b_mu.shape, -bound, bound)
        sigma = np.float32(self.sigma0) * bound
        self.w_mu.copy_(torch.from_numpy(w))
        self.b_mu.copy_(torch.from_numpy(b))
        self.w_sigma.fill_(float(sigma))
        self.b_sigma.fill_(float(sigma))

    def noise(self, key: np.ndarray) -> np.ndarray:
        """The layer's noise for ``key``, on the host: f(normal) over the
        inputs then over the outputs, from ``split(key)``, f(e) =
        sign(e) sqrt|e|."""
        rin, rout = prng.split(key)
        return np.concatenate([_signed_sqrt(prng.normal(rin, (self.in_features,))),
                               _signed_sqrt(prng.normal(rout, (self.features,)))])

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            return x @ self.w_mu + self.b_mu
        eps_in, eps_out = noise[:self.in_features], noise[self.in_features:]
        w = self.w_mu + self.w_sigma * torch.outer(eps_in, eps_out)
        b = self.b_mu + self.b_sigma * eps_out
        return x @ w + b


class QNetwork(nn.Module):
    """MLP mapping observations to one Q-value per action: ``torso_i``
    (Linear + relu), then ``q_head`` or, under ``dueling``, ``v_head`` and
    ``a_head``; ``noisy`` makes the heads ``NoisyDense``. With
    ``num_atoms`` > 1 (C51) the output is the return distribution's logits
    (batch, actions, atoms)."""

    def __init__(self, observation_size: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), dueling: bool = False,
                 noisy: bool = False, num_atoms: int = 1):
        super().__init__()
        self.num_actions, self.hidden = num_actions, tuple(hidden)
        self.dueling, self.noisy = dueling, noisy
        self.num_atoms = atoms = max(1, num_atoms)
        sizes = (observation_size, *self.hidden)
        for i, (n_in, n_out) in enumerate(zip(sizes, sizes[1:])):
            self.add_module(f"torso_{i}", nn.Linear(n_in, n_out))
        heads = ({"v_head": atoms, "a_head": num_actions * atoms} if dueling
                 else {"q_head": num_actions * atoms})
        layer = NoisyDense if noisy else nn.Linear
        for name, features in heads.items():
            self.add_module(name, layer(sizes[-1], features))
        self.head_names = tuple(heads)

    def noise(self, key: Optional[np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
        """Each noisy head's noise for the forward key ``key`` (the
        reference folds ``crc32(name) & 0x7FFFFFFF`` into it per head),
        drawn on the host and copied to ``device`` at once."""
        if not self.noisy or key is None:
            return {}
        parts = [getattr(self, name).noise(prng.fold_in(key, zlib.crc32(name.encode())
                                                        & 0x7FFFFFFF))
                 for name in self.head_names]
        return dict(zip(self.head_names, host_draws_to(device, *parts)))

    def forward(self, obs: torch.Tensor, rng: Optional[np.ndarray] = None) -> torch.Tensor:
        """Q-values (or C51 logits); ``rng`` a ``prng`` key resamples the
        noisy heads' noise, None uses their mean weights."""
        noise = self.noise(rng, obs.device)
        x = obs
        for i in range(len(self.hidden)):
            x = F.relu(getattr(self, f"torso_{i}")(x))

        def head(name):
            layer = getattr(self, name)
            return layer(x, noise.get(name)) if self.noisy else layer(x)

        atoms = self.num_atoms
        if self.dueling:
            value, adv = head("v_head"), head("a_head")
            if atoms > 1:
                adv = adv.reshape(adv.shape[0], self.num_actions, atoms)
                return value[:, None, :] + adv - adv.mean(dim=1, keepdim=True)
            return value + adv - adv.mean(dim=-1, keepdim=True)
        out = head("q_head")
        if atoms > 1:
            return out.reshape(out.shape[0], self.num_actions, atoms)
        return out


def make_q_network(observation_size: int, num_actions: int, hidden: Sequence[int], seed: int,
                   device: torch.device, **knobs) -> QNetwork:
    """A ``QNetwork`` on ``device`` with the reference's weights for
    ``seed``."""
    return drawn(QNetwork(observation_size, num_actions, hidden, **knobs), seed, device)


def atom_support(v_min: float, v_max: float, num_atoms: int,
                 device: DeviceLike = "cpu") -> torch.Tensor:
    """``jnp.linspace(v_min, v_max, num_atoms)`` in float32."""
    z = np.linspace(v_min, v_max, num_atoms, dtype=np.float64).astype(np.float32)
    return torch.from_numpy(z).to(device)


def expected_q(logits: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(B, A, N) distribution logits -> (B, A) expected Q values."""
    return (torch.softmax(logits, dim=-1) * z).sum(-1)


def categorical_projection(next_dist: torch.Tensor, rewards: torch.Tensor,
                           not_done: torch.Tensor, gamma_n: float,
                           z: torch.Tensor) -> torch.Tensor:
    """Project the Bellman-shifted support back onto the fixed atoms
    (the C51 target distribution, Bellemare et al. alg. 1), vectorized."""
    num_atoms = z.shape[0]
    v_min, v_max = z[0], z[-1]
    dz = (v_max - v_min) / (num_atoms - 1)
    tz = torch.clamp(rewards[:, None] + gamma_n * not_done[:, None] * z[None, :], v_min, v_max)
    b = (tz - v_min) / dz                     # (B, N) fractional atom index
    lower = torch.floor(b)
    upper = torch.ceil(b)
    # when b is integral, put all mass on the lower atom
    w_upper = b - lower
    w_lower = 1.0 - w_upper
    onehot_l = F.one_hot(lower.long(), num_atoms).to(next_dist.dtype)  # (B,N,N)
    onehot_u = F.one_hot(upper.long(), num_atoms).to(next_dist.dtype)
    return (next_dist[:, :, None] * (w_lower[:, :, None] * onehot_l
                                     + w_upper[:, :, None] * onehot_u)).sum(1)


class DQNRolloutWorker:
    """Epsilon-greedy (or noisy-net) transition collection on a vectorized
    env, with optional n-step return accumulation (rainbow knobs). The
    Q-network's forward runs on ``device``."""

    def __init__(self, env_name: str, *, num_envs: int = 4, seed: int = 0,
                 hidden: Tuple[int, ...] = (64, 64), dueling: bool = False,
                 noisy: bool = False, n_step: int = 1, gamma: float = 0.99,
                 num_atoms: int = 1, v_min: float = 0.0, v_max: float = 200.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.envs = VectorEnv(lambda: make_env(env_name), num_envs, seed=seed)
        probe = make_env(env_name)
        self.net = make_q_network(probe.observation_size, probe.num_actions, hidden, seed,
                                  self.device, dueling=dueling, noisy=noisy,
                                  num_atoms=num_atoms)
        self.num_actions = probe.num_actions
        self.noisy = noisy
        self.n_step = max(1, int(n_step))
        self.gamma = gamma
        self.z = atom_support(v_min, v_max, num_atoms, self.device) if num_atoms > 1 else None
        self._rng = np.random.default_rng(seed + 1)
        self._jrng = prng.PRNGKey(seed + 2)
        self._episodes = EpisodeReturnTracker(num_envs)

    def _fwd(self, obs: np.ndarray, key: Optional[np.ndarray] = None) -> np.ndarray:
        """Q-values on the host (the expectation over C51's atoms)."""
        with torch.no_grad():
            q = self.net(torch.from_numpy(np.asarray(obs, np.float32)).to(self.device), key)
            if self.z is not None:
                q = expected_q(q, self.z)
            return q.cpu().numpy()

    def set_weights(self, state_dict) -> bool:
        self.net.load_state_dict(state_dict)
        return True

    def sample(self, num_steps: int, epsilon: float) -> SampleBatch:
        """Collect ``num_steps`` transitions per env: (s, a, R_n, s_{t+n},
        done), where R_n is the n-step discounted return (n=1 reduces to
        the classic tuple).

        Time-limit truncations are stored with done=False — the target must
        still bootstrap from s' there, exactly like the reference separates
        terminated from truncated when building Q targets."""
        n = self.envs.num_envs
        obs_l, act_l, rew_l, next_l, done_l, ended_l = [], [], [], [], [], []
        for _ in range(num_steps):
            obs = self.envs.observations
            if self.noisy:
                # exploration comes from resampled weight noise
                self._jrng, sub = prng.split(self._jrng)
                actions = self._fwd(obs, sub).argmax(axis=-1).astype(np.int32)
            else:
                actions = self._fwd(obs).argmax(axis=-1)
                explore = self._rng.random(n) < epsilon
                actions = np.where(
                    explore, self._rng.integers(0, self.num_actions, n), actions
                ).astype(np.int32)
            next_obs, rewards, terms, truncs, finals = self.envs.step(actions)
            obs_l.append(obs)
            act_l.append(actions)
            rew_l.append(rewards)
            # s' is the PRE-reset state for ended episodes
            next_l.append(finals)
            done_l.append(terms)  # truncation is not a terminal for targets
            ended_l.append(terms | truncs)  # but it DOES break n-step chains
            self._episodes.track(rewards, terms | truncs)
        if self.n_step > 1:
            return self._nstep_batch(obs_l, act_l, rew_l, next_l, done_l, ended_l)
        return SampleBatch(
            obs=np.concatenate(obs_l),
            actions=np.concatenate(act_l),
            rewards=np.concatenate(rew_l),
            new_obs=np.concatenate(next_l),
            dones=np.concatenate(done_l),
        )

    def _nstep_batch(self, obs_l, act_l, rew_l, next_l, done_l, ended_l) -> SampleBatch:
        """Fold T timesteps into n-step transitions: R = sum gamma^k r_{t+k}
        with the chain broken at episode end (terminal OR truncation — a
        reset must never leak the next episode's rewards in); the bootstrap
        state is s_{t+n} or the chain-ending state. Emitted for every t
        whose full window fits in this fragment. A chain ended early by
        truncation bootstraps with gamma^n instead of gamma^{k+1}, as the
        reference's does."""
        T = len(obs_l)
        nstep, gamma = self.n_step, self.gamma
        obs = np.stack(obs_l)          # (T, E, ...)
        actions = np.stack(act_l)
        rewards = np.stack(rew_l)
        new_obs = np.stack(next_l)
        dones = np.stack(done_l)
        ended = np.stack(ended_l)
        out_obs, out_act, out_rew, out_next, out_done = [], [], [], [], []
        for t in range(T - nstep + 1):
            ret = np.zeros(rewards.shape[1], np.float32)
            discount = np.ones(rewards.shape[1], np.float32)
            alive = np.ones(rewards.shape[1], bool)
            boot_next = new_obs[t].copy()
            boot_done = dones[t].copy()
            for k in range(nstep):
                ret += discount * rewards[t + k] * alive
                boot_next[alive] = new_obs[t + k][alive]
                boot_done[alive] = dones[t + k][alive]
                alive = alive & ~ended[t + k]
                discount *= gamma
            out_obs.append(obs[t])
            out_act.append(actions[t])
            out_rew.append(ret)
            out_next.append(boot_next)
            out_done.append(boot_done)
        return SampleBatch(
            obs=np.concatenate(out_obs),
            actions=np.concatenate(out_act),
            rewards=np.concatenate(out_rew),
            new_obs=np.concatenate(out_next),
            dones=np.concatenate(out_done),
        )

    def episode_returns(self, clear: bool = True) -> List[float]:
        return self._episodes.drain(clear)


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor, delta: float = 1.0
               ) -> torch.Tensor:
    """optax's ``huber_loss``: 0.5 q^2 + delta * (|e| - q), q = min(|e|, delta)."""
    abs_errors = (predictions - targets).abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_errors - quadratic)


class DQNLearner:
    """Double-DQN update (or C51's cross-entropy), returning the
    per-sample TD error (or CE) as the priority; the online and target
    networks and the optimizer state on ``device``."""

    def __init__(self, observation_size: int, num_actions: int, *,
                 hidden: Sequence[int] = (64, 64), lr: float = 1e-3,
                 gamma: float = 0.99, grad_clip: float = 10.0, seed: int = 0,
                 dueling: bool = False, noisy: bool = False, n_step: int = 1,
                 num_atoms: int = 1, v_min: float = 0.0, v_max: float = 200.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.net = make_q_network(observation_size, num_actions, hidden, seed, self.device,
                                  dueling=dueling, noisy=noisy, num_atoms=num_atoms)
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.noisy = noisy
        self.num_atoms = num_atoms
        self.z = atom_support(v_min, v_max, num_atoms, self.device) if num_atoms > 1 else None
        self.opt = AdamParams(self.net, lr, grad_clip)
        self._update_rng = prng.PRNGKey(seed + 11)
        # n-step transitions bootstrap with gamma^n (the worker folded the
        # intermediate rewards into batch["rewards"])
        self.gamma_n = gamma ** max(1, int(n_step))

    @property
    def opt_state(self):
        return self.opt.opt_state

    def loss(self, batch: Tensors, rng: Optional[np.ndarray] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, per-sample TD error or CE) for the update key ``rng``."""
        net, target_net, z, gamma_n = self.net, self.target_net, self.z, self.gamma_n
        r_online = r_pick = r_target = None
        if self.noisy:
            # independent noise per pass, as in the rainbow paper
            r_online, r_pick, r_target = prng.split(rng, 3)
        actions = batch["actions"].long()
        not_done = 1.0 - batch["dones"].float()
        weights = batch.get("weights")
        if self.num_atoms > 1:
            # C51: cross-entropy to the projected target distribution
            logits = net(batch["obs"], r_online)
            logits_taken = logits.gather(1, actions[:, None, None].expand(
                -1, 1, logits.shape[-1]))[:, 0]
            logp_taken = torch.log_softmax(logits_taken, dim=-1)
            with torch.no_grad():
                next_online = net(batch["new_obs"], r_pick)
                best = torch.argmax(expected_q(next_online, z), dim=-1)
                next_target = target_net(batch["new_obs"], r_target)
                next_dist = torch.softmax(next_target.gather(1, best[:, None, None].expand(
                    -1, 1, next_target.shape[-1]))[:, 0], dim=-1)
                m = categorical_projection(next_dist, batch["rewards"], not_done, gamma_n, z)
            ce = -(m * logp_taken).sum(-1)  # per-sample CE = KL + const
            loss = torch.mean(ce * weights) if weights is not None else torch.mean(ce)
            return loss, ce.detach()  # CE doubles as the priority signal
        q = net(batch["obs"], r_online)
        q_taken = q.gather(-1, actions[:, None])[:, 0]
        # double-Q: online net picks the argmax, target net evaluates it
        with torch.no_grad():
            best = torch.argmax(net(batch["new_obs"], r_pick), dim=-1)
            q_next_target = target_net(batch["new_obs"], r_target)
            q_best = q_next_target.gather(-1, best[:, None])[:, 0]
        target = batch["rewards"] + gamma_n * not_done * q_best
        td_error = q_taken - target
        huber = huber_loss(q_taken, target, delta=1.0)
        loss = torch.mean(huber * weights) if weights is not None else torch.mean(huber)
        return loss, td_error.detach()

    def grad_step(self, batch: Tensors, rng: Optional[np.ndarray] = None):
        """(gradients, loss, TD error) of one update's loss."""
        loss, td = self.loss(batch, rng)
        return self.opt.grads(loss), loss.detach(), td

    def update(self, batch: SampleBatch) -> Tuple[float, np.ndarray]:
        jb = to_device({k: v for k, v in batch.items() if k != "batch_indexes"},
                           self.device)
        self._update_rng, sub = prng.split(self._update_rng)
        grads, loss, td = self.grad_step(jb, sub)
        self.opt.step(grads)
        return float(loss), td.cpu().numpy()

    def sync_target(self):
        self.target_net.load_state_dict(self.net.state_dict())

    def get_weights(self):
        return host_state_dict(self.net)

    def set_weights(self, state_dict) -> None:
        self.net.load_state_dict(state_dict)


@dataclasses.dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 1
    num_envs_per_worker: int = 4
    rollout_fragment_length: int = 32
    buffer_size: int = 50_000
    prioritized_replay: bool = True
    per_alpha: float = 0.6
    per_beta: float = 0.4
    learning_starts: int = 1_000
    train_batch_size: int = 64
    updates_per_iteration: int = 32
    target_update_interval: int = 500  # in update steps
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 5_000  # in env steps
    gamma: float = 0.99
    lr: float = 1e-3
    hidden: tuple = (64, 64)
    seed: int = 0
    # rainbow knobs (reference: rllib DQN config dueling/noisy/n_step/
    # num_atoms — >1 atoms switches to C51 distributional learning)
    dueling: bool = False
    noisy: bool = False
    n_step: int = 1
    num_atoms: int = 1
    v_min: float = 0.0
    v_max: float = 200.0
    device: Any = None
    rollout_device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "DQN":
        if self.rollout_fragment_length < self.n_step:
            raise ValueError(
                f"rollout_fragment_length ({self.rollout_fragment_length}) "
                f"must be >= n_step ({self.n_step}): every n-step window "
                "must fit inside one collected fragment"
            )
        return DQN(self)


@dataclasses.dataclass
class RainbowDQNConfig(DQNConfig):
    """DQN with the rainbow defaults on (reference configures rainbow
    through the same DQN surface: dueling + noisy + n-step + C51 + PER).
    v_min/v_max default to a CartPole-class return range; retune per env."""

    dueling: bool = True
    noisy: bool = True
    n_step: int = 3
    num_atoms: int = 51


def learner_kwargs(config: DQNConfig) -> Dict[str, Any]:
    """The ``DQNLearner`` keyword arguments of a config."""
    return dict(hidden=config.hidden, lr=config.lr, gamma=config.gamma, seed=config.seed,
                dueling=config.dueling, noisy=config.noisy, n_step=config.n_step,
                num_atoms=config.num_atoms, v_min=config.v_min, v_max=config.v_max,
                device=config.device)


class DQN:
    """Iteration driver: sample → store → replay-train → target sync. The
    workers are actors through ``config.hooks`` (by default, in this
    process)."""

    def __init__(self, config: DQNConfig):
        self.config = config
        self.hooks = config.hooks
        probe = make_env(config.env)
        worker = self.hooks.remote(DQNRolloutWorker)
        self.workers = [
            worker.remote(
                config.env,
                num_envs=config.num_envs_per_worker,
                seed=config.seed + 1000 * i,
                hidden=config.hidden,
                dueling=config.dueling,
                noisy=config.noisy,
                n_step=config.n_step,
                gamma=config.gamma,
                num_atoms=config.num_atoms,
                v_min=config.v_min,
                v_max=config.v_max,
                device=config.rollout_device,
            )
            for i in range(config.num_rollout_workers)
        ]
        self.learner = DQNLearner(probe.observation_size, probe.num_actions,
                                  **learner_kwargs(config))
        if config.prioritized_replay:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_size, alpha=config.per_alpha, seed=config.seed
            )
        else:
            self.buffer = ReplayBuffer(config.buffer_size, seed=config.seed)
        self._env_steps = 0
        self._updates = 0
        self._iteration = 0
        self._broadcast_weights()

    def _broadcast_weights(self):
        weights = self.learner.get_weights()
        self.hooks.get([w.set_weights.remote(weights) for w in self.workers], timeout=120)

    @property
    def epsilon(self) -> float:
        cfg = self.config
        if cfg.noisy:
            return 0.0  # exploration comes from the weight noise
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        cfg = self.config
        batches = self.hooks.get(
            [w.sample.remote(cfg.rollout_fragment_length, self.epsilon) for w in self.workers],
            timeout=600,
        )
        batch = SampleBatch.concat(batches)
        self._env_steps += len(batch)
        self.buffer.add(batch)

        losses = []
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iteration):
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    mb = self.buffer.sample(cfg.train_batch_size, beta=cfg.per_beta)
                    loss, td = self.learner.update(mb)
                    self.buffer.update_priorities(mb["batch_indexes"], td)
                else:
                    mb = self.buffer.sample(cfg.train_batch_size)
                    loss, _ = self.learner.update(mb)
                losses.append(loss)
                self._updates += 1
                if self._updates % cfg.target_update_interval == 0:
                    self.learner.sync_target()
            self._broadcast_weights()

        episode_returns: List[float] = []
        for w in self.workers:
            episode_returns.extend(self.hooks.get(w.episode_returns.remote(), timeout=60))
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "env_steps_total": self._env_steps,
            "num_updates": self._updates,
            "epsilon": self.epsilon,
            "buffer_size": len(self.buffer),
            "mean_loss": float(np.mean(losses)) if losses else float("nan"),
            "episode_return_mean": float(np.mean(episode_returns))
            if episode_returns else float("nan"),
            "episodes_this_iter": len(episode_returns),
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self):
        for w in self.workers:
            self.hooks.kill(w)
