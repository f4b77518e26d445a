"""Environments: a dependency-free CartPole + vectorized wrapper.

The reference consumes Gym/Gymnasium environments (reference:
rllib/env/vector_env.py, multi_agent_env.py); this build ships the classic
cart-pole control problem natively (standard published dynamics) so the
learning tests run with zero extra deps. The API follows the gymnasium
5-tuple convention: step -> (obs, reward, terminated, truncated, info).

A copy of ``ray_tpu/rl/env.py``, which the port may not import, so that
the same seed steps the same episodes in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class CartPole:
    """Pole balancing: push a cart left/right, keep the pole upright.

    Observation: [x, x_dot, theta, theta_dot]; actions: {0: left, 1: right};
    reward 1 per step; episode ends when |theta| > 12deg, |x| > 2.4, or
    after ``max_steps``.
    """

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * np.pi / 180
    X_LIMIT = 2.4

    observation_size = 4
    num_actions = 2

    def __init__(self, max_steps: int = 500, seed: Optional[int] = None):
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, np.float64)
        self._t = 0

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32).copy(), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        temp = (force + pole_ml * theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0 - self.POLE_MASS * cos_t**2 / total_mass)
        )
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        x = x + self.DT * x_dot
        x_dot = x_dot + self.DT * x_acc
        theta = theta + self.DT * theta_dot
        theta_dot = theta_dot + self.DT * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._t += 1
        terminated = bool(
            abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT
        )
        truncated = self._t >= self.max_steps
        return (
            self._state.astype(np.float32).copy(),
            1.0,
            terminated,
            truncated,
            {},
        )


class Pendulum:
    """Torque-control pendulum swing-up (standard published dynamics).

    Observation: [cos(theta), sin(theta), theta_dot]; action: continuous
    torque in [-2, 2]; reward: -(theta^2 + 0.1*theta_dot^2 + 0.001*u^2).
    The classic continuous-control smoke problem (the reference's SAC
    learning tests use Pendulum-v1 — rllib/algorithms/sac/tests)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    observation_size = 3
    action_size = 1
    action_low = -2.0
    action_high = 2.0
    continuous = True

    def __init__(self, max_steps: int = 200, seed: Optional[int] = None):
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._theta = 0.0
        self._theta_dot = 0.0
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.array(
            [np.cos(self._theta), np.sin(self._theta), self._theta_dot],
            np.float32,
        )

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._theta = self._rng.uniform(-np.pi, np.pi)
        self._theta_dot = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th, thdot = self._theta, self._theta_dot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (
            3 * self.G / (2 * self.L) * np.sin(th)
            + 3.0 / (self.M * self.L**2) * u
        ) * self.DT
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + thdot * self.DT
        self._theta, self._theta_dot = th, thdot
        self._t += 1
        truncated = self._t >= self.max_steps
        return self._obs(), -float(cost), False, truncated, {}


ENV_REGISTRY = {"CartPole-v1": CartPole, "Pendulum-v1": Pendulum}


def make_env(name_or_cls, **kwargs):
    if isinstance(name_or_cls, str):
        try:
            cls = ENV_REGISTRY[name_or_cls]
        except KeyError:
            raise ValueError(f"unknown env {name_or_cls!r}") from None
        return cls(**kwargs)
    return name_or_cls(**kwargs)


class VectorEnv:
    """N independent env copies with auto-reset (reference:
    rllib/env/vector_env.py)."""

    def __init__(self, env_fn, num_envs: int, seed: int = 0):
        self.envs: List[Any] = [env_fn() for _ in range(num_envs)]
        self.num_envs = num_envs
        self._obs = np.stack(
            [e.reset(seed=seed + i)[0] for i, e in enumerate(self.envs)]
        )

    @property
    def observations(self) -> np.ndarray:
        return self._obs

    def step(self, actions: np.ndarray):
        """Returns (obs, rewards, terminateds, truncateds, final_obs).

        ``final_obs[i]`` is the PRE-reset observation for envs that ended
        this step (== obs[i] otherwise): a truncated episode must bootstrap
        its value target from that state, not from the auto-reset one
        (reference: rllib bootstraps on time-limit truncation)."""
        obs, rewards, terms, truncs, finals = [], [], [], [], []
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            # discrete actions arrive as integer scalars -> python int;
            # continuous actions are float arrays and MUST pass through
            # un-truncated (int(a) would quantize a Pendulum torque of 1.7
            # down to 1 — the stored action would not be the executed one)
            arr = np.asarray(a)
            o, r, term, trunc, _ = env.step(
                int(arr) if arr.dtype.kind in "iub" else arr
            )
            finals.append(o)
            if term or trunc:
                o, _ = env.reset()
            obs.append(o)
            rewards.append(r)
            terms.append(term)
            truncs.append(trunc)
        self._obs = np.stack(obs)
        return (
            self._obs,
            np.asarray(rewards, np.float32),
            np.asarray(terms, np.bool_),
            np.asarray(truncs, np.bool_),
            np.stack(finals),
        )


class EpisodeReturnTracker:
    """Per-env cumulative return bookkeeping shared by rollout workers:
    accumulates raw rewards and banks the total when an episode ends."""

    def __init__(self, num_envs: int):
        self._returns = np.zeros(num_envs, np.float32)
        self._completed: List[float] = []

    def track(self, rewards: np.ndarray, ended: np.ndarray):
        self._returns += rewards
        for i in np.nonzero(ended)[0]:
            self._completed.append(float(self._returns[i]))
            self._returns[i] = 0.0

    def drain(self, clear: bool = True) -> List[float]:
        out = list(self._completed)
        if clear:
            self._completed = []
        return out
