"""External-env RL serving: PolicyServer + PolicyClient (counterpart of
``ray_tpu/rl/policy_server.py``).

Reference: rllib/env/policy_client.py + policy_server_input.py — an
environment living OUTSIDE the cluster (a game server, a robot, a
simulator in another language) drives episodes over the wire:
start_episode / get_action / log_returns / end_episode. The server turns
those calls into transitions for an off-policy learner.

The server embeds a ``DQNLearner`` (on ``device``) and a
PrioritizedReplayBuffer; actions are served epsilon-greedily from the live
weights, training runs inline every ``train_every`` transitions, so a
single process serves and learns. The wire comes from
``hooks.rpc_server`` / ``hooks.rpc_client``: by default an in-process
transport (each call on the caller's thread); the reference's runtime RPC
through the glue. The reference swaps immutable parameter trees; the
port's optimizer updates the network in place, so every forward and
every update runs under the server's lock: no action is taken from
half-updated weights.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch import DeviceLike
from ray_tpu_torch.rl.dqn import DQNLearner
from ray_tpu_torch.rl.replay_buffers import PrioritizedReplayBuffer
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["PolicyClient", "PolicyServer"]


class _Episode:
    __slots__ = ("last_obs", "last_action", "total_reward", "steps", "_pending_reward")

    def __init__(self):
        self.last_obs: Optional[np.ndarray] = None
        self.last_action: Optional[int] = None
        self.total_reward = 0.0
        self.steps = 0
        self._pending_reward = 0.0


class PolicyServer:
    """Serve actions to external episodes and learn from their returns."""

    def __init__(
        self,
        observation_size: int,
        num_actions: int,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        lr: float = 1e-3,
        gamma: float = 0.99,
        hidden: Tuple[int, ...] = (64, 64),
        buffer_size: int = 50_000,
        train_batch_size: int = 64,
        learning_starts: int = 500,
        train_every: int = 16,
        target_update_interval: int = 250,
        epsilon_start: float = 1.0,
        epsilon_end: float = 0.05,
        epsilon_decay_steps: int = 4_000,
        seed: int = 0,
        device: DeviceLike = None,
        hooks: Optional[RuntimeHooks] = None,
    ):
        self.learner = DQNLearner(
            observation_size, num_actions, hidden=hidden, lr=lr,
            gamma=gamma, seed=seed, device=device,
        )
        self.device = self.learner.device
        self.num_actions = num_actions
        self.buffer = PrioritizedReplayBuffer(buffer_size, seed=seed)
        self.train_batch_size = train_batch_size
        self.learning_starts = learning_starts
        self.train_every = train_every
        self.target_update_interval = target_update_interval
        self.epsilon_start = epsilon_start
        self.epsilon_end = epsilon_end
        self.epsilon_decay_steps = epsilon_decay_steps
        self._rng = np.random.default_rng(seed)
        self._episodes: Dict[str, _Episode] = {}
        self._lock = threading.Lock()
        self.transitions = 0
        self.updates = 0
        self.episode_returns: List[float] = []
        hooks = hooks or RuntimeHooks()
        self._server = hooks.rpc_server("policy-server", host=host, port=port)
        self._server.register_all(self, prefix="policy_")

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.address

    @property
    def epsilon(self) -> float:
        frac = min(1.0, self.transitions / max(1, self.epsilon_decay_steps))
        return self.epsilon_start + frac * (self.epsilon_end - self.epsilon_start)

    # -- wire handlers (all under the server's dispatch pool) -------------

    def rpc_start_episode(self, conn, payload) -> str:
        episode_id = (payload or {}).get("episode_id") or uuid.uuid4().hex[:16]
        with self._lock:
            self._episodes[episode_id] = _Episode()
        return episode_id

    @torch.no_grad()
    def _greedy(self, obs: np.ndarray) -> int:
        """The live network's argmax (called under the lock)."""
        q = self.learner.net(torch.from_numpy(obs[None]).to(self.device))
        return int(q[0].argmax().item())

    def rpc_get_action(self, conn, payload):
        episode_id, obs = payload["episode_id"], np.asarray(payload["obs"], np.float32)
        with self._lock:
            ep = self._episodes.get(episode_id)
            if ep is None:
                raise KeyError(f"unknown episode {episode_id!r}")
            # the PREVIOUS transition completes when the next obs arrives
            if ep.last_obs is not None:
                self._record(ep, obs, done=False)
            if self._rng.random() < self.epsilon:
                action = int(self._rng.integers(0, self.num_actions))
            else:
                action = self._greedy(obs)
            ep.last_obs = obs
            ep.last_action = action
        return action

    def rpc_log_returns(self, conn, payload) -> bool:
        episode_id, reward = payload["episode_id"], float(payload["reward"])
        with self._lock:
            ep = self._episodes.get(episode_id)
            if ep is None:
                raise KeyError(f"unknown episode {episode_id!r}")
            ep.total_reward += reward
            ep.steps += 1
            ep._pending_reward += reward
        return True

    def rpc_end_episode(self, conn, payload) -> Dict[str, Any]:
        episode_id = payload["episode_id"]
        final_obs = np.asarray(payload.get("obs"), np.float32)
        with self._lock:
            ep = self._episodes.pop(episode_id, None)
            if ep is None:
                raise KeyError(f"unknown episode {episode_id!r}")
            if ep.last_obs is not None:
                self._record(ep, final_obs, done=True)
            self.episode_returns.append(ep.total_reward)
        return {"episode_return": ep.total_reward, "steps": ep.steps}

    def rpc_get_stats(self, conn, payload=None) -> Dict[str, Any]:
        with self._lock:
            returns = list(self.episode_returns)
        return {
            "transitions": self.transitions,
            "updates": self.updates,
            "episodes": len(returns),
            "epsilon": self.epsilon,
            "recent_return_mean": float(np.mean(returns[-20:])) if returns else float("nan"),
        }

    # -- learning ---------------------------------------------------------

    def _record(self, ep: _Episode, next_obs: np.ndarray, done: bool):
        # called under self._lock with a completed (s, a, r, s') transition
        reward = ep._pending_reward
        ep._pending_reward = 0.0
        self.buffer.add(
            SampleBatch(
                obs=ep.last_obs[None],
                actions=np.asarray([ep.last_action], np.int32),
                rewards=np.asarray([reward], np.float32),
                new_obs=next_obs[None],
                dones=np.asarray([done]),
            )
        )
        self.transitions += 1
        if (
            self.transitions >= self.learning_starts
            and self.transitions % self.train_every == 0
        ):
            mb = self.buffer.sample(self.train_batch_size)
            _loss, td = self.learner.update(mb)
            self.buffer.update_priorities(mb["batch_indexes"], td)
            self.updates += 1
            if self.updates % self.target_update_interval == 0:
                self.learner.sync_target()

    def stop(self):
        self._server.stop()


class PolicyClient:
    """Thin wire client an external environment loop drives
    (reference: rllib/env/policy_client.py — same four verbs), through
    ``hooks.rpc_client``."""

    def __init__(self, address: Tuple[str, int], timeout: float = 30.0,
                 hooks: Optional[RuntimeHooks] = None):
        self._client = (hooks or RuntimeHooks()).rpc_client(address)
        self._timeout = timeout

    def start_episode(self, episode_id: Optional[str] = None) -> str:
        return self._client.call(
            "policy_start_episode", {"episode_id": episode_id},
            timeout=self._timeout,
        )

    def get_action(self, episode_id: str, obs) -> int:
        return self._client.call(
            "policy_get_action",
            {"episode_id": episode_id, "obs": np.asarray(obs, np.float32)},
            timeout=self._timeout,
        )

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._client.call(
            "policy_log_returns",
            {"episode_id": episode_id, "reward": float(reward)},
            timeout=self._timeout,
        )

    def end_episode(self, episode_id: str, obs) -> Dict[str, Any]:
        return self._client.call(
            "policy_end_episode",
            {"episode_id": episode_id, "obs": np.asarray(obs, np.float32)},
            timeout=self._timeout,
        )

    def get_stats(self) -> Dict[str, Any]:
        return self._client.call("policy_get_stats", None, timeout=self._timeout)

    def close(self):
        self._client.close()
