"""RolloutWorker: vectorized env stepping (counterpart of
``ray_tpu/rl/rollout_worker.py``).

Reference: rllib/evaluation/rollout_worker.py:166 (sample:879) — actors
run envs and the current policy, returning SampleBatches; weights
broadcast from the learner between iterations. Here the class is plain:
an algorithm makes it an actor through its ``RuntimeHooks.remote``. The
policy's forward runs on the worker's ``device``; the envs, the sampling
and GAE stay numpy on the host, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch import DeviceLike
from ray_tpu_torch.rl.env import EpisodeReturnTracker, VectorEnv, make_env
from ray_tpu_torch.rl.rl_module import RLModule
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae


class RolloutWorker:
    def __init__(self, env_name: str, *, num_envs: int = 4, seed: int = 0,
                 module_config: Dict[str, Any] = None, gamma: float = 0.99,
                 lam: float = 0.95, obs_connectors=None, action_connectors=None,
                 device: DeviceLike = None):
        self.envs = VectorEnv(lambda: make_env(env_name), num_envs, seed=seed)
        cfg = module_config or {}
        probe = make_env(env_name)
        self.module = RLModule(
            cfg.get("observation_size", probe.observation_size),
            cfg.get("num_actions", probe.num_actions),
            hidden=cfg.get("hidden", (64, 64)),
            seed=seed,
            device=device,
        )
        self._rng = np.random.default_rng(seed + 1)
        self.gamma = gamma
        self.lam = lam
        # connector pipelines between env and policy (reference:
        # rllib/connectors/ — obs transforms before inference, action
        # transforms before env.step); None = identity
        self.obs_connectors = obs_connectors
        self.action_connectors = action_connectors
        # episode-return tracking (the learning-test metric)
        self._episodes = EpisodeReturnTracker(num_envs)

    def _obs(self, obs: np.ndarray) -> np.ndarray:
        return self.obs_connectors(obs) if self.obs_connectors is not None else obs

    def _act(self, actions: np.ndarray) -> np.ndarray:
        if self.action_connectors is not None:
            return self.action_connectors(actions)
        return actions

    def connector_state(self) -> Dict[str, Any]:
        """Stateful-connector sync point (the reference syncs filter state
        through WorkerSet.foreach_worker)."""
        return {
            "obs": self.obs_connectors.state() if self.obs_connectors else {},
            "action": self.action_connectors.state() if self.action_connectors else {},
        }

    def set_connector_state(self, state: Dict[str, Any]) -> bool:
        if self.obs_connectors is not None and state.get("obs"):
            self.obs_connectors.set_state(state["obs"])
        if self.action_connectors is not None and state.get("action"):
            self.action_connectors.set_state(state["action"])
        return True

    def set_weights(self, state_dict) -> bool:
        """Load a learner's weights (a host state dict) onto the worker's
        device."""
        self.module.set_params(state_dict)
        return True

    def _step(self, obs: np.ndarray):
        """One env step under the policy: (actions, logp, values, rewards
        with the time-limit bootstrap folded in, raw rewards, dones)."""
        actions, logp, values = self.module.forward_inference(obs, self._rng)
        _, rewards, terms, truncs, finals = self.envs.step(self._act(actions))
        dones = terms | truncs
        raw_rewards = rewards
        bootstrap = truncs & ~terms
        if bootstrap.any():
            # time-limit truncation is not a real terminal: fold the
            # value of the final (pre-reset) state into the reward so
            # GAE's episode cut doesn't bias targets low
            _, _, final_vals = self.module.forward_inference(self._obs(finals), self._rng)
            rewards = rewards + self.gamma * final_vals * bootstrap
        self._episodes.track(raw_rewards, dones)  # excludes the bootstrap
        return actions, logp, values, rewards, dones

    def sample(self, num_steps: int) -> SampleBatch:
        """Collect num_steps per env; returns a flat SampleBatch with GAE
        advantages already attached (postprocessing on the worker, like the
        reference's sampler postprocessors)."""
        n = self.envs.num_envs
        obs_buf = np.empty((num_steps, n, self.module.observation_size), np.float32)
        act_buf = np.empty((num_steps, n), np.int32)
        rew_buf = np.empty((num_steps, n), np.float32)
        done_buf = np.empty((num_steps, n), np.bool_)
        logp_buf = np.empty((num_steps, n), np.float32)
        val_buf = np.empty((num_steps, n), np.float32)
        for t in range(num_steps):
            obs = self._obs(self.envs.observations)
            obs_buf[t] = obs
            act_buf[t], logp_buf[t], val_buf[t], rew_buf[t], done_buf[t] = self._step(obs)
        _, _, last_values = self.module.forward_inference(
            self._obs(self.envs.observations), self._rng
        )
        adv, rets = compute_gae(
            rew_buf, val_buf, done_buf, last_values, gamma=self.gamma, lam=self.lam
        )
        flat = lambda a: a.reshape(num_steps * n, *a.shape[2:])  # noqa: E731
        return SampleBatch(
            obs=flat(obs_buf),
            actions=flat(act_buf),
            rewards=flat(rew_buf),
            dones=flat(done_buf),
            logp=flat(logp_buf),
            values=flat(val_buf),
            advantages=flat(adv),
            returns=flat(rets),
        )

    def sample_trajectory(self, num_steps: int) -> SampleBatch:
        """Time-major fragment for off-policy correction (IMPALA/V-trace).

        Unlike :meth:`sample` this keeps the [T, num_envs] structure and
        attaches the behavior policy's log-probs instead of GAE — the
        learner recomputes values/target-logp under its (newer) policy and
        corrects the off-policyness with V-trace."""
        n = self.envs.num_envs
        d = self.module.observation_size
        obs_buf = np.empty((num_steps, n, d), np.float32)
        act_buf = np.empty((num_steps, n), np.int32)
        rew_buf = np.empty((num_steps, n), np.float32)
        done_buf = np.empty((num_steps, n), np.bool_)
        logp_buf = np.empty((num_steps, n), np.float32)
        for t in range(num_steps):
            obs = self._obs(self.envs.observations)
            obs_buf[t] = obs
            act_buf[t], logp_buf[t], _, rew_buf[t], done_buf[t] = self._step(obs)
        return SampleBatch(
            obs=obs_buf,
            actions=act_buf,
            rewards=rew_buf,
            dones=done_buf,
            behavior_logp=logp_buf,
            bootstrap_obs=np.asarray(self._obs(self.envs.observations)).copy(),
        )

    def episode_returns(self, clear: bool = True):
        return self._episodes.drain(clear)
