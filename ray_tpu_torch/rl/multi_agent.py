"""Multi-agent environments + independent-policy PPO training
(counterpart of ``ray_tpu/rl/multi_agent.py``).

Reference surface: rllib/env/multi_agent_env.py (dict-keyed obs/actions,
"__all__" episode end) + the policy_mapping_fn / per-policy train split in
rllib/evaluation/episode_v2 + algorithm multi-agent config. This build
keeps the same contract: a ``MultiAgentEnv`` steps dicts keyed by agent
id, a mapping function assigns each agent to a policy, rollout workers
split experience per policy, and one PPOLearner per policy trains on its
own slice (independent learning — the reference's default multi-agent
mode). Actors start through ``config.hooks``; the learners run on
``config.device``, the workers' policies on ``config.rollout_device``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch import DeviceLike
from ray_tpu_torch.rl.env import CartPole
from ray_tpu_torch.rl.learner import PPOLearner, PPOLossConfig
from ray_tpu_torch.rl.rl_module import RLModule
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae
from ray_tpu_torch.runtime import RuntimeHooks


class MultiAgentEnv:
    """Protocol: dict-keyed observations/actions per agent id.

    - ``reset(seed) -> (obs: {agent: np.ndarray}, infos: dict)``
    - ``step(actions: {agent: action}) ->
        (obs, rewards, terminateds, truncateds, infos)`` — all dicts keyed
        by agent id; ``terminateds["__all__"]``/``truncateds["__all__"]``
        end the episode for everyone (reference:
        rllib/env/multi_agent_env.py)."""

    agent_ids: Tuple[str, ...] = ()

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        raise NotImplementedError


class IndependentCartPoles(MultiAgentEnv):
    """Two cart-poles, one per agent; the episode ends when BOTH are done
    (kept independent so per-policy learning curves are interpretable)."""

    agent_ids = ("agent_0", "agent_1")
    observation_size = CartPole.observation_size
    num_actions = CartPole.num_actions

    def __init__(self, max_steps: int = 200, seed: Optional[int] = None):
        self._envs = {
            a: CartPole(max_steps=max_steps, seed=None if seed is None else seed + i)
            for i, a in enumerate(self.agent_ids)
        }
        self._done: Dict[str, bool] = {}

    def reset(self, seed: Optional[int] = None):
        obs = {}
        for i, (a, e) in enumerate(self._envs.items()):
            obs[a], _ = e.reset(None if seed is None else seed + i)
        self._done = {a: False for a in self.agent_ids}
        return obs, {}

    def step(self, actions: Dict[str, Any]):
        obs, rewards, terms, truncs = {}, {}, {}, {}
        for a, env in self._envs.items():
            if self._done[a]:
                continue  # done agents drop out of the dicts (rllib contract)
            o, r, term, trunc, _ = env.step(int(actions[a]))
            obs[a], rewards[a] = o, r
            terms[a], truncs[a] = term, trunc
            if term or trunc:
                self._done[a] = True
        terms["__all__"] = all(self._done.values())
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, {}


MULTI_AGENT_REGISTRY = {"IndependentCartPoles": IndependentCartPoles}


def make_multi_agent_env(name_or_cls, **kw) -> MultiAgentEnv:
    if isinstance(name_or_cls, str):
        return MULTI_AGENT_REGISTRY[name_or_cls](**kw)
    return name_or_cls(**kw)


class MultiAgentRolloutWorker:
    """Steps one multi-agent env; splits trajectories per POLICY and
    attaches GAE per agent-episode before returning."""

    def __init__(self, env_name: str, *, policy_specs: Dict[str, Dict[str, Any]],
                 policy_mapping: Dict[str, str], seed: int = 0,
                 gamma: float = 0.99, lam: float = 0.95, device: DeviceLike = None):
        self.env = make_multi_agent_env(env_name)
        self.policy_mapping = dict(policy_mapping)
        self.modules = {
            pid: RLModule(
                spec["observation_size"], spec["num_actions"],
                hidden=spec.get("hidden", (64, 64)), seed=seed + j, device=device,
            )
            for j, (pid, spec) in enumerate(policy_specs.items())
        }
        self.gamma, self.lam = gamma, lam
        self._rng = np.random.default_rng(seed + 1)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_returns: List[float] = []
        self._running_return = 0.0

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        for pid, params in weights.items():
            self.modules[pid].set_params(params)
        return True

    def episode_returns(self) -> List[float]:
        out, self._episode_returns = self._episode_returns, []
        return out

    def sample(self, num_steps: int) -> Dict[str, SampleBatch]:
        # per-agent trajectory buffers; cut + GAE at episode end
        traj: Dict[str, Dict[str, list]] = {
            a: {k: [] for k in ("obs", "actions", "rewards", "logp", "values")}
            for a in self.env.agent_ids
        }
        out: Dict[str, List[SampleBatch]] = {
            pid: [] for pid in self.modules
        }

        def _cut(agent: str, bootstrap_value: float):
            t = traj[agent]
            if not t["obs"]:
                return
            rewards = np.asarray(t["rewards"], np.float32)
            values = np.asarray(t["values"], np.float32)
            dones = np.zeros(len(rewards), np.bool_)
            dones[-1] = True
            # compute_gae is [t, n_envs]-shaped; one trajectory = one column
            adv, ret = compute_gae(
                rewards[:, None], values[:, None], dones[:, None],
                np.asarray([bootstrap_value], np.float32),
                gamma=self.gamma, lam=self.lam,
            )
            adv, ret = adv[:, 0], ret[:, 0]
            pid = self.policy_mapping[agent]
            out[pid].append(
                SampleBatch(
                    obs=np.asarray(t["obs"], np.float32),
                    actions=np.asarray(t["actions"], np.int32),
                    rewards=rewards,
                    logp=np.asarray(t["logp"], np.float32),
                    values=values,
                    advantages=adv,
                    returns=ret,
                    dones=dones,
                )
            )
            for v in t.values():
                v.clear()

        for _ in range(num_steps):
            actions: Dict[str, int] = {}
            for agent, obs in self._obs.items():
                pid = self.policy_mapping[agent]
                a, logp, value = self.modules[pid].forward_inference(
                    obs[None, :], self._rng
                )
                actions[agent] = int(a[0])
                t = traj[agent]
                t["obs"].append(obs)
                t["actions"].append(int(a[0]))
                t["logp"].append(float(logp[0]))
                t["values"].append(float(value[0]))
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            self._running_return += sum(rewards.values())
            for agent, r in rewards.items():
                traj[agent]["rewards"].append(r)
                ended = terms.get(agent) or truncs.get(agent)
                if ended:
                    boot = 0.0
                    if truncs.get(agent) and not terms.get(agent):
                        pid = self.policy_mapping[agent]
                        _, _, v = self.modules[pid].forward_inference(
                            next_obs.get(agent, traj[agent]["obs"][-1])[None, :]
                            if agent in next_obs
                            else np.asarray(traj[agent]["obs"][-1])[None, :],
                            self._rng,
                        )
                        boot = float(v[0])
                    _cut(agent, boot)
            if terms.get("__all__") or truncs.get("__all__"):
                self._episode_returns.append(self._running_return)
                self._running_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                # the env includes an ended agent's FINAL obs in its last
                # step return (rllib contract); it must not act again
                ended_now = {
                    a for a in rewards
                    if terms.get(a) or truncs.get(a)
                }
                self._obs = {
                    a: o for a, o in next_obs.items() if a not in ended_now
                }
        # cut the still-running trajectories with a bootstrap value
        for agent, obs in self._obs.items():
            if traj[agent]["obs"]:
                pid = self.policy_mapping[agent]
                _, _, v = self.modules[pid].forward_inference(
                    obs[None, :], self._rng
                )
                _cut(agent, float(v[0]))
        return {
            pid: SampleBatch.concat(batches)
            for pid, batches in out.items()
            if batches
        }


@dataclasses.dataclass
class MultiAgentPPOConfig:
    env: str = "IndependentCartPoles"
    # policy id -> module spec; None derives one shared spec per agent id
    policies: Optional[Dict[str, Dict[str, Any]]] = None
    # agent id -> policy id; None maps each agent to its own policy
    policy_mapping: Optional[Dict[str, str]] = None
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    minibatch_size: int = 128
    num_epochs: int = 4
    hidden: tuple = (64, 64)
    loss: PPOLossConfig = dataclasses.field(default_factory=PPOLossConfig)
    seed: int = 0
    device: Any = None
    rollout_device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """Independent PPO: one learner per policy over its agents' slices."""

    def __init__(self, config: MultiAgentPPOConfig):
        self.config = config
        self.hooks = config.hooks
        probe = make_multi_agent_env(config.env)
        mapping = config.policy_mapping or {
            a: f"policy_{a}" for a in probe.agent_ids
        }
        spec = {
            "observation_size": probe.observation_size,
            "num_actions": probe.num_actions,
            "hidden": config.hidden,
        }
        policies = config.policies or {pid: dict(spec) for pid in set(mapping.values())}
        self.learners = {
            pid: PPOLearner(
                p["observation_size"], p["num_actions"],
                hidden=tuple(p.get("hidden", config.hidden)),
                lr=config.lr, loss_config=config.loss, seed=config.seed + i,
                device=config.device,
            )
            for i, (pid, p) in enumerate(sorted(policies.items()))
        }
        worker = self.hooks.remote(MultiAgentRolloutWorker)
        self.workers = [
            worker.remote(
                config.env,
                policy_specs=policies,
                policy_mapping=mapping,
                seed=config.seed + 1000 * i,
                gamma=config.gamma,
                lam=config.lam,
                device=config.rollout_device,
            )
            for i in range(config.num_rollout_workers)
        ]
        self._iteration = 0
        self._broadcast()

    def _broadcast(self):
        weights = {pid: l.get_weights() for pid, l in self.learners.items()}
        self.hooks.get(
            [w.set_weights.remote(weights) for w in self.workers], timeout=120
        )

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        per_worker = self.hooks.get(
            [
                w.sample.remote(cfg.rollout_fragment_length)
                for w in self.workers
            ],
            timeout=300,
        )
        losses: Dict[str, float] = {}
        for pid, learner in self.learners.items():
            batches = [pw[pid] for pw in per_worker if pid in pw]
            if not batches:
                continue
            batch = SampleBatch.concat(batches)
            metrics = learner.update(
                batch,
                minibatch_size=cfg.minibatch_size,
                num_epochs=cfg.num_epochs,
                seed=cfg.seed + self._iteration,
            )
            losses[pid] = float(metrics["total_loss"])
        self._broadcast()
        self._iteration += 1
        returns = [
            r
            for w in self.workers
            for r in self.hooks.get(w.episode_returns.remote(), timeout=60)
        ]
        return {
            "iteration": self._iteration,
            "episode_return_mean": float(np.mean(returns)) if returns else None,
            "policy_losses": losses,
            "time_s": round(time.perf_counter() - t0, 2),
        }

    def stop(self):
        for w in self.workers:
            self.hooks.kill(w)
