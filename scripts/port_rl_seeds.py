#!/usr/bin/env python3
"""How the port's RL learning tests depend on the seed, on the CPU.

    python scripts/port_rl_seeds.py ppo|appo|impala [--seeds 0 1 2] [--reference-init]

Runs the reference's learning-test configuration of one algorithm
(tests/test_rl.py:84 for PPO, :257 for IMPALA, test_rl_breadth.py:189 for
APPO) with the port on the CPU, in-process hooks, once per seed, and prints
for each the iterations (PPO) or ``train(num_updates=8)`` calls taken to
reach the test's return, or the best return within its budget.
``--reference-init`` starts every learner from the reference's initial
weights for the seed (flax's draw from ``jax.random.PRNGKey(seed)``,
carried over by ``rl.convert``; imports JAX), to tell the port's own
initial draw apart from the rest of the algorithm.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# algorithm: (config name, train kwargs, return to reach, budget)
TESTS = {
    "ppo": ("PPOConfig", dict(rollout_fragment_length=128, lr=1e-3, num_epochs=8,
                              minibatch_size=256), {}, 120.0, 30),
    "impala": ("ImpalaConfig", dict(rollout_fragment_length=32, lr=1e-3),
               dict(num_updates=8), 80.0, 40),
    "appo": ("APPOConfig", dict(rollout_fragment_length=32, lr=1e-3),
             dict(num_updates=8), 80.0, 40),
}


def reference_init():
    """Make every port learner start from the reference's initial weights."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.rl.rl_module import DiscretePolicyModule
    from ray_tpu_torch.rl import learner
    from ray_tpu_torch.rl.convert import params_to_state_dict

    make_policy = learner.make_policy

    def drawn_by_flax(obs, actions, hidden, seed, device):
        net = make_policy(obs, actions, hidden, seed, device)
        params = DiscretePolicyModule(actions, tuple(hidden)).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, obs)))["params"]
        net.load_state_dict(params_to_state_dict(jax.device_get(params)))
        return net

    learner.make_policy = drawn_by_flax


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("algorithm", choices=sorted(TESTS))
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    ap.add_argument("--reference-init", action="store_true")
    args = ap.parse_args()
    if args.reference_init:
        reference_init()
    from ray_tpu_torch import rl

    name, config, train_kw, target, budget = TESTS[args.algorithm]
    for seed in args.seeds:
        algo = getattr(rl, name)(num_rollout_workers=2, num_envs_per_worker=4, seed=seed,
                                 device="cpu", rollout_device="cpu", **config).build()
        best, taken = 0.0, None
        try:
            for i in range(budget):
                r = algo.train(**train_kw)
                if np.isfinite(r["episode_return_mean"]):
                    best = max(best, r["episode_return_mean"])
                if best >= target:
                    taken = i + 1
                    break
        finally:
            algo.stop()
        print(f"{args.algorithm} seed {seed}: "
              + (f"{target} reached after {taken}" if taken else f"not reached in {budget}")
              + f", best {best:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
