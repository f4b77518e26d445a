#!/usr/bin/env python3
"""How the reference's RL learning tests depend on the seed, on the CPU.

    python scripts/ref_rl_seeds.py ALGORITHM [--seeds 0 1 2 3 4 5] [--timeout 900]

The counterpart of ``scripts/port_rl_seeds.py`` for the JAX package
(``ray_tpu.rl``): it runs the reference's learning-test configuration of
one algorithm under ``ray_tpu.init(num_cpus=4)`` (the tests' fixtures), on
the CPU, once per seed, each seed in a process of its own with its own
timeout, and prints for each how far into its budget the test's gate was
met, or the best it reached, in ``port_rl_seeds.py``'s format:

- ``ppo`` (tests/test_rl.py:84): best mean return >= 120 within 30
  iterations;
- ``appo`` (tests/test_rl_breadth.py:189): >= 80 within 40 calls of
  ``train(num_updates=8)``;
- ``dqn`` (tests/test_rl.py:231): >= 100 within 60 iterations.

The configurations are the tests' and ``port_rl_seeds.py``'s, with the
seed changed. The port starts every network from the reference's initial
weights for the seed, so the two scripts start a seed from the same
weights.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (config class, config, gate, budget, train keyword arguments)
TESTS = {
    "ppo": ("PPOConfig", dict(num_rollout_workers=2, num_envs_per_worker=4,
                              rollout_fragment_length=128, lr=1e-3, num_epochs=8,
                              minibatch_size=256), 120.0, 30, {}),
    "appo": ("APPOConfig", dict(num_rollout_workers=2, num_envs_per_worker=4,
                                rollout_fragment_length=32, lr=1e-3), 80.0, 40,
             dict(num_updates=8)),
    "dqn": ("DQNConfig", dict(num_rollout_workers=1, num_envs_per_worker=4,
                              rollout_fragment_length=64, learning_starts=256,
                              epsilon_decay_steps=3000, updates_per_iteration=16,
                              target_update_interval=100), 100.0, 60, {}),
}


def run_one(name: str, seed: int) -> dict:
    """One seed of one test, in this process: {"taken": the call that met
    the gate or None, "best": the best mean return}."""
    import numpy as np

    import ray_tpu
    from ray_tpu import rl

    cls, config, target, budget, train_kw = TESTS[name]
    ray_tpu.init(num_cpus=4, log_level="ERROR")
    try:
        algo = getattr(rl, cls)(seed=seed, **config).build()
        best, taken = -np.inf, None
        try:
            for i in range(budget):
                m = algo.train(**train_kw)["episode_return_mean"]
                if m is not None and np.isfinite(m):
                    best = max(best, float(m))
                if best >= target:
                    taken = i + 1
                    break
        finally:
            algo.stop()
    finally:
        ray_tpu.shutdown()
    return {"taken": taken, "best": best}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("algorithm", choices=sorted(TESTS))
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a seed may take, in its own process")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(run_one(args.algorithm, args.child)), flush=True)
        return 0
    _, _, target, budget, _ = TESTS[args.algorithm]
    gate = f">= {target:g} within {budget}"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    for seed in args.seeds:
        t0 = time.monotonic()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.algorithm, "--child", str(seed)],
                capture_output=True, text=True, timeout=args.timeout, env=env, cwd=ROOT)
        except subprocess.TimeoutExpired:
            print(f"{args.algorithm} seed {seed} ({gate}): timed out after {args.timeout:.0f} s",
                  flush=True)
            continue
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(f"{args.algorithm} seed {seed} ({gate}): failed (exit {proc.returncode}): "
                  f"{proc.stderr[-2000:]}", flush=True)
            continue
        res = json.loads(lines[-1])
        print(f"{args.algorithm} seed {seed} ({gate}): "
              + (f"met after {res['taken']}" if res["taken"] else "not met")
              + f", best {res['best']:.1f}, {time.monotonic() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
