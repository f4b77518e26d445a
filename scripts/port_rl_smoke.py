#!/usr/bin/env python3
"""The port's RL stack (ray_tpu_torch.rl) under ray_tpu's actors, on one
NVIDIA card.

    python scripts/port_rl_smoke.py [--iterations N] [--out results.json]

``rl_hooks()`` fills the port's ``RuntimeHooks`` with ray_tpu's actor API
(``remote``, ``get``, ``wait``, ``kill``) and its host collective
(``util.collective.init_collective_group`` and ``allreduce``), on top of
``runtime_hooks()`` from ``scripts/port_runtime_smoke.py``; the tests of the
port's RL algorithms under the runtime import it from here. Run as a script it
drives PPO on CartPole with 2 rollout-worker actors (their policies on the
card) and a ``LearnerGroup`` of 2 learner actors (on the card, their
gradients averaged through the host all-reduce), and prints each
iteration's wall time, return and metrics, the card's name and power limit,
and one JSON line. Exits non-zero without a card or when a metric is not
finite.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_tpu  # noqa: E402
from ray_tpu.util import collective  # noqa: E402
from ray_tpu_torch.runtime import RuntimeHooks  # noqa: E402

from scripts.port_runtime_smoke import runtime_hooks  # noqa: E402


def rl_hooks() -> RuntimeHooks:
    """``runtime_hooks()`` with ray_tpu's actors and host collective: every
    field a module-level function of ray_tpu, so the hooks (and the
    collective functions a ``LearnerGroup`` hands its actors) pickle by
    reference."""
    return dataclasses.replace(
        runtime_hooks(),
        remote=ray_tpu.remote,
        get=ray_tpu.get,
        wait=ray_tpu.wait,
        kill=ray_tpu.kill,
        init_collective_group=collective.init_collective_group,
        allreduce=collective.allreduce,
    )


def main() -> int:
    import argparse
    import math
    import subprocess

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--out", help="write the results to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_rl_smoke: torch.cuda.is_available() is false; this needs a card",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.rl import PPOConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    ray_tpu.init(num_cpus=4, log_level="WARNING")
    rows = []
    try:
        t0 = time.monotonic()
        algo = PPOConfig(num_rollout_workers=2, num_envs_per_worker=4,
                         rollout_fragment_length=128, num_learners=2, lr=1e-3, num_epochs=8,
                         minibatch_size=256, seed=0, device="cuda", rollout_device="cuda",
                         hooks=rl_hooks()).build()
        start_s = time.monotonic() - t0
        print(f"[ppo] 2 rollout actors and 2 learner actors started in {start_s:.2f} s")
        try:
            for i in range(args.iterations):
                r = algo.train()
                rows.append({k: v for k, v in r.items() if isinstance(v, (int, float))})
                print(f"[ppo] iteration {i + 1}: {r['time_this_iter_s'] * 1e3:.1f} ms, "
                      f"{r['env_steps_this_iter'] / r['time_this_iter_s']:.0f} env steps/s, "
                      f"return {r['episode_return_mean']:.1f}, total loss "
                      f"{r['total_loss']:.4f}")
        finally:
            algo.stop()
    finally:
        ray_tpu.shutdown()
    bad = [r for r in rows if not all(math.isfinite(r[k]) for k in
                                      ("total_loss", "policy_loss", "vf_loss", "entropy"))]
    report = {"card": smi, "start_s": start_s, "iterations": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi)
    print(json.dumps({"ok": not bad, "start_s": start_s,
                      "ms_per_iteration": [r["time_this_iter_s"] * 1e3 for r in rows]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
