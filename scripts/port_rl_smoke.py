#!/usr/bin/env python3
"""The port's RL stack (ray_tpu_torch.rl) under ray_tpu's actors, on one
NVIDIA card.

    python scripts/port_rl_smoke.py [--iterations N] [--out results.json]

``rl_hooks()`` fills the port's ``RuntimeHooks`` with ray_tpu's actor API
(``remote``, ``get``, ``wait``, ``kill``), its host collective
(``util.collective.init_collective_group`` and ``allreduce``), its datasets
(``write_dataset`` / ``read_dataset`` through ``ray_tpu.data``'s parquet)
and its control-plane RPC (``rpc_server`` / ``rpc_client``:
``_private.rpc.RpcServer`` and ``RpcClient``), on top of ``runtime_hooks()``
from ``scripts/port_runtime_smoke.py``; the tests of the port's RL
algorithms under the runtime import it from here. Run as a script it drives
PPO on CartPole with 2 rollout-worker actors (their policies on the card)
and a ``LearnerGroup`` of 2 learner actors (on the card, their gradients
averaged through the host all-reduce), then Ape-X DQN with 2 rollout actors
and 1 replay-shard actor (the learner and the workers' forwards on the
card), and prints each iteration's wall time, return and metrics, the
card's name and power limit, and one JSON line. Exits non-zero without a
card, when a metric is not finite or when an Ape-X worker call failed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_tpu  # noqa: E402
from ray_tpu._private.rpc import RpcClient, RpcServer  # noqa: E402
from ray_tpu.util import collective  # noqa: E402
from ray_tpu_torch.runtime import RuntimeHooks  # noqa: E402

from scripts.port_runtime_smoke import runtime_hooks  # noqa: E402


def write_dataset(columns, path):
    """The columns as a one-block ``ray_tpu.data`` dataset in parquet at
    ``path`` (the reference's ``offline.write_sample_batches``)."""
    import ray_tpu.data as rt_data

    return rt_data.from_numpy(columns, parallelism=1).write_parquet(path)


def read_dataset(path, batch_size=4096):
    """``ray_tpu.data``'s parquet dataset at ``path`` as numpy column dicts
    (the reference's ``offline.read_sample_batches``)."""
    import ray_tpu.data as rt_data

    yield from rt_data.read_parquet(path).iter_batches(batch_size=batch_size,
                                                       batch_format="numpy")


def rl_hooks() -> RuntimeHooks:
    """``runtime_hooks()`` with ray_tpu's actors, host collective, datasets
    and RPC: every field a module-level function or class, so the hooks (and
    the collective functions a ``LearnerGroup`` hands its actors) pickle by
    reference."""
    return dataclasses.replace(
        runtime_hooks(),
        remote=ray_tpu.remote,
        get=ray_tpu.get,
        wait=ray_tpu.wait,
        kill=ray_tpu.kill,
        init_collective_group=collective.init_collective_group,
        allreduce=collective.allreduce,
        write_dataset=write_dataset,
        read_dataset=read_dataset,
        rpc_server=RpcServer,
        rpc_client=RpcClient,
    )


def timed_get(refs, timeout=None):
    """``ray_tpu.get`` that refuses to wait without a limit."""
    if timeout is None:
        raise ValueError("a get without a timeout")
    return ray_tpu.get(refs, timeout=timeout)


def timed_wait(refs, num_returns=1, timeout=None):
    """``ray_tpu.wait`` that refuses to wait without a limit."""
    if timeout is None:
        raise ValueError("a wait without a timeout")
    return ray_tpu.wait(refs, num_returns=num_returns, timeout=timeout)


def timed_rl_hooks() -> RuntimeHooks:
    """``rl_hooks()`` whose ``get`` and ``wait`` raise without a timeout (the
    tests' hooks; module-level, so actors that are handed them can load
    them)."""
    return dataclasses.replace(rl_hooks(), get=timed_get, wait=timed_wait)


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
    from ray_tpu_torch.rl import ApexDQNConfig, PPOConfig

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
        apex_rows = []
        t0 = time.monotonic()
        apex = ApexDQNConfig(num_rollout_workers=2, num_envs_per_worker=4, num_replay_shards=1,
                             rollout_fragment_length=32, learning_starts=256,
                             updates_per_iteration=32, train_batch_size=64, seed=0,
                             device="cuda", rollout_device="cuda", hooks=rl_hooks()).build()
        apex_start_s = time.monotonic() - t0
        print(f"[apex] 2 rollout actors and 1 replay shard started in {apex_start_s:.2f} s")
        try:
            for i in range(args.iterations):
                r = apex.train()
                apex_rows.append({k: v for k, v in r.items() if isinstance(v, (int, float))})
                print(f"[apex] iteration {i + 1}: {r['time_this_iter_s'] * 1e3:.1f} ms, "
                      f"{r['num_updates']} updates, {r['env_steps_total']} env steps, shard "
                      f"{r['replay_shard_sizes']}, loss {r['mean_loss']:.4f}, return "
                      f"{r['episode_return_mean']:.1f}")
        finally:
            apex.stop()
    finally:
        ray_tpu.shutdown()
    bad = [r for r in rows if not all(math.isfinite(r[k]) for k in
                                      ("total_loss", "policy_loss", "vf_loss", "entropy"))]
    bad += [r for r in apex_rows if r["worker_failures"] or not math.isfinite(r["mean_loss"])]
    report = {"card": smi, "start_s": start_s, "iterations": rows,
              "apex_start_s": apex_start_s, "apex_iterations": apex_rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi)
    print(json.dumps({"ok": not bad, "start_s": start_s,
                      "ms_per_iteration": [r["time_this_iter_s"] * 1e3 for r in rows],
                      "apex_ms_per_iteration": [r["time_this_iter_s"] * 1e3
                                                for r in apex_rows]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
