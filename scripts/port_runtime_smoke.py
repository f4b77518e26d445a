#!/usr/bin/env python3
"""The port (ray_tpu_torch) inside ray_tpu's runtime, on one NVIDIA card.

    python scripts/port_runtime_smoke.py [--out results.json]

This is where the two packages meet: ``runtime_hooks()`` fills the port's
``RuntimeHooks`` with ray_tpu's functions (its metrics, the object store's
out-of-band buffers, serve's model registry, the runtime's error classes),
and the tests of the port's runtime halves import it from here. Run as a
script it drives, on the card:

1. ``ray_tpu.init`` with room in the object store for gpt_1b's bf16
   parameters (1.01 B, about 2.03 GB); ``put``/``get`` of them from the
   card, bitwise, with the device plane's transfer counters, pageable,
   pinned (the plane registering each region for its copy) and pageable
   again;
2. a remote task that receives a CUDA tensor and returns one;
3. ``TorchTrainer(TorchConfig("nccl"), 1 worker)`` running the port's
   ``gpt_train_loop`` for a few gpt_1b steps fed from a ``ray_tpu.data``
   dataset, with a checkpoint of the gathered state;
4. the port's ``LLMServer`` at gpt_1b behind ``serve.deployment`` and the
   HTTP proxy, answering 8 requests over HTTP, one through a LoRA adapter
   published with ``serve.register_model``;
5. the port's metrics read back from the runtime's.

Prints the card's name and power limit and one JSON line of results; exits
non-zero without a card or when a check fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_tpu  # noqa: E402
from ray_tpu_torch.runtime import RuntimeHooks  # noqa: E402


def caller_cancelled() -> bool:
    """Whether ray_tpu cancelled the task the current thread runs."""
    return ray_tpu.get_runtime_context().was_cancelled()


def runtime_hooks() -> RuntimeHooks:
    """The port's hooks over ray_tpu: every field a module-level function
    or class of ray_tpu (or of this module), so the hooks pickle by
    reference and can be handed to a serve replica."""
    from ray_tpu import serve
    from ray_tpu._private import internal_metrics, serialization
    from ray_tpu._private.core_worker import TaskCancelledError
    from ray_tpu.serve.handle import BackPressureError

    return RuntimeHooks(
        metrics=internal_metrics,
        serialize_scope_active=serialization.serialize_scope_active,
        append_oob_buffer=serialization.append_oob_buffer,
        lazy_buffer=serialization.LazyBuffer,
        get_indexed_buffer=serialization.get_indexed_buffer,
        fetch_adapter=serve.fetch_model,
        caller_cancelled=caller_cancelled,
        backpressure_error=BackPressureError,
        cancelled_error=TaskCancelledError,
    )


def install_device_plane(pin: bool = True):
    """The port's tensor reducer in this process's runtime pickler (the
    dispatch table of cloudpickle's Pickler, which ray_tpu's shares).
    ``pin``: register each object-store region with the driver for its
    copy; on an H100 that put gpt_1b's bf16 parameters at 2.60 GB/s where
    pageable copies into the fresh store made 0.37-0.53 GB/s (PERF.md)."""
    from ray_tpu._private import serialization
    from ray_tpu_torch._private import device_plane

    return device_plane.install(serialization._Pickler.dispatch_table, runtime_hooks(), pin=pin)


# ---------------------------------------------------------------------------
# the card run
# ---------------------------------------------------------------------------


def _transfer_counters():
    """ray_tpu's device plane counters in this process: {metric: {direction:
    value}}."""
    from ray_tpu._private import internal_metrics

    out = {}
    for name in ("ray_tpu_device_transfer_bytes_total", "ray_tpu_device_transfer_seconds_total"):
        series = internal_metrics.get(name)._snapshot()["series"]
        out[name] = {dict(k)["direction"]: v for k, v in series.items()}
    return out


def phase_object_plane(cfg, pin: bool):
    """gpt_1b's bf16 parameters put from the card and got back onto it,
    through the device plane installed with ``pin`` (each host region
    registered with the driver for its copy) or pageable."""
    import torch

    from ray_tpu_torch.models.inference import init_params

    install_device_plane(pin=pin)
    params = init_params(cfg, device="cuda", seed=0)
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    before = _transfer_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ray_tpu.put(params)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ray_tpu.get(ref, timeout=600)
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    after = _transfer_counters()
    same = all(back[n].is_cuda and torch.equal(back[n], t) for n, t in params.items())
    counted = {name: {d: after[name].get(d, 0.0) - before[name].get(d, 0.0)
                      for d in ("device_to_host", "host_to_device")} for name in after}
    out = dict(pin=pin, tensors=len(params), bytes=nbytes, put_s=put_s, get_s=get_s,
               put_gbps=nbytes / put_s / 1e9, get_gbps=nbytes / get_s / 1e9, bitwise=same,
               counted=counted)
    print(f"[object_plane] {'pinned' if pin else 'pageable'}: put {nbytes / 1e9:.3f} GB of "
          f"gpt_1b bf16 parameters from the card in "
          f"{put_s:.2f} s ({out['put_gbps']:.2f} GB/s), get onto the card {get_s:.2f} s "
          f"({out['get_gbps']:.2f} GB/s); bitwise {same}; device plane counters {counted}")
    if not same or counted["ray_tpu_device_transfer_bytes_total"] != {
            "device_to_host": nbytes, "host_to_device": nbytes}:
        raise SystemExit(f"object plane: bitwise {same}, counted {counted}")
    del params, back, ref
    torch.cuda.empty_cache()
    return out


@ray_tpu.remote
def _double_on_card(t):
    """A task that receives a CUDA tensor and returns one (pickled by the
    port's reducer, which this worker installs itself)."""
    install_device_plane()
    return t * 2, str(t.device)


def phase_remote_task():
    import torch

    x = torch.arange(1 << 24, dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    y, seen = ray_tpu.get(_double_on_card.remote(x), timeout=300)
    seconds = time.perf_counter() - t0
    ok = y.is_cuda and torch.equal(y, x * 2) and seen.startswith("cuda")
    print(f"[remote_task] a {x.numel() * 2 / 2**20:.0f} MiB CUDA tensor to a task and back in "
          f"{seconds:.2f} s: arrived on {seen}, returned on {y.device}, equal {ok}")
    if not ok:
        raise SystemExit("remote task: the CUDA tensor did not come back right")
    return dict(bytes=x.numel() * 2, seconds=seconds, worker_device=seen)


def phase_trainer(tmp: str, steps: int, layers: int):
    """TorchTrainer(TorchConfig("nccl"), 1 worker) running the port's loop
    at gpt_1b width from a ray_tpu.data dataset, checkpointing at the end."""
    import numpy as np

    from ray_tpu import data as rt_data
    from ray_tpu.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    config = {"model": "gpt_1b", "model_overrides": {"ce_chunk": 512, "num_layers": layers},
              "batch": 12, "seq": 2048, "steps": steps, "lr": 1e-4, "dataset": "train",
              "checkpoint_every": steps, "device": "cuda"}
    rows = np.random.RandomState(7).randint(0, 50304, (12 * steps, 2048)).astype(np.int64)
    ds = rt_data.from_numpy({"tokens": rows}, parallelism=2)

    def loop(cfg):
        from ray_tpu import train
        from ray_tpu_torch.train.loop import gpt_train_loop
        from scripts.port_runtime_smoke import runtime_hooks

        gpt_train_loop(cfg, session=train, hooks=runtime_hooks())

    t0 = time.monotonic()
    result = TorchTrainer(loop, train_loop_config=config, datasets={"train": ds},
                          scaling_config=ScalingConfig(num_workers=1),
                          backend_config=TorchConfig("nccl"),
                          run_config=RunConfig(name="port-runtime", storage_path=tmp)).fit()
    seconds = time.monotonic() - t0
    if result.error is not None:
        raise SystemExit(f"trainer: {result.error}")
    hist = result.metrics_history
    tree = result.checkpoint.to_dict()["state"]
    ck_bytes = sum(a.nbytes for part in ("params", "mu", "nu") for a in tree[part].values())
    out = dict(layers=layers, batch=12, seq=2048, steps=len(hist),
               losses=[m["loss"] for m in hist], step_ms=[m["step_ms"] for m in hist],
               fit_s=seconds, checkpoint_step=tree["step"], checkpoint_bytes=ck_bytes)
    print(f"[trainer] TorchTrainer(nccl, 1 worker), gpt_1b width with {layers} layers, b=12 "
          f"t=2048 from a ray_tpu.data dataset: losses {[round(x, 4) for x in out['losses']]}, "
          f"ms a step {[round(x, 1) for x in out['step_ms']]} (the last includes the "
          f"{ck_bytes / 1e9:.2f} GB checkpoint's gather), fit {seconds:.1f} s, checkpoint at "
          f"step {tree['step']}")
    if len(hist) != steps or tree["step"] != steps or not all(
            np.isfinite(out["losses"])):
        raise SystemExit(f"trainer: {out}")
    return out


def phase_serve(cfg):
    """The port's LLMServer at gpt_1b behind serve and the HTTP proxy:
    phase 6's 8 requests of chip_smoke.py over HTTP, the last through an
    adapter published with serve.register_model."""
    import http.client
    import threading

    import numpy as np

    from ray_tpu import serve
    from ray_tpu_torch.serve import llm

    name = "gpt1b"
    dep = serve.deployment(llm.LLMServer, name=name, max_concurrent_queries=16).bind(
        cfg, None, "cuda", hooks=runtime_hooks(), deployment=name, num_blocks=1024,
        block_size=16, prefill_chunk=256, prefill_lanes=4, lane_buckets=(1, 2, 4, 8),
        prefill_token_buckets=(64, 128, 256), cache_buckets=(256, 512, 1024, 2048),
        max_adapters=2)
    t0 = time.monotonic()
    handle = serve.run(dep)
    serve.register_model("lora:smoke", llm.random_lora(cfg, rank=8, seed=1, scale=2.0))
    proxy = serve.start_http_proxy()
    rng = np.random.RandomState(2)

    def prompt(n):
        return [int(t) for t in rng.randint(0, cfg.vocab_size, n)]

    def post(payload):
        conn = http.client.HTTPConnection(proxy.host, proxy.port, timeout=600)
        try:
            conn.request("POST", f"/{name}", body=json.dumps(payload),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise SystemExit(f"serve: HTTP {resp.status}: {body[:300]!r}")
            return json.loads(body)["result"]
        finally:
            conn.close()

    try:
        post({"prompt": prompt(100), "max_new_tokens": 4})  # warm-up
        ready_s = time.monotonic() - t0
        shared = prompt(512)
        payloads = [{"prompt": shared + prompt(n), "max_new_tokens": 32}
                    for n in (100, 200, 300, 400)]
        payloads += [{"prompt": prompt(n), "max_new_tokens": 32} for n in (200, 450, 700, 1000)]
        payloads[-1]["model_id"] = "lora:smoke"
        results = [None] * len(payloads)

        def call(i):
            results[i] = post(payloads[i])

        t1 = time.monotonic()
        results[0] = post(payloads[0])
        threads = [threading.Thread(target=call, args=(i,)) for i in range(1, len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        seconds = time.monotonic() - t1
        if any(r is None or len(r["tokens"]) != 32 for r in results):
            raise SystemExit("serve: not every request finished with 32 tokens")
        stats = handle.kv_stats.remote().result(timeout=60)
        ttft = np.array([r["ttft_s"] for r in results]) * 1e3
        out = dict(requests=len(payloads), seconds=seconds, ready_s=ready_s,
                   generated_tokens=32 * len(payloads),
                   tokens_per_s=32 * len(payloads) / seconds,
                   ttft_p50_ms=float(np.percentile(ttft, 50)),
                   ttft_p99_ms=float(np.percentile(ttft, 99)), ttft_ms=ttft.tolist(),
                   prefix_cached_tokens=[r["prefix_cached_tokens"] for r in results],
                   lora_model_id=results[-1]["model_id"], kv_stats=stats)
        print(f"[serve] the port's LLMServer at gpt_1b behind the HTTP proxy: deployed and warm "
              f"in {ready_s:.1f} s; 8 requests in {seconds:.2f} s, "
              f"{out['tokens_per_s']:.1f} tokens/s, TTFT p50 {out['ttft_p50_ms']:.1f} ms p99 "
              f"{out['ttft_p99_ms']:.1f} ms, cached tokens {out['prefix_cached_tokens']}, "
              f"adapter {out['lora_model_id']} resident {stats['adapters_resident']}")
        if (min(out["prefix_cached_tokens"][1:4]) < 512 or out["lora_model_id"] != "lora:smoke"
                or "lora:smoke" not in stats["adapters_resident"]):
            raise SystemExit(f"serve: {out}")
        return out
    finally:
        proxy.stop()


def phase_metrics(serve_out):
    """The port's metrics as the runtime aggregates them (the replica's
    reporter pushes every metrics_report_period_s)."""
    from ray_tpu.util import metrics as rt_metrics

    names = ("ray_tpu_llm_ttft_seconds", "ray_tpu_llm_prefill_tokens_total",
             "ray_tpu_llm_prefix_cache_hits_total", "ray_tpu_llm_kv_blocks_in_use",
             "ray_tpu_device_transfer_bytes_total", "ray_tpu_train_optimizer_state_bytes")
    want = serve_out["kv_stats"]["prefill_tokens"]
    deadline = time.monotonic() + 30
    while True:
        got = {}
        for name in names:
            for rec in rt_metrics.get_metrics(name):
                for k, v in rec.get("series", {}).items():
                    got.setdefault(name, {})[str(dict(k))] = v
        prefill = got.get("ray_tpu_llm_prefill_tokens_total", {}).get(
            str({"deployment": "gpt1b"}))
        if prefill == want or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    print(f"[metrics] read back from the runtime: {json.dumps(got, default=str)[:2000]}")
    if prefill != want:
        raise SystemExit(f"metrics: prefill tokens {prefill} in the runtime, the engine's {want}")
    return got


def main() -> int:
    import argparse
    import subprocess
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results to this JSON file")
    ap.add_argument("--train-steps", type=int, default=4)
    ap.add_argument("--train-layers", type=int, default=4,
                    help="the trainer phase's depth (gpt_1b has 16)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_runtime_smoke: torch.cuda.is_available() is false; this needs a card",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.models import gpt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    shm = subprocess.run(["df", "-B1", "--output=size,avail", "/dev/shm"], capture_output=True,
                         text=True).stdout.split()
    print(f"[setup] {smi}; /dev/shm size/avail {shm[2:] if len(shm) > 2 else shm}")
    cfg = gpt.gpt_1b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    report = {"card": smi}
    t_start = time.monotonic()
    ray_tpu.init(num_cpus=8, object_store_memory=24 * 2**30, log_level="WARNING",
                 _system_config={"metrics_report_period_s": 1.0})
    try:
        report["object_plane"] = [phase_object_plane(cfg, pin) for pin in (False, True, False)]
        install_device_plane()
        report["remote_task"] = phase_remote_task()
        with tempfile.TemporaryDirectory(prefix="port_runtime_smoke_") as tmp:
            report["trainer"] = phase_trainer(tmp, args.train_steps, args.train_layers)
        report["serve"] = phase_serve(cfg)
        report["metrics"] = phase_metrics(report["serve"])
    finally:
        from ray_tpu import serve

        serve.shutdown()
        ray_tpu.shutdown()
    report["seconds"] = time.monotonic() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(smi)
    print(json.dumps({"ok": True, "seconds": report["seconds"], "card": smi}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.exit(main())
