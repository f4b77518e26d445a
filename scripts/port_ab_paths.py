"""Time gpt_1b's train step and forward of one checkout of the port.

    cd <checkout> && python <this file> <label> [--gpt-j]

Runs the checkout's own ``chip_smoke.py`` phases 4 and 5 (gpt_1b train step
at b=12 t=2048: warm-up and 5 steps; forward at b=4 t=2048: 10 forwards)
with that checkout's kernels, and prints one line ``RESULT {json}``. With
``--gpt-j`` it times gpt_j_6b's train step instead (bf16 parameters and
moments, b=1 t=2048, remat "nothing": a warm-up, then 5 steps, each ended by
a synchronize; the median wall time, and the device's busy time over one
more step under ``torch.profiler``), with no launch gates, so that a
checkout whose head_dim-256 backward is another design runs it too. To
compare two commits on one card, unpack both into the repository and run
this from each in one call, in the order parent, change, change, parent.
Needs a card.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402  (sets the cuBLAS workspace before torch starts)
import torch  # noqa: E402

from ray_tpu_torch.models import gpt  # noqa: E402
from ray_tpu_torch.models.inference import init_params  # noqa: E402


def gpt_j_step(steps: int = 5) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import training

    cfg = gpt.gpt_j_6b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    opt = training.default_optimizer(1e-4)
    state = training.init_train_state(init_params(cfg, device="cuda", seed=0), opt)
    step = training.make_train_step(cfg, opt, device="cuda")
    tokens = chip_smoke._train_tokens(cfg, 1, 2048)
    state, _ = step(state, tokens)
    torch.cuda.synchronize()
    wall = []
    for _ in range(steps):
        t0 = time.monotonic()
        state, m = step(state, tokens)
        torch.cuda.synchronize()
        wall.append((time.monotonic() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = step(state, tokens)
        torch.cuda.synchronize()
    # kernels only: the port's record_function ranges show as device events too
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.key not in chip_smoke.RANGES]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    flash = sum(e.self_device_time_total for e in events if "flash_" in e.key) / 1e3
    return dict(gpt_j_ms=sorted(wall)[len(wall) // 2], gpt_j_wall_ms=wall,
                gpt_j_busy_ms=busy, gpt_j_flash_ms=flash, loss=float(m["loss"]))


def main() -> None:
    label = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--gpt-j" in sys.argv[2:]:
        print("RESULT", json.dumps(dict(tree=label, **gpt_j_step())), flush=True)
        return
    train = chip_smoke.phase_train(batch=12, seq=2048, steps=5, profile=False)
    cfg = gpt.gpt_1b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = init_params(cfg, device="cuda", seed=0)
    _, fwd = chip_smoke.phase_forward(cfg, params, batch=4, seq=2048, n_forward=10)
    print("RESULT", json.dumps(dict(
        tree=label, train_ms=train["ms_per_step"], train_tok_s=train["tokens_per_s"],
        fwd_ms=fwd["ms_per_forward"], fwd_tok_s=fwd["tokens_per_s"])), flush=True)


if __name__ == "__main__":
    main()
