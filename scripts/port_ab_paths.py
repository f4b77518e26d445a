"""Time gpt_1b's train step and forward of one checkout of the port.

    cd <checkout> && python <this file> <label>

Runs the checkout's own ``chip_smoke.py`` phases 4 and 5 (gpt_1b train step
at b=12 t=2048: warm-up and 5 steps; forward at b=4 t=2048: 10 forwards)
with that checkout's kernels, and prints one line ``RESULT {json}``. To
compare two commits on one card, unpack both into the repository and run
this from each in one call, in the order parent, change, change, parent.
Needs a card.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402  (sets the cuBLAS workspace before torch starts)
import torch  # noqa: E402

from ray_tpu_torch.models import gpt  # noqa: E402
from ray_tpu_torch.models.inference import init_params  # noqa: E402


def main() -> None:
    label = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    torch.backends.cuda.matmul.allow_tf32 = False
    train = chip_smoke.phase_train(batch=12, seq=2048, steps=5, profile=False)
    cfg = gpt.gpt_1b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = init_params(cfg, device="cuda", seed=0)
    _, fwd = chip_smoke.phase_forward(cfg, params, batch=4, seq=2048, n_forward=10)
    print("RESULT", json.dumps(dict(
        tree=label, train_ms=train["ms_per_step"], train_tok_s=train["tokens_per_s"],
        fwd_ms=fwd["ms_per_forward"], fwd_tok_s=fwd["tokens_per_s"])), flush=True)


if __name__ == "__main__":
    main()
