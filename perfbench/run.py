#!/usr/bin/env python3
"""Run one cell of the benchmark on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (``perfbench/README.md``); the numbers that decide ``correct`` are
the last lines of standard error. Exits non-zero, and prints no result,
without enough CUDA cards for the cell, where the program is missing, and
where JAX or the JAX package got loaded.
"""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its CUDA libraries under ``build/ray_tpu_torch``), Python's
    bytecode of every module imported from here on too: where the
    interpreter is told to write none and the packages ship none, each run
    would compile torch's and sympy's sources anew."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(root / "build" / "perfbench" / "pycache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / "perfbench" / sub)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.core.manifest import Manifest
    from perfbench.core.runner import dumps, run_cell

    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      STARTED)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
