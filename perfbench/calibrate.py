#!/usr/bin/env python3
"""The readings that ``limits/<workload>.json`` is set from, on the card at
the cell's own size (not run by the benchmark's runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control 1,2,3] [--faults 1,2,3] [--seconds 5] [--out file.jsonl]

For each seed of ``--seeds``: the program's numbers against the reference
(the lower readings). For each seed of ``--control``: the reference in fp8,
put in the program's place, against the float32 reference. For each seed of
``--faults``: each fault that the cell's step kind can have
(``faults.BY_KIND``), planted in the program (a state left unchanged is not
run: it reads 1 by the leaf measure). Train cells run set-up's steps and,
with no window between, the check's second run of them; eval cells a window
of ``--seconds``. One JSON line a reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def program_readings(manifest, cell, seed, seconds, device):
    from perfbench.core.runner import load_kind
    from perfbench.kinds import eval as eval_kind

    kind = load_kind(cell, seed, device)
    kind.setup()
    i, t0 = 0, time.monotonic()
    while cell.traffic["step"] != "train" and (time.monotonic() - t0 < seconds or
                                               i < eval_kind.CHECK_BATCHES):
        kind.step(i)
        i += 1
    counts = kind.finish()
    return kind, kind.readings(), counts


def main(argv=None, root: Path = ROOT) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, required=True)
    parser.add_argument("--control", type=_seeds, default=[])
    parser.add_argument("--faults", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import gc

    import torch

    from perfbench import faults
    from perfbench.core.manifest import Manifest

    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(seed, mode, gaps, **extra):
        line = json.dumps({"workload": cell.name, "seed": seed, "mode": mode, "gaps": gaps,
                           **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def free():
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()

    for seed in sorted(set(args.seeds) | set(args.control) | set(args.faults)):
        t0 = time.monotonic()
        kind, mine, counts = program_readings(manifest, cell, seed, args.seconds, args.device)
        free()
        t1 = time.monotonic()
        ref = kind.reference_readings()
        t_ref = time.monotonic() - t1
        if seed in args.seeds:
            emit(seed, "program", kind.worst_gaps(mine, ref), each=kind.each_gaps,
                 reference_s=t_ref, program_s=t1 - t0, **counts)
        if seed in args.control:
            t1 = time.monotonic()
            control = kind.reference_readings("fp8")
            emit(seed, "control_fp8", kind.gaps(control, ref), control_s=time.monotonic() - t1)
        if seed in args.faults:
            for name in faults.BY_KIND[cell.traffic["step"]]:
                if name == "unchanged_state":
                    continue
                with faults.FAULTS[name]():
                    fk, planted, _ = program_readings(manifest, cell, seed, args.seconds,
                                                      args.device)
                if cell.traffic["step"] == "eval":
                    ref = {**ref, **fk.reference_readings()}
                emit(seed, name, fk.worst_gaps(planted, ref))
                del fk
                free()
        del kind
        free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
