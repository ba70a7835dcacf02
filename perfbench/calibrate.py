"""Readings that the limits of checks.py are set from, many seeds in one
process (the benchmark's own runs never run this).

    python3 perfbench/calibrate.py --workload NAME --seeds 1,2,3 --seconds 8 \
        [--mode program|bf16|tf32]

``program`` runs the cell as run.py does (a short window at the cell's own
load, then the check) once per seed: its readings are the lower ones.
``bf16`` does the same with the program's bf16 profile, and ``tf32`` takes
the TF32 control's readings (control.py): the upper ones.  One JSON line per
seed, then one line with the largest and smallest reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import spec  # noqa: E402
from perfbench.run import banned_modules, cache_dirs, run_cell  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--mode", choices=("program", "bf16", "tf32"), default="program")
    args = p.parse_args(argv)
    cache_dirs(spec.ROOT)
    cell = spec.Cell(spec.benchmark(), args.workload)

    import torch

    from perfbench import control

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    numbers: dict[str, list] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.mode == "tf32":
            generate = spec.generator(cell.traffic["content"], cell.root)
            line = {"checks": control.readings(cell.config, cell.traffic, generate,
                                               seed, device).as_dict()}
        else:
            line = run_cell(cell, seed, args.seconds, False, device,
                            dtype="bfloat16" if args.mode == "bf16" else None)
        out = {"seed": seed, "mode": args.mode, "seconds": time.perf_counter() - t0,
               **{k: line[k] for k in ("correct", "metrics") if k in line},
               **{k: c["value"] for k, c in line["checks"].items()}}
        print(json.dumps(out), flush=True)
        for k, c in line["checks"].items():
            numbers.setdefault(k, []).append(c["value"])
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "max": {k: max(v) for k, v in numbers.items()},
                      "min": {k: min(v) for k, v in numbers.items()},
                      "banned_modules": banned_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
