"""The readings that the limits of ``limits/<workload>.json`` are set from.

    python -m benchmark.control --workload NAME --seeds N [N ...] \
        [--control fp8|tf32 | --fault NAME] [--seconds S]

For each seed, one run of the cell with a short window (``run.run``), in
one process: the program's compared numbers; with ``--control fp8`` those
of the control, the float8 reference put in the program's place (its
first three steps are the control's, compared with the float32
reference's on the same batches); with ``--control tf32`` those of the
reference with TF32 convolutions and matmuls, a witness of rounding
alone; with ``--fault`` those of the program with a fault planted
(``faults.py``). Each seed prints one JSON line
``{"seed", "mode", "checks"}``; the last line holds the largest reading
of each number over the seeds (the program's) or the smallest (the
control's).

The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from . import run as bench
    from .faults import FAULTS, plant
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", choices=("fp8", "tf32"), default=None)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = bench.load_cell(a.workload)
    mode = a.control or a.fault or "program"
    if a.fault:
        plant(a.fault)
    rows = []
    for seed in a.seeds:
        res = bench.run(a.workload, seed, a.seconds, False, spec=spec,
                        control=a.control)
        vals = {n: c["value"] for n, c in res["checks"].items()}
        rows.append(vals)
        print(json.dumps({"seed": seed, "mode": mode, "checks": vals,
                          "metrics": res["metrics"]}), flush=True)
    pick = max if mode == "program" else min
    print(json.dumps({"mode": mode, "seeds": len(rows),
                      "reading": {n: pick(r[n] for r in rows)
                                  for n in rows[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
