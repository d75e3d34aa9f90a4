"""The readings a cell's correctness limit is set from, on the card: for
each seed, one run of the cell at its own load (a short window), judged
by the cell's limits.  All seeds in one process.

    python3 benchmark/control.py --workload flagship.live --seconds 6 \\
        --seeds 11,12,13 [--precision bfloat16 | --biquads-float32]

``--precision`` puts the control in the program's place: the plain
reference at that precision (``refchain``'s spec: ``bfloat16`` rounds
every effect's output, ``float32:filter`` computes the biquads in
float32), compared as the program's outputs are.
``--biquads-float32`` runs the program itself with its biquads solved in
float32 rather than float64 (the step a faster port might take), so its
own verdict is the control's.

Prints one JSON line per seed (the program's verdict and number, and the
control's) and a summary line: the largest sound reading (the lower end
of the limit), the smallest control reading (the upper end), and whether
any control run came out correct."""

import inspect
import json
import sys
import time
from pathlib import Path


def plant_biquad_float32():
    """The program's biquad solved in float32: ``biquad_block``'s own
    source with its float64 casts made float32, bound where the biquad
    effect calls it."""
    from aefs_tpu_torch.models import biquad
    from aefs_tpu_torch.ops import scan

    src = inspect.getsource(scan.biquad_block)
    src = src.replace("x, state = x.double(), state.double()",
                      "x, state = x.float(), state.float()")
    src = src.replace("(c.double() for c in", "(c.float() for c in")
    if src.count(".float()") != 3:
        raise RuntimeError("biquad_block's float64 casts were not found")
    ns = dict(vars(scan))
    exec(src, ns)
    biquad.biquad_block = ns["biquad_block"]


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--biquads-float32", action="store_true")
    args = ap.parse_args()

    from benchmark import harness

    if args.biquads_float32:
        plant_biquad_float32()
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = harness.run(args.workload, seed, args.seconds, False, time.perf_counter(),
                           control=args.precision)
        row = {"seed": seed, "biquads_float32": args.biquads_float32,
               "program_correct": line["correct"],
               "failed": line["failed"], "program": line["checks"]["err_dbfs"]["value"],
               "limit": line["checks"]["err_dbfs"]["limit"]}
        if args.precision:
            row.update(precision=args.precision, control_correct=line["control"]["correct"],
                       control=line["control"]["checks"]["err_dbfs"]["value"])
        rows.append(row)
        print("reading " + json.dumps(row), flush=True)
    # The control's readings: the reference at the lower precision, or the
    # planted program's own.
    if args.precision:
        controls = [(r["control"], r["control_correct"]) for r in rows]
    else:
        controls = [(r["program"], r["program_correct"])
                    for r in rows] if args.biquads_float32 else []
    print("summary " + json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "biquads_float32": args.biquads_float32,
        "precision": args.precision,
        "program": sorted(r["program"] for r in rows),
        "control": sorted(v for v, _ok in controls),
        "control_min": min((v for v, _ok in controls), default=None),
        "any_control_correct": any(ok for _v, ok in controls)}), flush=True)


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    main()
