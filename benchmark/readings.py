"""The readings that a cell's check limits are set from: for each seed, the
numbers the program's run gives (benchmark/run.py's check after a short
window) and, for the first --control seeds, those of the control (the
reference at the precision below the cell's put in the program's place,
benchmark/check.py control_outputs) on the same sampled columns; with
--witness, on every seed also those of the reference at the cell's own
precision, a second witness of what that precision gives.  Not run by the
benchmark's own runs.

    python3 -m benchmark.readings --workload rami5.f32 --seeds 12 --control 3 --seconds 2

One JSON line per reading, then a summary line: the largest number of the
program's runs (the lower reading) and the smallest of the control's (the
upper reading), per number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check as CK
from . import generate as GEN
from .run import cache_dirs, load_cell, run


def control_numbers(cell, seed: int, device, witness: bool = False) -> dict:
    """The control's numbers on one seed: each input set's sampled columns
    (as a run samples them), the control against the reference.  With
    witness, the reference at the cell's own precision (float32 with TF32
    off, for a float32 cell) in its place: a second witness of what that
    precision alone gives."""
    sets = GEN.input_sets(cell.config, cell.traffic, seed)
    pick = np.random.default_rng([int(seed) % 2**64, 3])
    total, block = CK.Comparison(), cell.check["block_columns"]
    radsurf = cell.config["radsurf"]
    for a in sets:
        cols = CK.sample_columns(a["i_representation"], cell.check["columns_per_call"], pick)
        sub = CK.subset(a, cols)
        ref = CK.reference_outputs(radsurf, sub, device, block)
        if witness:
            other = CK.reference_outputs(radsurf, sub, device, block,
                                         getattr(torch, cell.traffic["dtype"]))
        else:
            other = CK.control_outputs(radsurf, sub, device, block, cell.traffic["dtype"])
        total.add(CK.day_only(other, sub["cos_sza"]), CK.day_only(ref, sub["cos_sza"]))
    return total.numbers()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=1_000_003)
    ap.add_argument("--also", type=int, nargs="*", default=[],
                    help="seeds read after the --seeds ones")
    ap.add_argument("--witness", action="store_true",
                    help="also read the reference at the cell's own precision on every seed")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    cache_dirs()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    lower, upper = {}, {}
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)] + args.also
    for k, seed in enumerate(seeds):
        t = time.perf_counter()
        res = run(cell, seed, args.seconds, False, device, t0=t)
        nums = {n: c["value"] for n, c in res["checks"].items()}
        for n, v in nums.items():
            lower[n] = max(lower.get(n, 0.0), v)
        print(json.dumps({"seed": seed, "side": "program", **nums,
                          "fields": {n: c["field"] for n, c in res["checks"].items()},
                          "attempted": res["attempted"], "check_s": res["check_s"],
                          "metrics": res["metrics"], "card": res["card"]}), flush=True)
        if k < args.control:
            t = time.perf_counter()
            ctl = control_numbers(cell, seed, device)
            for n, (v, _) in ctl.items():
                upper[n] = min(upper.get(n, float("inf")), v)
            print(json.dumps({"seed": seed, "side": "control",
                              **{n: v for n, (v, _) in ctl.items()},
                              "fields": {n: f for n, (_, f) in ctl.items()},
                              "seconds": time.perf_counter() - t}), flush=True)
        if args.witness:
            wit = control_numbers(cell, seed, device, witness=True)
            print(json.dumps({"seed": seed, "side": "witness",
                              **{n: v for n, (v, _) in wit.items()},
                              "fields": {n: f for n, (_, f) in wit.items()}}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "ratio": {n: upper[n] / lower[n] for n in upper if lower.get(n)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
