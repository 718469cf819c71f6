#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... --control-seeds 7,8,9

For each seed: a row of the cell's table drawn from the seed, and the
reference's sample of it (as a run draws one) at the configuration's
precisions. With ``--program-seeds`` the port's entry computes the job and
is held against the reference: the lower readings. With
``--control-seeds`` the reference computed one precision lower (the
float64 stages in float32, ``--kind all``, or only the bins' sums,
``--kind sums``) is put in the port's place: the upper readings; or, with
``--kind march64``, the reference with its march in float64, a sound march
that rounds otherwise. Prints one line a seed and, last, the largest
program reading and the least and largest reading of the reference put in
its place, for each number, as JSON. Runs on the card; with
``--device cpu`` on the CPU, where the port marches in float64.
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench.judge import CONTROLS, VARIANTS  # noqa: E402


def readings(cell, seed, device, control, kind):
    """(row label, the compared numbers) of one seed."""
    driver = harness.load_driver(cell.config["driver"], cell.root)
    rows = harness.job_rows(cell.traffic)
    i = int(harness.seed_rng(seed, 4).integers(len(rows)))
    par = harness.job_params(cell.config, rows[i])
    sample = driver.sample(par, cell.config, harness.seed_rng(seed, 3, 0))
    ref = driver.reference(par, sample, cell.config, device=device)
    if control:
        out = driver.control(par, sample, cell.config, device=device, kind=kind)
    else:
        out = driver.run(par, device=device)
    return harness.row_label(rows[i], cell.traffic), driver.compare(out, ref, sample)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--kind", default="sums", choices=CONTROLS + VARIANTS,
                   help="every float64 stage in float32, the bins' sums only in float32, or "
                        "the march in float64")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(harness.load_spec(), args.workload)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device visible", file=sys.stderr)
            return 2
        print(f"device: {harness.smi_line()}")
    worst, least, most = {}, {}, {}
    for control, seeds in ((False, args.program_seeds), (True, args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            t = time.perf_counter()
            row, nums = readings(cell, seed, args.device, control, args.kind)
            side = f"control ({args.kind})" if control else "program"
            print(f"{side} seed {seed} row {row}: {nums} ({time.perf_counter() - t:.1f} s)",
                  flush=True)
            for k, v in nums.items():
                if control:
                    least[k] = min(least.get(k, v), v)
                    most[k] = max(most.get(k, v), v)
                else:
                    worst[k] = max(worst.get(k, v), v)
    print(json.dumps({"workload": args.workload, "program_max": worst,
                      f"{args.kind}_min": least, f"{args.kind}_max": most}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
