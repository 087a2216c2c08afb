"""The readings that the check's limits are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload <name> --seconds 20 --seeds 1 2 ... --control 1 2 3

One process and one Engine: for each seed the weights are drawn again into
the same buffers, a window of the cell's traffic runs, and its sample of
finished requests (``harness.sample``, as a run takes it) goes through the
fp32 reference: the program's readings (``max_logit_gap``, ``gap_p90``,
``gap_p50``, ``flip_share``; ``harness.gap_numbers``).  For the seeds under
``--control`` the same sequences also go through the fp8 control, whose
readings are the reference's gaps of the tokens the fp8 forward puts first,
under the same names.  Both are judged by ``harness.checks`` and
``harness.passed`` against the cell's limits file, as a run is: each line
gives ``correct`` and ``control_correct``.  A limit lies above the largest
program reading and below the smallest control reading.  ``--rate``
replaces an open loop's rate (a calibration before the rate is fixed).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch  # noqa: F401

    from portbench import harness, model as model_mod, spec
    from portbench.traffic import Traffic

    bench = spec.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    model = model_mod.load(bench.config_path(cell["config"]))
    tspec = bench.traffic(cell["traffic"])
    if args.rate is not None:
        tspec = dict(tspec, rate_per_s=args.rate)
    limits = bench.limits(args.workload)
    program = None
    rows = []
    for seed in args.seeds:
        traffic = Traffic(tspec, model.vocab, seed, args.seconds)
        if program is None:
            program = harness.Program(model, traffic, seed, "cuda", traffic.slots)
        else:
            program.fill(seed)
        win = harness.Window(program, traffic, args.seconds, False).run()
        t0 = time.perf_counter()
        picked = harness.sample(win, seed, limits)
        read = harness.readings(win, picked, model, seed, "cuda", control=seed in args.control)
        row = {"seed": seed, **read["program"], "failed": win.failed(),
               "correct": harness.passed(harness.checks(read["program"], win.failed(), limits))}
        if "control" in read:
            row.update({"control_" + k: v for k, v in read["control"].items()})
            row["control_correct"] = harness.passed(harness.checks(read["control"], 0, limits))
        row["reference_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
