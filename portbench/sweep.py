"""Find an open-loop cell's knee: one process, one Engine, one window per rate.

    python3 portbench/sweep.py --workload qwen2-7b.chat --seed 11 --seconds 30 --rates 2 3 4 5 6

For each rate it prints the backlog (requests due and not yet handed to the
Engine) at the window's middle and end, and the cell's tails.  The knee is
the highest rate whose backlog does not grow across the window; the cell's
traffic file then takes 4/5 of it as its ``rate_per_s``.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch  # noqa: F401

    from portbench import harness, model as model_mod, spec, work
    from portbench.traffic import Traffic

    bench = spec.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    model = model_mod.load(bench.config_path(cell["config"]))
    base = bench.traffic(cell["traffic"])
    program = harness.Program(model, Traffic(base, model.vocab, args.seed, args.seconds), args.seed, "cuda", int(base["slots"]))
    rows = []
    for rate in args.rates:
        traffic = Traffic(dict(base, rate_per_s=rate), model.vocab, args.seed, args.seconds)
        win = harness.Window(program, traffic, args.seconds, False).run()
        mid = win.w0 + args.seconds / 2
        row = {"rate_per_s": rate, "backlog_mid": win.backlog(mid), "backlog_end": win.backlog(win.w1),
               "due": win.attempted(), "ttft_p95_ms": work.percentile(win.ttft_ms(), 95),
               "ttft_p50_ms": work.percentile(win.ttft_ms(), 50), "itl_p95_ms": work.percentile(win.itl_ms(), 95),
               "queue_wait_p50_ms": work.percentile(win.queue_wait_ms(), 50),
               "out_tok_s": win.tokens_in_window() / args.seconds, "pipeline": win.pipeline(),
               "captured_in_window": win.captured_in_window()}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
