"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Exits with 2, printing no result, without a
CUDA card (or with fewer than the cell asks for), and with 3 if the process
holds ``jax``, ``jaxlib``, ``flax`` or ``nf4_tpu`` once the window closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The program's and the libraries' kernel caches live at fixed paths inside
# the checkout, so that a checkout's first run builds and the rest reuse.
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path[0] = str(ROOT)  # the checkout's root, not this folder: no module here shadows another


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    chips = int(next(w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                     if w["name"] == args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: needs {chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from portbench import harness

    harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
