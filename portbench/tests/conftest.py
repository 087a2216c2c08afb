"""The benchmark's tests: the checkout's root on the import path, and tiny
configurations written into a temporary copy of the benchmark's data."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PORTBENCH = ROOT / "portbench"

TINY = {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "vocab_size": 512, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "max_position_embeddings": 256}
# Qwen2's shape in small: grouped heads and q/k/v biases.
TINY_QWEN2 = dict(TINY, qkv_bias=True)
# Mixtral's in small: 4 experts, top-2.
TINY_MIXTRAL = dict(TINY, num_local_experts=4, num_experts_per_tok=2)
OPEN = {"loop": "open", "rate_per_s": 40, "slots": 16, "ramp_s": 0.5,
        "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 64},
        "output": {"dist": "uniform", "min": 8, "max": 24}}
CLOSED = {"loop": "closed", "slots": 16, "ramp_s": 0.2, "stagger_ramp": True, "block": 16,
          "prompt": {"dist": "uniform", "min": 16, "max": 96}, "output": {"dist": "uniform", "min": 32, "max": 48}}
# The tiny cells are checked as the committed cells are: their limits files
# (numbers compared, limits, sample sizes) are copied whole.
COMMITTED = {"tiny-qwen2.chat": "qwen2-7b.chat", "tiny-qwen2.batch": "qwen2-7b.longctx"}
CELLS = {"tiny-qwen2.chat": ("tiny-qwen2", "tiny-open"), "tiny-qwen2.batch": ("tiny-qwen2", "tiny-closed")}
# The fp8 control at tiny sizes moves the logits less than at full size, so
# its test holds it to limits set between the tiny program's readings on
# seeds 11-15 and 2**31 + 5 and the tiny control's: max_logit_gap
# 0.0186-0.0605 against 0.3495-0.5269 (Qwen2's shape), gap_p90 0.0 against
# 0.0722-0.1049 (Qwen2's) and 0.1669-0.2279 (Mixtral's).  In Mixtral's shape
# the widest gap swings with route flips (0.11-3.04 for the program) and is
# not compared.  The sample is the committed cells'.
CONTROL_LIMITS = {"qwen2": {"max_logit_gap": 0.2, "gap_p90": 0.04}, "mixtral": {"gap_p90": 0.04}}


def committed_limits(cell: str) -> dict:
    return json.loads((PORTBENCH / "limits" / f"{COMMITTED[cell]}.json").read_text())


def make_bench(tmp: Path) -> Path:
    """A checkout-like directory: ``BENCHMARK.json`` with two tiny cells
    (``tiny-qwen2.chat``, open loop; ``tiny-qwen2.batch``, closed) and a copy
    of the benchmark's folder holding their files."""
    base = tmp / "pb"
    shutil.copytree(PORTBENCH, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (base / "configs" / "tiny-qwen2.json").write_text(json.dumps(TINY_QWEN2))
    (base / "traffic" / "tiny-open.json").write_text(json.dumps(OPEN))
    (base / "traffic" / "tiny-closed.json").write_text(json.dumps(CLOSED))
    for name in CELLS:
        (base / "limits" / f"{name}.json").write_text(json.dumps(committed_limits(name)))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny-qwen2", "source": "test", "file": "pb/configs/tiny-qwen2.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for n, (c, t) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny for tiny, real in COMMITTED.items() if real in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


class StepClock:
    """A host clock that advances ``dt`` seconds at every reading, and a sleep
    that advances it: a run's course then depends on its code alone, not on
    the speed of the machine running the test."""

    def __init__(self, dt: float = 0.002):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def run_tiny(root, base, cell, seed, seconds=5.0, **kw):
    """``harness.run_cell`` on the CPU under a :class:`StepClock`."""
    from portbench import harness

    clock = StepClock()
    return harness.run_cell(root, cell, seed, seconds, False, 0.0, "cpu", base, clock=clock, sleep=clock.sleep, **kw)


@pytest.fixture
def bench_dir(tmp_path):
    """(root, base) of a tiny benchmark copy."""
    return tmp_path, make_bench(tmp_path)
