"""The port's timing harness (``nf4_tpu_torch/utils/timing.py``) against
the JAX package's ``nf4_tpu/utils/timing.py`` on the CPU: ``Stats`` of the
same times, its ``repr`` included; ``measure_s`` and ``measure_chained_s``
on a CPU step (their CUDA completion, ``torch.cuda.synchronize``, runs on
the card in ``python -m nf4_tpu_torch.diagnostics``)."""

import numpy as np
import pytest
import torch

from nf4_tpu.utils import timing as jtiming
from nf4_tpu_torch.utils import timing
from _torch_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("times", [[0.001], [0.0021, 0.0019, 0.0025, 0.002], list(np.linspace(1e-5, 3e-2, 7))])
def test_stats_match_the_jax_package(times):
    ours, theirs = timing.Stats(times), jtiming.Stats(times)
    for field in ("mean", "std", "min", "max", "median"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert repr(ours) == repr(theirs)


def test_measure_s_on_a_cpu_step():
    a = torch.randn(64, 64)
    calls = []

    def fn():
        calls.append(1)
        return {"y": [a @ a, (a.sum(),)]}  # nested outputs are waited for as one

    stats = timing.measure_s(fn, iters=4, warmup=2, repeats=3)
    assert len(calls) == 2 + 4 * 3
    assert 0 < stats.min <= stats.median <= stats.max and stats.std >= 0
    assert repr(stats).startswith("mean ") and repr(stats).endswith(")")


def test_measure_chained_s_on_a_cpu_step():
    a = torch.randn(64, 64)
    seen = []

    def step(c):
        seen.append(c.shape)
        return c + (a @ a)[0, 0] * 1e-30

    stats = timing.measure_chained_s(step, torch.zeros(()), n1=2, n2=6, repeats=2)
    assert len(seen) == 3 + 2 * (2 + 6) and set(seen) == {torch.Size([])}
    assert np.isfinite([stats.mean, stats.median]).all()
