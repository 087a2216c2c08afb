"""The port's backend flags (``nf4_tpu_torch/utils/env.py``) against the JAX
package's ``nf4_tpu/utils/env.py``, and the ops' dispatch on them, on the
CPU.

* ``backend_choice``, ``backend``, ``matmul_tile_override`` and
  ``collective_chunks`` give the JAX package's value, or raise its error
  with its message, for valid and invalid settings.
* ``NF4TPU_BACKEND=jnp`` runs each op's plain version on a CPU tensor;
  ``pallas`` raises there (no kernel runs off the card, and nothing falls
  back).
* ``NF4TPU_MATMUL_TILE`` reaches kernels B, D and E as the block rows and
  K split of their C entries (a mocked launch on a 132-SM card, as
  ``tests/test_torch_int8.py`` checks the default dispatch); a triple a
  kernel lacks raises a ValueError naming the ones it takes.
"""

import types

import pytest
import torch

from nf4_tpu.utils import env as jenv
from nf4_tpu_torch.ops import int8_serve as tint8
from nf4_tpu_torch.ops import matmul as tm
from nf4_tpu_torch.utils import env
from _torch_threads import _one_thread  # noqa: F401

CASES = [
    ("NF4TPU_BACKEND", None), ("NF4TPU_BACKEND", "auto"), ("NF4TPU_BACKEND", "pallas"), ("NF4TPU_BACKEND", "jnp"),
    ("NF4TPU_BACKEND", "JNP"), ("NF4TPU_BACKEND", "bogus"), ("NF4TPU_BACKEND", ""),
    ("NF4TPU_MATMUL_TILE", None), ("NF4TPU_MATMUL_TILE", ""), ("NF4TPU_MATMUL_TILE", "16,1024,128"),
    ("NF4TPU_MATMUL_TILE", "256, 2048 ,128"), ("NF4TPU_MATMUL_TILE", "16,1024"), ("NF4TPU_MATMUL_TILE", "16,1024,128,4"),
    ("NF4TPU_MATMUL_TILE", "a,b,c"), ("NF4TPU_MATMUL_TILE", "16,,128"),
    ("NF4TPU_COLLECTIVE_MATMUL", None), ("NF4TPU_COLLECTIVE_MATMUL", "0"), ("NF4TPU_COLLECTIVE_MATMUL", "4"),
    ("NF4TPU_COLLECTIVE_MATMUL", "-1"), ("NF4TPU_COLLECTIVE_MATMUL", "two"),
]


def _outcome(fn):
    try:
        return ("value", fn())
    except Exception as e:  # the type and message must match
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("var,value", CASES, ids=[f"{v}={x}" for v, x in CASES])
def test_flags_match_the_jax_package(monkeypatch, var, value):
    if value is None:
        monkeypatch.delenv(var, raising=False)
    else:
        monkeypatch.setenv(var, value)
    assert not torch.cuda.is_available()  # auto resolves to the plain path, as JAX's does off the TPU
    for name in ("backend_choice", "backend", "matmul_tile_override", "collective_chunks"):
        assert _outcome(getattr(env, name)) == _outcome(getattr(jenv, name)), name


def _ops(seed=0):
    """(name, call) of every op with a kernel choice, on small CPU operands."""
    from nf4_tpu_torch import dequantize, dequantize_fast, nf4_matmul, quantize_for_tpu
    from nf4_tpu_torch.ops.attention import flash_attention
    from nf4_tpu_torch.ops.int8_serve import int8_matmul, recode_int8_weight

    g = torch.Generator().manual_seed(seed)
    pw = quantize_for_tpu(torch.randn(256, 1024, generator=g).numpy() * 0.02, method="oracle", device="cpu")
    x = torch.randn(3, 1024, generator=g).to(torch.bfloat16)
    q = torch.randn(1, 4, 8, 64, generator=g).to(torch.bfloat16)
    kv = torch.randn(1, 2, 16, 64, generator=g).to(torch.bfloat16)
    pos = torch.arange(8)[None]
    return [
        ("dequantize", lambda: dequantize(pw)),
        ("dequantize_fast", lambda: dequantize_fast(pw)),
        ("nf4_matmul bf16", lambda: nf4_matmul(x, pw)),
        ("nf4_matmul fp32", lambda: nf4_matmul(x.float(), pw)),
        ("int8_matmul", lambda: int8_matmul(x, recode_int8_weight(pw))),
        ("flash_attention", lambda: flash_attention(q, kv, kv, pos, torch.tensor([8]), scale=0.125)),
    ]


@pytest.mark.parametrize("index", range(6), ids=[name for name, _ in _ops()])
def test_jnp_runs_the_plain_version_and_pallas_raises_on_the_cpu(monkeypatch, index):
    name, call = _ops()[index]
    monkeypatch.delenv("NF4TPU_BACKEND", raising=False)
    want = call()
    monkeypatch.setenv("NF4TPU_BACKEND", "jnp")
    assert torch.equal(call(), want), name
    monkeypatch.setenv("NF4TPU_BACKEND", "pallas")
    with pytest.raises(RuntimeError, match="NF4TPU_BACKEND=pallas runs the CUDA kernels"):
        call()
    monkeypatch.setenv("NF4TPU_BACKEND", "bogus")
    with pytest.raises(ValueError, match="NF4TPU_BACKEND='bogus' invalid"):
        call()


# (kernel, tile, rows) -> (block rows, K split) passed to its C entry, for a
# weight of n_pad 2048 x m_pad 512; None: the triple raises.
TILES = [
    ("B", "16,512,128", 16, (16, 4)), ("B", "16,2048,128", 64, (16, 1)), ("B", "128,1024,256", 64, (128, 2)),
    ("B", "256,64,128", 64, (256, 32)), ("B", "16,512,256", 16, None), ("B", "128,1000,256", 64, None),
    ("B", "64,512,128", 64, None), ("B", "256,4096,128", 64, None), ("B", "128,32,256", 64, None),
    ("D", "16,1024,128", 16, (16, 2)), ("D", "256,2048,128", 64, (256, 1)), ("D", "128,512,256", 64, (128, 4)),
    ("D", "128,512,128", 64, None), ("D", "16,96,128", 16, None),
    ("E", "16,1024,128", 16, (16, 2)), ("E", "128,32,128", 64, (128, 64)), ("E", "128,1024,128", 64, (128, 2)),
    ("E", "256,2048,128", 64, None), ("E", "128,1024,256", 64, None), ("E", "16,32,128", 16, None),
]


@pytest.mark.parametrize("kernel,tile,rows,want", TILES, ids=[f"{k}:{t}@{r}" for k, t, r, _ in TILES])
def test_matmul_tile_override_reaches_the_kernels(monkeypatch, kernel, tile, rows, want):
    queries = set()

    def shape(dev, query=tm._B_DECODE):
        queries.add(query)
        return 128, 1

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(tm, "_decode_shape", shape)
    for mod in (tm, tint8):
        monkeypatch.setattr(mod, "_tile_counters", lambda dev, tiles: torch.zeros(tiles, dtype=torch.int32))
    launched = []
    record = lambda *args: launched.append(args)  # noqa: E731
    monkeypatch.setattr(tm, "_KERNEL", record)
    monkeypatch.setattr(tm, "_EXACT_KERNEL", record)
    monkeypatch.setattr(tint8, "_KERNEL", record)
    monkeypatch.setenv("NF4TPU_MATMUL_TILE", tile)
    n_pad, m_pad = 2048, 512
    packed, scales = torch.zeros((n_pad // 2, m_pad), dtype=torch.uint8), torch.zeros((n_pad // 64, m_pad))
    call = {
        "B": lambda: tm._matmul_bf16_kernel(torch.zeros((rows, n_pad), dtype=torch.bfloat16), packed, scales,
                                            torch.bfloat16),
        "E": lambda: tm._matmul_exact_kernel(torch.zeros((rows, n_pad)), packed, scales, torch.float32),
        "D": lambda: tint8._int8_matmul_kernel(torch.zeros((rows, n_pad), dtype=torch.bfloat16),
                                               torch.zeros((n_pad, m_pad), dtype=torch.int8), scales, torch.bfloat16),
    }[kernel]
    if want is None:
        with pytest.raises(ValueError, match=f"NF4TPU_MATMUL_TILE={tile}: kernel {kernel} .* takes 16,bks,128"):
            call()
        return
    call()
    args = launched[-1]
    got = (args[-3], args[-2]) if kernel == "D" else (args[9], args[-2])
    assert got == want
    counters = args[5] if kernel == "D" else args[-3]
    assert (counters is not None) == (want[0] == 16)  # the decode kernel's tile counters
    assert queries == {{"B": tm._B_DECODE, "D": tint8._D_DECODE, "E": tm._E_DECODE}[kernel]}


def test_row_unit_follows_the_tile(monkeypatch):
    """The ops pad a kernel's rows to 16 for the decode tile and to 64 for a
    prefill one (the prefill blocks mask their ragged last tile)."""
    monkeypatch.delenv("NF4TPU_MATMUL_TILE", raising=False)
    assert [tm._row_unit(b) for b in (4, 16, 17)] == [16, 16, 64] and tm._row_unit(4, prefill=True) == 64
    monkeypatch.setenv("NF4TPU_MATMUL_TILE", "16,1024,128")
    assert [tm._row_unit(b) for b in (4, 300)] == [16, 16] and tm._row_unit(4, prefill=True) == 16
    monkeypatch.setenv("NF4TPU_MATMUL_TILE", "128,1024,256")
    assert [tm._row_unit(b) for b in (4, 300)] == [64, 64]
