"""The port's C++ host quantizer (``nf4_tpu_torch/nf4/native.py``) against
the JAX package's (``nf4_tpu.nf4.native``) and the NumPy oracle.

Every field of the flat QuantState and every byte of the packed layout
must equal theirs: codes and absmax, NF4 and FP4, an odd-numel tail, a
zero block (unit scale), midpoint ties (left), the branchless tree of the
255-midpoint dynamic codebook and the generic midpoint count, the K-major
pack with its shards.  Then the dispatch: ``quantize_for_tpu``'s ``auto``
on the CPU takes the native quantizer, ``NF4TPU_NATIVE`` is validated, and
a build that fails raises under an explicit ``method="native"`` or
``NF4TPU_NATIVE=1`` (never another method in its place).
"""

import numpy as np
import pytest
import torch
from _torch_threads import _one_thread  # noqa: F401

from nf4_tpu.nf4 import format as jformat
from nf4_tpu.nf4 import native as jnative
from nf4_tpu.nf4.reference import quantize_nf4 as j_quantize_nf4
from nf4_tpu.nf4.reference import quantize_to_code
from nf4_tpu_torch.nf4 import format as tformat
from nf4_tpu_torch.nf4 import native
from nf4_tpu_torch.nf4.lut import NF4_CODE, code_midpoints, dynamic_code
from nf4_tpu_torch.nf4.reference import quantize_nf4


@pytest.fixture(autouse=True)
def _built():
    """Both quantizers build at first use (g++), inside a test, not while
    the module is collected."""
    if not (native.available() and jnative.available()):
        pytest.skip("the native quantizers did not build (no g++?)")


def _rand(shape, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _codes_equal(w, blocksize, mids):
    got = native.quantize_codes(w, blocksize, mids)
    want = jnative.quantize_codes(w, blocksize, mids)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g, j)
    return got


@pytest.mark.parametrize("n", [64, 128, 4096, 100, 63, 65, 1])
def test_codes_and_absmax_match_the_oracle(n):
    w = _rand((n,), seed=n)
    codes, absmax = _codes_equal(w, 64, code_midpoints(NF4_CODE))
    nb = -(-n // 64)
    wp = np.concatenate([w, np.zeros(nb * 64 - n, np.float32)])
    am = np.abs(wp.reshape(nb, 64)).max(axis=1)
    np.testing.assert_array_equal(absmax, am)
    sc = np.where(am > 0, am, np.float32(1.0))
    want = quantize_to_code((wp.reshape(nb, 64) / sc[:, None]).astype(np.float32), NF4_CODE).ravel()[:n]
    np.testing.assert_array_equal(codes, want)


def test_zero_block_takes_unit_scale():
    codes, absmax = _codes_equal(np.zeros(64, np.float32), 64, code_midpoints(NF4_CODE))
    assert absmax[0] == 0.0
    np.testing.assert_array_equal(codes, quantize_to_code(np.zeros(64, np.float32), NF4_CODE))


def test_midpoint_tie_goes_left():
    """A value exactly on a midpoint keeps the lower index (searchsorted
    side='left', bitsandbytes' strictly-greater comparisons)."""
    mids = code_midpoints(NF4_CODE)
    for k in range(mids.size):
        w = np.full(64, mids[k], np.float32)
        w[0] = 1.0  # absmax 1: the values pass unscaled
        codes, _ = _codes_equal(w, 64, mids)
        np.testing.assert_array_equal(codes, quantize_to_code(w, NF4_CODE))
        assert codes[1] == k


def test_generic_midpoint_count():
    """5 midpoints (not 2^k - 1, more than none): the lower_bound arm."""
    mids5 = np.asarray([-0.6, -0.2, 0.0, 0.2, 0.6], np.float32)
    w = _rand((256,), seed=9, scale=1.0)
    codes, _ = _codes_equal(w, 64, mids5)
    am = np.abs(w.reshape(4, 64)).max(axis=1)
    norm = (w.reshape(4, 64) / np.where(am > 0, am, np.float32(1.0))[:, None]).astype(np.float32)
    np.testing.assert_array_equal(codes, np.searchsorted(mids5, norm, side="left").astype(np.uint8).ravel())


def test_255_midpoint_tree():
    """The 256-entry dynamic codebook (255 = 2^8 - 1 midpoints): the
    branchless tree, on a dense sweep, against searchsorted."""
    mids = code_midpoints(dynamic_code())
    w = np.linspace(-1.2, 1.2, 4096).astype(np.float32)
    codes, absmax = _codes_equal(w, w.size, mids)
    want = np.searchsorted(mids, (w / np.float32(absmax[0])).astype(np.float32), side="left").astype(np.uint8)
    np.testing.assert_array_equal(codes, want)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("shape", [(8, 64), (100, 320), (128, 1024), (257, 192), (3, 5)])
def test_quant_state_fields_byte_identical(shape, quant_type):
    w = _rand(shape, seed=sum(shape))
    got = native.quantize_nf4_native(w, quant_type=quant_type)
    for want in (quantize_nf4(w, quant_type=quant_type), j_quantize_nf4(w, quant_type=quant_type),
                 jnative.quantize_nf4_native(w, quant_type=quant_type)):
        np.testing.assert_array_equal(got.packed, want.packed)
        np.testing.assert_array_equal(got.absmax_u8, want.absmax_u8)
        np.testing.assert_array_equal(got.absmax32.view(np.uint32), want.absmax32.view(np.uint32))
        assert got.offset.tobytes() == np.float32(want.offset).tobytes()
        assert (got.shape, got.dtype, got.blocksize, got.blocksize2, got.quant_type) == (
            tuple(want.shape), want.dtype, want.blocksize, want.blocksize2, want.quant_type)


def test_odd_numel_tail_nibble():
    w = _rand((3, 5), seed=1)
    got = native.quantize_nf4_native(w)
    np.testing.assert_array_equal(got.packed, quantize_nf4(w).packed)
    assert got.packed.size == 8 and got.packed[-1] & 0xF == 0  # 15 codes: the last low nibble pads a zero
    np.testing.assert_array_equal(native.pack_flat(np.arange(15, dtype=np.uint8) % 16),
                                  jnative.pack_flat(np.arange(15, dtype=np.uint8) % 16))


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("shape", [(128, 1024), (100, 320), (256, 2048)])
def test_packed_layout_byte_identical(shape, quant_type):
    w = _rand(shape, seed=shape[0])
    got = tformat.quantize_for_tpu(w, method="native", quant_type=quant_type, device="cpu")
    want = tformat.quantize_for_tpu(w, method="oracle", quant_type=quant_type, device="cpu")
    jgot = jformat.quantize_for_tpu(w, method="native", quant_type=quant_type)
    for ref in (want, jgot):
        np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
        np.testing.assert_array_equal(got.scales.numpy().view(np.uint32), np.asarray(ref.scales).view(np.uint32))
        assert (got.shape, got.padded_shape, got.shards, got.quant_type) == (
            tuple(ref.shape), tuple(ref.padded_shape), ref.shards, ref.quant_type)
    assert got.dtype == torch.bfloat16 and got.packed.device.type == "cpu"


@pytest.mark.parametrize("shape,shards", [((128, 1024), 1), ((100, 320), 1), ((256, 2048), 2), ((64, 4096), 4)])
def test_pack_kmajor_keeps_its_shards(shape, shards):
    """The C++ K-major pack, per K chunk padded, against the JAX package's
    (the multi-GPU slice packs through it)."""
    m, n = shape
    codes = np.random.default_rng(n).integers(0, 16, shape, dtype=np.uint8)
    m_pad, n_chunk_pad = tformat.pad_to(m, 128), tformat.pad_to(n // shards, 1024)
    got = native.pack_kmajor(codes, m_pad, n_chunk_pad, shards)
    np.testing.assert_array_equal(got, jnative.pack_kmajor(codes, m_pad, n_chunk_pad, shards))
    assert got.shape == (shards * n_chunk_pad // 2, m_pad)
    with pytest.raises(ValueError, match="padded shape"):  # checked before any pointer is passed
        native.pack_kmajor(codes, m_pad - 128, n_chunk_pad, shards)


def test_auto_on_the_cpu_prefers_native(monkeypatch):
    """``method="auto"`` off the card takes the native quantizer and still
    gives the oracle's bytes; with ``NF4TPU_NATIVE=0`` it takes the device
    quantizer on the CPU, the same bytes."""
    calls = []
    real = native.quantize_for_tpu_native
    monkeypatch.setattr(native, "quantize_for_tpu_native", lambda *a, **k: calls.append(1) or real(*a, **k))
    w = _rand((128, 1024), seed=7)
    want = tformat.quantize_for_tpu(w, method="oracle", device="cpu")
    got = tformat.quantize_for_tpu(w, device="cpu")
    assert calls == [1]
    monkeypatch.setenv("NF4TPU_NATIVE", "0")
    off = tformat.quantize_for_tpu(w, device="cpu")
    assert calls == [1]
    for q in (got, off):
        assert torch.equal(q.packed, want.packed) and torch.equal(q.scales, want.scales)


def test_env_flag_validation(monkeypatch):
    w = _rand((64, 128), seed=3)
    monkeypatch.setenv("NF4TPU_NATIVE", "banana")
    with pytest.raises(ValueError, match="NF4TPU_NATIVE"):
        native._load()
    with pytest.raises(ValueError, match="NF4TPU_NATIVE"):
        tformat.quantize_for_tpu(w, method="native", device="cpu")
    assert not native.available()
    monkeypatch.setenv("NF4TPU_NATIVE", "0")
    assert native._load() is None and not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        tformat.quantize_for_tpu(w, method="native", device="cpu")
    for value in ("auto", "AUTO", "1"):
        monkeypatch.setenv("NF4TPU_NATIVE", value)
        assert native.available()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A source g++ rejects: ``NF4TPU_NATIVE=1`` and an explicit
    ``method="native"`` raise; ``auto`` reports the quantizer unavailable
    and ``quantize_for_tpu(method="auto")`` takes the device quantizer."""
    bad = tmp_path / "nf4quant.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    w = _rand((64, 128), seed=4)
    monkeypatch.setenv("NF4TPU_NATIVE", "1")
    with pytest.raises(RuntimeError, match="failed to build"):
        native._load()
    with pytest.raises(RuntimeError, match="failed to build"):
        tformat.quantize_for_tpu(w, method="native", device="cpu")
    assert not native.lib_path().exists()
    monkeypatch.setenv("NF4TPU_NATIVE", "auto")
    assert not native.available()
    with pytest.raises(RuntimeError, match="its build failed: g\\+\\+ failed"):
        tformat.quantize_for_tpu(w, method="native", device="cpu")
    got = tformat.quantize_for_tpu(w, device="cpu")
    want = tformat.quantize_for_tpu(w, method="oracle", device="cpu")
    assert torch.equal(got.packed, want.packed) and torch.equal(got.scales, want.scales)


def test_the_library_is_named_after_its_source(monkeypatch, tmp_path):
    """The build goes into the package's ``_build/`` directory under a name
    that follows the source's content (an edited source rebuilds)."""
    from nf4_tpu_torch.ops._cuda import BUILD_DIR

    path = native.lib_path()
    assert path.parent == BUILD_DIR and path.name.startswith("libnf4quant-") and path.exists()
    edited = tmp_path / "nf4quant.cpp"
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", edited)
    assert native.lib_path() != path
