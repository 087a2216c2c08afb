"""4-bit quantization on the device (the load path), byte-identical to the
NumPy oracle.

The counterpart of the JAX package's ``nf4/fast_quant.py``, which is XLA
code, not a Pallas kernel; here it is plain PyTorch on the target device:

* the per-64-block absmax, a max-reduce (exact in fp32);
* the statistics (offset, the dynamic-code compression of the absmax
  stream) on the HOST with the oracle's own ``quantize_blockwise_u8`` and
  ``dequantize_absmax``: the fp64 mean and the small searchsorted are cheap,
  and the block scales are the oracle's bit for bit;
* the code of each element, ``#{midpoints < x / absmax}`` (``bucketize``
  over the fp32 midpoints; FP4 by magnitude with the sign bit added), and
  the pair-layout packing, on the device.

``x / absmax`` is an elementwise division of two fp32 tensors, correctly
rounded on the card and on the CPU (multiplying by a reciprocal is not),
so the codes equal the oracle's, also for values a ulp from a midpoint.
Memory: the fp32 and code transients are one weight's, not a layer's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .format import PackedNF4, _pack_codes
from .lut import code_midpoints, fp4_order_and_mids, get_code
from .reference import NF4_BLOCK, QuantState, dequantize_absmax, quantize_blockwise_u8

__all__ = ["quantize_for_tpu_device"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _as_tensor(w) -> torch.Tensor:
    """A dense weight as a torch tensor in its own (compact) float dtype."""
    if isinstance(w, torch.Tensor):
        return w.detach()
    arr = np.ascontiguousarray(w)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _codes(norm: torch.Tensor, quant_type: str) -> torch.Tensor:
    """The 4-bit code of each normalized value: ``#{mids < x}`` for a
    monotone table, ``order[#{mids < |x|}] + 8 * (x < 0)`` for FP4's
    sign-magnitude one (the oracle's ``quantize_to_code``)."""
    table = get_code(quant_type)
    if np.all(np.diff(table) >= 0):
        mids = torch.from_numpy(code_midpoints(table)).to(norm.device)
        return torch.bucketize(norm, mids, out_int32=True).to(torch.uint8)
    order, mids = fp4_order_and_mids(table)
    pos = torch.bucketize(norm.abs(), torch.from_numpy(mids).to(norm.device), out_int32=True)
    sign = (norm < 0).to(torch.uint8) << 3
    return torch.from_numpy(order).to(norm.device)[pos] + sign


def quantize_for_tpu_device(w, dtype=torch.bfloat16, quant_type: str = "nf4", device=None) -> PackedNF4:
    """Quantize a dense [m, n] weight (fp32, bf16 or fp16; torch or numpy)
    to :class:`PackedNF4` on ``device`` (default ``cuda``): the oracle's
    bytes, double-quantized statistics included.  The weight moves to the
    device in its own dtype and is upcast there."""
    dev = resolve_device(device)
    t = _as_tensor(w)
    if t.dtype not in _DTYPES:
        t = t.float()
    if t.dim() != 2:
        raise ValueError(f"expected a 2D weight, got shape {tuple(t.shape)}")
    m, n = t.shape
    if n % NF4_BLOCK:
        raise ValueError(f"in_features must be a multiple of {NF4_BLOCK}, got {n}")

    x = t.to(dev).float().reshape(-1, NF4_BLOCK)
    absmax = x.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones((), dtype=torch.float32, device=dev))
    codes = _codes(x / scale[:, None], quant_type).reshape(m, n)
    del x

    # The statistics on the host with the oracle's code: bit-identical scales.
    absmax_np = absmax.cpu().numpy()
    offset = np.float32(absmax_np.mean(dtype=np.float64))
    absmax_u8, absmax32 = quantize_blockwise_u8(absmax_np - offset)
    state = QuantState(packed=np.zeros(0, np.uint8), absmax_u8=absmax_u8, absmax32=absmax32, offset=offset,
                       shape=(m, n), dtype=np.dtype(np.float16))
    scales = torch.from_numpy(dequantize_absmax(state).reshape(m, n // NF4_BLOCK)).to(dev)
    return _pack_codes(codes, scales, dtype, 1, quant_type)


def midpoint_stress(m: int, n: int, quant_type: str = "nf4", seed: int = 0) -> np.ndarray:
    """An fp32 [m, n] weight whose normalized values sit on every decision
    midpoint of ``quant_type``'s table and one ulp either side: the inputs
    on which a quantizer whose division is not correctly rounded, or whose
    comparison is not strict, gives other codes than the oracle.  Each
    64-block's first element is its absmax ``s`` (its sign alternating);
    even blocks take ``s = 2^-k`` (the normalized values are exactly the
    targets), odd blocks a random ``s`` and the values ``fl(target * s)``
    (the division's rounding decides their side).  From ``seed``."""
    if n % NF4_BLOCK:
        raise ValueError(f"in_features must be a multiple of {NF4_BLOCK}, got {n}")
    rng = np.random.default_rng(seed)
    table = get_code(quant_type)
    if np.all(np.diff(table) >= 0):
        mids = code_midpoints(table)
    else:
        mids = fp4_order_and_mids(table)[1]
        mids = np.concatenate([mids, -mids])
    targets = np.concatenate([mids, np.nextafter(mids, np.float32(-2)), np.nextafter(mids, np.float32(2))])
    targets = targets[np.abs(targets) <= 1].astype(np.float32)
    nblocks = m * n // NF4_BLOCK
    vals = targets[np.arange(nblocks * (NF4_BLOCK - 1)) % targets.size].reshape(nblocks, NF4_BLOCK - 1)
    pow2 = np.float32(2.0) ** -rng.integers(1, 12, nblocks).astype(np.float32)
    rand = rng.uniform(1e-3, 0.1, nblocks).astype(np.float32)
    s = np.where(np.arange(nblocks) % 2 == 0, pow2, rand).astype(np.float32)
    out = np.empty((nblocks, NF4_BLOCK), np.float32)
    out[:, 0] = np.where(np.arange(nblocks) % 4 < 2, s, -s)
    out[:, 1:] = (vals * s[:, None]).astype(np.float32)
    return out.reshape(m, n)
