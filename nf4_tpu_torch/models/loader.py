"""Checkpoints: HF safetensors directories, quantized as they load, and
packed checkpoints (quantize once, reload fast).

:func:`load_hf_llama` reads a local HF checkpoint directory (``config.json``
and ``*.safetensors``, read with safetensors' ``"pt"`` framework so bf16
arrives as torch bf16), STREAMING: each layer is quantized on the device as
soon as its last tensor has been read, and its dense tensors freed.  A
"*-bnb-4bit" checkpoint (packed uint8 weights and quant-state sidecars,
``nf4.bnb_checkpoint``) loads through the same function and is repacked,
never requantized.  :func:`hf_config_to_llama` maps every family the JAX
package's ``models/loader.py`` maps, and raises its errors.

The counterpart of ``save_packed`` / ``load_packed`` / ``load_packed_auto``
in the JAX package's ``models/loader.py``, with the same schema and the same
``"nf4_tpu"`` metadata key, so either package reads what the other wrote:

* ``layers.<name>.packed`` / ``.scales`` for the packed projections
  (``wqkv``, ``wo``, ``w_gateup``, ``w_down``), stacked over the layer axis
  (an MoE model's expert-stacked ``w_gateup`` and ``w_down`` as ``[L, E,
  ...]``); ``layers.<name>`` for dense projections, the two norms and,
  where the model has them, ``qkv_bias``, ``q_norm``, ``k_norm``,
  ``router``, ``post_attn_out_norm`` and ``post_ffw_norm``; top-level
  ``embed``, ``final_norm`` and ``lm_head`` (or ``lm_head.packed`` /
  ``.scales``).
* metadata: each packed weight's logical ``shapes``, ``shards`` and
  ``quant_types``; ``dtypes`` (the ``.npz`` keys stored as bf16 bits); the
  ``dtype``; and the whole ``config``, so a checkpoint describes itself.

``.npz`` always works: bf16 tensors are stored as uint16 bit patterns and
read back through a torch view.  ``.safetensors`` needs the ``safetensors``
package.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import re
import types
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..nf4.bnb_checkpoint import BnbWeightGroup, is_bnb_sidecar, qdense_from_group
from ..nf4.format import PackedNF4, QDense
from ..ops.int8_serve import PackedInt8
from ..utils.device import resolve_device
from .convert import _OPTIONAL_LAYER_FIELDS as _OPTIONAL_FIELDS
from .convert import config_from_dict, config_to_dict
from .llama import LayerParams, LlamaConfig, LlamaParams, _lm_head, quantize_layer

__all__ = ["load_hf_llama", "hf_config_to_llama", "save_packed", "load_packed", "load_packed_auto",
           "load_packed_sharded"]

_LINEAR_FIELDS = ("wqkv", "wo", "w_gateup", "w_down")
_NORM_FIELDS = ("input_norm", "post_attn_norm")


def _safetensors(module: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            ".safetensors checkpoints need the 'safetensors' package, which is not installed; "
            "use a .npz path instead"
        ) from e


def _put_weight(tensors: dict, meta: dict, key: str, name: str, ws: list, stacked: bool) -> None:
    """Store weight ``name`` (one per layer when ``stacked``) under ``key``."""
    join = torch.stack if stacked else (lambda ts: ts[0])
    w = ws[0]
    if isinstance(w, PackedInt8):
        raise ValueError("int8-recoded weights are a serving format: save the packed 4-bit params")
    if isinstance(w, PackedNF4):
        tensors[f"{key}.packed"] = join([x.packed for x in ws])
        tensors[f"{key}.scales"] = join([x.scales for x in ws])
        meta["shapes"][name] = list(w.shape)
        meta["shards"][name] = w.shards
        meta["quant_types"][name] = w.quant_type
    else:
        tensors[key] = join(ws)


def save_packed(path: str, params: LlamaParams, cfg: LlamaConfig) -> None:
    """Write packed params and their config: ``.safetensors`` by extension,
    else an ``.npz`` archive (bf16 stored as uint16 bits)."""
    meta = {
        "shapes": {}, "shards": {}, "quant_types": {}, "dtypes": {},
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "config": config_to_dict(cfg),
    }
    tensors: Dict[str, torch.Tensor] = {"embed": params.embed, "final_norm": params.final_norm}
    _put_weight(tensors, meta, "lm_head", "lm_head", [params.lm_head], stacked=False)
    for name in _LINEAR_FIELDS:
        _put_weight(tensors, meta, f"layers.{name}", name, [getattr(lp, name) for lp in params.layers], True)
    for name in _NORM_FIELDS + _OPTIONAL_FIELDS:
        if getattr(params.layers[0], name) is not None:
            tensors[f"layers.{name}"] = torch.stack([getattr(lp, name) for lp in params.layers])
    tensors = {k: t.detach().cpu().contiguous() for k, t in tensors.items()}

    if path.endswith(".safetensors"):
        _safetensors("safetensors.torch").save_file(tensors, path, metadata={"nf4_tpu": json.dumps(meta)})
        return
    arrays = {}
    for key, t in tensors.items():
        if t.dtype == torch.bfloat16:
            arrays[key] = t.view(torch.int16).numpy().view(np.uint16)
            meta["dtypes"][key] = "bfloat16"
        else:
            arrays[key] = t.numpy()
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def _from_npz(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if bf16 else torch.from_numpy(arr)


def _read_packed(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A save_packed artifact -> (CPU tensors by key, metadata)."""
    if path.endswith(".safetensors"):
        with _safetensors("safetensors").safe_open(path, framework="pt") as f:
            meta = json.loads(f.metadata()["nf4_tpu"])
            return {k: f.get_tensor(k) for k in f.keys()}, meta
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        data = {key: _from_npz(z[key], meta["dtypes"].get(key) == "bfloat16") for key in z.files if key != "__meta__"}
    return data, meta


class _LazyEntry:
    """One tensor of a checkpoint, read when indexed: ``entry[idx]`` reads
    only that slice of a ``.safetensors`` file (``get_slice``), or the
    whole ``.npz`` member and then the slice (npz has no partial reads: one
    member at a time is held).  ``stats``, when given, records each index
    read under the key."""

    def __init__(self, key: str, shape, read, stats=None):
        self.key, self.shape, self._read, self.stats = key, tuple(shape), read, stats

    def __getitem__(self, idx) -> torch.Tensor:
        if self.stats is not None:
            self.stats.setdefault(self.key, []).append(idx)
        return self._read(idx)


def _lazy_entries(handle, path: str, stats) -> Tuple[Dict[str, _LazyEntry], dict]:
    """(lazy entries by key, metadata) of an open checkpoint."""
    if path.endswith(".safetensors"):
        def reader(sl):
            return lambda idx: sl[idx].contiguous()

        data = {}
        for k in handle.keys():
            sl = handle.get_slice(k)
            data[k] = _LazyEntry(k, sl.get_shape(), reader(sl), stats)
        return data, json.loads(handle.metadata()["nf4_tpu"])
    with handle.open("__meta__.npy") as f:
        meta = json.loads(bytes(np.lib.format.read_array(f, allow_pickle=False)).decode())

    def reader(name, bf16):
        def read(idx):
            with handle.open(name) as f:
                return _from_npz(np.lib.format.read_array(f, allow_pickle=False), bf16)[idx].contiguous()
        return read

    data = {}
    for name in handle.namelist():
        key = name[: -len(".npy")]
        if key == "__meta__" or not name.endswith(".npy"):
            continue
        with handle.open(name) as f:
            version = np.lib.format.read_magic(f)
            header = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
            shape = header(f)[0]
        data[key] = _LazyEntry(key, shape, reader(name, meta["dtypes"].get(key) == "bfloat16"), stats)
    return data, meta


def load_packed_sharded(path: str, mesh, read_stats: Dict | None = None, device=None,
                        **overrides) -> Tuple[LlamaParams, LlamaConfig]:
    """This rank's slice of a packed checkpoint, read from the file slice
    by slice (shard-on-read): each rank reads only what it serves
    (``.safetensors`` by ``get_slice``; ``.npz`` one member at a time) and
    holds no whole-model copy.  The counterpart of the JAX package's
    ``load_packed_sharded``, which reads the same slices for each device.

    ``mesh`` is the rank's :class:`~nf4_tpu_torch.parallel.mesh.Mesh`; the
    checkpoint must be packed for its degree (``python -m
    nf4_tpu_torch.quantize --tp N``, or ``repack_tp`` and
    :func:`save_packed`: the fused interleave is a permutation of the whole
    weight, which no slice can apply on its own).  Returns ``(params,
    cfg)``: the params of ``parallel.tp.localize_params`` on ``device``
    (default the mesh's), the config the whole model's, with
    ``overrides``.  ``read_stats`` collects the indices read per key."""
    from ..parallel.tp import local_meta, local_slice, shard_axis, shard_kinds, tp_local_config

    if path.endswith(".safetensors"):
        opened = _safetensors("safetensors").safe_open(path, framework="pt")
    else:
        import zipfile

        opened = zipfile.ZipFile(path, "r")
    with opened as handle:
        entries, meta = _lazy_entries(handle, path, read_stats)
        if "config" not in meta:
            raise ValueError(f"{path} has no 'config' in its metadata: quantize and save it again")
        cfg = dataclasses.replace(config_from_dict(meta["config"]), **overrides)
        tp, rank = mesh.tp, mesh.tp_rank
        if tp > 1:
            tp_local_config(cfg, tp, rank)  # the degree must match the pack
        kinds = dict(shard_kinds(cfg), lm_head="col", qkv_bias="col")
        local = dict(meta, shapes=dict(meta["shapes"]), shards=dict(meta.get("shards", {})))
        data = {}
        for key, entry in entries.items():
            base, _, part = key.removeprefix("layers.").rpartition(".")
            name, packed = (base, True) if part in ("packed", "scales") else (key.removeprefix("layers."), False)
            kind = kinds.get(name) if tp > 1 else None
            if kind is None:
                data[key] = entry[(slice(None),) * len(entry.shape)]
                continue
            axis = -1 if name == "qkv_bias" else shard_axis(kind, packed)
            data[key] = local_slice(entry, axis, tp, rank)
            if part == "packed":
                rows, lanes = entry.shape[-2:]
                whole = types.SimpleNamespace(shape=tuple(meta["shapes"][name]), padded_shape=(lanes, 2 * rows),
                                              shards=int(meta.get("shards", {}).get(name, 1)))
                fields = local_meta(whole, kind, tp)
                local["shapes"][name] = list(fields.get("shape", whole.shape))
                local["shards"][name] = fields.get("shards", whole.shards)
    return _assemble(data, local, cfg, device if device is not None else mesh.device), cfg


def _assemble(data: Dict[str, torch.Tensor], meta: dict, cfg: LlamaConfig, device) -> LlamaParams:
    dev = resolve_device(device)
    # Checkpoints from before the "shards" / "quant_types" fields were all
    # written with shards=1 and NF4.
    shards, quant_types = meta.get("shards", {}), meta.get("quant_types", {})

    def weight(key, name, i=None):
        pick = (lambda t: t.to(dev)) if i is None else (lambda t: t[i].to(dev))
        if f"{key}.packed" not in data:
            return pick(data[key])
        packed = data[f"{key}.packed"]
        m, n = meta["shapes"][name]
        return PackedNF4(
            packed=pick(packed),
            scales=pick(data[f"{key}.scales"]),
            shape=(m, n),
            padded_shape=(packed.shape[-1], 2 * packed.shape[-2]),
            dtype=cfg.dtype,
            shards=int(shards.get(name, 1)),
            quant_type=str(quant_types.get(name, "nf4")),
        )

    vectors = [name for name in _NORM_FIELDS + _OPTIONAL_FIELDS if f"layers.{name}" in data]
    layers = [
        LayerParams(
            **{name: weight(f"layers.{name}", name, i) for name in _LINEAR_FIELDS},
            **{name: data[f"layers.{name}"][i].to(dev) for name in vectors},
        )
        for i in range(cfg.num_layers)
    ]
    return LlamaParams(
        embed=weight("embed", "embed"),
        layers=layers,
        final_norm=weight("final_norm", "final_norm"),
        lm_head=weight("lm_head", "lm_head"),
    )


def load_packed(path: str, cfg: LlamaConfig, device=None) -> LlamaParams:
    """Params saved by :func:`save_packed` (``.npz`` or ``.safetensors``),
    on ``device`` (default ``cuda``)."""
    data, meta = _read_packed(path)
    return _assemble(data, meta, cfg, device)


def load_packed_auto(path: str, device=None, **overrides) -> Tuple[LlamaParams, LlamaConfig]:
    """Params AND their config from a self-describing checkpoint, on
    ``device`` (default ``cuda``).  ``overrides`` are serving-time fields
    applied on top (e.g. ``kv_quant=True``, ``max_seq_len=4096``)."""
    data, meta = _read_packed(path)
    if "config" not in meta:
        raise ValueError(
            f"{path} has no 'config' in its metadata: use load_packed(path, cfg) with the model's config"
        )
    cfg = dataclasses.replace(config_from_dict(meta["config"]), **overrides)
    return _assemble(data, meta, cfg, device), cfg


# ---------------------------------------------------------------------------
# HF checkpoint directories


def _rows(t, r0: int, r1: int):
    """Out-feature row slice of a dense tensor or a QDense alike."""
    return t.rows(r0, r1) if isinstance(t, QDense) else t[r0:r1]


def _parse_rope_scaling(rs, ckpt_max=None):
    """HF ``rope_scaling`` -> the hashable LlamaConfig tuple: "llama3"
    (Llama-3.1/3.2), "linear" and "longrope"; "default" and None pass
    through.  Other schemes (yarn, dynamic) raise: ignoring them would load
    a checkpoint with wrong long-range attention."""
    if not rs:
        return None
    kind = str(rs.get("rope_type", rs.get("type", ""))).lower()
    if kind in ("", "default"):
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return ("llama3", float(rs["factor"]), float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
                int(rs["original_max_position_embeddings"]))
    if kind == "longrope":
        orig = int(rs["original_max_position_embeddings"])
        # The attention factor comes from the CHECKPOINT's context (HF's
        # max_position_embeddings), not the serving cap.
        af = rs.get("attention_factor")
        if af is None:
            scale = max(1.0, float(ckpt_max or orig) / orig)
            af = 1.0 if scale == 1.0 else math.sqrt(1.0 + math.log(scale) / math.log(orig))
        return ("longrope", tuple(float(f) for f in rs["short_factor"]), tuple(float(f) for f in rs["long_factor"]),
                orig, float(af))
    raise ValueError(f"unsupported rope_scaling type {kind!r} (supported: llama3, linear, longrope)")


def hf_config_to_llama(cfg_path: str, **overrides) -> LlamaConfig:
    """An HF ``config.json`` as a LlamaConfig (``overrides`` on top): the
    Llama family, Qwen2/3 (biases, head norms), Mistral's window, Gemma
    (GeGLU, ``(1 + w)`` norms, scaled embeddings), Gemma-2 (softcaps, an
    alternating window), Gemma-3 (local layers with their own RoPE), Phi-3,
    Mixtral and Qwen3-MoE, and bitsandbytes 4-bit ``quantization_config``."""
    with open(cfg_path) as f:
        hf = json.load(f)
    mtype = hf.get("model_type")
    kwargs = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=_parse_rope_scaling(hf.get("rope_scaling"), hf.get("max_position_embeddings")),
        num_experts=int(hf.get("num_local_experts") or hf.get("num_experts") or 1),
        experts_per_token=int(hf.get("num_experts_per_tok", 2) or 2),
        # HF norm_topk_prob (Qwen-MoE); absent: Mixtral's renormalization.
        moe_norm_topk=bool(hf.get("norm_topk_prob", True)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        attn_bias=bool(hf.get("attention_bias", False)) or mtype == "qwen2",
        qk_norm=mtype in ("qwen3", "qwen3_moe"),
        max_seq_len=min(int(hf.get("max_position_embeddings", 2048)), 8192),
        sliding_window=int(hf["sliding_window"]) if hf.get("sliding_window") else None,
    )
    act = hf.get("hidden_act") or hf.get("hidden_activation") or ""
    is_gemma = mtype in ("gemma", "gemma2", "gemma3", "gemma3_text")
    if mtype in ("gemma3", "gemma3_text"):
        # 5 local layers per global one; local layers at
        # rope_local_base_freq unscaled, global ones at rope_theta with the
        # config's scaling; q/k head norms, no softcaps, four-norm blocks.
        kwargs.update(
            sliding_window_pattern=int(hf.get("sliding_window_pattern", 6)),
            rope_local_theta=float(hf.get("rope_local_base_freq", 10000.0)),
            qk_norm=True,
            query_pre_attn_scalar=float(hf["query_pre_attn_scalar"]) if hf.get("query_pre_attn_scalar") else None,
        )
    if mtype == "gemma2":
        def capval(key, default):
            # Present but null or 0 means disabled; the default applies
            # only when the key is absent.
            if key in hf:
                return float(hf[key]) if hf[key] else None
            return default

        qpas = hf.get("query_pre_attn_scalar", hf["hidden_size"] / hf["num_attention_heads"])
        kwargs.update(
            attn_logit_softcapping=capval("attn_logit_softcapping", 50.0),
            final_logit_softcapping=capval("final_logit_softcapping", 30.0),
            query_pre_attn_scalar=float(qpas) if qpas else None,
            sliding_window_pattern=2,  # local and global layers alternate
        )
    if is_gemma or "gelu" in act:
        # gelu_pytorch_tanh / gelu_tanh / gelu_new / gelu_fast are tanh
        # approximations; bare gelu / gelu_python the exact erf form; any
        # other gelu name raises rather than swapping approximations.
        if is_gemma or act in ("gelu_pytorch_tanh", "gelu_tanh", "gelu_new", "gelu_fast"):
            activation = "gelu_tanh"
        elif act in ("gelu", "gelu_python"):
            activation = "gelu"
        else:
            raise ValueError(f"unsupported hidden_act {act!r}")
        kwargs.update(activation=activation, rmsnorm_one_plus=is_gemma, scale_embeddings=is_gemma)
    if kwargs["num_experts"] > 1:
        # Qwen3-MoE: the expert width is moe_intermediate_size.  Shared
        # experts and mixed dense/sparse stacks are not supported: they
        # raise rather than load wrongly (or wait for expert keys forever).
        if hf.get("moe_intermediate_size"):
            kwargs["intermediate_size"] = int(hf["moe_intermediate_size"])
        if hf.get("shared_expert_intermediate_size"):
            raise ValueError("shared-expert MoE (Qwen2-MoE style) is not supported")
        if hf.get("mlp_only_layers"):
            raise ValueError("mixed dense/sparse layer stacks (mlp_only_layers) are not supported")
        if int(hf.get("decoder_sparse_step", 1) or 1) != 1:
            raise ValueError("mixed dense/sparse layer stacks (decoder_sparse_step > 1) are not supported")
    # Pre-quantized checkpoints: transformers records the bitsandbytes
    # setup here; bnb_4bit_quant_type defaults to bitsandbytes' "fp4".
    qc = hf.get("quantization_config")
    if qc:
        method = str(qc.get("quant_method", "bitsandbytes")).lower()
        if method != "bitsandbytes":
            raise ValueError(f"unsupported quantization_config quant_method {method!r} "
                             "(only bitsandbytes 4-bit checkpoints are supported)")
        if qc.get("load_in_8bit") or qc.get("_load_in_8bit"):
            raise ValueError("bitsandbytes 8-bit (LLM.int8) checkpoints are not supported — only 4-bit (nf4/fp4)")
        if not (qc.get("load_in_4bit") or qc.get("_load_in_4bit")):
            raise ValueError("quantization_config is present but load_in_4bit is not set; cannot tell how the "
                             "checkpoint was quantized")
        kwargs["quant_type"] = str(qc.get("bnb_4bit_quant_type") or "fp4").lower()
    kwargs.update(overrides)
    return LlamaConfig(**kwargs)


def _iter_safetensors(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, CPU tensor) over the directory's ``*.safetensors`` files, in
    file-name order."""
    safe_open = _safetensors("safetensors").safe_open
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    for fname in files:
        with safe_open(os.path.join(model_dir, fname), framework="pt") as f:
            for key in f.keys():
                yield key, f.get_tensor(key)


_HF_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.(.+)")
# Mixtral's experts (w1 = gate, w3 = up, w2 = down) and Qwen3-MoE's.
_HF_EXPERT_RE = re.compile(r"block_sparse_moe\.experts\.(\d+)\.w([123])\.weight")
_EXPERT_W = {"1": "w_gate", "2": "w_down", "3": "w_up"}
_HF_QWEN_EXPERT_RE = re.compile(r"mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight")

_HF_TO_OURS = {
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "mlp.gate_proj.weight": "w_gate",
    "mlp.up_proj.weight": "w_up",
    "mlp.down_proj.weight": "w_down",
    "block_sparse_moe.gate.weight": "router",  # Mixtral
    "mlp.gate.weight": "router",  # Qwen3-MoE
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_attn_norm",
    "self_attn.q_proj.bias": "bq",
    "self_attn.k_proj.bias": "bk",
    "self_attn.v_proj.bias": "bv",
}
_BIAS_KEYS = {"bq", "bk", "bv"}
# Gemma-2/3's four norms: HF's post_attention_layernorm is the attention
# OUTPUT norm there, and pre_feedforward_layernorm is what this layout calls
# post_attn_norm (the MLP's input norm).
_GEMMA2_NORMS = {
    "post_attention_layernorm.weight": "post_attn_out_norm",
    "pre_feedforward_layernorm.weight": "post_attn_norm",
    "post_feedforward_layernorm.weight": "post_ffw_norm",
}


def _required(cfg: LlamaConfig, gemma2: bool) -> set:
    """The names a layer must have before it is quantized."""
    required = set(_HF_TO_OURS.values())
    if not cfg.attn_bias:
        required -= _BIAS_KEYS
    if gemma2:
        required |= {"post_attn_out_norm", "post_ffw_norm"}
    if not cfg.qk_norm:
        required -= {"q_norm", "k_norm"}
    if cfg.num_experts > 1:
        required -= {"w_gate", "w_up", "w_down"}
        required |= {f"expert{e}.{w}" for e in range(cfg.num_experts) for w in ("w_gate", "w_up", "w_down")}
    else:
        required -= {"router"}
    return required


def _layer_pieces(sub: str, tensor, cfg: LlamaConfig, gemma2: bool):
    """A layer tensor's name(s) in this layout: {name: tensor}, Phi-3's
    fused ``qkv_proj`` / ``gate_up_proj`` split by rows; None when the
    tensor is not one the model uses."""
    if gemma2 and sub in _GEMMA2_NORMS:
        return {_GEMMA2_NORMS[sub]: tensor}
    ours = _HF_TO_OURS.get(sub)
    if ours is None:
        me = _HF_EXPERT_RE.match(sub)
        if me:
            ours = f"expert{int(me.group(1))}.{_EXPERT_W[me.group(2)]}"
        else:
            me = _HF_QWEN_EXPERT_RE.match(sub)
            if me:
                ours = f"expert{int(me.group(1))}.w_{me.group(2)}"
    if ours is not None:
        return {ours: tensor}
    if sub == "self_attn.qkv_proj.weight":
        q, kv = cfg.q_dim, cfg.kv_dim
        return {"wq": _rows(tensor, 0, q), "wk": _rows(tensor, q, q + kv), "wv": _rows(tensor, q + kv, tensor.shape[0])}
    if sub == "mlp.gate_up_proj.weight":
        inter = tensor.shape[0] // 2
        return {"w_gate": _rows(tensor, 0, inter), "w_up": _rows(tensor, inter, tensor.shape[0])}
    return None


def load_hf_llama(model_dir: str, cfg: LlamaConfig | None = None, stats: Dict | None = None,
                  device=None) -> Tuple[LlamaParams, LlamaConfig]:
    """Load a local HF checkpoint directory and quantize it to 4 bits on
    ``device`` (default ``cuda``), STREAMING: each layer is quantized (and
    its dense tensors freed) as soon as its last tensor has been read, so
    the host holds one dense layer at a time beside the embedding, the
    lm_head and the norms, never the whole dense checkpoint.

    ``cfg`` defaults to :func:`hf_config_to_llama` of the directory's
    ``config.json``.  Tied embeddings: without an ``lm_head.weight`` the
    embedding serves as the lm_head.  ``stats``, when given, gets
    ``peak_dense_bytes`` (the most bytes of dense layer tensors held at
    once) and ``total_dense_bytes``: the bounded-memory contract, counted
    as the JAX package counts it.  Incomplete bnb groups and missing layer
    tensors raise."""
    if cfg is None:
        cfg = hf_config_to_llama(os.path.join(model_dir, "config.json"))
    dev = resolve_device(device)
    # Four-norm blocks go with either Gemma-2 marker (a checkpoint may turn
    # the softcaps off, but it always alternates attention).
    gemma2 = cfg.attn_logit_softcapping is not None or cfg.sliding_window_pattern > 1
    required = _required(cfg, gemma2)

    layer_weights: Dict[int, dict] = {}
    built: Dict[int, LayerParams] = {}
    top = {}  # embed, final_norm, lm_head
    count = dict(dense=0, peak=0, total=0)

    def route(key, tensor):
        """One logical tensor (dense, or a QDense decoded from a bnb
        sidecar group) to its slot."""
        if key == "model.embed_tokens.weight":
            if isinstance(tensor, QDense):
                raise ValueError("quantized embeddings are not supported")
            top["embed"] = tensor
            return
        if key in ("model.norm.weight", "lm_head.weight"):
            top["final_norm" if key == "model.norm.weight" else "lm_head"] = tensor
            return
        m = _HF_LAYER_RE.match(key)
        if not m:
            return
        idx = int(m.group(1))
        pieces = _layer_pieces(m.group(2), tensor, cfg, gemma2)
        if pieces is None or idx >= cfg.num_layers:
            return
        lw = layer_weights.setdefault(idx, {})
        lw.update(pieces)
        count["dense"] += tensor.nbytes
        count["total"] += tensor.nbytes
        count["peak"] = max(count["peak"], count["dense"])
        if required <= set(lw):
            # The layer is complete: quantize it now and free its tensors.
            built[idx] = quantize_layer(lw, cfg, dev)
            count["dense"] -= tensor.nbytes + sum(a.nbytes for name, a in lw.items() if name not in pieces)
            del layer_weights[idx]

    # A bnb Linear arrives as a packed uint8 ".weight" and its sidecars,
    # possibly across files: grouped, and routed once complete.
    pending: Dict[str, BnbWeightGroup] = {}

    def bnb_add(base, part, tensor):
        group = pending.setdefault(base, BnbWeightGroup(base))
        group.add(part, tensor)
        if group.complete():
            del pending[base]
            route(base, qdense_from_group(group))

    for key, tensor in _iter_safetensors(model_dir):
        side = is_bnb_sidecar(key)
        if side is not None:
            bnb_add(side[0], side[1], tensor)
        elif tensor.dtype == torch.uint8 and key.endswith(".weight"):
            bnb_add(key, "weight", tensor)
        else:
            route(key, tensor)

    if pending:
        raise ValueError(f"incomplete bitsandbytes weight groups (missing sidecar tensors): {sorted(pending)[:4]}")
    if "embed" not in top or "final_norm" not in top:
        raise ValueError(f"checkpoint at {model_dir} missing embed/final norm")
    missing = sorted(set(range(cfg.num_layers)) - set(built))
    if missing:
        have = set(layer_weights.get(missing[0], {}))
        raise ValueError(f"layer {missing[0]} missing tensors: {sorted(required - have)}")
    if stats is not None:
        stats["peak_dense_bytes"] = count["peak"]
        stats["total_dense_bytes"] = count["total"]

    embed = top["embed"].to(dev, cfg.dtype)
    lm_head = top.get("lm_head")
    if lm_head is None and not cfg.quantize_lm_head:
        lm_head = embed  # tied embeddings: one tensor serves both
    else:
        lm_head = _lm_head(top["embed"] if lm_head is None else lm_head, cfg, dev)
    params = LlamaParams(embed=embed, layers=[built[i] for i in range(cfg.num_layers)],
                         final_norm=top["final_norm"].to(dev, torch.float32), lm_head=lm_head)
    return params, cfg
