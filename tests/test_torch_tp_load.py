"""Shard-on-read loading (``load_packed_sharded``) and packing for tensor
parallelism (``python -m nf4_tpu_torch.quantize --tp``) on the CPU, held
against the JAX package's: each rank's slices are the shards the JAX
loader puts on the device of the same tensor-parallel coordinate (the
setup of ``tests/test_sharded_load.py``), read in 1/tp slices; the ranks
serve the loaded slices as one device serves the whole checkpoint; the
CLI's ``--tp 4`` file holds the JAX CLI's bytes."""

import json

import jax
import numpy as np
import pytest
import torch

import _torch_dist as td
from nf4_tpu.models import loader as jloader
from nf4_tpu.parallel import mesh as jmesh
from nf4_tpu.quantize import main as jax_main
from nf4_tpu_torch.models import configs, llama, loader
from nf4_tpu_torch.parallel.launch import Ranks
from nf4_tpu_torch.parallel.mesh import Mesh
from nf4_tpu_torch.quantize import main
from nf4_tpu_torch.serve.engine import Engine
from _torch_threads import _one_thread  # noqa: F401

pytest.importorskip("safetensors")
TP = 4
CPU = torch.device("cpu")


def _mesh(rank, tp=TP):
    return Mesh(tp=tp, dp=1, rank=rank, tp_rank=rank, dp_rank=0, tp_group=None, dp_group=None, device=CPU,
                backend="gloo")


@pytest.fixture(scope="module")
def ranks():
    with Ranks(TP, backend="gloo", device="cpu", threads=1) as r:
        yield r


@pytest.fixture(scope="module", params=["safetensors", "npz"])
def ckpt(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / f"tiny_tp.{request.param}")
    loader.save_packed(path, llama.init_params(configs.TINY_TP, seed=0, device=CPU), configs.TINY_TP)
    return path


def _port_leaves(params):
    """{JAX leaf path: per-layer numpy arrays (or one)} of the port's params."""
    out = {"embed": [params.embed], "final_norm": [params.final_norm]}
    head = params.lm_head
    out.update({"lm_head.packed": [head.packed], "lm_head.scales": [head.scales]} if hasattr(head, "packed")
               else {"lm_head": [head]})
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        ws = [getattr(lp, name) for lp in params.layers]
        out[f"layers.{name}.packed"] = [w.packed for w in ws]
        out[f"layers.{name}.scales"] = [w.scales for w in ws]
    for name in ("input_norm", "post_attn_norm"):
        out[f"layers.{name}"] = [getattr(lp, name) for lp in params.layers]
    return {k: [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy() for t in v] for k, v in out.items()}


def test_slices_match_the_jax_loaders_shards(ckpt):
    jm = jmesh.make_mesh(tp=TP, dp=2)
    jparams, jcfg = jloader.load_packed_sharded(ckpt, jm)
    for rank in range(TP):
        stats = {}
        params, cfg = loader.load_packed_sharded(ckpt, _mesh(rank), read_stats=stats)
        assert cfg == configs.TINY_TP
        want = {p: [a] for p, a in _jax_leaves(jparams, jm, rank).items()}
        got = _port_leaves(params)
        assert sorted(got) == sorted(want)
        for key, arrays in got.items():
            (shard,) = want[key]
            stacked = np.stack(arrays) if key.startswith("layers.") else arrays[0]
            np.testing.assert_array_equal(stacked, shard, err_msg=key)
        wqkv, wo = params.layers[0].wqkv, params.layers[0].wo
        assert wqkv.shape == (2048 // TP, 256) and wqkv.padded_shape == (512, 1024) and wqkv.packed.is_contiguous()
        assert wo.shape == (256, 1024 // TP) and wo.shards == 1 and wo.padded_shape == (256, 1024)
        # The tp-sharded tensors are read in 1/tp slices of their sharded axis.
        (idx,) = stats["layers.wqkv.packed"]
        assert idx[-1] == slice(rank * 512, (rank + 1) * 512)
        (idx,) = stats["layers.wo.packed"]  # [L, 4 chunks x 512 byte rows, 256]: the rank's chunk
        assert idx == (slice(None), slice(rank * 512, (rank + 1) * 512))
        assert len(stats["embed"]) == 1 and stats["embed"][0] == (slice(None),) * 2


def _jax_leaves(params, mesh, rank):
    dev = mesh.devices[0, rank]
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        key = ".".join(str(getattr(p, "name", getattr(p, "key", p))) for p in path)
        shard = next(s for s in leaf.addressable_shards if s.device == dev)
        data = np.asarray(shard.data)
        out[key] = data.astype(np.float32) if data.dtype.name == "bfloat16" else data
    return out


def test_ranks_serve_the_sharded_load(ranks, ckpt):
    """Four ranks serve their slices of the checkpoint as one device serves
    the whole of it; a checkpoint packed for 4 refuses a mesh of 2."""
    prompts = [[3, 5, 7], [11, 13, 17, 19]]
    params, cfg = loader.load_packed_auto(ckpt, device=CPU)
    want = [r.tokens for r in Engine(params, cfg, batch_size=2, eos_token=-1, device=CPU).generate(prompts, 6)]
    every = ranks.run(td.load_serve, ckpt, prompts, 6, tp=TP)
    assert all(t == want for t in every)
    with pytest.raises(ValueError, match="tp_shards=4"):
        loader.load_packed_sharded(ckpt, _mesh(0, tp=2))


def _hf_dir(path, seed=0):
    """A dense HF Llama directory of TINY_TP's shapes (2 layers, fp32)."""
    from safetensors.numpy import save_file

    cfg = configs.TINY_TP
    rng = np.random.default_rng(seed)
    path.mkdir()
    hf = dict(model_type="llama", vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
              intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              rope_theta=10000.0, rms_norm_eps=1e-5, max_position_embeddings=cfg.max_seq_len)
    (path / "config.json").write_text(json.dumps(hf))
    h, q, kv, inter = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size

    def w(m, n):
        return (rng.standard_normal((m, n)) * n**-0.5).astype(np.float32)

    t = {"model.embed_tokens.weight": w(cfg.vocab_size, h), "model.norm.weight": np.ones(h, np.float32),
         "lm_head.weight": w(cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t.update({p + "self_attn.q_proj.weight": w(q, h), p + "self_attn.k_proj.weight": w(kv, h),
                  p + "self_attn.v_proj.weight": w(kv, h), p + "self_attn.o_proj.weight": w(h, q),
                  p + "mlp.gate_proj.weight": w(inter, h), p + "mlp.up_proj.weight": w(inter, h),
                  p + "mlp.down_proj.weight": w(h, inter), p + "input_layernorm.weight": np.ones(h, np.float32),
                  p + "post_attention_layernorm.weight": np.ones(h, np.float32)})
    save_file(t, str(path / "model.safetensors"))
    return str(path)


def test_quantize_cli_tp4_writes_the_jax_clis_file(tmp_path, capsys):
    src = _hf_dir(tmp_path / "hf")
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    assert main(["--hf-dir", src, "--out", ours, "--force-cpu", "--tp", "4"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["tp_shards"] == 4
    assert jax_main(["--hf-dir", src, "--out", theirs, "--tp", "4"]) == 0
    with np.load(ours, allow_pickle=False) as a, np.load(theirs, allow_pickle=False) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    params, cfg = loader.load_packed_sharded(ours, _mesh(1))
    assert cfg.tp_shards == 4 and params.layers[1].w_down.shape == (256, 512 // 4)
