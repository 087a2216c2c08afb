"""The port's quantization CLI (``python -m nf4_tpu_torch.quantize``) on the
CPU (``--force-cpu``) against the JAX package's (``nf4_tpu.quantize``) on
the same tiny HF directories (dense, and bnb NF4): the packed file it
writes holds the arrays and metadata the JAX CLI's file holds, byte for
byte (the archives' own bytes differ only in the zip entries' times), and
both packages' ``load_packed_auto`` read it."""

import json

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("safetensors")
from test_torch_hf_loader import write_checkpoint  # noqa: E402

from nf4_tpu.models import loader as jloader  # noqa: E402
from nf4_tpu.quantize import main as jax_main  # noqa: E402
from nf4_tpu_torch.models import loader  # noqa: E402
from nf4_tpu_torch.quantize import main  # noqa: E402


def _arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("bnb", [None, ("nf4", True)])
def test_quantize_cli_writes_the_jax_clis_file(tmp_path, capsys, bnb):
    src = write_checkpoint(tmp_path / "hf", "llama3", np.float16, bnb=bnb, shards=2)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    assert main(["--hf-dir", src, "--out", ours, "--force-cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu" and report["quant_type"] == "nf4" and report["peak_dense_bytes"] > 0
    assert jax_main(["--hf-dir", src, "--out", theirs]) == 0
    got, want = _arrays(ours), _arrays(theirs)
    assert sorted(got) == sorted(want)
    meta, jmeta = (json.loads(bytes(a["__meta__"]).decode()) for a in (got, want))
    assert meta == jmeta
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key

    params, cfg = loader.load_packed_auto(ours, device="cpu")
    jparams, jcfg = jloader.load_packed_auto(ours)
    assert cfg.num_layers == jcfg.num_layers == 2
    np.testing.assert_array_equal(params.layers[1].w_down.packed.numpy(),
                                  np.asarray(jax.tree.map(lambda x: x[1], jparams.layers).w_down.packed))


def test_quantize_cli_refuses(tmp_path):
    src = write_checkpoint(tmp_path / "hf", "llama3")
    with pytest.raises(SystemExit, match="not ported yet"):
        main(["--hf-dir", src, "--out", str(tmp_path / "x.npz"), "--tp", "2"])
    if not torch.cuda.is_available():  # the card by default, never a quiet CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--hf-dir", src, "--out", str(tmp_path / "x.npz")])
