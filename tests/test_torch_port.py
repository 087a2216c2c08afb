"""The port stands alone: nf4_tpu_torch imports neither JAX, Flax, optax,
ml_dtypes nor anything of nf4_tpu, and builds no kernel at import time."""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "nf4_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "ml_dtypes", "nf4_tpu")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(PKG)) if p.is_relative_to(PKG) else p.name,
)
def test_sources_import_nothing_of_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_import_loads_no_jax_and_builds_nothing():
    """A fresh interpreter importing every module of the port has no JAX
    module loaded afterwards and has started no compiler."""
    code = (
        "import sys, importlib, pkgutil, nf4_tpu_torch\n"
        "for m in pkgutil.walk_packages(nf4_tpu_torch.__path__, 'nf4_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from nf4_tpu_torch.ops import _cuda\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'ml_dtypes', 'nf4_tpu')]\n"
        "assert not bad, bad\n"
        "assert sorted(_cuda.KERNELS) == ['dequant_t', 'dequant_t_fast', 'flash_attention',"
        " 'flash_attention_int8', 'int8_matmul', 'matmul_bf16', 'matmul_exact'], _cuda.KERNELS\n"
        "assert set(_cuda.launch_counts().values()) == {0}\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PKG.parent, timeout=120)
