"""Guards of the port: no JAX inside it, no device fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_llama_tpu_torch.ops import cuda_attention, cuda_build, cuda_q40
from distributed_llama_tpu_torch.quants.torch_codec import QuantizedTensor
from distributed_llama_tpu_torch.runtime.engine import Engine, resolve_device
from distributed_llama_tpu_torch.testing import tiny_spec

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "distributed_llama_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where `import jax`
    (and the JAX package) fails."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', "
        "'distributed_llama_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') for k in sys.modules)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_import_names_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "distributed_llama_tpu"), \
                f"{path}: imports {n}"


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tiny_spec(), {"tok_emb": torch.zeros(1), "layers": []})
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_raise_off_cpu_instead_of_falling_back():
    """A tensor on a non-CPU device is never handed to the plain version:
    the wrapper launches the kernel or raises."""
    x = torch.empty((1, 64), device="meta")
    w = QuantizedTensor(torch.empty((8, 32), dtype=torch.uint8, device="meta"),
                        torch.empty((8, 2), dtype=torch.float16, device="meta"))
    before = cuda_q40.q40_matmul.launches
    with pytest.raises(ValueError, match="no kernel"):
        cuda_q40.q40_matmul(x, w)
    q = torch.empty((1, 1, 2, 16), device="meta")
    kv = torch.empty((1, 2, 8, 16), device="meta")
    pos = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_attention.flash_attention(q, kv, kv, pos)
    assert cuda_q40.q40_matmul.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing drops back to the plain version."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()


def test_kernel_sources_exist_and_export_c_entries():
    for name, entry in (("q40_matmul", "q40_matmul_launch"),
                        ("flash_attention", "flash_attention_launch")):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {entry}(' in src
        assert "cudaGetLastError()" in src
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


@pytest.mark.parametrize("kwargs,needle", [
    (dict(cache_dtype=torch.float8_e4m3fn), "not ported"),
    (dict(compute_dtype=torch.float16), "compute_dtype"),
])
def test_engine_refuses_unported_dtypes(kwargs, needle):
    params = {"tok_emb": torch.zeros(1), "layers": []}
    with pytest.raises(ValueError, match=needle):
        Engine(tiny_spec(), params, device="cpu", **kwargs)
