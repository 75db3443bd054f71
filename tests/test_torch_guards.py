"""Guards of the port: no JAX inside it, no device fallback."""

import ast
import ctypes
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import (cuda_attention, cuda_build,
                                             cuda_probes, cuda_q40, cuda_q80)
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


def test_card_by_default_entry_points_raise_without_a_card(monkeypatch):
    """load_params, params_from_jax and KVCache.create put their tensors on
    `cuda` unless asked for the CPU: with no card they raise."""
    from distributed_llama_tpu_torch.models.convert import params_from_jax
    from distributed_llama_tpu_torch.models.params import (load_params,
                                                           random_tensors)
    from distributed_llama_tpu_torch.models.transformer import KVCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tiny_spec()
    host = random_tensors(spec, seed=0)
    for call in (lambda: load_params(spec, host),
                 lambda: params_from_jax(
                     {"layers": [{}] * spec.n_layers}, spec),
                 lambda: KVCache.create(spec, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert KVCache.create(spec, 1, device="cpu").k[0].device.type == "cpu"


def test_kernel_wrappers_raise_off_cpu_instead_of_falling_back():
    """A tensor on a non-CPU device is never handed to the plain version:
    the wrapper launches the kernel or raises."""
    x = torch.empty((1, 64), device="meta")
    w = QuantizedTensor(torch.empty((8, 32), dtype=torch.uint8, device="meta"),
                        torch.empty((8, 2), dtype=torch.float16, device="meta"))
    before = cuda_q40.q40_matmul.launches
    with pytest.raises(ValueError, match="no kernel"):
        cuda_q40.q40_matmul(x, w)
    stack = QuantizedTensor(
        torch.empty((4, 8, 32), dtype=torch.uint8, device="meta"),
        torch.empty((4, 8, 2), dtype=torch.float16, device="meta"))
    idx = torch.zeros((2,), dtype=torch.int32, device="meta")
    before_k2 = cuda_q40.q40_expert_matmul.launches
    with pytest.raises(ValueError, match="no kernel"):
        cuda_q40.q40_expert_matmul(x, stack, idx)
    q = torch.empty((1, 1, 2, 16), device="meta")
    kv = torch.empty((1, 2, 8, 16), device="meta")
    pos = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_attention.flash_attention(q, kv, kv, pos)
    kv8 = torch.empty((1, 2, 8, 16), dtype=torch.float8_e4m3fn, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_attention.flash_attention(q, kv8, kv8, pos)
    assert cuda_q40.q40_matmul.launches == before
    assert cuda_q40.q40_expert_matmul.launches == before_k2


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing drops back to the plain version."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()


def test_kernel_sources_exist_and_export_c_entries():
    for name, entry in (("q40_matmul", "q40_matmul_launch"),
                        ("q40_matmul", "q40_expert_matmul_launch"),
                        ("flash_attention", "flash_attention_launch")):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {entry}(' in src
        assert "cudaGetLastError()" in src
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


@pytest.mark.parametrize("kwargs,needle", [
    (dict(cache_dtype=torch.float16), "not ported"),
    (dict(compute_dtype=torch.float16), "compute_dtype"),
])
def test_engine_refuses_unported_dtypes(kwargs, needle):
    params = {"tok_emb": torch.zeros(1), "layers": []}
    with pytest.raises(ValueError, match=needle):
        Engine(tiny_spec(), params, device="cpu", **kwargs)


def test_import_guards_cover_the_probes():
    """The blocked-jax import test and the per-file import scan walk the
    whole package: the probe tools and their kernel module are in it."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"ops/cuda_probes.py", "tools/__init__.py", "tools/timing.py",
            "tools/kernel_ladder.py", "tools/kernel_experiments.py",
            "tools/exp_int8_dot.py", "tools/exp_f8_flash.py",
            "tools/exp_pk_decode.py", "tools/exp_scale_f16.py",
            "tools/exp_unpack_overlap.py"} <= files


def test_probe_tool_module_raises_without_a_card():
    """`python -m ...tools.kernel_ladder` runs on cuda unless told otherwise:
    with no card it raises instead of running on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch.tools.kernel_ladder"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "MB/pass" not in res.stdout


@pytest.mark.parametrize("tool", ["exp_f8_flash", "exp_pk_decode", "exp_scale_f16",
                                  "exp_unpack_overlap", "k1_plans"])
def test_probe_tool_modules_raise_without_a_card(tool):
    """Each later probe tool runs on cuda unless told otherwise: with no
    card its `python -m` entry raises instead of running on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run(
        [sys.executable, "-m", f"distributed_llama_tpu_torch.tools.{tool}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "MB/pass" not in res.stdout


# lines a tool prints beside its pass lines on the CPU: the TPU tools'
# result lines that need no timing (exactness, relative error), or say
# that the timed ones were not measured
RESULT_LINES = {"exp_f8_flash": 5, "exp_pk_decode": 2, "exp_scale_f16": 1,
                "exp_unpack_overlap": 1}


@pytest.mark.parametrize("tool,small", [
    ("kernel_ladder", dict(L=2, H=16, D=64)),
    ("kernel_experiments", dict(L=2, H=16, D=64)),
    ("exp_int8_dot", dict(L=2, D=16, K=64)),
    ("exp_f8_flash", dict(KVH=2, S=512, FILL=300)),
    ("exp_pk_decode", dict(SHAPES=(("w1", 64, 256, 256), ("attn", 32, 256, 1024)))),
    ("exp_scale_f16", dict(L=2, D_OUT=32, D_IN=256)),
    ("exp_unpack_overlap", dict(D=128, N=256, T=16)),
])
def test_probe_tools_need_a_card_unless_asked_for_the_cpu(tool, small, monkeypatch,
                                                          capsys):
    """The tools' shapes are module constants, cut here to a few rows; on
    the CPU each pass runs its plain versions once, untimed."""
    import importlib

    mod = importlib.import_module(f"distributed_llama_tpu_torch.tools.{tool}")
    for name, value in small.items():
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    rows = mod.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    pass_lines = [ln for ln in lines if "MB/pass" in ln]
    assert len(pass_lines) == len(rows) >= 2
    assert len(lines) == len(rows) + RESULT_LINES.get(tool, 0)
    assert all("cpu" in ln for ln in pass_lines)
    assert all("TB/s" not in ln and "TFLOP/s" not in ln for ln in lines)
    assert all(r["ms"] is None and r["bytes"] > 2 * 16 * 64 // 2 for r in rows)


def test_probe_wrappers_raise_off_cpu_instead_of_falling_back():
    w = QuantizedTensor(torch.empty((8, 32), dtype=torch.uint8, device="meta"),
                        torch.empty((8, 2), dtype=torch.float32, device="meta"))
    x = torch.empty((1, 64), device="meta")
    xb = torch.empty((1, 64), dtype=torch.bfloat16, device="meta")
    fns = (cuda_probes.q40_ladder, cuda_probes.q40_matmul_a,
           cuda_probes.q40_matmul_b, cuda_probes.int8_gemv)
    before = [f.launches for f in fns]
    with pytest.raises(ValueError, match="no kernel"):
        cuda_probes.q40_ladder("dot", x, w)
    for fn in (cuda_probes.q40_matmul_a, cuda_probes.q40_matmul_b):
        with pytest.raises(ValueError, match="no kernel"):
            fn(xb, w)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_probes.int8_gemv(torch.empty((1, 64), dtype=torch.int8, device="meta"),
                              w.packed, torch.empty((8, 1), device="meta"))
    with pytest.raises(ValueError, match="stage"):
        cuda_probes.q40_ladder("fma", x, w)
    assert [f.launches for f in fns] == before


def test_later_probe_wrappers_raise_off_cpu_instead_of_falling_back():
    """P2, P3, P5 and P6 on a non-CPU device: a raise, no plain version, no
    launch counted; an unknown mode raises too."""
    meta = functools.partial(torch.empty, device="meta")
    w16 = QuantizedTensor(meta((8, 128), dtype=torch.uint8), meta((8, 8), dtype=torch.float16))
    wu = QuantizedTensor(w16.packed, meta((8, 8), dtype=torch.uint16))
    q = meta((2, 1, 128), dtype=torch.bfloat16)
    k = meta((2, 64, 128), dtype=torch.uint8)
    pos = meta((1,), dtype=torch.int32)
    row = meta((1, 128))
    fns = (cuda_probes.f8_flash_decode, cuda_probes.q40_pk_gemv,
           cuda_probes.q40_matmul_scales, cuda_probes.q40_matmul_sub)
    before = [f.launches for f in fns]
    calls = [lambda: cuda_probes.f8_flash_decode("bits", pos, q, k, k),
             lambda: cuda_probes.q40_pk_gemv("pk", row, row, meta((1, 8)), w16),
             lambda: cuda_probes.q40_matmul_scales(meta((1, 256)), wu),
             lambda: cuda_probes.q40_matmul_sub(meta((16, 256), dtype=torch.bfloat16),
                                                w16, 2, 64)]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel"):
            call()
    with pytest.raises(ValueError, match="mode"):
        cuda_probes.f8_flash_decode("e5m2", pos, q, k, k)
    with pytest.raises(ValueError, match="mode"):
        cuda_probes.q40_pk_gemv("mask", row, row, meta((1, 8)), w16)
    assert [f.launches for f in fns] == before


def test_probe_source_exports_c_entries():
    # built on their own: the engine's first launch never compiles them
    assert cuda_build.PROBES == ("q40_probes", "q40_gemv1_probes", "f8_flash_probe",
                                 "q40_prefill_probe")
    assert not set(cuda_build.PROBES) & set(cuda_build.KERNELS)
    entries = {"q40_probes": ("q40_ladder_launch", "q40_matmul_a_launch",
                              "q40_matmul_b_launch", "int8_gemv_launch"),
               "q40_gemv1_probes": ("q40_pk_gemv_launch", "q40_matmul_scales_launch",
                                    "q40_gemv1_probe_launch", "q40_gemv1_probe_plan",
                                    "q40_gemv1_probe_attrs"),
               "f8_flash_probe": ("f8_flash_decode_launch", "f8_flash_plan",
                                  "f8_flash_decode_attrs"),
               "q40_prefill_probe": ("q40_matmul_sub_launch", "q40_matmul_sub_attrs")}
    for name, names in entries.items():
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        for entry in names:
            assert f'extern "C" int {entry}(' in src
        assert "cudaGetLastError()" in src
    assert "__dp4a" in (cuda_build.CSRC / "q40_probes.cu").read_text()
    # P3 and P5: K1's t = 1 GEMV design, the operand into the magic constant
    # by a LOP3 or (pk's byte) a PRMT, no int-to-float convert
    g1 = (cuda_build.CSRC / "q40_gemv1_probes.cu").read_text()
    assert "lop3.b32" in g1 and "__byte_perm" in g1 and "0x4B000000u" in g1
    assert "__int2float" not in g1 and "__uint2float" not in g1
    f8 = (cuda_build.CSRC / "f8_flash_probe.cu").read_text()
    assert "__nv_cvt_fp8x2_to_halfraw2" in f8 and "mma.sync" in f8 and "cp.async.cg" in f8
    # P6: SS wgmma fed by a TMA ring, the -8 correction as tf32 wgmma
    sub = (cuda_build.CSRC / "q40_prefill_probe.cu").read_text()
    assert "wgmma.mma_async" in sub and ".tf32.tf32" in sub and "cp.async.bulk.tensor" in sub


def test_q80_roundtrip_raises_off_cpu_instead_of_falling_back():
    """The Q80 round trip on a non-CPU device: a raise, no plain version,
    no launch counted; a width that is not whole Q80 blocks raises too."""
    before = cuda_q80.q80_roundtrip.launches
    with pytest.raises(ValueError, match="no kernel"):
        cuda_q80.q80_roundtrip(torch.empty((2, 64), device="meta"), torch.float32)
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_q80.q80_roundtrip(torch.empty((2, 48)), torch.float32)
    assert cuda_q80.q80_roundtrip.launches == before


def test_q80_and_wgmma_sources_export_c_entries():
    """q80_roundtrip.cu is an engine kernel (built with K1-K3) and exports
    its C entry; K1's source has the wgmma path, its TMA maps and the plan
    export the tests mirror."""
    assert "q80_roundtrip" in cuda_build.KERNELS
    src = (cuda_build.CSRC / "q80_roundtrip.cu").read_text()
    assert 'extern "C" int q80_roundtrip_launch(' in src
    assert "cudaGetLastError()" in src and "__float2int_rn" in src
    k1 = (cuda_build.CSRC / "q40_matmul.cu").read_text()
    assert 'extern "C" int q40_matmul_tc_plan(' in k1
    assert 'extern "C" int q40_matmul_mma_rows(' in k1
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor.2d", "setmaxnreg",
                   "mbarrier.try_wait", "barrier.cluster"):
        assert needle in k1
    # the prefill path is wgmma only; mma.sync is the small-batch GEMV's
    wgmma_kernel = k1.split("q40_matmul_wgmma_kernel(const", 1)[1].split(
        "// The small-batch GEMV on the tensor cores (q40_gemv_mma_kernel):", 1)[0]
    assert "mma.sync" not in wgmma_kernel
    assert "mma.sync.aligned.m16n8k16" in k1


class _FakeKernel:
    """A stand-in for a C entry point: records each call's arguments and
    returns the given cudaError_t."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


def test_fused_q80_wrappers_launch_at_t1_and_raise_above(monkeypatch):
    """K1's and K2's fused Q80 round trip, through their CUDA branches with
    the kernel library mocked: at t = 1 the launch passes q80 = 1 and counts
    one launch (and one fused); at t >= 2, on the card or the CPU, the
    wrappers raise before any launch; a launch the kernel refuses raises
    and counts nothing. Nothing falls back to a launch without the round
    trip."""
    import types

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    meta = functools.partial(torch.empty, device="meta")
    w = QuantizedTensor(meta((8, 32), dtype=torch.uint8), meta((8, 2), dtype=torch.float16))
    stack = QuantizedTensor(meta((4, 8, 32), dtype=torch.uint8),
                            meta((4, 8, 2), dtype=torch.float16))
    idx = meta((2,), dtype=torch.int32)

    def counts():
        return (cuda_q40.q40_matmul.launches, cuda_q40.q40_expert_matmul.launches,
                cuda_q40.q80_fused.launches)

    k1, k2 = _FakeKernel(), _FakeKernel()
    monkeypatch.setattr(cuda_q40, "_lib", lambda: k1)
    monkeypatch.setattr(cuda_q40, "_expert_lib", lambda: k2)
    before = counts()
    cuda_q40._launch(meta((1, 64)), w, torch.bfloat16, activation_q80=True)
    cuda_q40._expert_launch(meta((2, 1, 64)), stack, idx, torch.float32,
                            activation_q80=True)
    assert k1.calls[-1][11] == 1 and k2.calls[-1][13] == 1   # the q80 argument
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 2)
    cuda_q40._launch(meta((2, 64)), w, torch.bfloat16)           # unfused: q80 = 0
    assert k1.calls[-1][11] == 0 and counts()[2] == before[2] + 2

    before, n1, n2 = counts(), len(k1.calls), len(k2.calls)
    for call in (lambda: cuda_q40._launch(meta((2, 64)), w, torch.float32, activation_q80=True),
                 lambda: cuda_q40._expert_launch(meta((2, 64)), stack, idx, torch.float32,
                                                 activation_q80=True),
                 lambda: cuda_q40.q40_matmul(meta((1, 3, 64)), w, activation_q80=True),
                 lambda: cuda_q40.q40_matmul(torch.zeros((2, 64)), w, activation_q80=True),
                 lambda: cuda_q40.q40_expert_matmul(torch.zeros((2, 2, 64)), stack,
                                                    torch.zeros(2, dtype=torch.int32),
                                                    activation_q80=True)):
        with pytest.raises(ValueError, match="t = 1 only"):
            call()
    assert (len(k1.calls), len(k2.calls)) == (n1, n2) and counts() == before

    refuse = _FakeKernel(rc=1)   # cudaErrorInvalidValue
    monkeypatch.setattr(cuda_q40, "_lib", lambda: refuse)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        cuda_q40._launch(meta((1, 64)), w, torch.float32, activation_q80=True)
    assert counts() == before and len(refuse.calls) == 1


def _c_params(src: str, entry: str) -> list[str]:
    sig = src.split(f'extern "C" int {entry}(', 1)[1].split(")", 1)[0]
    return [" ".join(p.split()) for p in sig.split(",")]


def test_q40_entry_points_take_the_q80_argument(monkeypatch):
    """csrc/q40_matmul.cu exports K1's and K2's entry points with the q80
    argument before the stream, and the wrappers' ctypes argument lists
    match the C parameter lists one for one."""
    import types

    src = (cuda_build.CSRC / "q40_matmul.cu").read_text()
    fake = types.SimpleNamespace(q40_matmul_launch=types.SimpleNamespace(),
                                 q40_expert_matmul_launch=types.SimpleNamespace())
    monkeypatch.setattr(cuda_build, "load", lambda name: fake)
    for entry, lib in (("q40_matmul_launch", cuda_q40._lib),
                       ("q40_expert_matmul_launch", cuda_q40._expert_lib)):
        params = _c_params(src, entry)
        assert params[-2:] == ["int q80", "void* stream"]
        fn = lib.__wrapped__()   # past the cache: types the fake entry
        assert len(fn.argtypes) == len(params)
        assert fn.argtypes[-2:] == [ctypes.c_int, ctypes.c_void_p]
        assert "cudaErrorInvalidValue" in src.split(f'extern "C" int {entry}(', 1)[1][:600]


def test_import_guards_cover_the_compiled_decode_path():
    """The device sampler and the graph module are in the package the
    blocked-jax import test and the per-file import scan walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"ops/device_sampler.py", "runtime/graphs.py"} <= files


def _cpu_engine(**kw):
    from distributed_llama_tpu_torch.models.params import load_params, random_tensors

    spec = tiny_spec()
    params = load_params(spec, random_tensors(spec, seed=0), device="cpu")
    return Engine(spec, params, device="cpu",
                  compute_dtype=torch.float32, cache_dtype=torch.float32, **kw)


def test_cpu_engine_never_captures(monkeypatch):
    """On the CPU every step runs eagerly, cuda_graphs or not: capturing
    (or touching a CUDA graph at all) would raise here."""
    from distributed_llama_tpu_torch.runtime import engine as engine_mod

    def refuse(*a, **k):
        raise AssertionError("a CPU engine tried to capture a CUDA graph")
    monkeypatch.setattr(engine_mod, "capture", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    eng = _cpu_engine(cuda_graphs=True)
    assert eng.cuda_graphs is False
    eng.step(np.asarray([[3]], np.int32), 0)
    eng.decode_greedy_device(3, 4)
    eng.reset()
    eng.generate_device([1, 2], 4, temperature=0.8, topp=0.9, seed=1)
    assert eng.graphs == {}


def test_failed_capture_raises_without_eager_fallback(monkeypatch):
    """A graph engine whose capture fails raises from step(); it does not
    run the step eagerly instead (no launch counted, no position moved)."""
    from distributed_llama_tpu_torch.runtime import engine as engine_mod

    eng = _cpu_engine()
    eng.cuda_graphs = True          # as a CUDA engine would have it
    tried = []

    def fail(fn):
        tried.append(fn)
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(engine_mod, "capture", fail)
    monkeypatch.setattr(engine_mod, "forward", lambda *a, **k: pytest.fail("ran eagerly"))
    with pytest.raises(RuntimeError, match="capturing"):
        eng.step(np.asarray([[3]], np.int32), 0)
    assert len(tried) == 1 and eng.pos == 0 and eng.graphs == {}


def test_capture_tallies_launches_and_replays_count_them(monkeypatch):
    """graphs.capture with CUDA's graph API faked on the CPU: the warm-up's
    launches count (they run), the capture's are taken back (nothing runs)
    and kept as the tally, and each replay adds the tally, so counters stay
    exact under replay."""
    import contextlib
    import types

    from distributed_llama_tpu_torch.runtime import graphs

    replays = []

    class FakeGraph:
        def replay(self):
            replays.append(1)

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(graphs, "pool_bytes", lambda g: 0)

    def step():
        cuda_q40.q40_matmul.launches += 3
        cuda_q40.q80_fused.launches += 3
        cuda_attention.flash_attention.launches += 2
        return "logits"
    before = [c.launches for c in graphs.LAUNCH_COUNTERS]
    g = graphs.capture(step)
    warm = [c.launches - b for c, b in zip(graphs.LAUNCH_COUNTERS, before)]
    assert warm == [3, 0, 3, 2, 0, 0] and g.tally == (3, 0, 3, 2, 0, 0) and g.out == "logits"
    for _ in range(5):
        g.replay()
    assert len(replays) == 5
    assert [c.launches - b for c, b in zip(graphs.LAUNCH_COUNTERS, before)] == \
        [3 + 5 * 3, 0, 3 + 5 * 3, 2 + 5 * 2, 0, 0]
    assert graphs.LAUNCH_COUNTERS == (cuda_q40.q40_matmul, cuda_q40.q40_expert_matmul,
                                      cuda_q40.q80_fused, cuda_attention.flash_attention,
                                      cuda_q80.q80_roundtrip, cuda_q40.q40_gemv_mma)


def test_import_guards_cover_the_serving_path():
    """The serving slice's modules are in the package the blocked-jax
    import test and the per-file import scan walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"runtime/scheduler.py", "runtime/resilience.py", "runtime/faults.py",
            "runtime/trace.py", "runtime/profiler.py", "runtime/sampling.py",
            "runtime/stats.py", "apps/api_server.py"} <= files


def test_import_guards_cover_the_other_mesh_axes():
    """The other axes' modules (pp, ep, sp) are in the package the
    blocked-jax import test and the per-file import scan walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"parallel/pp.py", "parallel/ep_moe.py", "parallel/ring_attention.py",
            "parallel/mesh.py", "parallel/collectives.py"} <= files


def test_import_guards_cover_the_kv_reuse_path():
    """The KV-reuse slice's modules are in the package the blocked-jax
    import test and the per-file import scan walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"runtime/prefix_cache.py", "runtime/engine.py", "apps/dllama.py",
            "apps/api_server.py"} <= files


def test_import_guards_cover_the_fleet(tmp_path):
    """The fleet's modules are in the package the blocked-jax import test
    and the per-file import scan walk, and the worker entry point runs as
    `python -m` in a process where `import jax` (and the JAX package)
    fails: a config with no model exits 2 (config_error) from its main."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"runtime/router.py", "runtime/fleet.py", "runtime/replica_worker.py",
            "runtime/kv_transfer.py", "runtime/netstats.py",
            "ops/launch_scope.py"} <= files
    cfg = tmp_path / "bad.json"
    cfg.write_text("{}")
    code = (
        "import sys, runpy\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', "
        "'distributed_llama_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.argv = ['replica_worker', '--config', {str(cfg)!r}]\n"
        "try:\n"
        "    runpy.run_module('distributed_llama_tpu_torch.runtime.replica_worker',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not any(k.split('.')[0] == 'jax' for k in sys.modules)\n"
        "    print('exit', e.code)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("exit 2") and "config_error" in res.stdout


def test_kv_reuse_paths_run_with_jax_blocked(tmp_path):
    """In a process where `import jax` (and the JAX package) fails: `dllama
    chat --session` runs two turns and resumes a third on the CPU, and the
    scheduler seeds a request from its prefix cache; no JAX module is ever
    loaded, at import or at run time."""
    code = (
        "import sys, io, builtins, contextlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'distributed_llama_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from distributed_llama_tpu_torch.apps import dllama\n"
        "from distributed_llama_tpu_torch.testing import write_fixture\n"
        f"m, t = write_fixture({str(tmp_path)!r}, seq_len=96)\n"
        "def chat(lines):\n"
        "    it = iter(lines)\n"
        "    def fake(*a):\n"
        "        try:\n"
        "            return next(it)\n"
        "        except StopIteration:\n"
        "            raise EOFError\n"
        "    builtins.input = fake\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        dllama.main(['chat', '--model', m, '--tokenizer', t, '--steps', '3',\n"
        "                     '--temperature', '0', '--device', 'cpu', '--session',\n"
        f"                     {str(tmp_path / 's.npz')!r}])\n"
        "    return buf.getvalue()\n"
        "chat(['', 'ab', 'cd'])\n"
        "assert 'resumed session' in chat(['ef'])\n"
        "import torch\n"
        "from distributed_llama_tpu_torch.models.params import load_params, random_tensors\n"
        "from distributed_llama_tpu_torch.runtime.engine import Engine\n"
        "from distributed_llama_tpu_torch.runtime.prefix_cache import PrefixCache\n"
        "from distributed_llama_tpu_torch.runtime.scheduler import Scheduler\n"
        "from distributed_llama_tpu_torch.sampler import Sampler\n"
        "from distributed_llama_tpu_torch.testing import tiny_spec\n"
        "spec = tiny_spec(seq_len=64)\n"
        "p = load_params(spec, random_tensors(spec, seed=1), mode='q40', dtype=torch.float32, device='cpu')\n"
        "eng = Engine(spec, p, device='cpu', batch=2, compute_dtype=torch.float32, cache_dtype=torch.float32)\n"
        "pc = PrefixCache(eng, num_blocks=8, block_len=4)\n"
        "sched = Scheduler(eng, chunk=8, prefix_cache=pc)\n"
        "sched.warmup()\n"
        "for tail in ([5], [6, 7]):\n"
        "    r = sched.submit(list(range(1, 10)) + tail, 2, Sampler(spec.vocab_size, 0.0, 0.9, 1))\n"
        "    while not r.finished.is_set():\n"
        "        sched.step()\n"
        "assert pc.stats.hits == 1 and pc.stats.tokens_saved == 8, pc.stats\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') for k in sys.modules)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("call", [
    lambda e: e.step(np.asarray([[3]], np.int32), 0),
    lambda e: e.prefill([1, 2]),
    lambda e: e.generate([1, 2], 3, None),
    lambda e: e.decode_greedy_device(3, 2),
    lambda e: e.generate_device([1, 2], 3, temperature=0.0, topp=0.9, seed=1),
], ids=["step", "prefill", "generate", "decode_greedy_device", "generate_device"])
def test_batch_engine_refuses_the_one_sequence_methods(call):
    eng = _cpu_engine(batch=3)
    with pytest.raises(ValueError, match="slot_prefill_chunk and slot_decode_step"):
        call(eng)
    assert eng.pos == 0


def test_cpu_batch_engine_never_captures_the_slot_step(monkeypatch):
    from distributed_llama_tpu_torch.runtime import engine as engine_mod

    def refuse(*a, **k):
        raise AssertionError("a CPU engine tried to capture a CUDA graph")
    monkeypatch.setattr(engine_mod, "capture", refuse)
    eng = _cpu_engine(batch=2, cuda_graphs=True)
    s = eng.seq_len
    logits = eng.slot_decode_step(np.asarray([[3], [4]], np.int32),
                                  np.asarray([0, s], np.int32))
    assert logits.shape == (2, eng.spec.vocab_size) and eng.graphs == {}


def test_slot_decode_captures_once_and_records_the_ledger(monkeypatch):
    """With capture faked on the CPU: the first slot step captures graph
    "slot_decode" (into COMPILES), later steps replay it and return a
    copy; a capture after warmup is counted, and refused when frozen; a
    failed capture raises, with no eager run instead."""
    import types

    from distributed_llama_tpu_torch.runtime import engine as engine_mod
    from distributed_llama_tpu_torch.runtime import graphs
    from distributed_llama_tpu_torch.runtime.profiler import COMPILES
    from distributed_llama_tpu_torch.runtime.scheduler import RequestError

    made = []

    def fake_capture(fn):
        out = fn()
        made.append(out)
        return graphs.CapturedStep(
            types.SimpleNamespace(replay=lambda: None, reset=lambda: None),
            out, (0,) * len(graphs.LAUNCH_COUNTERS), 0.002, 0)
    monkeypatch.setattr(engine_mod, "capture", fake_capture)
    COMPILES.reset()
    eng = _cpu_engine(batch=2)
    eng.cuda_graphs = True
    tok, pos = np.asarray([[3], [4]], np.int32), np.asarray([0, eng.seq_len], np.int32)
    a = eng.slot_decode_step(tok, pos)
    b = eng.slot_decode_step(tok, pos)
    assert list(eng.graphs) == ["slot_decode"] and len(made) == 1
    assert torch.equal(a, made[0]) and a is not made[0] and b is not a
    assert COMPILES.summary()["by_key"]["slot_decode"]["count"] == 1
    eng.mark_compile_warm()
    eng._captured(("greedy",), lambda: None)
    assert COMPILES.summary()["after_warmup"] == 1
    COMPILES.freeze = True
    try:
        with pytest.raises(RequestError, match="frozen"):
            eng._captured(("other",), lambda: None)
    finally:
        COMPILES.reset()
    eng.release()
    assert eng.cache is None and eng.graphs == {}

    def fail(fn):
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(engine_mod, "capture", fail)
    eng = _cpu_engine(batch=2)
    eng.cuda_graphs = True
    monkeypatch.setattr(engine_mod, "forward", lambda *a, **k: pytest.fail("ran eagerly"))
    with pytest.raises(RuntimeError, match="capturing"):
        eng.slot_decode_step(tok, pos)


def test_cli_refuses_unported_serving_flags(capsys):
    from distributed_llama_tpu_torch.apps import dllama

    for argv, needle in (
            (["api", "--prefix-cache"], "--prefix-cache requires --serve-batch N"),
            (["api", "--draft", "self:1", "--lookup-decode", "2"],
             "both pick the draft source"),
            (["api", "--replicas", "2"], "require --serve-batch N"),
            (["api", "--slo-ttft-ms", "5"], "require --serve-batch N|auto"),
            (["api", "--serve-batch", "2", "--session", "s.bin"],
             "does not compose with --session"),
            (["generate", "--serve-batch", "2"], "api-mode flags"),
            (["api", "--queue-depth", "3"], "need --serve-batch")):
        with pytest.raises(SystemExit) as ei:
            dllama.main(argv)
        assert needle in str(ei.value), argv
    with pytest.raises(SystemExit):
        dllama.main(["api", "--serve-batch", "many"])
    assert "expected an integer or 'auto'" in capsys.readouterr().err


def test_api_mode_without_a_card_raises(monkeypatch, tmp_path):
    """`dllama api` runs on cuda unless told otherwise: with no card it
    raises before any server binds, never serving on the CPU."""
    from distributed_llama_tpu_torch.apps import api_server, dllama
    from distributed_llama_tpu_torch.testing import write_fixture

    mpath, tpath = write_fixture(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(api_server, "ThreadingHTTPServer",
                        lambda *a: pytest.fail("a server was bound"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dllama.main(["api", "--model", mpath, "--tokenizer", tpath,
                     "--serve-batch", "2", "--port", "0"])


def test_chat_mode_without_a_card_raises(monkeypatch, tmp_path):
    """`dllama chat` runs on cuda unless told otherwise: with no card it
    raises before the first prompt, never chatting on the CPU."""
    import builtins

    from distributed_llama_tpu_torch.apps import dllama
    from distributed_llama_tpu_torch.testing import write_fixture

    mpath, tpath = write_fixture(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(builtins, "input", lambda *a: pytest.fail("chat asked for input"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dllama.main(["chat", "--model", mpath, "--tokenizer", tpath,
                     "--session", str(tmp_path / "s.npz")])
    assert not (tmp_path / "s.npz").exists()


def test_import_guards_cover_the_speculation_path():
    """The speculation slice's modules are in the package the blocked-jax
    import test and the per-file import scan walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"runtime/speculative.py", "runtime/draft.py"} <= files


def test_cpu_engine_never_captures_the_speculative_steps(monkeypatch):
    """On the CPU the verify steps and the draft's steps run eagerly,
    cuda_graphs or not."""
    from distributed_llama_tpu_torch.runtime import draft as draft_mod
    from distributed_llama_tpu_torch.runtime import engine as engine_mod
    from distributed_llama_tpu_torch.runtime.draft import DraftModel

    def refuse(*a, **k):
        raise AssertionError("a CPU engine tried to capture a CUDA graph")
    monkeypatch.setattr(engine_mod, "capture", refuse)
    monkeypatch.setattr(draft_mod, "capture", refuse)
    eng = _cpu_engine(cuda_graphs=True)
    d = DraftModel.self_draft(eng, 1)
    assert len(eng.generate_lookup([1, 2, 1, 2], 6, draft_len=3).tokens) == 6
    eng.reset()
    assert len(eng.generate_draft([1, 2, 3], 6, draft=d, draft_len=3).tokens) == 6
    eng.reset()
    assert len(eng.generate_draft_sampled([1, 2, 3], 4, draft=d, temperature=0.8,
                                          topp=0.9, seed=1).tokens) == 4
    b = _cpu_engine(batch=2, cuda_graphs=True)
    greedy, logits0 = b.slot_verify_step(np.asarray([[3, 4, 5], [6, 6, 6]], np.int32),
                                         np.asarray([0, b.seq_len], np.int32), 50)
    assert greedy.shape == (2, 3) and greedy.dtype == np.int32
    assert logits0.shape == (2, b.spec.vocab_size)
    assert eng.graphs == {} and d.graphs == {} and b.graphs == {}


def test_speculative_graph_keys_and_launch_tallies(monkeypatch):
    """With CUDA's graph API faked on the CPU and a forward that counts 2
    K1 and 1 K3 launches: each verify width T is one graph ("lookup", T),
    the draft's proposal one graph replayed k times, its sampled step one
    graph, the scheduler's verify one ("slot_verify", 1 + K, n_vocab);
    every key is in COMPILES, the capture's launches are the warm-up's,
    each replay adds the tally, and Engine.release releases the drafts."""
    import contextlib
    import types

    from distributed_llama_tpu_torch.runtime import draft as draft_mod
    from distributed_llama_tpu_torch.runtime import engine as engine_mod
    from distributed_llama_tpu_torch.runtime import graphs
    from distributed_llama_tpu_torch.runtime.draft import DraftModel
    from distributed_llama_tpu_torch.runtime.profiler import COMPILES

    class FakeGraph:
        def replay(self):
            pass

        def reset(self):
            pass

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(graphs, "pool_bytes", lambda g: 0)

    def counting_forward(params, spec, tokens, pos0, cache, *, logits_for_all=False,
                         logits=True, **kw):
        cuda_q40.q40_matmul.launches += 2
        cuda_attention.flash_attention.launches += 1
        b, t = tokens.shape
        return torch.zeros((b, t, spec.vocab_size) if logits_for_all
                           else (b, spec.vocab_size))
    monkeypatch.setattr(engine_mod, "forward", counting_forward)
    monkeypatch.setattr(draft_mod, "forward", counting_forward)
    COMPILES.reset()
    try:
        eng = _cpu_engine()
        eng.cuda_graphs = True
        v = eng.spec.vocab_size
        k1 = cuda_q40.q40_matmul
        n0 = k1.launches
        for t in (3, 3, 2):
            lg = eng._verify_logits(np.zeros((1, t), np.int32), 4)
            assert lg.shape == (t, v)
        assert set(eng.graphs) == {("lookup", 3), ("lookup", 2)}
        assert all(g.tally == (2, 0, 0, 1, 0, 0) for g in eng.graphs.values())
        assert k1.launches - n0 == 2 * 2 + 3 * 2   # two warm-ups, three replays
        d = DraftModel.self_draft(eng, 1)
        n0 = k1.launches
        toks, cache = d.propose(d.cache, np.asarray([3], np.int32),
                                np.asarray([4], np.int32), 5, n_vocab=v)
        assert toks.shape == (1, 5) and cache is d.cache
        assert k1.launches - n0 == 2 + 5 * 2       # warm-up, five replays
        d.step_logits(d.cache, np.asarray([[3]], np.int32), np.asarray([4], np.int32))
        assert set(d.graphs) == {("sdraft_scan", "self1", 5, v), ("sdraft_step", "self1")}
        assert d.graphs[("sdraft_scan", "self1", 5, v)].tally == (2, 0, 0, 1, 0, 0)
        b = _cpu_engine(batch=2)
        b.cuda_graphs = True
        greedy, logits0 = b.slot_verify_step(np.zeros((2, 4), np.int32),
                                             np.asarray([0, b.seq_len], np.int32), v)
        assert list(b.graphs) == [("slot_verify", 4, v)]
        assert greedy.shape == (2, 4) and logits0.shape == (2, v)
        assert {"lookup:3", "lookup:2", f"sdraft_scan:self1:5:{v}", "sdraft_step:self1",
                f"slot_verify:4:{v}"} <= set(COMPILES.summary()["by_key"])
        eng.release()
        assert d.cache is None and d.graphs == {} and eng._drafts == []
    finally:
        COMPILES.reset()
