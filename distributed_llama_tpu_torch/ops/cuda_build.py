"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with ctypes — no PyTorch headers, so a build takes
seconds. Libraries go to `build/kernels/` beside the package (listed in
.gitignore), named by a hash of the source and the flags: a second run
reuses them, an edited source rebuilds. `build_all()` starts one nvcc per
source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module, and nvcc
is only reached when a kernel is first launched on a CUDA tensor (or
`build_all()` is called). There is no fallback: a missing nvcc or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
KERNELS = ("q40_matmul", "flash_attention",   # the engine's kernels
           "q80_roundtrip")
PROBES = ("q40_probes", "q40_gemv1_probes",   # the design probes (tools/)
          "f8_flash_probe", "q40_prefill_probe")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
        "built from csrc/ at first launch and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every missing library, one nvcc process per source, all in
    parallel. Returns {name: library path}; raises on any failure."""
    targets = {n: _target(n) for n in names}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    failed = []
    for n, (proc, tmp, p) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, p)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`. An engine kernel not built yet
    builds all of KERNELS first; a probe source builds alone, so the engine
    never waits for (or fails on) the probes."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            names = KERNELS if name in KERNELS else (name,)
            lib = ctypes.CDLL(str(build_all(names)[name]))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point: a
    refused launch never runs, and a later synchronize would not say so."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
