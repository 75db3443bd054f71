"""ctypes binding for the native C++ tokenizer/sampler (the repo's native/),
the port's own copy of the JAX package's native.py.

The shared library is host code and optional: `available()` is False when
it has not been built (`make -C native` builds native/libdllama_native.so
from native/dllama_native.cpp), and the pure-Python implementations in
tokenizer.py / sampler.py, the oracles the native code is tested against,
are used instead. The reference ships these components as C++ (ref:
src/tokenizer.cpp), so the native build restores that layering for the
host's hot paths (prompt encoding, per-token sampling). `load(path)` loads
a library from an explicit path instead (the tests build one into a
temporary directory).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "native",
                 "libdllama_native.so"),
    "libdllama_native.so",
)

_lib = None


def load(path: str | None = None):
    """The loaded library, or None when none loads. With `path`, that file
    replaces any library loaded before (OSError if it does not load);
    without, the first of the repo's native/ build and the loader's search
    path that loads, once."""
    global _lib
    if path is None and _lib is not None:
        return _lib
    for p in (path,) if path is not None else _LIB_PATHS:
        try:
            lib = ctypes.CDLL(p)
        except OSError:
            if path is not None:
                raise
            continue
        lib.dllama_tok_create.restype = ctypes.c_void_p
        lib.dllama_tok_create.argtypes = [
            ctypes.c_int32, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32]
        lib.dllama_tok_free.argtypes = [ctypes.c_void_p]
        lib.dllama_tok_encode.restype = ctypes.c_int32
        lib.dllama_tok_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.dllama_tok_decode_piece.restype = ctypes.c_int32
        lib.dllama_tok_decode_piece.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32]
        lib.dllama_sampler_create.restype = ctypes.c_void_p
        lib.dllama_sampler_create.argtypes = [
            ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_uint64]
        lib.dllama_sampler_free.argtypes = [ctypes.c_void_p]
        lib.dllama_sampler_set_temp.argtypes = [ctypes.c_void_p, ctypes.c_float]
        lib.dllama_sampler_set_seed.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dllama_sampler_get_state.restype = ctypes.c_uint64
        lib.dllama_sampler_get_state.argtypes = [ctypes.c_void_p]
        lib.dllama_sampler_set_state.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dllama_sampler_sample.restype = ctypes.c_int32
        lib.dllama_sampler_sample.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
        if hasattr(lib, "dllama_rng_fill_f32"):  # older .so builds lack it
            lib.dllama_rng_fill_f32.restype = ctypes.c_uint64
            lib.dllama_rng_fill_f32.argtypes = [
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64]
        _lib = lib
        return lib
    return None


def available() -> bool:
    return load() is not None


def rng_fill_f32(state: int, n: int) -> tuple[int, np.ndarray]:
    """n sequential xorshift* f32 draws (raw <0,1) stream, no scaling) as a
    float32 array, plus the advanced state — the bulk form of
    utils.rng.xorshift_f32 for golden-fixture weight generation
    (tests/test_reference_golden.py seeds ~200M weights this way)."""
    lib = load()
    if lib is None or not hasattr(lib, "dllama_rng_fill_f32"):
        raise RuntimeError("native library not built (make -C native)")
    out = np.empty(n, np.float32)
    new_state = lib.dllama_rng_fill_f32(
        state & ((1 << 64) - 1),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    return int(new_state), out


class NativeTokenizer:
    """C++ tokenizer backend; drop-in for Tokenizer's encode/decode_piece."""

    def __init__(self, vocab: list[bytes], scores: list[float],
                 bos_id: int, eos_id: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        self._lib = lib
        blob = b"".join(vocab)
        lens = (ctypes.c_int32 * len(vocab))(*[len(v) for v in vocab])
        sc = (ctypes.c_float * len(scores))(*scores)
        self._h = lib.dllama_tok_create(len(vocab), blob, lens, sc,
                                        bos_id, eos_id)
        # one reusable piece buffer sized to the longest piece — decode is
        # called per generated token
        self._piece_cap = max((len(v) for v in vocab), default=16) + 1
        self._piece_buf = ctypes.create_string_buffer(self._piece_cap)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.dllama_tok_free(self._h)
            self._h = None

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> list[int]:
        raw = text.encode("utf-8")
        cap = len(raw) + 3
        out = (ctypes.c_int32 * cap)()
        n = self._lib.dllama_tok_encode(self._h, raw, len(raw),
                                        int(add_bos), int(add_eos), out, cap)
        assert n >= 0
        return list(out[:n])

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        buf = self._piece_buf
        n = self._lib.dllama_tok_decode_piece(
            self._h, prev_token, token,
            ctypes.cast(buf, ctypes.c_char_p), self._piece_cap)
        assert n >= 0
        return buf.raw[:n]


class NativeSampler:
    """C++ sampler backend with the shared xorshift state exposed so the
    Python Sampler API (rng_state save/restore) keeps working."""

    def __init__(self, vocab_size: int, temperature: float, topp: float,
                 seed: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        self._lib = lib
        self.vocab_size = vocab_size
        self.temperature = float(temperature)
        self.topp = float(topp)
        self._h = lib.dllama_sampler_create(
            vocab_size, temperature, topp, seed & ((1 << 64) - 1))

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.dllama_sampler_free(self._h)
            self._h = None

    @property
    def rng_state(self) -> int:
        return int(self._lib.dllama_sampler_get_state(self._h))

    @rng_state.setter
    def rng_state(self, v: int) -> None:
        self._lib.dllama_sampler_set_state(self._h, v & ((1 << 64) - 1))

    def set_temp(self, temperature: float) -> None:
        self.temperature = float(temperature)
        self._lib.dllama_sampler_set_temp(self._h, temperature)

    def set_seed(self, seed: int) -> None:
        self._lib.dllama_sampler_set_seed(self._h, seed & ((1 << 64) - 1))

    def sample(self, logits: np.ndarray) -> int:
        # always copy: the C sampler scribbles softmax into the buffer, and
        # the caller may hand us a read-only view
        x = np.array(np.asarray(logits).reshape(-1)[: self.vocab_size],
                     dtype=np.float32)
        return int(self._lib.dllama_sampler_sample(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            x.size))
