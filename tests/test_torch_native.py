"""The port's native tokenizer and sampler (distributed_llama_tpu_torch/
native.py over the repo's native/dllama_native.cpp) held against the port's
Python ones and the JAX package's, on JAX tests/test_native.py's cases.

The library is built from the repo's source into a temporary directory
with the system's C++ compiler and loaded through the loader's explicit
path; the tests skip only where no C++ compiler is found. The loader is
reset afterwards, so no other test picks the library up.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from distributed_llama_tpu.io.tokenizer_file import TokenizerData as JaxTokenizerData
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu.tokenizer import Tokenizer as JaxTokenizer
from distributed_llama_tpu_torch import native
from distributed_llama_tpu_torch.io.tokenizer_file import TokenizerData
from distributed_llama_tpu_torch.sampler import Sampler
from distributed_llama_tpu_torch.tokenizer import Tokenizer

ROOT = Path(__file__).resolve().parent.parent
CXX = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")

pytestmark = pytest.mark.skipif(CXX is None, reason="no C++ compiler found")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("native") / "libdllama_native.so"
    subprocess.run([CXX, "-std=c++17", "-O2", "-fPIC", "-shared", "-o", str(out),
                    str(ROOT / "native" / "dllama_native.cpp")], check=True,
                   capture_output=True, timeout=300)
    saved = native._lib
    native.load(str(out))
    yield out
    native._lib = saved


def _vocab():
    # JAX tests/test_native.py's vocab: merges, byte-fallback pieces and a
    # duplicate piece
    vocab = [b"<unk>", b"<s>", b"</s>"]
    vocab += [f"<0x{b:02X}>".encode() for b in range(256)]
    vocab += [b" ", b"a", b"b", b"ab", b" a", b"ba", b"bab", b" hello",
              b"he", b"ll", b"o", b"hell", b"ab"]
    scores = [0.0] * 259 + [1.0, 1.1, 1.2, 5.0, 2.0, 4.0, 6.0, 9.0, 3.0,
                            3.5, 1.05, 7.0, 8.0]
    return vocab, scores


def _tokenizers():
    vocab, scores = _vocab()
    data = TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2)
    jdata = JaxTokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2)
    return (Tokenizer(data, backend="native"), Tokenizer(data, backend="python"),
            JaxTokenizer(jdata, backend="python"))


CASES = ["", "a", "ab", "bab", " hello", "hello ab", "abba abab",
         "héllo \N{SNOWMAN}", "\x00\x7f", "a" * 64]


@pytest.mark.parametrize("text", CASES)
def test_native_tokenizer_matches_python_and_jax(lib, text):
    nat, py, jx = _tokenizers()
    assert nat._native is not None and py._native is None
    for add_bos in (True, False):
        for add_eos in (False, True):
            want = jx.encode(text, add_bos=add_bos, add_eos=add_eos)
            assert nat.encode(text, add_bos=add_bos, add_eos=add_eos) == want
            assert py.encode(text, add_bos=add_bos, add_eos=add_eos) == want


def test_native_decode_matches_python_and_jax(lib):
    nat, py, jx = _tokenizers()
    ids = py.encode("hello ab", add_bos=True)
    for prev, tok in zip([py.bos_id] + ids, ids):
        assert nat.decode_piece(prev, tok) == py.decode_piece(prev, tok) == \
            jx.decode_piece(prev, tok)
    assert nat.decode_piece(5, 3 + 0x41) == b"\x41"  # <0x41> raw byte
    assert nat.decode(ids) == py.decode(ids) == jx.decode(ids)
    # the duplicate piece: the first occurrence wins in every backend
    assert nat.encode("ab", add_bos=False) == jx.encode("ab", add_bos=False)


def test_native_tokenizer_fuzz_parity(lib):
    nat, py, jx = _tokenizers()
    rng = np.random.default_rng(7)
    alphabet = list("ab hello") + ["é", "√", "\n"]
    for _ in range(50):
        s = "".join(rng.choice(alphabet) for _ in range(int(rng.integers(0, 40))))
        assert nat.encode(s) == py.encode(s) == jx.encode(s), repr(s)


@pytest.mark.parametrize("temp,topp", [(0.0, 0.9), (0.8, 0.0), (0.7, 0.9), (1.3, 0.5)])
def test_native_sampler_matches_python_and_jax(lib, temp, topp):
    """Indices and the xorshift state after every draw."""
    rng = np.random.default_rng(3)
    nat = Sampler(100, temp, topp, seed=123, backend="native")
    py = Sampler(100, temp, topp, seed=123, backend="python")
    jx = JaxSampler(100, temp, topp, seed=123, backend="python")
    assert nat._native is not None and py._native is None
    for i in range(50):
        logits = rng.standard_normal(100).astype(np.float32) * 3
        assert nat.sample(logits.copy()) == py.sample(logits.copy()) == \
            jx.sample(logits.copy()), (temp, topp, i)
        assert nat.rng_state == py.rng_state == jx.rng_state
    assert nat.next_seed() == py.next_seed() == jx.next_seed()


def test_native_sampler_state_roundtrip(lib):
    nat = Sampler(50, 0.8, 0.9, seed=9, backend="native")
    py = Sampler(50, 0.8, 0.9, seed=9, backend="python")
    logits = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    saved = nat.rng_state
    a = nat.sample(logits.copy())
    assert a == py.sample(logits.copy())
    nat.rng_state = saved
    assert nat.sample(logits.copy()) == a
    nat.set_seed(77)
    py.set_seed(77)
    assert nat.rng_state == py.rng_state == 77
    nat.set_temp(0.0)
    assert nat.sample(logits.copy()) == int(np.argmax(logits))


def test_backends_without_the_library(lib, monkeypatch):
    """"auto" uses the library when it is loaded and the Python code when
    it is not; "native" without it raises, as in the JAX package."""
    vocab, scores = _vocab()
    data = TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2)
    assert Tokenizer(data)._native is not None
    assert Sampler(10, 0.5, 0.9, 1)._native is not None
    monkeypatch.setattr(native, "load", lambda path=None: None)
    assert Tokenizer(data)._native is None and Sampler(10, 0.5, 0.9, 1)._native is None
    with pytest.raises(RuntimeError, match="not built"):
        Tokenizer(data, backend="native")
    with pytest.raises(RuntimeError, match="not built"):
        Sampler(10, 0.5, 0.9, 1, backend="native")
    monkeypatch.undo()
    # an explicit path that does not load raises and keeps the loaded one
    with pytest.raises(OSError):
        native.load("/nonexistent/libdllama_native.so")
    assert native.available()


def test_rng_fill_matches_the_python_stream(lib):
    from distributed_llama_tpu_torch.utils.rng import xorshift_f32

    state, out = native.rng_fill_f32(12345, 5)
    s, want = 12345, []
    for _ in range(5):
        s, v = xorshift_f32(s)
        want.append(v)
    assert state == s and np.allclose(out, np.asarray(want, np.float32), rtol=0, atol=0)
