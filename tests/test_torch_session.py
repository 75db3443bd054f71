"""The port's KV-cache sessions (Engine.save_session / load_session) and
`dllama chat --session`, held against the JAX package's on the CPU, f32
compute: the cases of tests/test_session.py (all but the mesh restore,
which waits for tensor parallelism), a file saved by either package loaded
by the other and continued with the other's greedy tokens, the same file
written by both, the fp8 NaN-code guard at the load, and the cache tensors
never rebound by a load or a reset.
"""

import builtins
import contextlib
import io
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.models import ArchType
from distributed_llama_tpu.models.params import load_params
from distributed_llama_tpu.runtime import Engine as JaxEngine
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler

from test_model_forward import dense_weights, make_spec

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
PROMPT = [1, 5, 9, 2]


def greedy(v=128):
    return Sampler(v, temperature=0.0, topp=0.9, seed=1)


def jgreedy(v=128):
    return JaxSampler(v, temperature=0.0, topp=0.9, seed=1, backend="python")


def _spec_host(seed=51, **kw):
    spec = make_spec(ArchType.LLAMA, dim=64, n_heads=8, n_kv_heads=4,
                     vocab_size=128, seq_len=64, **kw)
    host, _ = dense_weights(spec, seed=seed)
    return spec, host


@pytest.fixture(scope="module")
def model():
    """tests/test_session.py's model (Q40 weights, seed 51) in both
    packages: (spec, JAX params, port params)."""
    spec, host = _spec_host()
    jp = load_params(spec, host, mode="q40", dtype=jnp.float32)
    return spec, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     spec, "cpu")


def _port(model, cache=torch.float32, **kw):
    spec, _, pp = model
    return Engine(spec, pp, device="cpu", compute_dtype=torch.float32,
                  cache_dtype=cache, **kw)


def _jax(model, cache=torch.float32, **kw):
    spec, jp, _ = model
    return JaxEngine(spec, jp, compute_dtype=jnp.float32, cache_dtype=JDT[cache], **kw)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_session_roundtrip_continues_exactly(model, tmp_path, cache):
    """A restored session continues exactly where the original engine
    would have, and both give the JAX engine's tokens."""
    eng_a = _port(model, cache)
    part1 = eng_a.generate(PROMPT, 5, greedy()).tokens
    eng_a.save_session(str(tmp_path / "s.npz"))
    want = eng_a.generate([part1[-1]], 5, greedy()).tokens

    eng_b = _port(model, cache)
    eng_b.load_session(str(tmp_path / "s.npz"))
    assert eng_b.pos == len(PROMPT) + len(part1) - 1
    assert eng_b.generate([part1[-1]], 5, greedy()).tokens == want

    jeng = _jax(model, cache)
    assert jeng.generate(PROMPT, 5, jgreedy()).tokens == part1
    assert jeng.generate([part1[-1]], 5, jgreedy()).tokens == want


def test_session_token_history_roundtrips(model, tmp_path):
    """The token history rides along with the cache; files saved without
    one, and files from before the field existed, load as []."""
    eng = _port(model)
    out = eng.generate([1, 5], 3, greedy()).tokens
    eng.save_session(str(tmp_path / "s.npz"), tokens=[1, 5] + out)
    eng.save_session(str(tmp_path / "bare.npz"))
    eng2 = _port(model)
    assert eng2.load_session(str(tmp_path / "s.npz")) == [1, 5] + out
    assert eng2.load_session(str(tmp_path / "bare.npz")) == []
    z = np.load(str(tmp_path / "bare.npz"))
    with open(str(tmp_path / "legacy.npz"), "wb") as f:
        np.savez(f, **{k: z[k] for k in z.files if k != "tokens"})
    assert eng2.load_session(str(tmp_path / "legacy.npz")) == []


def test_session_extensionless_path_roundtrips(model, tmp_path):
    """save_session writes exactly the path asked for (np.savez would add
    .npz to a bare name) and leaves no temporary behind."""
    eng = _port(model)
    eng.generate([1, 5], 2, greedy())
    path = str(tmp_path / "chat.sess")
    eng.save_session(path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["chat.sess"]
    eng2 = _port(model)
    eng2.load_session(path)
    assert eng2.pos == eng.pos


def test_session_rejects_mismatched_config(model, tmp_path):
    eng = _port(model)
    eng.generate([1, 5], 2, greedy())
    eng.save_session(str(tmp_path / "s.npz"))
    other_spec, other_host = _spec_host(n_layers=4)
    jp = load_params(other_spec, other_host, mode="q40", dtype=jnp.float32)
    other = Engine(other_spec, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                               other_spec, "cpu"),
                   device="cpu", compute_dtype=torch.float32, cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="does not match"):
        other.load_session(str(tmp_path / "s.npz"))
    with pytest.raises(ValueError, match="does not match"):
        _port(model, torch.bfloat16).load_session(str(tmp_path / "s.npz"))
    with pytest.raises(ValueError, match="does not match"):
        _port(model, batch=2).load_session(str(tmp_path / "s.npz"))


def test_session_rejects_different_weight_content(model, tmp_path):
    """A same-shape model with other weights is refused; fingerprint 0
    (params held in memory) degrades to the shape-only check."""
    eng = _port(model, model_fingerprint=0xAAAA)
    eng.generate([1, 5], 2, greedy())
    eng.save_session(str(tmp_path / "s.npz"))
    with pytest.raises(ValueError, match="does not match"):
        _port(model, model_fingerprint=0xBBBB).load_session(str(tmp_path / "s.npz"))
    same = _port(model, model_fingerprint=0xAAAA)
    assert same.load_session(str(tmp_path / "s.npz")) == []
    assert same.pos == eng.pos
    assert _port(model).load_session(str(tmp_path / "s.npz")) == []


def test_content_fingerprint_distinguishes_files(tmp_path):
    from distributed_llama_tpu.io.model_file import content_fingerprint as jax_fp
    from distributed_llama_tpu_torch.io.model_file import content_fingerprint

    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    a.write_bytes(b"\x01" * 100_000)
    b.write_bytes(b"\x01" * 99_999 + b"\x02")
    assert content_fingerprint(str(a)) != content_fingerprint(str(b))
    for f in (a, b):
        assert content_fingerprint(str(f)) == jax_fp(str(f))


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fingerprint_and_file_equal_the_jax_engines(model, tmp_path, cache):
    """After the same generate, both packages write the same session:
    fingerprint value for value, the same keys, pos, dtype name, tokens,
    and cache prefixes within 1e-5 (bf16: one bf16 ulp)."""
    eng, jeng = _port(model, cache, model_fingerprint=77), _jax(model, cache,
                                                                model_fingerprint=77)
    assert eng._session_fingerprint() == jeng._session_fingerprint()
    toks = eng.generate(PROMPT, 6, greedy()).tokens
    assert jeng.generate(PROMPT, 6, jgreedy()).tokens == toks
    eng.save_session(str(tmp_path / "port.npz"), tokens=PROMPT + toks)
    jeng.save_session(str(tmp_path / "jax.npz"), tokens=PROMPT + toks)
    p, j = np.load(str(tmp_path / "port.npz")), np.load(str(tmp_path / "jax.npz"))
    assert sorted(p.files) == sorted(j.files)
    for key in ("pos", "cache_dtype", "config", "tokens"):
        assert np.array_equal(p[key], j[key]), key
    for key in (k for k in p.files if k[0] in "kv" and k[1:].isdigit()):
        assert p[key].dtype == j[key].dtype and p[key].shape == j[key].shape
        got, want = (np.asarray(torch.from_numpy(z[key].view(np.int16)).view(torch.bfloat16)
                                .float()) if cache == torch.bfloat16 else z[key]
                     for z in (p, j))
        tol = 2 ** -7 if cache == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_jax_saved_session_continues_in_the_port(model, tmp_path, cache):
    """A session the JAX engine saved loads into the port, which continues
    with the JAX engine's greedy tokens."""
    jeng = _jax(model, cache)
    part1 = jeng.generate(PROMPT, 5, jgreedy()).tokens
    jeng.save_session(str(tmp_path / "s.npz"), tokens=PROMPT + part1)
    want = jeng.generate([part1[-1]], 6, jgreedy()).tokens
    eng = _port(model, cache)
    assert eng.load_session(str(tmp_path / "s.npz")) == PROMPT + part1
    assert eng.pos == jeng.pos - 6
    assert eng.generate([part1[-1]], 6, greedy()).tokens == want


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_port_saved_session_continues_in_jax(model, tmp_path, cache):
    """And the reverse: the port's file loads into the JAX engine, which
    continues with the port's greedy tokens."""
    eng = _port(model, cache)
    part1 = eng.generate(PROMPT, 5, greedy()).tokens
    eng.save_session(str(tmp_path / "s.npz"), tokens=PROMPT + part1)
    want = eng.generate([part1[-1]], 6, greedy()).tokens
    jeng = _jax(model, cache)
    assert jeng.load_session(str(tmp_path / "s.npz")) == PROMPT + part1
    assert jeng.generate([part1[-1]], 6, jgreedy()).tokens == want


def test_f8_session_load_saturates_nan_codes(model, tmp_path):
    """e4m3 bytes entering the cache from a file pass the NaN-code guard in
    both packages: 0x7F and 0xFF load as +448 and -448, every other code
    as it is."""
    eng = _port(model, torch.float8_e4m3fn)
    eng.generate(PROMPT * 3, 2, greedy())       # 13 positions: 416 bytes in k0
    path = str(tmp_path / "f8.npz")
    eng.save_session(path)
    z = dict(np.load(path))
    codes = np.arange(256, dtype=np.uint8)
    k0 = z["k0"].copy()
    k0.reshape(-1)[:256] = codes
    z["k0"] = k0
    with open(path, "wb") as f:
        np.savez(f, **z)
    eng2 = _port(model, torch.float8_e4m3fn)
    eng2.load_session(path)
    got = eng2.cache.k[0][:, :, :eng2.pos].reshape(-1)[:256].float()
    want = torch.from_numpy(codes).view(torch.float8_e4m3fn).float()
    want[0x7F], want[0xFF] = 448.0, -448.0
    assert torch.equal(got, want)
    jeng = JaxEngine(model[0], model[1], compute_dtype=jnp.float32,
                     cache_dtype=jnp.float8_e4m3fn)
    jeng.load_session(path)
    jgot = np.asarray(jeng.cache.k[0][:, :, :jeng.pos].astype(jnp.float32)).reshape(-1)[:256]
    np.testing.assert_array_equal(jgot, want.numpy())


def test_load_and_reset_never_rebind_the_cache(model, tmp_path):
    """The captured graphs read and write the cache's addresses: a load,
    a reset and a generate keep every cache tensor where it was."""
    eng = _port(model)
    ptrs = [t.data_ptr() for t in (*eng.cache.k, *eng.cache.v)]
    eng.generate(PROMPT, 3, greedy())
    eng.save_session(str(tmp_path / "s.npz"))
    eng.reset()
    eng.load_session(str(tmp_path / "s.npz"))
    assert [t.data_ptr() for t in (*eng.cache.k, *eng.cache.v)] == ptrs


# -- dllama chat --session -----------------------------------------------------


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    from distributed_llama_tpu.testing import write_fixture

    return write_fixture(tmp_path_factory.mktemp("chat"),
                         rng=np.random.default_rng(23), seq_len=192)


def _chat(main, argv, lines, monkeypatch) -> str:
    """One chat process: `lines` on stdin, stdout from the first
    assistant turn on."""
    it = iter(lines)

    def fake_input(*a):
        try:
            return next(it)
        except StopIteration:
            raise EOFError
    monkeypatch.setattr(builtins, "input", fake_input)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    return out[out.index("🤖"):]


def test_chat_session_rejects_multihost_and_pp(fixture_files, tmp_path):
    from distributed_llama_tpu_torch.apps import dllama

    mpath, tpath = fixture_files
    for extra in (["--pp", "2"], ["--nnodes", "2"]):
        with pytest.raises(SystemExit, match="session"):
            dllama.main(["chat", "--model", mpath, "--tokenizer", tpath, "--device",
                         "cpu", "--session", str(tmp_path / "s.npz"), *extra])


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_chat_session_flag_resumes(fixture_files, tmp_path, monkeypatch, temperature):
    """`chat --session FILE` saves after each turn and resumes: two turns,
    then a third in a new process from the file, print the JAX CLI's text
    for the same runs, and the resumed third turn the text of an
    uninterrupted three-turn run (greedy)."""
    from distributed_llama_tpu.apps import dllama as jax_dllama
    from distributed_llama_tpu_torch.apps import dllama

    mpath, tpath = fixture_files
    common = ["chat", "--model", mpath, "--tokenizer", tpath, "--steps", "4",
              "--seed", "7", "--temperature", temperature, "--compute-dtype", "f32",
              "--cache-dtype", "f32"]
    turns = ["be brief", "ab", "cd"]
    out = {}
    for pkg, main, extra in (("jax", jax_dllama.main, []),
                             ("port", dllama.main, ["--device", "cpu"])):
        sess = str(tmp_path / f"{pkg}.npz")
        two = _chat(main, common + extra + ["--session", sess], turns[:2], monkeypatch)
        third = _chat(main, common + extra + ["--session", sess], turns[2:], monkeypatch)
        whole = _chat(main, common + extra, turns, monkeypatch)
        out[pkg] = (two, third, whole)
        assert whole.startswith(two)
        if temperature == "0":
            assert whole == two + "\n" + third
    assert out["port"] == out["jax"]
    # a file of either package resumes in the other
    shutil.copy(str(tmp_path / "jax.npz"), str(tmp_path / "x.npz"))
    assert (_chat(dllama.main, common + ["--device", "cpu", "--session",
                                         str(tmp_path / "x.npz")], ["ef"], monkeypatch)
            == _chat(jax_dllama.main, common + ["--session", str(tmp_path / "port.npz")],
                     ["ef"], monkeypatch))


def test_chat_refuses_speculation_flags(fixture_files):
    """Chat speculates (tests/test_torch_draft.py, test_torch_speculative.py);
    what it refuses are the JAX CLI's dead combinations, in its words."""
    from distributed_llama_tpu.apps import dllama as jax_dllama
    from distributed_llama_tpu_torch.apps import dllama

    mpath, tpath = fixture_files
    for extra, needle in ((["--lookup-decode", "5", "--draft", "self:1"],
                           "both pick the draft source"),
                          (["--draft-len", "3"], "--draft-len has no effect")):
        argv = ["chat", "--model", mpath, "--tokenizer", tpath] + extra
        with pytest.raises(SystemExit) as ei:
            dllama.main(argv)
        with pytest.raises(SystemExit) as ej:
            jax_dllama.main(argv)
        assert needle in str(ei.value) and str(ei.value) == str(ej.value)
