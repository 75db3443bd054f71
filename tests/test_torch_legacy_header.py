"""The port's CLI against the JAX CLI on the flags the port lacked until
this slice, on the CPU:

  * F3: the tiny Q40 fixture with its KV header replaced by the
    reference's legacy 9-int header (testing.write_legacy_copy) loads with
    --weights-float-type q40 and prints the JAX CLI's tokens (f32 compute
    and cache: exact); without the flag both CLIs fail to read it as F32;
    a flag that contradicts a KV header gives the JAX error;
  * the other JAX flags the parser did not know: --nthreads is accepted
    and ignored, --workers refused in the JAX CLI's words, --pallas and
    --no-pallas and the cluster flags refused naming their ROADMAP item,
    --shard-vocab on without --tp refused in the JAX CLI's words, none of
    them argparse's exit 2;
  * --profile DIR beside --profile-sample and --profile-dir: no prefix
    collision, and a torch.profiler trace of the generation in DIR.
"""

import json
import os

import pytest

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.io.model_file import read_spec as jax_read_spec
from distributed_llama_tpu.quants.types import FloatType as JaxFloatType
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.io.model_file import read_spec
from distributed_llama_tpu_torch.quants.types import FloatType
from distributed_llama_tpu_torch.testing import write_legacy_copy

COMMON = ["generate", "--prompt", "hello world", "--steps", "10", "--seed", "9",
          "--temperature", "0", "--compute-dtype", "f32", "--cache-dtype", "f32"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("legacy")
    mpath, tpath = write_fixture(d, seed=44)
    return mpath, tpath, write_legacy_copy(mpath, str(d / "legacy.m"))


def _text(lines):
    """The generation's lines: from the prompt-token count on."""
    return lines[next(k for k, ln in enumerate(lines) if ln.startswith("💡")):]


def test_legacy_copy_reads_as_the_reference_header(fixture):
    """The copy's header is the 9-int legacy form: the same spec in both
    packages, weight type F32 unless the flag names it."""
    mpath, _, legacy = fixture
    with open(legacy, "rb") as f:
        assert int.from_bytes(f.read(4), "little") == 0xABCD00
    assert os.path.getsize(legacy) == os.path.getsize(mpath) - (
        _kv_header_size(mpath) - 40)
    for wt in (None, "q40"):
        mine = read_spec(legacy, FloatType[wt.upper()] if wt else None)
        theirs = jax_read_spec(legacy, JaxFloatType[wt.upper()] if wt else None)
        assert (mine.dim, mine.n_layers, mine.vocab_size, mine.seq_len,
                int(mine.weights_float_type), mine.rope_theta) == \
            (theirs.dim, theirs.n_layers, theirs.vocab_size, theirs.seq_len,
             int(theirs.weights_float_type), theirs.rope_theta)
    assert read_spec(legacy).weights_float_type == FloatType.F32


def _kv_header_size(path):
    with open(path, "rb") as f:
        f.seek(4)
        return int.from_bytes(f.read(4), "little")


def test_legacy_header_q40_prints_the_jax_cli_tokens(fixture, capsys):
    """F3 closed: --weights-float-type q40 on the legacy copy prints the
    JAX CLI's tokens, which are the KV-header file's."""
    mpath, tpath, legacy = fixture
    argv = COMMON + ["--tokenizer", tpath, "--weights-float-type", "q40"]
    jax_dllama.main(argv + ["--model", legacy])
    want = _text(capsys.readouterr().out.splitlines())
    dllama.main(argv + ["--model", legacy, "--device", "cpu"])
    got = _text(capsys.readouterr().out.splitlines())
    dllama.main(COMMON + ["--tokenizer", tpath, "--model", mpath, "--device", "cpu"])
    kv = _text(capsys.readouterr().out.splitlines())
    assert got == want == kv
    assert len(got) >= 2 and got[1]


def test_legacy_header_without_the_flag_fails_like_jax(fixture):
    """Without the flag the legacy Q40 file reads as F32 and both CLIs
    fail on the truncated tensor data."""
    _, tpath, legacy = fixture
    argv = COMMON + ["--tokenizer", tpath, "--model", legacy]
    with pytest.raises(EOFError) as mine:
        dllama.main(argv + ["--device", "cpu"])
    with pytest.raises(Exception) as theirs:
        jax_dllama.main(argv)
    assert "truncated" in str(mine.value) and "truncated" in str(theirs.value)


@pytest.mark.parametrize("wt", ["f32", "f16", "q80"])
def test_flag_contradicting_a_kv_header_gives_the_jax_error(fixture, wt):
    mpath, tpath, _ = fixture
    argv = COMMON + ["--tokenizer", tpath, "--model", mpath, "--weights-float-type", wt]
    with pytest.raises(ValueError) as mine:
        dllama.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as theirs:
        jax_dllama.main(argv)
    assert str(mine.value) == str(theirs.value)
    assert "does not match the model file header" in str(mine.value)


@pytest.mark.parametrize("flags,needle", [
    (["--workers", "10.0.0.1:9998", "10.0.0.2:9998"], "not applicable on a GPU"),
    (["--pallas"], "ROADMAP North star"),
    (["--no-pallas"], "ROADMAP North star"),
    (["--shard-vocab", "on"], "needs a tensor-parallel mesh (--tp > 1)"),
    (["--nnodes", "2", "--coordinator", "h:1234", "--node-rank", "1"],
     "non-root ranks must run `dllama worker`"),
    (["--nnodes", "2", "--node-rank", "1"],
     "--nnodes > 1 requires --coordinator host:port"),
    (["--nnodes", "2", "--coordinator", "h:1", "--connect-timeout", "5",
      "--device-sampling"], "--device-sampling does not compose with --nnodes"),
    (["--nnodes", "2", "--coordinator", "h:1", "--heartbeat-interval", "0"],
     "--heartbeat-interval and --worker-timeout must be positive"),
    (["--nnodes", "2", "--coordinator", "h:1", "--worker-timeout", "3"],
     "--worker-timeout 3 must be at least 2x --heartbeat-interval (2)"),
    (["--nnodes", "2", "--coordinator", "h:1", "--push-weights", "--draft",
      "self:1"], "--draft does not compose with --nnodes"),
], ids=["workers", "pallas", "no-pallas", "shard-vocab", "coordinator", "node-rank",
        "connect-timeout", "heartbeat-interval", "worker-timeout", "push-weights"])
def test_jax_flags_are_refused_by_item_not_by_argparse(flags, needle):
    """Each JAX flag parses in both CLIs (never argparse's exit 2); the
    port refuses it, or a combination the JAX CLI refuses (the cluster
    flags run since the multi-node control plane came), with a message
    naming why, before any model load."""
    argv = ["generate", "--model", "x.m", "--tokenizer", "x.t"] + flags
    jax_dllama.build_argparser().parse_args(argv)
    dllama.build_argparser().parse_args(argv)
    with pytest.raises(SystemExit) as e:
        dllama.main(argv)
    assert e.value.code != 2 and needle in str(e.value)


def test_workers_refusal_keeps_the_jax_words():
    with pytest.raises(SystemExit) as mine:
        dllama.main(["generate", "--workers", "a:1"])
    with pytest.raises(SystemExit) as theirs:
        jax_dllama.main(["generate", "--workers", "a:1"])
    assert str(theirs.value).startswith("error: --workers is not applicable on TPU")
    assert str(mine.value).startswith("error: --workers is not applicable on a GPU")
    assert "--nnodes/--coordinator + `dllama worker`" in str(mine.value)


def test_nthreads_is_accepted_and_ignored(fixture, capsys):
    mpath, tpath, _ = fixture
    argv = COMMON + ["--tokenizer", tpath, "--model", mpath, "--device", "cpu"]
    dllama.main(argv)
    plain = _text(capsys.readouterr().out.splitlines())
    dllama.main(argv + ["--nthreads", "4"])
    assert _text(capsys.readouterr().out.splitlines()) == plain


def test_profile_flags_do_not_collide():
    """--profile DIR is its own flag beside --profile-sample and
    --profile-dir, as in the JAX parser."""
    argv = ["api", "--profile", "d", "--profile-sample", "2", "--profile-dir", "e"]
    for parser in (dllama.build_argparser(), jax_dllama.build_argparser()):
        a = parser.parse_args(argv)
        assert (a.profile, a.profile_sample, a.profile_dir) == ("d", 2, "e")


@pytest.mark.parametrize("mode", ["generate", "inference"])
def test_cli_profile_writes_a_trace(fixture, tmp_path, capsys, mode):
    """--profile DIR: a torch.profiler Chrome trace of the generation in
    DIR/trace.json, and the same tokens as without it."""
    mpath, tpath, _ = fixture
    argv = COMMON[1:] + ["--tokenizer", tpath, "--model", mpath, "--device", "cpu"]
    dllama.main([mode] + argv)
    plain = capsys.readouterr().out
    pdir = str(tmp_path / "trace")
    dllama.main([mode] + argv + ["--profile", pdir])
    out = capsys.readouterr().out
    assert "profiler trace written" in out
    with open(os.path.join(pdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    keep = [ln for ln in out.splitlines() if "profiler trace" not in ln]
    if mode == "generate":
        assert _text(keep) == _text(plain.splitlines())
    else:
        assert [ln for ln in keep if ln.startswith("Generated tokens")] == \
            [ln for ln in plain.splitlines() if ln.startswith("Generated tokens")]


def test_chat_profile_writes_a_trace(fixture, tmp_path, monkeypatch, capsys):
    mpath, tpath, _ = fixture
    lines = iter(["", "hi there"])

    def fake_input(prompt=""):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError
    monkeypatch.setattr("builtins.input", fake_input)
    pdir = str(tmp_path / "chat")
    dllama.main(["chat", "--model", mpath, "--tokenizer", tpath, "--steps", "4",
                 "--temperature", "0", "--device", "cpu", "--profile", pdir])
    assert "profiler trace written" in capsys.readouterr().out
    with open(os.path.join(pdir, "trace.json")) as f:
        assert any(e.get("name", "").startswith("aten::")
                   for e in json.load(f)["traceEvents"])
