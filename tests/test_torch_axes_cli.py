"""The CLI over the other mesh axes (--pp, --ep, --sp) on the tiny
fixtures, held against the JAX CLI on conftest's 8 virtual CPU devices,
and the refusals of what does not run over them yet.

  * `generate --pp 2 / --ep 2 / --sp 2` prints the JAX CLI's text;
  * `chat --pp 2` and `chat --ep 2` (with a session over ep) print the JAX
    CLI's chat text, and the legacy `api --pp 2 / --ep 2` answers with the
    one-rank server's text: the control channel's ops carry them
    (parallel/control.py);
  * the scheduler over any new axis, a model draft on a mesh and
    --session with --pp are refused in the JAX words; a grid the model
    does not fit in the JAX engine's words (chat and the legacy api over
    sp: tests/test_torch_sp_serving.py).

Each port run is one command: this process is rank 0 and prints, the
other ranks are spawned (parallel/launch.run_ranks) with the CLI's rank
timeout cut to 60 s (the api server is a process of its own). Both CLIs
run at their defaults (Q40 weights, --buffer-float-type q80): under --pp
both print the notice that Q80 is ignored and run without Q80
activations; under --ep the experts' inputs skip the round trip in both
(the JAX _ep_body quirk).
"""

import io
import sys

import numpy as np
import pytest

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.models import ArchType as JArch
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from test_torch_serve_ranks_cli import _one_rank, _ranks_server

MOE = dict(arch=JArch.MIXTRAL, n_experts=4, n_active_experts=2)

PP_NOTICE = "⏩ --pp uses exact collectives; ignoring --buffer-float-type q80"


def _text(lines):
    return lines[next(k for k, line in enumerate(lines)
                      if line.startswith("💡")):]


@pytest.mark.parametrize("axis,moe", [("pp", False), ("ep", True),
                                      ("sp", False)])
def test_cli_generate_over_an_axis_prints_the_jax_cli_text(
        axis, moe, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(dllama, "RANK_TIMEOUT_S", 60.0)
    mpath, tpath = write_fixture(tmp_path, seed=51, **(MOE if moe else {}))
    common = ["generate", "--model", mpath, "--tokenizer", tpath,
              "--prompt", "hello world, over the ranks", "--steps", "12",
              "--seed", "9", "--temperature", "0", "--compute-dtype", "f32",
              "--cache-dtype", "f32", f"--{axis}", "2"]
    jax_dllama.main(common)
    want = capsys.readouterr().out.splitlines()
    dllama.main(common + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert any(f"{axis}=2" in line and "gloo" in line for line in got)
    assert (PP_NOTICE in got) == (PP_NOTICE in want) == (axis == "pp")
    assert _text(got) == _text(want)


def _fixture(tmp_path, axis: str):
    """The tiny fixture of the serving tests, a MoE one for --ep."""
    return write_fixture(tmp_path, rng=np.random.default_rng(44),
                         seq_len=160, **(MOE if axis == "ep" else {}))


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_cli_chat_over_pp_and_ep_prints_the_jax_cli_text(axis, tmp_path,
                                                         capsys, monkeypatch):
    """`dllama chat --pp 2 / --ep 2` on piped stdin: rank 0 (this process)
    reads two turns and prints the JAX CLI's chat text, every step an op
    of the control channel; over ep the session is saved after each turn
    (JAX refuses --session with --pp)."""
    monkeypatch.setattr(dllama, "RANK_TIMEOUT_S", 60.0)
    mpath, tpath = _fixture(tmp_path, axis)
    common = ["chat", "--model", mpath, "--tokenizer", tpath, "--steps", "12",
              "--seed", "9", "--temperature", "0", "--compute-dtype", "f32",
              "--cache-dtype", "f32", "--system-prompt", "be brief",
              f"--{axis}", "2"]
    session = (lambda name: ["--session", str(tmp_path / name)]) \
        if axis == "ep" else (lambda name: [])

    def run(main, argv):
        monkeypatch.setattr(sys, "stdin", io.StringIO("hello there\nand again\n"))
        main(argv)
        lines = capsys.readouterr().out.splitlines()
        return lines[next(i for i, line in enumerate(lines)
                          if line.startswith("👱")):]

    want = run(jax_dllama.main, common + session("jax.npz"))
    assert run(dllama.main, common + session("port.npz") + ["--device", "cpu"]) \
        == want
    if axis == "ep":
        assert (tmp_path / "port.npz").stat().st_size > 0


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_cli_api_legacy_over_pp_and_ep_gives_the_one_rank_text(axis,
                                                               tmp_path):
    """The legacy api over --pp 2 / --ep 2 as a process: rank 0's request
    loop steps through the control channel's ops and answers with the one
    rank server's text; SIGTERM ends it with code 0. Under --pp both
    sides run without Q80 activations, which the CLI drops there."""
    files = _fixture(tmp_path, axis)
    extra = ("--buffer-float-type", "f32") if axis == "pp" else ()
    want, _ = _one_rank(files, *extra, batch=False)
    got, health, rc, out = _ranks_server(files, *extra, batch=False,
                                         ranks=(f"--{axis}", "2"))
    assert got == want
    assert health["status"] == "ok" and rc == 0, out
    assert f"{axis}=2" in out


@pytest.mark.parametrize("argv,needle", [
    (["chat", "--sp", "2", "--draft", "model:x.m"],
     "--draft model:PATH needs a mesh-less engine (use --draft "
     "self:<depth>, which shares the target's sharded buffers)"),
    (["api", "--serve-batch", "2", "--sp", "2"],
     "--serve-batch needs a single-process engine (no --dp/--sp/--ep/--pp; "
     "--tp composes)"),
    (["api", "--serve-batch", "2", "--ep", "2"],
     "--serve-batch needs a single-process engine (no --dp/--sp/--ep/--pp; "
     "--tp composes)"),
    (["chat", "--pp", "2", "--session", "s.npz"],
     "--session does not compose with --nnodes or --pp"),
])
def test_cli_serving_over_the_new_axes_is_refused(argv, needle):
    """chat and the legacy api run over sp (tests/test_torch_sp_serving.py);
    a model draft on a mesh, the scheduler over any new axis and --session
    with --pp are refused in the JAX words. Each before any model load or
    rank spawn."""
    with pytest.raises(SystemExit) as e:
        dllama.main(argv + ["--model", "x.m", "--tokenizer", "x.t"])
    assert needle in str(e.value)


@pytest.mark.parametrize("axis,n,needle", [
    ("ep", 2, "--ep requires a MoE model (experts to place)"),
    ("pp", 3, "pp=3 must divide n_layers=2"),
    ("sp", 3, "sp=3 must divide max_seq_len=160 (sp-sharded KV cache)"),
])
def test_cli_refuses_a_grid_the_model_does_not_fit(axis, n, needle, tmp_path,
                                                   monkeypatch):
    """The JAX engine's placement rules, in its words, checked on the
    dense fixture's header on every rank before any weight is read."""
    monkeypatch.setattr(dllama, "RANK_TIMEOUT_S", 60.0)
    mpath, tpath = write_fixture(tmp_path, seed=52)
    with pytest.raises((SystemExit, RuntimeError)) as e:
        dllama.main(["generate", "--model", mpath, "--tokenizer", tpath,
                     "--steps", "2", f"--{axis}", str(n), "--device", "cpu"])
    assert needle in str(e.value)
