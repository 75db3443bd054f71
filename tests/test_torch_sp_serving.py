"""Serving over sp (the ring prefill as an op of the control channel): the
CLI's `chat --sp 2`, with a session saved after every turn and resumed in
a new run, prints the JAX CLI's `--sp 2` chat text, and the legacy
`api --sp 2` answers as the JAX server over an sp = 2 mesh (conftest's
virtual CPU devices, one process). The port's ranks are this process
(rank 0, which reads stdin or binds the port) and one spawned rank that
follows it; the chat's rank timeout is cut to 60 s."""

import io
import sys
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from test_torch_serve_ranks_cli import _ranks_server, _texts

F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(44), seq_len=160)


def test_chat_sp2_with_a_resumed_session_prints_the_jax_cli_text(
        files, tmp_path, capsys, monkeypatch):
    """Two turns saving the session, then a third in a new run resumed
    from it, over --sp 2: every rank runs each turn's ring prefill (a
    mirrored op) and steps in rank 0's order; the saved file gathers both
    shards' positions."""
    monkeypatch.setattr(dllama, "RANK_TIMEOUT_S", 60.0)
    mpath, tpath = files
    common = ["chat", "--model", mpath, "--tokenizer", tpath, "--steps", "10",
              "--seed", "9", "--temperature", "0", *F32, "--sp", "2"]

    def run(main, session, turns, system=True):
        monkeypatch.setattr(sys, "stdin", io.StringIO(turns))
        main(common + ["--session", session]
             + (["--system-prompt", "be brief"] if system else []))
        lines = capsys.readouterr().out.splitlines()
        return lines[next(i for i, line in enumerate(lines)
                          if line.startswith(("👱", "💾"))):]

    port, jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    want = run(jax_dllama.main, jax, "hello there\nand again\n")
    got = run(lambda a: dllama.main(a + ["--device", "cpu"]), port,
              "hello there\nand again\n")
    assert got == want
    want = run(jax_dllama.main, jax, "one more\n", system=False)
    got = run(lambda a: dllama.main(a + ["--device", "cpu"]), port,
              "one more\n", system=False)
    assert got[1:] == want[1:]
    assert got[0].startswith("💾 resumed session") and got[0] == want[
        0].replace(jax, port)


def test_legacy_api_sp2_answers_as_the_jax_sp2_server(files):
    """`dllama api --sp 2` (the legacy path) as a process: a request from
    position 0 prefills as one ring segment on both ranks, a request that
    reuses the cached prefix steps its suffix in chunks; the answers are
    the JAX server's over --sp 2."""
    mpath, tpath = files
    args = jax_dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--temperature", "0",
         "--seed", "3", "--sp", "2", *F32])
    engine, tokenizer, sampler = jax_dllama.build_engine(args)
    state = jax_api.ApiState(engine, tokenizer, sampler)
    server = ThreadingHTTPServer(("127.0.0.1", 0), jax_api.make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        want = _texts(server.server_address[1], batch=False)
    finally:
        server.shutdown()
        server.server_close()
    got, health, rc, out = _ranks_server(files, batch=False,
                                         ranks=("--sp", "2"))
    assert got == want
    assert health["status"] == "ok" and rc == 0, out
    assert "sp=2" in out
