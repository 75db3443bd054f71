"""The CLI's serving over ranks end to end on the CPU (ROADMAP item 18):
`dllama api --tp 2` as its own process (rank 0 binds the port, one rank
is spawned and follows), and `dllama chat --tp 2` in this process as rank
0, each held against one rank of the port or the JAX CLI.

  * `api --serve-batch 2 --tp 2` with the prefix cache and a self:1 draft
    answers completions, chat completions and a batch with the one-rank
    server's text, /healthz is ok, and SIGTERM drains, joins the spawned
    rank and exits 0;
  * `api --tp 2` on the legacy path with `--session FILE`: the one-rank
    legacy server's text, and the session it saves at shutdown loads in a
    one-rank engine;
  * `chat --tp 2` on piped stdin prints the JAX CLI's `--tp 2` chat text,
    with `--profile DIR` one trace a rank;
  * `generate` speculating over ranks (a self-draft and prompt lookup at
    --tp 2, greedy lookup at --dp 2) prints the JAX CLI's text.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import api_server, dllama

F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]
COMPLETIONS = [("/v1/completions", {"prompt": "hello world", "max_tokens": 12}),
               ("/v1/chat/completions",
                {"messages": [{"role": "user", "content": "hi there"}],
                 "max_tokens": 10}),
               ("/v1/completions", {"prompt": "hello world again",
                                    "max_tokens": 12})]
BATCH = {"prompts": ["a b c", "d e"], "max_tokens": 8}
# a spawned server's start (imports, its rank, the model) and each wait
WAIT_S = 120


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(44), seq_len=160)


def _argv(files, *extra):
    mpath, tpath = files
    return ["api", "--model", mpath, "--tokenizer", tpath, "--device", "cpu",
            "--host", "127.0.0.1", "--port", "0", "--temperature", "0",
            "--seed", "3", *F32, *extra]


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


def _texts(port, batch: bool) -> list:
    out = []
    for path, body in COMPLETIONS:
        r = _post(port, path, dict(body, temperature=0))
        c = r["choices"][0]
        out.append(c["text"] if "text" in c else c["message"]["content"])
    if batch:
        r = _post(port, "/v1/batch/completions", dict(BATCH, temperature=0))
        out.append([c["message"]["content"] for c in r["choices"]])
    return out


def _one_rank(files, *extra, batch: bool):
    """The one-rank server's answers, in this process."""
    args = dllama.build_argparser().parse_args(_argv(files, *extra))
    server, state = api_server.build_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        return _texts(server.server_address[1], batch), state
    finally:
        server.shutdown()
        server.server_close()
        api_server.finish(state, drain_timeout=10.0)


def _ranks_server(files, *extra, batch: bool, ranks=("--tp", "2")):
    """`dllama api --tp 2 ...` (or over the axes in `ranks`) as a process:
    its answers and /healthz, then SIGTERM; its exit code and output."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llama_tpu_torch.apps.dllama",
         *_argv(files, *ranks, *extra)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    lines = []
    try:
        timer = threading.Timer(WAIT_S, proc.kill)
        timer.start()
        for line in proc.stdout:
            lines.append(line)
            if "listening on" in line:
                break
        timer.cancel()
        port = int(lines[-1].rsplit(":", 1)[1])
        texts = _texts(port, batch)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=WAIT_S) as r:
            health = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return texts, health, proc.returncode, "".join(lines) + rest


def test_cli_api_serve_batch_tp2_gives_the_one_rank_text(files):
    extra = ("--serve-batch", "2", "--prefix-cache", "--draft", "self:1",
             "--draft-len", "3")
    want, _ = _one_rank(files, *extra, batch=True)
    got, health, rc, out = _ranks_server(files, *extra, batch=True)
    assert got == want
    assert health["status"] == "ok"
    assert rc == 0, out
    assert "mesh dp=1 tp=2 over 2 ranks: gloo" in out
    assert "drained: all in-flight requests completed" in out


def test_cli_api_legacy_tp2_with_a_session(files, tmp_path):
    """The legacy path over ranks: every step an op of rank 0's request
    loop, its prefix reuse across requests, its session saved at shutdown
    (every rank's heads gathered to rank 0) and loadable on one rank."""
    path = str(tmp_path / "s.npz")
    want, state = _one_rank(files, batch=False)
    got, health, rc, out = _ranks_server(files, "--session", path,
                                         batch=False)
    assert got == want
    assert health["status"] == "ok" and rc == 0, out
    assert "saved session to" in out
    args = dllama.build_argparser().parse_args(_argv(files))
    engine, _, _ = dllama.build_engine(args)
    assert engine.load_session(path) == state.cached_tokens
    assert engine.pos == len(state.cached_tokens) > 0


def test_cli_chat_tp2_prints_the_jax_cli_text(files, tmp_path, capsys,
                                              monkeypatch):
    """`dllama chat --tp 2` on piped stdin: rank 0 (this process) reads the
    turns and prints the JAX CLI's --tp 2 chat text; EOF shuts the ranks
    down; --profile writes one trace a rank."""
    monkeypatch.setattr(dllama, "RANK_TIMEOUT_S", 60.0)
    mpath, tpath = files
    common = ["chat", "--model", mpath, "--tokenizer", tpath, "--steps", "12",
              "--seed", "9", "--temperature", "0", *F32, "--system-prompt",
              "be brief", "--tp", "2"]
    turns = "hello there\nand again\n"

    def run(main, argv):
        monkeypatch.setattr(sys, "stdin", io.StringIO(turns))
        main(argv)
        lines = capsys.readouterr().out.splitlines()
        return lines[next(i for i, line in enumerate(lines)
                          if line.startswith("👱")):]

    want = run(jax_dllama.main, common)
    prof = str(tmp_path / "prof")
    got = run(dllama.main, common + ["--device", "cpu", "--profile", prof])
    assert got[:-1] == want[:-1]
    assert "profiler traces written" in got[-1]
    for r in (0, 1):
        assert os.path.getsize(os.path.join(prof, f"rank{r}", "trace.json")) > 0


@pytest.mark.parametrize("ranks", [["--tp", "2", "--draft", "self:1"],
                                   ["--tp", "2", "--lookup-decode", "3"],
                                   ["--dp", "2", "--lookup-decode", "3"]],
                         ids=["tp-draft", "tp-lookup", "dp-lookup"])
def test_cli_generate_speculates_over_ranks(ranks, files, capsys, monkeypatch):
    """`dllama generate` speculating over ranks prints the JAX CLI's text:
    a self-draft or prompt lookup at --tp 2 (every rank runs the same
    loop), greedy lookup at --dp 2 through generate_batch_lookup (JAX
    apps/dllama.py:814-829)."""
    monkeypatch.setattr(dllama, "RANK_TIMEOUT_S", 60.0)
    mpath, tpath = files
    common = ["generate", "--model", mpath, "--tokenizer", tpath, "--prompt",
              "hello world hello world", "--steps", "12", "--seed", "9",
              "--temperature", "0", *F32, *ranks]

    def text(main, argv):
        main(argv)
        lines = capsys.readouterr().out.splitlines()
        return lines[next(i for i, line in enumerate(lines)
                          if line.startswith("💡")):]

    assert text(dllama.main, common + ["--device", "cpu"]) == \
        text(jax_dllama.main, common)
