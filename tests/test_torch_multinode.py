"""The port's multi-node cluster on the CPU (parallel/multihost.py,
apps/dllama.py `worker`, `--nnodes`): real clusters of OS processes on
127.0.0.1, each node a `dllama` process, held against the JAX CLI on
conftest's virtual CPU devices at the same axes (one process there).

  * a two-node `generate` prints the JAX CLI's `--tp 2` text: with the
    model file on both nodes, with a file-less `--push-weights` worker,
    and with `--lookup-decode` (the worker replays the lookup run from the
    RUN header);
  * two nodes of two ranks each print the JAX CLI's `--tp 4` text (a
    node's second rank gets the protocol from its first);
  * `inference` over two nodes completes its XFER_BENCH sequence and
    prints the G/I/T/H/S lines, S and the kB breakdown the JAX CLI's;
  * a worker with no root exits 44 at its --connect-timeout;
  * the cluster refusals give the JAX CLI's words.

Every node runs under a hard timeout (tests/torch_cluster.py).
"""

import numpy as np
import pytest

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from torch_cluster import finish, node, run_cluster, text_from

F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(44), seq_len=160)


def _argv(files, prompt="hello world, over two nodes", steps=8, *extra):
    mpath, tpath = files
    return ["--model", mpath, "--tokenizer", tpath, "--prompt", prompt,
            "--steps", str(steps), "--seed", "9", "--temperature", "0",
            *F32, *extra]


def _jax_text(capsys, mode, argv):
    jax_dllama.main([mode, *argv])
    return text_from(capsys.readouterr().out)


def _worker_argv(files, push: bool, *extra):
    mpath, tpath = files
    model = [] if push else ["--model", mpath]
    return [*model, "--tokenizer", tpath, "--temperature", "0", *F32,
            *(["--push-weights"] if push else []), *extra]


@pytest.mark.parametrize("push", [False, True], ids=["files", "push"])
def test_two_node_generate_prints_the_jax_cli_tp2_text(files, push, capsys):
    argv = _argv(files)
    want = _jax_text(capsys, "generate", [*argv, "--tp", "2"])
    (rc, out), [(wrc, wout)] = run_cluster(
        "generate", [*argv, *(["--push-weights"] if push else [])],
        _worker_argv(files, push))
    assert rc == 0 and wrc == 0, (out, wout)
    assert text_from(out) == want
    assert "mesh dp=1 tp=2 over 2 ranks: gloo" in out
    assert "⏳ worker rank 1 of 2 ready" in wout
    assert "🔌 root shut down — exiting" in wout
    assert ("⏩ <pushed>:" in wout) == push


def test_two_node_lookup_decode_prints_the_jax_cli_text(files, capsys):
    """The worker replays the lookup run from the RUN header's draft
    length: drafts mined from the same tokens, the same verify widths."""
    argv = _argv(files, "abab abab abab abab", 12, "--lookup-decode", "5")
    want = _jax_text(capsys, "generate", [*argv, "--tp", "2"])
    (rc, out), [(wrc, wout)] = run_cluster(
        "generate", argv, _worker_argv(files, False, "--lookup-decode", "5"))
    assert rc == 0 and wrc == 0, (out, wout)
    assert text_from(out) == want


def test_two_nodes_of_two_ranks_print_the_jax_cli_tp4_text(tmp_path, capsys):
    """--tp 4 over two nodes: each node runs two ranks, its second spawned
    by its first and fed the protocol by it (a fixture wide enough for
    four Q40 column shards)."""
    files = write_fixture(tmp_path, rng=np.random.default_rng(45),
                          seq_len=96, dim=128, hidden_dim=256, n_heads=8,
                          n_kv_heads=4)
    argv = _argv(files, "four ranks", 6, "--tp", "4")
    want = _jax_text(capsys, "generate", argv)
    (rc, out), [(wrc, wout)] = run_cluster(
        "generate", argv, _worker_argv(files, False, "--tp", "4"))
    assert rc == 0 and wrc == 0, (out, wout)
    assert text_from(out) == want
    assert "mesh dp=1 tp=4 over 4 ranks" in out


def _benchmark(out: str) -> tuple[list, list, list]:
    """(the 🔶 lines' S fields, the kB breakdown lines, the text line)."""
    lines = text_from(out)
    s_cols = [ln.rsplit(" S ", 1)[1] for ln in lines if ln.startswith("🔶")]
    kb = [ln for ln in lines if ln.startswith("  ") and ln.endswith(" kB")]
    return s_cols, kb, lines[1]


def test_two_node_inference_prints_the_transfer_columns(files, capsys):
    """inference over two nodes: the root's benchmark sends XFER_BENCH and
    both nodes run the same measure sequence (else the root would wait in
    a collective); S and its breakdown equal the JAX CLI's --tp 2 text
    (runtime/netstats.estimate_decode_wire for that mesh)."""
    argv = _argv(files, "columns", 5)
    jax_dllama.main(["inference", *argv, "--tp", "2"])
    want = capsys.readouterr().out
    (rc, out), [(wrc, wout)] = run_cluster("inference", argv,
                                           _worker_argv(files, False))
    assert rc == 0 and wrc == 0, (out, wout)
    s_got, kb_got, text_got = _benchmark(out)
    s_want, kb_want, text_want = _benchmark(want)
    assert text_got == text_want
    assert s_got == s_want and len(s_got) == 5
    assert kb_got == kb_want and kb_got
    line = next(ln for ln in text_from(out) if ln.startswith("🔶"))
    assert " T " in line and " H " in line
    avg = [ln for ln in text_from(out) if ln.startswith("Avg transfer (est):")]
    assert len(avg) == 1 and avg[0].endswith(
        next(ln for ln in text_from(want)
             if ln.startswith("Avg transfer")).rsplit(",", 1)[1])


def test_worker_with_no_root_exits_44_at_its_connect_timeout(files):
    from torch_cluster import free_port_pair

    w = node("worker", _worker_argv(files, False, "--connect-timeout", "1"),
             port=free_port_pair(), rank=1)
    rc, out = finish(w, 60)
    assert rc == 44, out
    assert "🔴 cluster formation failed: could not reach root control port" \
        in out
    assert "--connect-timeout" in out


# (argv, the JAX CLI's words); `jax` = the JAX CLI's main exits with them
# before any cluster work, so both CLIs are run
REFUSALS = [
    (["worker"], "error: worker mode needs a cluster — pass --nnodes N "
     "--node-rank r --coordinator host:port (single-host multi-device runs "
     "need no workers: use --tp N)", True),
    (["generate", "--nnodes", "2"],
     "error: --nnodes > 1 requires --coordinator host:port", True),
    (["generate", "--nnodes", "2", "--node-rank", "1", "--coordinator",
      "127.0.0.1:1"], "error: non-root ranks must run `dllama worker`", True),
    (["worker", "--nnodes", "2", "--coordinator", "127.0.0.1:1"],
     "error: rank 0 is the root — run a non-worker mode", True),
    (["generate", "--nnodes", "2", "--coordinator", "127.0.0.1:1",
      "--heartbeat-interval", "1", "--worker-timeout", "1.5"],
     "error: --worker-timeout 1.5 must be at least 2x --heartbeat-interval "
     "(1) — a node is only expected to produce a frame per heartbeat, so a "
     "tighter bound declares healthy peers lost (recommended: 3-5x)", True),
    (["chat", "--nnodes", "2", "--coordinator", "127.0.0.1:1", "--session",
      "s.npz"], "error: --session does not compose with --nnodes > 1 — a "
     "multi-process mesh's cache shards are not addressable from one host",
     True),
    (["generate", "--nnodes", "2", "--coordinator", "127.0.0.1:1",
      "--draft", "self:1"], "error: --draft does not compose with --nnodes "
     "(the worker protocol has no draft replay)", True),
    (["generate", "--nnodes", "2", "--coordinator", "127.0.0.1:1",
      "--device-sampling"], "error: --device-sampling does not compose with "
     "--nnodes (the worker protocol drives generate())", False),
    (["generate", "--nnodes", "2", "--coordinator", "127.0.0.1:1", "--dp",
      "2", "--lookup-decode", "3", "--temperature", "0"],
     "error: --lookup-decode with --dp does not compose with --nnodes",
     False),
    (["chat", "--nnodes", "2", "--coordinator", "127.0.0.1:1",
      "--lookup-decode", "3"],
     "error: --lookup-decode does not compose with --nnodes", False),
    (["api", "--nnodes", "2", "--coordinator", "127.0.0.1:1",
      "--serve-batch", "2"],
     "error: --serve-batch does not compose with --nnodes", False),
]


@pytest.mark.parametrize("argv,words,jax", REFUSALS,
                         ids=[str(i) for i in range(len(REFUSALS))])
def test_cluster_refusals_give_the_jax_words(argv, words, jax, monkeypatch):
    """Each refused before any model load or cluster work; where the JAX
    CLI refuses in main (before its cluster forms), its main gives the
    same words here. The others the JAX CLI gives after forming its
    cluster (cmd_generate, cmd_chat, serve)."""
    full = argv + ["--model", "x.m", "--tokenizer", "x.t"]
    with pytest.raises(SystemExit) as e:
        dllama.main(full)
    assert str(e.value) == words
    if jax:
        with pytest.raises(SystemExit) as e:
            jax_dllama.main(full)
        assert str(e.value) == words


def test_an_uneven_mesh_is_refused():
    with pytest.raises(SystemExit) as e:
        dllama.main(["generate", "--model", "x.m", "--tokenizer", "x.t",
                     "--nnodes", "2", "--coordinator", "127.0.0.1:1",
                     "--tp", "3"])
    assert str(e.value) == ("error: the mesh's 3 ranks do not split evenly "
                            "over --nnodes 2 (each node runs the same number "
                            "of ranks)")
