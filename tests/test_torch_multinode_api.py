"""The legacy `dllama api` over a two-node cluster of the port on the CPU:
the root sends each request body as MSG_API and the worker replays it
through the legacy completion loop (apps/dllama.py cmd_worker), so the
answers equal the JAX package's server over a --tp 2 mesh (conftest's
virtual CPU devices, one process), with and without --lookup-decode. One
cluster serves every request of a case; the first case then checks the
root's /stats and /metrics cluster blocks and kills the worker with
SIGKILL: the root exits 43 with the ClusterPeerLost line within
--worker-timeout and a heartbeat. A replay that fails on the worker
alone ends the worker with its error and the root with exit 43."""

import json
import signal
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.testing import write_fixture
from torch_cluster import finish, free_port_pair, node, wait_line

F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]
HB, TIMEOUT = 0.3, 2.0
REQUESTS = [("/v1/chat/completions",
             {"messages": [{"role": "user", "content": "hi there"}],
              "max_tokens": 6, "temperature": 0}),
            ("/v1/completions", {"prompt": "abab abab abab", "max_tokens": 8,
                                 "temperature": 0}),
            ("/v1/completions", {"prompt": "hello world", "max_tokens": 5,
                                 "temperature": 0, "seed": 5})]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(44), seq_len=160)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read().decode()


def _answers(port):
    out = []
    for path, body in REQUESTS:
        r = _post(port, path, body)
        c = r["choices"][0]
        out.append((c["text"] if "text" in c else c["message"]["content"],
                    r["usage"]))
    return out


def _jax_answers(files, lookup):
    mpath, tpath = files
    args = jax_dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--temperature", "0",
         "--seed", "3", "--tp", "2", "--lookup-decode", str(lookup), *F32])
    engine, tokenizer, sampler = jax_dllama.build_engine(args)
    state = jax_api.ApiState(engine, tokenizer, sampler,
                             lookup_decode=lookup)
    server = ThreadingHTTPServer(("127.0.0.1", 0), jax_api.make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        return _answers(server.server_address[1])
    finally:
        server.shutdown()
        server.server_close()


def _cluster(files, lookup, push, worker_prelude=None):
    mpath, tpath = files
    common = ["--tokenizer", tpath, "--temperature", "0", "--seed", "3",
              "--lookup-decode", str(lookup), *F32,
              "--heartbeat-interval", str(HB), "--worker-timeout",
              str(TIMEOUT), *(["--push-weights"] if push else [])]
    port = free_port_pair()
    worker = node("worker", [*([] if push else ["--model", mpath]), *common],
                  port=port, rank=1, prelude=worker_prelude)
    root = node("api", ["--model", mpath, *common, "--host", "127.0.0.1",
                        "--port", "0"], port=port, rank=0)
    lines = wait_line(root, "listening on")
    at = next(ln for ln in lines if "listening on" in ln)
    return root, worker, int(at.rsplit(":", 1)[1]), lines


@pytest.mark.parametrize("lookup", [0, 5])
def test_two_node_legacy_api_answers_as_the_jax_tp2_server(files, lookup):
    want = _jax_answers(files, lookup)
    root, worker, port, head = _cluster(files, lookup, push=lookup == 0)
    try:
        assert _answers(port) == want
        if lookup:
            root.send_signal(signal.SIGTERM)
            rc, out = finish(root)
            wrc, wout = finish(worker)
            assert rc == 0 and wrc == 0, (out, wout)
            assert "🔌 root shut down — exiting" in wout
            return
        stats = json.loads(_get(port, "/stats"))
        cl = stats["cluster"]
        assert cl["nnodes"] == 2 and cl["peers_lost"] == []
        assert cl["bcast_tensors_bytes"] > 0          # the weight push
        assert stats["wire"]["peers"]["1"]["tx"]["API"]["frames"] == 3
        metrics = _get(port, "/metrics")
        assert ('dllama_wire_bytes_total{peer="1",kind="API",dir="tx"}'
                in metrics)
        assert 'dllama_heartbeat_rtt_ms{peer="1",quantile="0.5"}' in metrics
        assert "dllama_cluster_nnodes 2" in metrics
        # the worker dies: the root's link sees it and exits 43
        t_kill = time.monotonic()
        worker.send_signal(signal.SIGKILL)
        rc, out = finish(root, 60)
        took = time.monotonic() - t_kill
        assert rc == 43, "".join(head) + out
        lost = json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("🔴 cluster: "))
                          .split(": ", 1)[1])
        assert lost["event"] == "cluster_peer_lost" and lost["node_id"] == 1
        assert lost["phase"] == "serve"
        assert took < TIMEOUT + HB + 5.0, took
    finally:
        for p in (root, worker):
            if p.poll() is None:
                p.kill()
                p.communicate()


# the worker's replay of a request fails on that node alone (as a kernel
# or an allocation would): its own error, raised in the worker only
LOCAL_FAILURE = """
from distributed_llama_tpu_torch.apps import api_server

def _fail(state, body):
    raise RuntimeError("injected: this node's replay failed")
    yield

api_server._completion_chunks = _fail
"""


def test_worker_local_failure_in_a_replay_ends_the_cluster(files):
    """A failure of the worker's own replay (not one the root raised at
    the same point) is not passed over: the worker exits with its error,
    and the root, whose collectives for that request can no longer line
    up, exits 43 with the ClusterPeerLost line within --worker-timeout
    and a heartbeat of the worker's end."""
    root, worker, port, head = _cluster(files, 0, push=False,
                                        worker_prelude=LOCAL_FAILURE)
    try:
        path, body = REQUESTS[1]
        try:
            _post(port, path, body)
        except OSError:
            pass                  # the root's handler may fail or close
        wrc, wout = finish(worker, 60)
        t_end = time.monotonic()
        assert wrc not in (0, 43, 44), wout
        assert "injected: this node's replay failed" in wout
        assert "request failed" not in wout       # no resync, no warning
        rc, out = finish(root, 60)
        took = time.monotonic() - t_end
        assert rc == 43, "".join(head) + out
        lost = json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("🔴 cluster: "))
                          .split(": ", 1)[1])
        assert lost["event"] == "cluster_peer_lost" and lost["node_id"] == 1
        assert took < TIMEOUT + HB + 5.0, took
    finally:
        for p in (root, worker):
            if p.poll() is None:
                p.kill()
                p.communicate()
