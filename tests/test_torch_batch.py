"""The port's batch generators and POST /v1/batch/completions held against
the JAX package's (runtime/engine.py generate_batch, generate_batch_stream,
generate_batch_device, generate_batch_lookup; apps/api_server.py
_batch_completion_chunks), on the CPU, all f32.

The same prompts and seeds through both engines (dense weights, B = 3,
ragged prompts, one row reaching the context's end) must give the same
tokens, exactly: greedy and sampled host loops, the device loop (the JAX
loop's per-row xorshift streams, bit for bit), the batched prompt lookup
and its accept record, the caller's stop flags. With CUDA's graph capture
faked, the device loop captures one graph a sampler configuration and the
lookup one verify graph a width. The batch endpoint must give the JAX
server's texts, finish reasons and usage, streamed or not, with and
without --lookup-decode, and wait for a request already streaming.
"""

import http.client
import json
import threading
import types
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.apps import api_server as jax_api
from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.models import params as jax_params
from distributed_llama_tpu.models.spec import ArchType as JaxArch
from distributed_llama_tpu.models.spec import HiddenAct as JaxAct
from distributed_llama_tpu.models.spec import ModelSpec as JaxSpec
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import api_server, dllama
from distributed_llama_tpu_torch.models.params import load_params, random_tensors
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.runtime import engine as engine_mod
from distributed_llama_tpu_torch.runtime import graphs
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.runtime.profiler import COMPILES
from distributed_llama_tpu_torch.sampler import Sampler

SEQ, B = 48, 3
# ragged prompts; the last row's 40 tokens reach S = 48 within a run
PROMPTS = [[1, 5, 9, 13], [2, 7], [3] + list(range(4, 43))]
F32 = ["--compute-dtype", "f32", "--cache-dtype", "f32"]


@pytest.fixture(scope="module")
def engines():
    """The port's and the JAX package's batch-B engines over the same dense
    f32 weights (seed 3, tests/test_scheduler.py's model)."""
    kw = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=SEQ)
    spec = ModelSpec(arch=ArchType.LLAMA, hidden_act=HiddenAct.SILU, **kw)
    jspec = JaxSpec(arch=JaxArch.LLAMA, hidden_act=JaxAct.SILU, **kw)
    params = load_params(spec, random_tensors(spec, seed=3, scale=0.05),
                         mode="dense", dtype=torch.float32, device="cpu")
    jp = jax_params.load_params(jspec, jax_params.random_tensors(
        jspec, seed=3, scale=0.05), mode="dense", dtype=jnp.float32)
    eng = Engine(spec, params, device="cpu", batch=B, prefill_chunk=16,
                 compute_dtype=torch.float32, cache_dtype=torch.float32)
    jeng = JaxEngine(jspec, jp, batch=B, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32)
    return eng, jeng


@pytest.mark.parametrize("temperature,topp", [(0.0, 0.9), (0.8, 0.9), (1.0, 1.0)],
                         ids=["greedy", "top-p", "multinomial"])
def test_generate_batch_matches_jax(engines, temperature, topp):
    """Tokens equal to the JAX engine's, exactly (one shared Sampler, coins
    drawn in row order); the eos stop and pos too."""
    eng, jeng = engines
    got = eng.generate_batch(PROMPTS, 12, Sampler(128, temperature, topp, 7), eos_id=91)
    want = jeng.generate_batch(PROMPTS, 12, JaxSampler(128, temperature, topp, 7,
                                                       backend="python"), eos_id=91)
    assert got == want
    assert eng.pos == jeng.pos


def test_generate_batch_stream_stop_flags_match_jax(engines):
    """A row flagged before the first step never samples; a row flagged
    between steps stops: every step's yield equal to the JAX stream's."""
    eng, jeng = engines
    streams = []
    for e, smp in ((eng, Sampler(128, 0.8, 0.9, 5)),
                   (jeng, JaxSampler(128, 0.8, 0.9, 5, backend="python"))):
        flags = np.asarray([False, False, True])
        steps = []
        for k, step in enumerate(e.generate_batch_stream(PROMPTS, 10, smp,
                                                         stop_flags=flags)):
            steps.append(list(step))
            if k == 3:
                flags[0] = True
        streams.append((steps, smp.rng_state))
    assert streams[0] == streams[1]
    assert streams[0][0][0][2] is None and all(s[0] is None for s in streams[0][0][5:])


@pytest.mark.parametrize("temperature,topp,eos", [(0.0, 0.9, None), (0.8, 0.9, None),
                                                  (0.8, 1.0, 91), (0.8, 0.9, 91)],
                         ids=["greedy", "top-p", "multinomial-eos", "top-p-eos"])
def test_generate_batch_device_matches_jax(engines, temperature, topp, eos):
    """The device loop equal to the JAX loop bit for bit: row i on its own
    xorshift stream seed + i, rows stopping at eos or at S, the iteration
    count and pos."""
    eng, jeng = engines
    kw = dict(temperature=temperature, topp=topp, seed=11, eos_id=eos)
    for n in (12, 60):
        got = eng.generate_batch_device(PROMPTS, n, **kw)
        want = jeng.generate_batch_device(PROMPTS, n, **kw)
        assert got == want, n
        assert eng.last_device_steps == jeng.last_device_steps
        assert eng.pos == jeng.pos


def test_generate_batch_lookup_matches_jax(engines):
    """Per-row drafts, one verify a step: tokens and the accept record
    equal to the JAX engine's, with a pre-retired row and an eos."""
    eng, jeng = engines
    for kw in (dict(draft_len=3), dict(draft_len=5, eos_id=91),
               dict(draft_len=2, stop_flags=np.asarray([False, True, False]))):
        got = eng.generate_batch_lookup(PROMPTS, 20, **kw)
        want = jeng.generate_batch_lookup(PROMPTS, 20, **kw)
        assert got == want, kw
        assert eng.last_accept_stats == jeng.last_accept_stats
        assert eng.pos == jeng.pos


def test_zero_budget_and_bad_batches(engines):
    eng, jeng = engines
    assert eng.generate_batch(PROMPTS, 0, Sampler(128, 0.0, 0.9, 1)) == [[]] * B
    assert eng.generate_batch_device(PROMPTS, 0, temperature=0.8, topp=0.9, seed=1) \
        == jeng.generate_batch_device(PROMPTS, 0, temperature=0.8, topp=0.9, seed=1)
    assert eng.generate_batch_lookup(PROMPTS, 0) == jeng.generate_batch_lookup(PROMPTS, 0)
    assert eng.last_accept_stats == jeng.last_accept_stats == (1, 0)
    with pytest.raises(ValueError, match="slots"):
        eng.generate_batch(PROMPTS[:2], 4, Sampler(128, 0.0, 0.9, 1))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate_batch([[1], [], [2]], 4, Sampler(128, 0.0, 0.9, 1))
    with pytest.raises(ValueError, match="context overflow"):
        eng.generate_batch_device([[1] * SEQ, [1], [1]], 4, temperature=0.0, topp=0.9,
                                  seed=1)


def _fake_capture(fn):
    """CUDA graph capture faked on the CPU: a replay reruns fn eagerly and
    copies its outputs into the captured ones, as a real replay rewrites
    its pool."""
    out = fn()

    def leaves(o):
        return [o] if isinstance(o, torch.Tensor) else list(o or ())

    def replay():
        for a, b in zip(leaves(out), leaves(fn())):
            a.copy_(b)
    return graphs.CapturedStep(types.SimpleNamespace(replay=replay, reset=lambda: None),
                               out, (0,) * len(graphs.LAUNCH_COUNTERS), 0.001, 0)


def test_batch_graphs_with_faked_capture(engines, monkeypatch):
    """Under graphs: the device loop captures one ("bdsample", ...) graph a
    sampler configuration whatever max_tokens and seed (the loop's warm-up
    run writes nothing), the lookup one ("slot_verify", T, vocab) a width T
    <= 1 + draft_len; every token equals the eager run's."""
    eng, _ = engines
    want = {n: eng.generate_batch_device(PROMPTS, n, temperature=0.8, topp=0.9, seed=s)
            for n, s in ((9, 4), (30, 6))}
    want_lookup = eng.generate_batch_lookup(PROMPTS, 20, draft_len=4)
    monkeypatch.setattr(engine_mod, "capture", _fake_capture)
    COMPILES.reset()
    eng.cuda_graphs = True
    try:
        for n, s in ((9, 4), (30, 6)):
            assert eng.generate_batch_device(PROMPTS, n, temperature=0.8, topp=0.9,
                                             seed=s) == want[n]
        assert eng.generate_batch_lookup(PROMPTS, 20, draft_len=4) == want_lookup
        keys = list(eng.graphs)
        assert keys.count(("bdsample", 0.8, 0.9, 128, ())) == 1
        widths = [k[1] for k in keys if k[0] == "slot_verify"]
        assert widths and all(1 <= t <= 5 for t in widths)
        assert len(keys) == 1 + len(widths) + ("slot_decode" in keys)
        assert COMPILES.summary()["total"] == len(keys)
    finally:
        eng.cuda_graphs = False
        eng.graphs.clear()
        COMPILES.reset()


# -- POST /v1/batch/completions --------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("fx"),
                         rng=np.random.default_rng(42), seq_len=96)


def _states(files, **kw):
    """(port, JAX) ApiStates over the tiny Q40 fixture, f32, greedy."""
    mpath, tpath = files
    argv = ["api", "--model", mpath, "--tokenizer", tpath, "--temperature", "0",
            "--seed", "3", *F32]
    engine, tokenizer, sampler = dllama.build_engine(
        dllama.build_argparser().parse_args(argv + ["--device", "cpu"]))
    port = api_server.ApiState(engine, tokenizer, sampler, model_name="tiny",
                               serve_batch=3, serve_chunk=16, **kw)
    engine, tokenizer, sampler = jax_dllama.build_engine(
        jax_dllama.build_argparser().parse_args(argv))
    jax = jax_api.ApiState(engine, tokenizer, sampler, model_name="tiny",
                           serve_batch=3, serve_chunk=16, **kw)
    return port, jax


@pytest.fixture(scope="module")
def servers(files):
    """{(package, lookup): (address, state)}: both servers with
    --serve-batch 3, and with --lookup-decode 4 too."""
    out, made = {}, []
    for lookup in (0, 4):
        for pkg, state, handler in zip(("port", "jax"),
                                       _states(files, lookup_decode=lookup),
                                       (api_server.make_handler, jax_api.make_handler)):
            server = ThreadingHTTPServer(("127.0.0.1", 0), handler(state))
            threading.Thread(target=server.serve_forever, daemon=True).start()
            made.append((server, state))
            out[(pkg, lookup)] = server.server_address, state
    yield out
    for server, state in made:
        server.shutdown()
        if state._scheduler is not None:
            state._scheduler.close()


def _post(addr, body, route="/v1/batch/completions"):
    conn = http.client.HTTPConnection(*addr, timeout=240)
    conn.request("POST", route, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


def _shape(status, raw, stream):
    """What must agree between the servers: the status, and each row's
    text and finish reason (and the usage) or the SSE rows' pieces."""
    if status != 200:
        return status, None
    if stream:
        events = [json.loads(line[6:]) for line in raw.splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        assert raw.rstrip().endswith("data: [DONE]")
        rows: dict = {}
        for e in events:
            c = e["choices"][0]
            r = rows.setdefault(c["index"], ["", None])
            r[0] += c["delta"].get("content", "")
            r[1] = c["finish_reason"] or r[1]
        return status, sorted(rows.items())
    body = json.loads(raw)
    assert body["object"] == "chat.completion"
    return status, ([(c["index"], c["message"]["content"], c["finish_reason"])
                     for c in body["choices"]], body["usage"])


BODIES = [
    {"prompts": ["abab", "ba", "hello world"], "max_tokens": 6},
    {"prompts": ["abab", "ba"], "max_tokens": 8, "stop": "a"},
    {"messages_list": [[{"role": "user", "content": "ab"}],
                       [{"role": "user", "content": "hi there"}]], "max_tokens": 5},
    {"prompts": ["ab", "ba"], "max_tokens": 0},
    {"prompts": ["ab", "ba", "x", "y"], "max_tokens": 2},
    {"prompts": ["ab"], "max_tokens": 3, "temperature": "hot"},
    {"prompts": ["ab", "cd"], "max_tokens": 6, "temperature": 0.9, "seed": 5},
]


@pytest.mark.parametrize("lookup", [0, 4], ids=["plain", "lookup"])
@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
@pytest.mark.parametrize("body", BODIES, ids=["raw", "stop", "chat", "unlimited",
                                             "too-many", "bad-temperature", "sampled"])
def test_batch_endpoint_matches_jax(servers, body, stream, lookup):
    """The same request to both servers: the same status, and the same
    texts, finish reasons and usage (or SSE rows)."""
    req = {"temperature": 0, **body, "stream": stream}
    got = _shape(*_post(servers[("port", lookup)][0], req), stream)
    want = _shape(*_post(servers[("jax", lookup)][0], req), stream)
    assert got == want


def test_batch_endpoint_off_without_serve_batch(files):
    mpath, tpath = files
    engine, tokenizer, sampler = dllama.build_engine(dllama.build_argparser().parse_args(
        ["api", "--model", mpath, "--tokenizer", tpath, "--device", "cpu", *F32]))
    state = api_server.ApiState(engine, tokenizer, sampler)
    server = ThreadingHTTPServer(("127.0.0.1", 0), api_server.make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert _post(server.server_address, {"prompts": ["x"]})[0] == 404
    finally:
        server.shutdown()


def test_batch_endpoint_waits_for_a_running_stream(servers, files):
    """exclusive() under load: a batch request sent while a scheduler
    stream decodes waits for it; the stream's text and the batch's equal
    the ones each gives alone."""
    import time

    addr, state = servers[("port", 0)]
    stream = {"prompt": "tell me", "max_tokens": 40, "temperature": 0, "stream": True}
    batch = {"prompts": ["abab", "ba"], "max_tokens": 6, "temperature": 0}

    def both(stream_resp, batch_resp):
        return (stream_resp[0], _streamed_text(stream_resp[1]), _shape(*batch_resp, False))
    alone = both(_post(addr, stream, "/v1/completions"), _post(addr, batch))
    sup = state._scheduler
    before = sup.stats.tokens_out
    res = {}
    t = threading.Thread(target=lambda: res.setdefault(
        "stream", _post(addr, stream, "/v1/completions")))
    t.start()
    end = time.monotonic() + 60
    while sup.stats.tokens_out == before:   # the stream is decoding
        assert time.monotonic() < end, "the stream never decoded"
        time.sleep(0.001)
    res["batch"] = _post(addr, batch)
    t.join(timeout=240)
    assert both(res["stream"], res["batch"]) == alone
    assert alone[0] == 200 and alone[1] and alone[2][0] == 200


def _streamed_text(raw: str) -> str:
    return "".join(json.loads(line[6:])["choices"][0]["text"]
                   for line in raw.splitlines()
                   if line.startswith("data: ") and line != "data: [DONE]")


def test_streamed_lookup_batch_captures_beside_its_borrow(servers, monkeypatch):
    """A streamed greedy batch with --lookup-decode collects on a helper
    thread while the borrow holds the device gate. On the card the helper
    captures a verify width at its first use, which takes the gate
    exclusively (runtime/graphs.py); the borrow hands its hold to the
    helper, so that capture does not wait on the HTTP thread that waits
    for the helper. Here the helper takes the gate exclusively as that
    capture would, and the stream answers as the JAX server's."""
    from distributed_llama_tpu_torch.runtime import graphs

    addr, state = servers[("port", 4)]
    engine = state._scheduler.engine
    plain = engine.generate_batch_lookup
    took = []

    def capturing(*a, **kw):
        with graphs.DEVICE_GATE.exclusive():
            took.append(threading.get_ident())
        return plain(*a, **kw)
    monkeypatch.setattr(engine, "generate_batch_lookup", capturing)
    req = {"prompts": ["abab", "ba"], "max_tokens": 8, "temperature": 0, "stream": True}
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("got", _post(addr, req)),
                         daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the streamed lookup batch deadlocked on the device gate"
    assert _shape(*res["got"], True) == _shape(*_post(servers[("jax", 4)][0], req), True)
    assert len(took) == 1 and took[0] != threading.get_ident()
