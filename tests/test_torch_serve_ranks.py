"""Serving over ranks (parallel/control.py, ROADMAP item 18) held against
the JAX package and against the port on one rank, on the CPU.

The port's ranks are gloo processes (parallel/launch.RankPool, one pool of
2 and one of 4 ranks for the module, every job bounded by the pool's
timeout): rank 0 runs the host layers against its mirrored engine and the
other ranks run the follower loop (parallel/jobs.py). The JAX oracle is
its scheduler and engine on make_mesh(tp=...) over conftest's 8 virtual
CPU devices. The same numpy-seeded weights go to both
(tests/torch_mesh_cases.py); f32 with the exact reduce, so greedy tokens
compare exactly.

  * the scheduler with chunked prefill, the radix prefix cache (seeded for
    the later requests) and a self:1 draft, at tp = 2 and tp = 4 on the
    vocab-sharded engine: greedy tokens equal the JAX scheduler's on a
    vocab-sharded tp = 2 mesh and the port's on one rank; mixed greedy
    and sampled rows: greedy rows equal, sampled rows the same over two
    runs, served from the candidates; Mixtral, its experts dense;
  * the supervisor tier: its factory carries the mesh and the vocab split,
    and a crash before any op rebuilds and serves the same tokens;
  * sessions: a tp = 2 save loads in the JAX tp = 2 engine and in a
    one-rank port engine, and a JAX tp = 2 save in the port's tp = 2
    engine, each continuing with the uninterrupted run's tokens;
  * speculation: prompt lookup and the self-draft, greedy and sampled,
    over tp = 2, and generate_batch_lookup over dp = 2, equal one rank's;
  * the control channel: an idle wait past the channel's timeout keeps the
    followers; an op refused on every rank keeps them in step, one that
    fails on one rank loses the run everywhere, naming it; a dead follower
    fails rank 0 within the timeout, naming it; a dead rank 0 ends the
    followers' loop; the auto-sizing headroom is the least of any rank's,
    a shared card counted once.
"""

import pytest

from distributed_llama_tpu.runtime.draft import build_draft as jax_build_draft
from distributed_llama_tpu.runtime.prefix_cache import PrefixCache as JaxPrefixCache
from distributed_llama_tpu.runtime.scheduler import Scheduler as JaxScheduler
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu_torch.parallel import jobs
from distributed_llama_tpu_torch.parallel.launch import RankPool
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler
from torch_mesh_cases import F32, JOBS, Case

# the JAX _serve's requests (tests/test_vocab_shard.py:239-275): a shared
# 32-token system prefix (the later requests hit the radix cache) and 3
# tokens of their own, 10 new tokens each
SYS_PREFIX = list(range(40, 72))
PROMPTS = [SYS_PREFIX + [5 + i, 9, 3 + i] for i in range(6)]
N_NEW = 10
SERVE = dict(batch=2, chunk=16, prefix=(16, 8), draft="self:1", draft_len=4)
# the JAX tiny fixture's shape (vocab 288 splits over 2 and 4 ranks),
# with peaked logits: a sampled row's nucleus fits the candidates
CASE_KW = dict(seed=11, wcls_scale=20.0, vocab_size=288, seq_len=96)


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def llama():
    return Case("LLAMA", "dense", **CASE_KW)


def _requests(temps):
    return [(p, N_NEW, temps[i % len(temps)], 0.9, 1000 + i)
            for i, p in enumerate(PROMPTS)]


def _one_rank(case, requests, **kw):
    eng = Engine(case.pspec, case.params(), device="cpu", **F32)
    return jobs.serve_requests(eng, requests, **dict(SERVE, **kw))


def _jax_serve(case, requests, tp=2):
    """The JAX scheduler of tests/test_vocab_shard.py _serve on a
    vocab-sharded tp mesh."""
    eng = case.jax_engine(tp=tp, batch=2, shard_vocab=True)
    pc = JaxPrefixCache(eng, num_blocks=16, block_len=8)
    sched = JaxScheduler(eng, chunk=16, prefix_cache=pc,
                         draft_factory=lambda e: jax_build_draft(e, "self:1"),
                         draft_len=4, draft_vocab=case.spec.vocab_size)
    sched.warmup()
    try:
        reqs = [sched.submit(p, n, JaxSampler(case.spec.vocab_size, t, tp_,
                                              seed=sd, backend="python"))
                for p, n, t, tp_, sd in requests]
        while sched.has_work():
            sched.step()
        return [list(r.tokens()) for r in reqs]
    finally:
        sched.close()


@pytest.fixture(scope="module")
def greedy_want(llama):
    """The greedy requests' tokens on one rank of the port and through the
    JAX scheduler on a vocab-sharded tp = 2 mesh (computed once)."""
    reqs = _requests([0.0])
    return _one_rank(llama, reqs)["tokens"], _jax_serve(llama, reqs)


@pytest.mark.parametrize("tp", [2, 4])
def test_scheduler_greedy_over_tp_equals_jax_and_one_rank(tp, llama, pool2,
                                                          pool4, greedy_want):
    """Greedy serving over tp ranks through every scheduler path (chunked
    prefill, decode, the seeded prefix cache, the self-draft's verify):
    the JAX scheduler's tokens on a vocab-sharded tp = 2 mesh and the
    port's on one rank, bit for bit; the argmax from the sharded summary,
    no fallback; every op acknowledged by every rank."""
    reqs = _requests([0.0])
    got = (pool2 if tp == 2 else pool4).run(f"{JOBS}:serve", tp, llama.blob,
                                           F32, reqs, SERVE)
    assert got[1:] == [None] * (tp - 1)
    got = got[0]
    one, jax_want = greedy_want
    assert got["tokens"] == one == jax_want
    assert got["vocab_sample_stats"]["sharded"] > 0
    assert got["vocab_sample_stats"]["fallback"] == 0
    assert got["prefix"]["hits"] >= 4 and got["spec"]["drafted"] > 0
    assert got["control"]["ops"] > 0


def test_scheduler_mixed_rows_over_tp(llama, pool2):
    """Greedy and sampled rows together at tp = 2: greedy rows equal the
    JAX scheduler's and one rank's; sampled rows are the same over two
    runs and come from the candidate summary."""
    reqs = _requests([0.0, 0.8])
    a = pool2.run(f"{JOBS}:serve", 2, llama.blob, F32, reqs, SERVE)[0]
    b = pool2.run(f"{JOBS}:serve", 2, llama.blob, F32, reqs, SERVE)[0]
    assert a["tokens"] == b["tokens"]
    want, jax_want = _one_rank(llama, reqs)["tokens"], _jax_serve(llama, reqs)
    for i in range(0, len(reqs), 2):
        assert a["tokens"][i] == want[i] == jax_want[i]
    assert a["vocab_sample_stats"]["sharded"] > 0


def test_scheduler_mixtral_over_tp(pool2):
    """Mixtral at tp = 2 through the scheduler (its experts dense in the
    slot and verify forwards, as in the JAX package): greedy tokens equal
    one rank's and the JAX scheduler's."""
    case = Case("MIXTRAL", "dense", **CASE_KW)
    reqs = _requests([0.0])[:4]
    got = pool2.run(f"{JOBS}:serve", 2, case.blob, F32, reqs, SERVE)[0]
    assert got["tokens"] == _one_rank(case, reqs)["tokens"]
    assert got["tokens"] == _jax_serve(case, reqs)


def test_supervisor_tier_serves_on_tp_mesh(llama, pool2):
    """`dllama api --serve-batch N --tp T`'s tier (JAX
    test_vocab_shard.py:307): the factory carries the template's mesh and
    resolved vocab split, greedy requests serve the one-rank tokens, and a
    crash on rank 0's host before any op rebuilds the engine on every rank
    and serves the same tokens again."""
    prompts = [[1 + i, 5, 9] for i in range(3)]
    got = pool2.run(f"{JOBS}:supervise", 2, llama.blob, F32, prompts, 8,
                    dict(batch=2, chunk=16, stall_timeout=60.0,
                         backoff_base=0.01))[0]
    one = Engine(llama.pspec, llama.params(), device="cpu", **F32)
    want = []
    for i, p in enumerate(prompts):
        one.reset()
        want.append(one.generate(p, 8, Sampler(llama.spec.vocab_size, 0.0, 0.9,
                                                50 + i, backend="python")).tokens)
    assert got["mesh_carried"] and got["shard_vocab"]
    assert got["before"] == want == got["after"]
    assert got["failed"] and got["recoveries"] >= 1 and got["state"] == "ready"


def test_sessions_cross_ranks_and_packages(llama, pool2, tmp_path):
    """A tp = 2 session file (every rank's heads gathered to rank 0) loads
    in the JAX tp = 2 engine and in a one-rank port engine, and a JAX
    tp = 2 file in the port's tp = 2 engine; every continuation equals
    the uninterrupted run's tokens."""
    prompt, n = [1, 5, 9, 33, 7, 101], 6
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    first = pool2.run(f"{JOBS}:session_save", 2, llama.blob, F32, prompt, n,
                      port_file)[0]
    one = Engine(llama.pspec, llama.params(), device="cpu", **F32)
    whole = one.generate(prompt, 2 * n, Sampler(llama.spec.vocab_size, 0.0,
                                                0.9, 1, backend="python")).tokens
    assert first == whole[:n]
    want = whole[n:]

    one.reset()
    hist = one.load_session(port_file)
    assert hist == prompt + first[:-1] and one.pos == len(hist)
    assert one.generate([first[-1]], n, Sampler(
        llama.spec.vocab_size, 0.0, 0.9, 1, backend="python")).tokens == want

    jeng = llama.jax_engine(tp=2, shard_vocab=True)
    assert jeng.load_session(port_file) == hist
    jgreedy = JaxSampler(llama.spec.vocab_size, 0.0, 0.9, 1, backend="python")
    assert jeng.generate([first[-1]], n, jgreedy).tokens == want
    jeng.reset()
    jeng.generate(prompt, n, jgreedy)
    jeng.save_session(jax_file, tokens=hist)

    got = pool2.run(f"{JOBS}:session_load", 2, llama.blob, F32, jax_file,
                    first[-1], n)[0]
    assert got["history"] == hist and got["pos"] == len(hist)
    assert got["tokens"] == want


def test_speculation_over_ranks(llama, pool2):
    """Prompt lookup and the self:1 draft, greedy and sampled, at tp = 2
    (rank 0's host loops, each verify and draft step an op) equal one
    rank's streams; generate_batch_lookup over dp = 2 gives every row the
    one-rank greedy stream."""
    prompt = [1, 5, 9, 33, 7, 101, 5, 9, 33, 7]
    got = pool2.run(f"{JOBS}:speculate", 2, 1, llama.blob, F32, prompt, 12, 3)[0]
    one = Engine(llama.pspec, llama.params(), device="cpu", **F32)
    want = dict(lookup=one.generate_lookup(prompt, 12, draft_len=3).tokens)
    one.reset()
    d = one.new_draft("self:1")
    want["draft"] = one.generate_draft(prompt, 12, draft=d, draft_len=3).tokens
    one.reset()
    want["draft_sampled"] = one.generate_draft_sampled(
        prompt, 12, draft=d, temperature=0.8, topp=0.9, seed=7,
        draft_len=3).tokens
    one.reset()
    want["lookup_sampled"] = one.generate_lookup_sampled(
        prompt, 12, temperature=0.8, topp=0.9, seed=7, draft_len=3).tokens
    assert got == want
    rows = pool2.run(f"{JOBS}:speculate", 1, 2, llama.blob, dict(F32, batch=2),
                     prompt, 12, 3)[0]
    assert rows["rows"] == [want["lookup"]] * 2
    assert rows["accept"][1] == 24


def test_control_idle_past_the_timeout_keeps_the_followers(llama, pool2):
    """An idle rank 0 (3 s, past the channel's 1.5 s timeout) pings its
    followers, which wait through it: the next ops run and give the same
    tokens."""
    got = pool2.run(f"{JOBS}:control_idle", 2, llama.blob, F32, [1, 5, 9], 6,
                    1.5, 3.0)[0]
    assert got["after"] == got["before"] and got["pings"] >= 2


def test_control_errors_in_step_and_out_of_step(llama, pool2):
    """An op every rank refuses the same way (an empty prefix arena) keeps
    the ranks in step: rank 0 raises it, the next op runs. An op that
    fails on one rank only ends the run on every rank with the structured
    error naming that rank and what it raised."""
    got = pool2.run(f"{JOBS}:control_errors", 2, llama.blob, F32)
    assert "prefix arena of 0 blocks" in got[0]["refused"]
    assert got[0]["after"] == llama.spec.vocab_size
    assert got[0]["ranks"] == [1]
    for r in (0, 1):
        assert "op reset failed on rank(s) [1]" in got[r]["lost"]
        assert "RuntimeError: rank 1 alone" in got[r]["lost"]


def test_control_dead_follower_fails_rank_0_naming_it(llama):
    """A follower that exits makes rank 0's next op fail at once with the
    structured error naming it, well within the channel's timeout."""
    with RankPool(2, device_type="cpu", timeout_s=30) as pool:
        got = pool.run(f"{JOBS}:control_dead_follower", 2, llama.blob, F32,
                       20.0, partial=True)
    assert got[1] is None
    assert got[0]["ranks"] == [1] and "rank(s) [1] exited" in got[0]["error"]
    assert got[0]["seconds"] < 20.0 and got[0]["lost"]


def test_control_dead_root_ends_the_followers(llama):
    """A rank 0 that exits ends every follower's loop with the structured
    error in bounded time."""
    with RankPool(2, device_type="cpu", timeout_s=30) as pool:
        got = pool.run(f"{JOBS}:control_dead_root", 2, llama.blob, F32, 20.0,
                       partial=True)
    assert got[0] is None
    assert got[1]["error"] and "rank 1: serving over ranks lost" in got[1]["error"]
    assert got[1]["seconds"] < 20.0


def test_auto_sizing_reads_the_least_headroom_of_any_rank(pool2):
    """--serve-batch auto over ranks: the rank with the least headroom
    decides, and ranks sharing one card each count their share of its
    free bytes (two ranks on an 80 GB card size against 40 GB each)."""
    gib = 1 << 30
    stats = [dict(bytes_in_use=10 * gib, bytes_limit=80 * gib,
                  bytes_reserved=12 * gib),
             dict(bytes_in_use=20 * gib, bytes_limit=80 * gib,
                  bytes_reserved=22 * gib)]
    got = pool2.run(f"{JOBS}:least_headroom_of", 2, stats, 2)
    assert got[0] == got[1] == dict(bytes_in_use=20 * gib,
                                    bytes_limit=22 * gib + 29 * gib)
    alone = pool2.run(f"{JOBS}:least_headroom_of", 2, stats, 1)[0]
    assert alone == dict(bytes_in_use=20 * gib, bytes_limit=80 * gib)
