"""Jobs for a RankPool (parallel/launch.py): each runs on every rank of the
pool's process group, builds its mesh, and returns what that rank saw as
host values (numpy arrays, lists, numbers). The CPU tests hold these
results against the JAX package; chip_smoke.py runs its own jobs.

The serving jobs (`serve`, `supervise`, `session_save`, `session_load`,
`speculate`, `control_idle`, `control_dead_follower`,
`control_dead_root`) run serving over ranks as the CLI does: every rank
builds its engine and the control channel (parallel/control.py), rank 0
runs the host layers against the mirrored engine and the other ranks run
the follower loop; rank 0 returns what it served, the others None.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sharded_vocab import embed_tokens_sharded, sharded_sample_prep
from ..parallel import collectives
from ..parallel.mesh import make_mesh
from ..parallel.sharding import row_shard
from .launch import unpack


def host(x):
    """A result as host values: tensors to numpy (bf16 through f32),
    dicts, tuples and lists element by element."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):     # NamedTuple
        return type(x)(*(host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    return x


def collective(tp: int, op: str, xs: list) -> np.ndarray:
    """collectives.<op> of rank r's xs[r] over a tp-rank mesh."""
    mesh = make_mesh(tp=tp, device_type="cpu")
    return host(getattr(collectives, op)(torch.from_numpy(xs[mesh.rank]),
                                         mesh))


def default_mesh_device(tp: int) -> str:
    """The device of a mesh built with no device_type on this rank's gloo
    group, or what building it raised."""
    try:
        return str(make_mesh(tp=tp).device)
    except RuntimeError as e:
        return str(e)


def vocab(tp: int, emb: np.ndarray, tokens: np.ndarray, logits: np.ndarray,
          temps: np.ndarray, n_vocab: int, k: int) -> dict:
    """The vocab split on a tp-rank mesh: the embedding of `tokens` from
    each rank's rows of `emb`, and the sampling summary of each rank's
    slice of `logits`."""
    mesh = make_mesh(tp=tp, device_type="cpu")
    x = embed_tokens_sharded(row_shard(torch.from_numpy(emb), tp, mesh.rank),
                             torch.from_numpy(tokens), mesh, torch.float32)
    vl = logits.shape[-1] // tp
    lg = torch.from_numpy(logits[:, mesh.rank * vl:(mesh.rank + 1) * vl])
    prep = sharded_sample_prep(lg, torch.from_numpy(temps), mesh, n_vocab, k)
    return host(dict(emb=x, prep=prep))


def _engine(tp: int, dp: int, blob: bytes, engine_kw: dict):
    """An Engine over a (dp, tp) mesh of CPU ranks from the full params in
    `blob` (pack((spec, params)))."""
    from ..runtime.engine import Engine

    spec, params = unpack(blob)
    return Engine(spec, params, mesh=make_mesh(tp=tp, dp=dp, device_type="cpu"),
                  **engine_kw)


def engine_calls(tp: int, dp: int, blob: bytes, engine_kw: dict,
                 calls: list) -> dict:
    """Each (method, args, kwargs) of `calls`, in order, on an Engine over
    a (dp, tp) mesh of CPU ranks; their results and the mesh's stats."""
    eng = _engine(tp, dp, blob, engine_kw)
    out = [host(getattr(eng, m)(*a, **kw)) for m, a, kw in calls]
    return dict(results=out, stats=dict(eng.mesh.stats),
                vocab_sample_stats=dict(eng.vocab_sample_stats),
                shard_vocab=eng.shard_vocab, tp_reduce=eng.tp_reduce)


def refusals(tp: int, dp: int, blob: bytes, engine_kw: dict,
             calls: list) -> list[str]:
    """What each (method, args, kwargs) of `calls` raises (ValueError) on
    an Engine over a (dp, tp) mesh of CPU ranks; "" where it raised
    nothing."""
    eng = _engine(tp, dp, blob, engine_kw)
    out = []
    for m, a, kw in calls:
        try:
            host(getattr(eng, m)(*a, **kw))
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return out


# -- the other axes (sp, ep, pp) ------------------------------------------


def placement(eng) -> dict:
    """What this rank holds: its layers, the experts of its MoE stacks,
    its parameter bytes and its cache's (layers, rows, kv heads,
    positions) and bytes."""
    from ..models.loader import param_bytes

    lw = eng.params["layers"][0]
    k = eng.cache.k
    return dict(layers=len(eng.params["layers"]),
                experts=lw["moe_up"].shape[0] if "moe_up" in lw else 0,
                param_bytes=param_bytes(eng.params),
                cache=(len(k), *k[0].shape[:3]),
                cache_bytes=sum(t.numel() * t.element_size()
                                for t in (*k, *eng.cache.v)))


def _grid_report(eng, calls: list) -> dict:
    out = []
    for m, a, kw in calls:
        try:
            out.append(host(getattr(eng, m)(*a, **kw)))
        except ValueError as e:            # an engine refusal, as a result
            out.append(f"ValueError: {e}")
    return dict(results=out, stats=dict(eng.mesh.stats),
                placement=placement(eng), coords=dict(eng.mesh.coords),
                vocab_axis=eng._vocab_axis, tp_reduce=eng.tp_reduce)


def grid_calls(grid: dict, blob: bytes, engine_kw: dict, calls: list) -> dict:
    """Each (method, args, kwargs) of `calls` on an Engine over a mesh of
    CPU ranks of the axis sizes `grid` (make_mesh's keywords), built from
    the full params in `blob`: their results (a ValueError's message in
    its place), the mesh's stats and coordinates, and the rank's
    placement."""
    from ..runtime.engine import Engine

    spec, params = unpack(blob)
    eng = Engine(spec, params, mesh=make_mesh(**grid, device_type="cpu"),
                 **engine_kw)
    return _grid_report(eng, calls)


def ring(sp: int, q: np.ndarray, k: np.ndarray, v: np.ndarray,
         pos0: int) -> np.ndarray:
    """ring_attention_local of rank i's chunk of the whole (B, T, ...) q,
    k and v on an sp-rank mesh, the chunk's first position pos0 + i*T/sp."""
    from .ring_attention import ring_attention_local

    mesh = make_mesh(sp=sp, device_type="cpu")
    t = q.shape[1] // sp
    c = slice(mesh.sp_rank * t, (mesh.sp_rank + 1) * t)
    return host(ring_attention_local(
        *(torch.from_numpy(np.ascontiguousarray(a[:, c])) for a in (q, k, v)),
        pos0 + mesh.sp_rank * t, mesh))


def sp_cache(sp: int, q: np.ndarray, k_cache: np.ndarray,
             v_cache: np.ndarray, q_pos: np.ndarray) -> np.ndarray:
    """sp_cache_attention_local of the queries q against rank i's shard
    of the whole (B, KVH, S, hs) caches, positions [i*S/sp, (i+1)*S/sp)."""
    from .ring_attention import sp_cache_attention_local

    mesh = make_mesh(sp=sp, device_type="cpu")
    s = k_cache.shape[2] // sp
    c = slice(mesh.sp_rank * s, (mesh.sp_rank + 1) * s)
    return host(sp_cache_attention_local(
        torch.from_numpy(q),
        *(torch.from_numpy(np.ascontiguousarray(a[:, :, c]))
          for a in (k_cache, v_cache)), torch.from_numpy(q_pos), mesh))


def moe_layer(grid: dict, blob: bytes, engine_kw: dict,
              x: np.ndarray) -> np.ndarray:
    """The MoE FFN of layer 0 (models/transformer._moe_ffn) on the
    post-norm activations x (B, T, dim), over a mesh of CPU ranks of the
    axis sizes `grid`, in the engine's configuration (its Q80 activations
    and reduce)."""
    from ..models.transformer import _moe_ffn
    from ..runtime.engine import Engine

    spec, params = unpack(blob)
    eng = Engine(spec, params, mesh=make_mesh(**grid, device_type="cpu"),
                 **engine_kw)
    mm = dict(compute_dtype=eng.compute_dtype,
              activation_q80=eng.activation_q80, mesh=eng.mesh,
              tp_reduce=eng.tp_reduce)
    return host(_moe_ffn(torch.from_numpy(x).to(eng.compute_dtype),
                         eng.params["layers"][0], eng.spec, mm))


def grid_file_calls(grid: dict, path: str, engine_kw: dict,
                    calls: list) -> dict:
    """grid_calls over the streamed loader's placement of the `.m` file at
    `path` (each rank reads only its share into its params), with the
    loader's own count of the bytes it kept."""
    from ..io.model_file import read_spec
    from ..models.loader import load_params_streamed
    from ..parallel.sharding import loader_placement, vocab_splits
    from ..runtime.engine import Engine

    mesh = make_mesh(**grid, device_type="cpu")
    spec = read_spec(path)
    shard_vocab = engine_kw.get("shard_vocab")
    if shard_vocab is None:
        shard_vocab = vocab_splits(spec, mesh.tp)
    params, stats = load_params_streamed(
        spec, path, "cpu", dtype=engine_kw.get("compute_dtype", torch.float32),
        **loader_placement(mesh, spec, shard_vocab))
    eng = Engine(spec, params, mesh=mesh, **engine_kw)
    return dict(_grid_report(eng, calls), loaded_bytes=stats.device_bytes)


# -- serving over ranks (parallel/control.py) -------------------------------


def _mirrored(tp: int, dp: int, blob: bytes, engine_kw: dict,
              timeout_s: float = 60.0):
    """This rank's engine and its control channel, attached."""
    from .control import Control

    eng = _engine(tp, dp, blob, engine_kw)
    ctl = Control(eng.mesh, timeout_s)
    ctl.attach(eng)
    return eng, ctl


def on_root(ctl, fn):
    """Rank 0 runs fn() against the mirrored engine, then closes the
    channel; every other rank follows until then. fn's result on rank 0,
    None elsewhere."""
    if not ctl.is_root:
        ctl.follow()
        return None
    try:
        return fn()
    finally:
        ctl.close()


def serve_requests(engine, requests: list, *, batch: int, chunk: int,
                   prefix: tuple | None, draft: str | None,
                   draft_len: int = 0) -> dict:
    """Serve `requests` ((prompt, max_tokens, temperature, topp, seed), a
    Sampler of its own each) through a Scheduler over `engine.spawn(batch)`
    with a radix prefix cache of `prefix` = (blocks, block_len) and a
    `draft`; the tokens of each request, the vocab sampler's counters, the
    prefix cache's hits and the accept record. Runs on one engine or on
    rank 0 of a mirrored one."""
    from ..runtime.draft import build_draft
    from ..runtime.prefix_cache import PrefixCache
    from ..runtime.scheduler import Scheduler
    from ..sampler import Sampler

    eng = engine.spawn(batch)
    vocab = eng.spec.vocab_size
    pc = (PrefixCache(eng, num_blocks=prefix[0], block_len=prefix[1])
          if prefix else None)
    sched = Scheduler(eng, chunk=chunk, prefix_cache=pc,
                      draft_factory=((lambda e: build_draft(e, draft))
                                     if draft else None),
                      draft_len=draft_len if draft else 0,
                      draft_vocab=vocab)
    sched.warmup()
    try:
        reqs = [sched.submit(p, n, Sampler(vocab, t, tp, seed=sd,
                                           backend="python"))
                for p, n, t, tp, sd in requests]
        while sched.has_work():
            sched.step()
        outs = [list(r.tokens(timeout=60.0)) for r in reqs]
    finally:
        sched.close()
    summary = sched.stats.summary()
    return dict(tokens=outs, vocab_sample_stats=dict(eng.vocab_sample_stats),
                prefix=summary.get("prefix_cache"), spec=summary.get("spec"))


def serve(tp: int, blob: bytes, engine_kw: dict, requests: list,
          serve_kw: dict) -> dict | None:
    """serve_requests on rank 0 of a tp-rank mirrored engine, with the
    control channel's counters."""
    eng, ctl = _mirrored(tp, 1, blob, engine_kw)

    def run():
        out = serve_requests(eng, requests, **serve_kw)
        out.update(control=dict(ctl.stats), mesh=dict(eng.mesh.stats))
        return out
    return on_root(ctl, run)


def supervise(tp: int, blob: bytes, engine_kw: dict, prompts: list,
              n: int, sup_kw: dict) -> dict | None:
    """The supervisor tier over a tp-rank mirrored engine, as `dllama api
    --serve-batch B --tp T` builds it: its factory spawns over the
    template's mesh and vocab split. Greedy tokens of `prompts`, then a
    forced rebuild (a crash on rank 0's host before any op), then the
    same prompts again."""
    import time

    from ..runtime.faults import FAULTS
    from ..runtime.resilience import EngineSupervisor
    from ..sampler import Sampler

    eng, ctl = _mirrored(tp, 1, blob, engine_kw)

    def greedy(i):
        return Sampler(eng.spec.vocab_size, 0.0, 0.9, seed=50 + i,
                       backend="python")

    def run():
        batch = sup_kw.pop("batch")
        sup = EngineSupervisor(lambda: eng.spawn(batch), **sup_kw)
        try:
            got = dict(mesh_carried=sup.engine.mesh is eng.mesh,
                       shard_vocab=sup.engine.shard_vocab)
            got["before"] = [list(sup.submit(p, n, greedy(i)).tokens(30.0))
                             for i, p in enumerate(prompts)]
            FAULTS.arm("step_raise")
            req = sup.submit(prompts[0], n, greedy(0))
            try:
                list(req.tokens(30.0))
                got["failed"] = False
            except Exception:  # noqa: BLE001 — the injected crash
                got["failed"] = True
            t0 = time.perf_counter()
            while not sup.ready and time.perf_counter() - t0 < 30.0:
                time.sleep(0.02)
            got["recoveries"] = sup.sup_stats.recoveries
            got["after"] = [list(sup.submit(p, n, greedy(i)).tokens(30.0))
                            for i, p in enumerate(prompts)]
            got["state"] = sup.state
            return got
        finally:
            FAULTS.clear()
            sup.close()
    return on_root(ctl, run)


def session_save(tp: int, blob: bytes, engine_kw: dict, prompt: list,
                 n: int, path: str) -> list | None:
    """Greedy tokens of `prompt` on a tp-rank mirrored engine, then its
    session saved to `path` (rank 0 writes every rank's heads)."""
    from ..sampler import Sampler

    eng, ctl = _mirrored(tp, 1, blob, engine_kw)

    def run():
        toks = eng.generate(prompt, n, Sampler(eng.spec.vocab_size, 0.0,
                                               0.9, 1, backend="python")).tokens
        eng.save_session(path, tokens=prompt + toks[:-1])
        return toks
    return on_root(ctl, run)


def session_load(tp: int, blob: bytes, engine_kw: dict, path: str,
                 next_tok: int, n: int) -> dict | None:
    """Load `path` into a tp-rank mirrored engine and continue greedily
    from `next_tok` for n tokens."""
    from ..sampler import Sampler

    eng, ctl = _mirrored(tp, 1, blob, engine_kw)

    def run():
        hist = eng.load_session(path)
        pos = eng.pos
        toks = eng.generate([next_tok], n, Sampler(
            eng.spec.vocab_size, 0.0, 0.9, 1, backend="python")).tokens
        return dict(history=hist, pos=pos, tokens=toks)
    return on_root(ctl, run)


def speculate(tp: int, dp: int, blob: bytes, engine_kw: dict, prompt: list,
              n: int, draft_len: int) -> dict | None:
    """The speculative streams on rank 0 of a mirrored engine: over tp,
    greedy generate_lookup, generate_draft and generate_draft_sampled
    with a self:1 draft, and generate_lookup_sampled; over dp,
    generate_batch_lookup (greedy) of the same prompt in every row."""
    eng, ctl = _mirrored(tp, dp, blob, engine_kw)

    def run():
        if dp > 1:
            return dict(rows=eng.generate_batch_lookup(
                [prompt] * eng.batch, n, draft_len=draft_len),
                accept=eng.last_accept_stats)
        out = dict(lookup=eng.generate_lookup(prompt, n,
                                              draft_len=draft_len).tokens)
        eng.reset()
        d = eng.new_draft("self:1")
        out["draft"] = eng.generate_draft(prompt, n, draft=d,
                                          draft_len=draft_len).tokens
        eng.reset()
        out["draft_sampled"] = eng.generate_draft_sampled(
            prompt, n, draft=d, temperature=0.8, topp=0.9, seed=7,
            draft_len=draft_len).tokens
        eng.reset()
        out["lookup_sampled"] = eng.generate_lookup_sampled(
            prompt, n, temperature=0.8, topp=0.9, seed=7,
            draft_len=draft_len).tokens
        return out
    return on_root(ctl, run)


def control_idle(tp: int, blob: bytes, engine_kw: dict, prompt: list,
                 n: int, timeout_s: float, idle_s: float) -> dict | None:
    """Greedy tokens, an idle wait of `idle_s` (longer than the channel's
    `timeout_s`), greedy tokens again: the pings keep the followers."""
    import time

    from ..sampler import Sampler

    eng, ctl = _mirrored(tp, 1, blob, engine_kw, timeout_s=timeout_s)

    def run():
        smp = Sampler(eng.spec.vocab_size, 0.0, 0.9, 1, backend="python")
        a = eng.generate(prompt, n, smp).tokens
        time.sleep(idle_s)
        eng.reset()
        b = eng.generate(prompt, n, smp).tokens
        return dict(before=a, after=b, pings=ctl.stats["pings"])
    return on_root(ctl, run)


def control_dead_follower(tp: int, blob: bytes, engine_kw: dict,
                          timeout_s: float) -> dict | None:
    """Rank 1 exits while rank 0 idles; rank 0's next op must fail within
    the channel's timeout, naming rank 1."""
    import os
    import time

    from .control import RankLost

    eng, ctl = _mirrored(tp, 1, blob, engine_kw, timeout_s=timeout_s)
    if not ctl.is_root:
        if ctl.rank == 1:
            os._exit(3)
        ctl.follow()
        return None
    time.sleep(1.0)
    t0 = time.perf_counter()
    try:
        eng.reset()
        eng.step(np.asarray([[1, 2]], np.int32), 0)
        return dict(error=None, seconds=time.perf_counter() - t0)
    except RankLost as e:
        return dict(error=str(e), ranks=e.ranks,
                    seconds=time.perf_counter() - t0, lost=ctl.lost)


def control_dead_root(tp: int, blob: bytes, engine_kw: dict,
                      timeout_s: float) -> dict | None:
    """Rank 0 exits after one op; every follower's loop must end with
    RankLost within the channel's timeout."""
    import os
    import time

    from .control import RankLost

    eng, ctl = _mirrored(tp, 1, blob, engine_kw, timeout_s=timeout_s)
    if ctl.is_root:
        eng.reset()
        os._exit(3)
    t0 = time.perf_counter()
    try:
        ctl.follow()
        return dict(error=None, seconds=time.perf_counter() - t0)
    except RankLost as e:
        return dict(error=str(e), ranks=e.ranks,
                    seconds=time.perf_counter() - t0)


def least_headroom_of(tp: int, stats: list, share: int) -> dict:
    """runtime/profiler.least_headroom over a tp-rank CPU mesh, rank r
    reporting stats[r] on a card that `share` ranks hold."""
    from ..runtime.profiler import least_headroom

    mesh = make_mesh(tp=tp, device_type="cpu")
    return least_headroom(stats[mesh.rank], mesh, share)


def control_errors(tp: int, blob: bytes, engine_kw: dict) -> dict:
    """An op refused the same way on every rank keeps the ranks in step
    (rank 0 raises it, the next op runs); an op that fails on rank 1
    alone loses the run on every rank, naming rank 1."""
    from .control import RankLost

    eng, ctl = _mirrored(tp, 1, blob, engine_kw)
    if ctl.rank == 1:
        def refuse():
            raise RuntimeError("rank 1 alone")
        eng.reset = refuse
    out: dict = {}
    if not ctl.is_root:
        try:
            ctl.follow()
        except RankLost as e:
            out["lost"] = str(e)
        return out
    try:
        eng.new_prefix_arena(0, 8)
    except ValueError as e:
        out["refused"] = str(e)
    out["after"] = eng.step(np.asarray([[1, 2]], np.int32), 0).shape[-1]
    try:
        eng.reset()
    except RankLost as e:
        out.update(lost=str(e), ranks=e.ranks)
    return out
