"""Jobs for a RankPool (parallel/launch.py): each runs on every rank of the
pool's process group, builds its mesh, and returns what that rank saw as
host values (numpy arrays, lists, numbers). The CPU tests hold these
results against the JAX package; chip_smoke.py runs its own jobs.
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
