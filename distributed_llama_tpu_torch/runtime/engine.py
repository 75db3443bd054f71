"""Inference engine on one device — counterpart of the JAX package's
runtime/engine.py (Engine.__init__ for one device, reset, step, prefill,
generate, fetch_logits, decode_greedy_device, generate_device, the
speculative streams generate_lookup* and generate_draft*, and the
continuous-batching slot steps slot_prefill_chunk, slot_decode_step and
slot_verify_step).

The prompt is prefilled in chunks of `prefill_chunk` (256 by default, the Q40
kernel's MAX_T: the fewest whole-weight passes that still take the kernel);
decode then runs one token per step through the host sampler with the
reference's xorshift stream. The KV cache is preallocated once and written
in place; `reset` zeroes it in place, so neither it nor the parameters
ever move.

On the card, a decode step (T = 1) is a CUDA graph (runtime/graphs.py):
the forward over static token and position buffers, captured once per
engine and replayed at every step, as the JAX engine jits its step once
(runtime/engine.py:669 _compiled_step). The two on-device loops are graphs
of one step each, replayed back to back with no host read per token:
`decode_greedy_device` (the loop the JAX bench times) and `generate_device`
(sampled, with ops/device_sampler.py). Prefill chunks run eagerly.
`cuda_graphs=False` runs every step eagerly on the card too; on the CPU
everything runs eagerly and nothing is captured.

An engine of `batch=B` holds B sequences ("slots") in one (B, KVH, S, hs)
cache for the serving scheduler (runtime/scheduler.py), which owns every
row's position: `slot_prefill_chunk` runs a (B, C) chunk eagerly,
`slot_decode_step` a (B, 1) step, on the card one captured graph
("slot_decode") over static token and position buffers. A row a call does
not serve passes position S: its writes land in the cache's spare row and
its logits mean nothing. The batch-1 methods (step, prefill, generate and
the device loops) refuse a batch-B engine. A batch-B engine may share the
params of a batch-1 one: fuse_layer_weights leaves fused params as they
are, so no weight is copied.

Speculative decoding (JAX runtime/engine.py:932-1447, :1524): every mode
runs one verify loop (`_lookup_loop`): a forward over [last token] + a
draft of k tokens at t = 1 + k, every position's logits to the host, the
accepted prefix plus one token emitted. On a CUDA engine the verify at
width T is one captured graph ("lookup", T) over a static (1, T) token
buffer and the device position, so a stream mints at most draft_len + 1
graphs. Drafts come from the context's n-grams (prompt lookup) or from a
DraftModel (runtime/draft.py), greedy (the stream equals generate()'s) or
sampled by rejection resampling on a numpy PCG64 stream drawn in the JAX
order. `slot_verify_step` is the scheduler's fixed-width verify over the B
slots, one graph ("slot_verify", 1 + K, n_vocab).

Batched generation (JAX runtime/engine.py:1683-2188): `generate_batch`,
`generate_batch_stream`, `generate_batch_device` and
`generate_batch_lookup` run B independent prompts on a batch-B engine
(the API server's /v1/batch/completions borrows the scheduler's). The
prompts prefill right-padded, chunk by chunk, through `slot_prefill_chunk`;
each row then decodes at its own position, a finished row gated to S (its
writes land in the spare row). The host loop replays the "slot_decode"
graph and samples every live row with the one shared Sampler in row order;
the device loop is one graph ("bdsample", ...) replayed with each row's
own xorshift stream (seed + i); the lookup loop drafts per row and
verifies all rows in one "slot_verify" graph of width 1 + k_max.

Cache seeding (JAX runtime/engine.py:406-545, :1577-1652): `save_session`
and `load_session` persist the filled cache prefix in the JAX package's
file format (one file serves both packages), and `new_prefix_arena`,
`slot_seed_prefix` and `slot_publish_block` move K/V between a slot's
cache row and the radix prefix cache's block arena
(runtime/prefix_cache.py). Every one of them copies into the existing
cache tensors: the captured graphs read and write those addresses, so a
load, a seed or a reset never rebinds them. Bytes entering the cache from
outside a forward pass the fp8 NaN-code guard (`saturate_f8_nan_codes`).

Over ranks (JAX runtime/engine.py:118-329, the mesh branches): `mesh=` (a
parallel/mesh.py Mesh over dp x sp x ep x pp x tp ranks, one engine a rank
process) makes
the engine hold this rank's shard of the params (parallel/sharding.py:
its row and column splits, kv heads replicated when tp exceeds them, its
row shards fused), a cache of its KVH/tp kv heads, and its rows of a
batch: batch/dp when dp divides the batch, every row otherwise (as the
JAX mesh replicates a batch that dp does not divide). The column splits'
partial sums reduce exactly or, with `q80_collectives` (the default with
Q80 activations at tp > 1), by the Q80 two-shot exchange; `shard_vocab`
splits the embedding's and the head's vocab rows (auto: when tp divides
the vocab). prefill, generate, the device loops, generate_batch with its
stream and generate_batch_device run over the mesh: every rank computes
the same logits, so its host sampler draws the same tokens. In the batch stream the rows'
logits (or, vocab-sharded, their candidate summaries) meet at every rank
before one shared Sampler samples them in row order, as the JAX
generate_batch does; greedy rows exchange only their tokens. Under NCCL a
decode step is captured with its collectives inside; under gloo on a card
(ranks sharing a GPU) collectives stage through host memory, which a
graph cannot capture, so steps run eagerly. `force_mesh_kernels` runs the
shard path on a 1-rank mesh (JAX :139), the single-card proof of the mesh
step.

The other axes (JAX runtime/engine.py:160-330, 834-875): over pp the rank
holds its stage's L/pp layers and their cache, a long segment takes GPipe
(`pp_gpipe`, on by default) and every step runs eagerly (the stage hop is
point to point); over ep it holds E/ep experts of every MoE stack; over
sp it holds every weight and S/sp positions of the cache, and `prefill`
from position 0 runs the whole prompt as one ring segment (padded to a
multiple of sp, the logits at its true last position). With the vocab
split and pp > 1 the vocab lies over (pp, tp) when pp*tp divides it.
Sessions and the prefix cache refuse pp as the JAX engine does; over sp
the prefix arena holds every kv head, and the ring prefill is an op of
the control channel, so chat and the legacy api serve over sp.

Over nodes (parallel/multihost.py): an engine whose mesh spans ranks of
more than one node keeps the vocab split of the weights but samples from
whole logits (`shard_sampling` is off, JAX runtime/engine.py:753), and
`wire_estimate`, `measure_transfer_ms` and `measure_prefill_transfer_ms`
give the inference CLI's S and T columns (JAX :549-600), the latter two
timing activation-sized collectives over the schedules the forward runs.

Serving over ranks (parallel/control.py): under `chat` and `api` only rank
0 has the inputs, so rank 0 runs every host loop (the scheduler, the
samplers, Engine.generate, the speculative loops) and the other ranks run
the ops it mirrors to them. Every method that issues a collective or
changes state a follower holds is `@mirrored`: on rank 0 of an engine with
a `control` channel, a call of it is sent, then run, on every rank; a
method that calls another runs the inner one locally on each rank. The
slot steps, the verify steps, the prefix arena's seed and publish, the
sessions (saved through a gather of every rank's heads to rank 0, loaded
from rank 0's read of the file), the sampling views and their row fetch,
the drafts and the engine factory of the supervisor (`spawn`) are such
ops; with no channel (one rank, or the SPMD CLI runs where every rank runs
the same program) they run locally.

The engine runs on `cuda` unless the caller asks for the CPU: with no card
present, `Engine(...)` raises instead of running elsewhere.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import os
import time
import types
import zlib
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from ..models.params import fuse_layer_weights, kv_replication
from ..models.spec import ModelSpec
from ..models.transformer import _BITS, KVCache, forward
from ..ops.cuda_attention import saturate_f8_nan_codes
from ..ops.device_sampler import sample_rows, sample_token, state_from_seed
from ..ops.sharded_vocab import sharded_argmax, sharded_sample_prep
from ..parallel.collectives import all_gather, all_reduce, broadcast_object
from ..parallel.control import mirrored
from ..parallel.mesh import (DP_AXIS, EP_AXIS, PP_AXIS, SP_AXIS,
                             TP_AXIS, WORLD, axis_parts)
from ..parallel.sharding import (check_axis_constraints, check_tp_constraints,
                                 is_sharded, shard_params, vocab_axis,
                                 vocab_splits)
from ..quants.torch_codec import QuantizedTensor
from ..sampler import Sampler
from ..utils.device import resolve_device
from .faults import FAULTS
from .graphs import DEVICE_GATE, CapturedStep, capture
from .profiler import COMPILES, PROFILER, compile_key_str
from .sampling import FullLogitsView, ShardedLogitsView
from .stats import RunStats, StepStats

# the fp8 (e4m3) cache stores 1 byte per value; writes saturate at +-448
# and K3 upcasts it in registers (ops/cuda_attention.py)
CACHE_DTYPES = (torch.bfloat16, torch.float32, torch.float8_e4m3fn)
# the numpy names of the cache dtypes (jnp.dtype(...).name in the JAX
# package): the session file stores them and its fingerprint hashes them
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
               torch.float8_e4m3fn: "float8_e4m3fn"}
# generate_device's host reads the loop's done flag once every this many
# replays: at most this many - 1 forwards run after the stop token
_DONE_CHECK_EVERY = 8
# candidates each rank of a vocab-split head sends the sampler a row (JAX
# Engine(vocab_topk=32)); the guard fetches one replicated row when they
# cannot prove the draw
VOCAB_TOPK = 32

__all__ = ["CACHE_DTYPES", "Engine", "GenerationResult", "resolve_device",
           "seed_rows_from_blocks"]


class GenerationResult(NamedTuple):
    tokens: list[int]
    stats: RunStats


def seed_rows_from_blocks(cache: KVCache, arena_k: torch.Tensor,
                          arena_v: torch.Tensor, row: int,
                          block_ids) -> None:
    """Seed cache row `row`'s leading positions from prefix-arena blocks,
    in place (the body of Engine.slot_seed_prefix; JAX
    runtime/engine.py:42 seed_rows_from_blocks).

    arena_k/arena_v: (num_blocks, layers, kv_heads, block_len, head_size),
    each block laid out like a cache slice (KVH before the sequence), so
    a layer's seed is one gather of the matched blocks and one copy into
    cache[l][row, :, :n], n = len(block_ids) * block_len. Unlike the JAX
    seed, which pads block_ids to a fixed width for one compilation key,
    only the matched blocks are written. The blocks pass the fp8 NaN-code
    guard: the arena's producer is not trusted at the seeding boundary."""
    ids = torch.as_tensor(np.asarray(block_ids, np.int64),
                          device=arena_k.device)
    mb = int(ids.numel())
    if mb == 0:
        return
    _, _, kvh, bl, hs = arena_k.shape
    n = mb * bl
    for l in range(len(cache.k)):
        for arena, leaf in ((arena_k, cache.k[l]), (arena_v, cache.v[l])):
            # moved as integer bits of the dtype's width (every dtype's
            # gather and copy), guarded in the dtype itself
            seg = _bits(arena[:, l]).index_select(0, ids)
            seg = _bits(saturate_f8_nan_codes(seg.view(arena.dtype)))
            _bits(leaf[row, :, :n]).view(kvh, mb, bl, hs).transpose(0, 1).copy_(seg)


_BITS_NP = {1: np.uint8, 2: np.int16, 4: np.int32}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers of its width (a view)."""
    return t.view(_BITS[t.element_size()])


class Engine:
    # the op channel of serving over ranks (parallel/control.py): set on
    # rank 0 of a mirrored engine, None everywhere else
    control = None
    _ctl_id = None
    _mirrorable = True

    def __init__(
        self,
        spec: ModelSpec,
        params: dict,
        *,
        device=None,
        max_seq_len: int | None = None,
        compute_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16,
        prefill_chunk: int = 256,
        activation_q80: bool = False,
        cuda_graphs: bool = True,
        batch: int = 1,
        model_fingerprint: int = 0,
        mesh=None,
        q80_collectives: bool | None = None,
        shard_vocab: bool | None = None,
        force_mesh_kernels: bool = False,
        pp_gpipe: bool = True,
    ):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(
                f"cache_dtype {cache_dtype} is not ported: the port's cache "
                "is bf16, f32 or float8_e4m3fn")
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bf16 or f32, got "
                             f"{compute_dtype}")
        pdev = params["tok_emb"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine on {self.device}")
        tp = mesh.tp if mesh is not None else 1
        sp, ep, pp = ((mesh.sp, mesh.ep, mesh.pp) if mesh is not None
                      else (1, 1, 1))
        file_spec = spec
        if tp > spec.n_kv_heads:
            # kv heads replicated to tp virtual heads (JAX engine.py:163-174)
            kv_replication(spec, tp)
            spec = dataclasses.replace(spec, n_kv_heads=tp)
        self.spec = spec
        self.seq_len = min(max_seq_len or spec.seq_len, spec.seq_len)
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype
        self.prefill_chunk = prefill_chunk
        # the reference's Q80 activation buffers: every matmul input through
        # the Q80 round trip (JAX runtime/engine.py:125; the CLI's default
        # for Q40 models)
        self.activation_q80 = activation_q80
        # content hash of the weights file (io/model_file.py
        # content_fingerprint; the CLI sets it), folded into the session
        # fingerprint; 0 for params held in memory
        self.model_fingerprint = int(model_fingerprint)
        # the mesh knobs (JAX runtime/engine.py:139-266): the column
        # splits reduce exactly, or by the Q80 two-shot exchange
        # (--buffer-float-type q80 at tp > 1); the vocab split, auto when
        # tp divides the vocab
        self.mesh = mesh
        if q80_collectives is None:
            q80_collectives = activation_q80 and tp > 1
        self.q80_collectives = bool(q80_collectives) and tp > 1
        self.tp_reduce = "q80" if self.q80_collectives else "exact"
        # the other axes' rules (JAX :186-189, 215-221, 234-245); GPipe for
        # a long segment over pp (JAX pp_gpipe)
        check_axis_constraints(spec, sp=sp, ep=ep, pp=pp,
                               seq_len=self.seq_len,
                               q80_collectives=self.q80_collectives)
        self.pp_gpipe = bool(pp_gpipe)
        if shard_vocab and not vocab_splits(spec, tp):
            raise ValueError(f"shard_vocab: mesh tp axes cannot split vocab="
                             f"{spec.vocab_size} evenly (tp={tp})")
        self.shard_vocab = (vocab_splits(spec, tp) if shard_vocab is None
                            else bool(shard_vocab))
        # the axis the vocab split lies over: (pp, tp) when the stages
        # widen it (JAX vocab_shard_axes), else tp
        self._vocab_axis = (vocab_axis(spec, tp, pp) if self.shard_vocab
                            else TP_AXIS)
        # how often the sharded sampler served a row, and how often it
        # fetched one replicated row instead
        self.vocab_sample_stats = {"sharded": 0, "fallback": 0}
        # a mesh over ranks of more than one node: the samplers read whole
        # logits (JAX runtime/engine.py:334-337, :753)
        from ..parallel.multihost import is_multihost

        self._multihost = is_multihost(mesh)
        # the forward's mesh: None on one device, unless the shard path is
        # forced on a 1-rank mesh
        self._mesh = (mesh if mesh is not None
                      and (mesh.size > 1 or force_mesh_kernels) else None)
        if self._mesh is None:
            # single-device fast path: fused QKV / w1|w3 launches (in place)
            self.params = fuse_layer_weights(params)
        elif is_sharded(params) or len(params["layers"]) != spec.n_layers:
            # the streamed loader's placement
            if (params["tok_emb"].shape[0] != spec.vocab_size) != self.shard_vocab:
                raise ValueError("the params' embedding split does not match "
                                 f"shard_vocab={self.shard_vocab}")
            if len(params["layers"]) != spec.n_layers // pp:
                raise ValueError(f"the params hold {len(params['layers'])} "
                                 f"layers, a pp={pp} stage {spec.n_layers // pp}")
            self.params = params
        else:
            q40 = any(isinstance(v, QuantizedTensor)
                      for lw in params["layers"] for v in lw.values())
            check_tp_constraints(spec, tp, q40=q40)
            self.params = shard_params(
                params, file_spec, tp, mesh.tp_rank, vocab=self.shard_vocab,
                ep=ep, ep_k=mesh.ep_rank, pp=pp, pp_k=mesh.pp_rank,
                vocab_split=(mesh.shape[self._vocab_axis],
                             mesh.index(self._vocab_axis)))
        # B slots (rows) of the scheduler, or the one sequence of step();
        # over dp ranks this rank holds rows [row0, row0 + rows) of them
        self.batch = int(batch)
        dp = mesh.dp if self._mesh is not None else 1
        self._dp_split = dp > 1 and self.batch % dp == 0
        self._rows = self.batch // dp if self._dp_split else self.batch
        self._row0 = mesh.dp_rank * self._rows if self._dp_split else 0
        self.cache = self.rank_cache(spec)
        self.pos = 0
        # the captured steps, keyed like the JAX engine's _steps: 1 (the
        # decode step), ("greedy",), ("dsample", temperature, topp, vocab,
        # stop ids), "slot_decode"; empty on the CPU or with
        # cuda_graphs=False. Every capture is recorded in COMPILES; once
        # the scheduler's warmup marks the engine warm, a new key is a
        # capture after warmup (runtime/profiler.py)
        # over pp every step runs eagerly: the stage hop is point to point
        self.cuda_graphs = (bool(cuda_graphs) and self.device.type == "cuda"
                            and pp == 1)
        if self.cuda_graphs and self._mesh is not None and self._mesh.stages:
            self.cuda_graphs = False
            if mesh.rank == 0:
                print("⏩ engine: gloo stages every collective through host "
                      "memory, which a CUDA graph cannot capture: the "
                      "decode steps run eagerly", flush=True)
        self.graphs: dict[object, CapturedStep] = {}
        self._compile_warm = False
        # device while-loop iterations of the last generate_device call
        # (== its sampled tokens; forwards run == that - 1)
        self.last_device_steps = 0
        # the last speculative stream's (forwards, tokens) and its accept
        # record (forwards, drafted, accepted, emitted), updated per verify
        self.last_accept_stats = (0, 0)
        self.last_spec: dict | None = None
        # the drafts built over this engine (runtime/draft.py): release()
        # releases their caches and graphs with the engine's own
        self._drafts: list = []
        # the steps' static buffers: a graph reads and writes these at
        # replay, so they never move
        dev, i64 = self.device, torch.int64
        self._buf = types.SimpleNamespace(
            tok=torch.zeros((self._rows, 1), dtype=i64, device=dev),
            pos=torch.zeros((self._rows,), dtype=torch.int32, device=dev),
            count=torch.zeros((1,), dtype=i64, device=dev),
            out=torch.zeros((self.seq_len + 2,), dtype=i64, device=dev),
            done=torch.zeros((1,), dtype=torch.bool, device=dev),
            limit=torch.zeros((1,), dtype=i64, device=dev),
            rng=torch.zeros((2,), dtype=i64, device=dev),
            logits=torch.zeros((1, spec.vocab_size), dtype=torch.float32,
                               device=dev),
            # the verify steps' (B, T) token buffers, one per width T
            seg={},
            # generate_batch_device's per-row buffers, made at first use
            rows=None)

    def rank_cache(self, spec: ModelSpec) -> KVCache:
        """A zeroed cache of `spec`'s layers as this rank holds them: its
        rows of the batch, its KVH/tp kv heads, its pp stage's L/pp layers
        and its S/sp positions (JAX sharding.cache_pspec)."""
        m = self._mesh
        tp, sp, pp = (m.tp, m.sp, m.pp) if m is not None else (1, 1, 1)
        return KVCache.create(
            dataclasses.replace(spec, n_kv_heads=spec.n_kv_heads // tp,
                                n_layers=spec.n_layers // pp),
            self._rows, self.seq_len // sp, self.cache_dtype, self.device)

    def _refuse_pp(self, what: str) -> None:
        if self._mesh is not None and self._mesh.pp > 1:
            raise ValueError(f"{what} does not support --pp")

    @mirrored
    def spawn(self, batch: int) -> "Engine":
        """An engine of `batch` slots over this one's params, mesh and
        configuration (the supervisor's engine factory): it costs its KV
        cache, never a copy of the weights. On every rank as one op."""
        return Engine(self.spec, self.params, device=self.device,
                      batch=batch, max_seq_len=self.seq_len,
                      compute_dtype=self.compute_dtype,
                      cache_dtype=self.cache_dtype,
                      prefill_chunk=self.prefill_chunk,
                      activation_q80=self.activation_q80,
                      cuda_graphs=self.cuda_graphs,
                      model_fingerprint=self.model_fingerprint,
                      mesh=self.mesh, q80_collectives=self.q80_collectives,
                      shard_vocab=self.shard_vocab,
                      force_mesh_kernels=self._mesh is not None,
                      pp_gpipe=self.pp_gpipe)

    @mirrored
    def ranks_device_stats(self) -> dict | None:
        """The device numbers of the rank with the least headroom
        (runtime/profiler.py least_headroom): the auto-sizing decision
        over ranks reads them. None on the CPU."""
        from .profiler import device_memory_stats, least_headroom

        local = device_memory_stats(self.device)
        if local is not None:
            local["bytes_reserved"] = int(torch.cuda.memory_reserved(self.device))
        return least_headroom(local, self._mesh)

    @mirrored
    def new_draft(self, spec_str: str):
        """A DraftModel over this engine from a --draft string
        (runtime/draft.py), on every rank as one op."""
        from .draft import make_draft

        return make_draft(self, spec_str)

    @mirrored
    def reset(self) -> None:
        """New session: zero the cache (in place) and rewind the position."""
        self._zero_cache()
        self.pos = 0

    # -- session persistence (JAX runtime/engine.py:406-545) ---------------

    @mirrored
    def save_session(self, path: str, tokens: list[int] | None = None) -> None:
        """Persist the session: pos and the filled cache prefix (positions
        < pos), with an optional token history, as the JAX package's .npz
        (narrow dtypes stored as raw uint8/uint16 bits), so either package
        loads the other's file. Written to path + ".tmp", then renamed: a
        signal mid-write never leaves a truncated file where a good one
        stood. Over ranks every rank's kv heads (and rows) are gathered and
        rank 0 writes the whole cache in the JAX layout (JAX
        runtime/engine.py:406 fetches it to the host the same way); over
        sp the shards' positions are gathered too. pp is refused, in the
        JAX words (JAX :417)."""
        self._refuse_pp("session save/restore")
        data: dict = {
            "pos": np.int64(self.pos),
            "cache_dtype": np.str_(DTYPE_NAMES[self.cache_dtype]),
            "config": np.asarray(self._session_fingerprint(), np.int64),
            "tokens": np.asarray(tokens if tokens is not None else [],
                                 np.int32),
        }
        for l in range(self.spec.n_layers):
            for name, leaf in (("k", self.cache.k[l]), ("v", self.cache.v[l])):
                arr = self._whole_prefix(leaf).cpu().numpy()
                if self.cache_dtype == torch.bfloat16:
                    arr = arr.view(np.uint16)
                elif self.cache_dtype == torch.float32:
                    arr = arr.view(np.float32)
                data[f"{name}{l}"] = arr
        if self._mesh is not None and self._mesh.rank != 0:
            return
        # an open handle: np.savez(str) appends ".npz" to a bare name
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **data)
        os.replace(tmp, path)

    def _whole_prefix(self, leaf: torch.Tensor) -> torch.Tensor:
        """The filled prefix (positions < pos) of one cache leaf as integer
        bits, with every rank's kv heads and rows on a mesh: (B, KVH, pos,
        hs). The gather moves bytes, which every backend carries."""
        if self._mesh is None:
            return _bits(leaf[:, :, :self.pos]).contiguous()
        bits = _bits(leaf).contiguous()
        raw = bits.view(torch.uint8)
        if self._mesh.sp > 1:           # every shard's positions, in order
            raw = all_gather(raw, self._mesh, SP_AXIS).movedim(0, 2).flatten(2, 3)
        raw = raw[:, :, :self.pos].contiguous()
        if self._mesh.tp > 1:
            raw = all_gather(raw, self._mesh, TP_AXIS).movedim(0, 1).flatten(1, 2)
        raw = self._gather_rows(raw)
        return raw.view(bits.dtype)

    @mirrored
    def load_session(self, path: str) -> list[int]:
        """Restore a save_session() file, of either package: refuses a
        mismatched model or engine config, zeroes the cache and copies the
        saved prefix into it IN PLACE (through the NaN-code guard), sets
        pos. Returns the saved token history ([] when it has none). Over
        ranks rank 0 reads the file and hands its bytes to every rank,
        each of which keeps its own kv heads and rows (and, over sp, its
        positions)."""
        self._refuse_pp("session save/restore")
        if self._mesh is None:
            z = np.load(path)
        else:
            blob = None
            if self._mesh.rank == 0:
                try:
                    with open(path, "rb") as f:
                        blob = f.read()
                except OSError as e:
                    blob = e
            blob = broadcast_object(blob, self._mesh)
            if isinstance(blob, OSError):
                raise blob
            z = np.load(io.BytesIO(blob))
        saved, mine = [int(x) for x in z["config"]], self._session_fingerprint()
        # the weight-content element compares only when both sides know it:
        # 0 means params held in memory (and 4-element files predate it)
        content_ok = (len(saved) < 5 or saved[4] == mine[4]
                      or 0 in (saved[4], mine[4]))
        if saved[:4] != mine[:4] or not content_ok:
            raise ValueError(
                "session file does not match this engine's model/config "
                f"(saved {saved}, engine {mine})")
        pos = int(z["pos"])
        if not 0 <= pos <= self.seq_len:
            raise ValueError(f"session pos {pos} outside 0..{self.seq_len}")
        self.reset()
        kvh, s = self.cache.k[0].shape[1], self.cache.k[0].shape[2]
        h0 = self._mesh.tp_rank * kvh if self._mesh is not None else 0
        rows = slice(self._row0, self._row0 + self._rows)
        # this rank's positions of the prefix: [lo, hi), from off on
        off = self._mesh.sp_rank * s if self._mesh is not None else 0
        lo, hi = min(pos, off), min(pos, off + s)
        for l in range(self.spec.n_layers):
            for name, leaf in (("k", self.cache.k[l]), ("v", self.cache.v[l])):
                raw = np.ascontiguousarray(
                    z[f"{name}{l}"][rows, h0:h0 + kvh, lo:hi])
                bits = torch.from_numpy(raw.view(_BITS_NP[raw.dtype.itemsize]))
                pfx = bits.to(self.device).view(self.cache_dtype)
                _bits(leaf[:, :, lo - off:hi - off]).copy_(
                    _bits(saturate_f8_nan_codes(pfx)))
        self.pos = pos
        return z["tokens"].tolist() if "tokens" in z.files else []

    def _session_fingerprint(self) -> list[int]:
        """Architecture dims, cache shape and dtype, and the weights'
        content hash: the JAX engine's fingerprint, value for value."""
        sp = self.spec
        return [zlib.crc32(repr((sp.arch, sp.dim, sp.hidden_dim, sp.n_layers,
                                 sp.n_heads, sp.n_kv_heads,
                                 sp.head_size)).encode()),
                self.batch, self.seq_len,
                zlib.crc32(DTYPE_NAMES[self.cache_dtype].encode()),
                self.model_fingerprint]

    def _zero_cache(self) -> None:
        for buf in (*self.cache.k, *self.cache.v):
            buf.zero_()

    # -- steps: the forward over the engine's configuration ---------------

    def _forward(self, tokens: torch.Tensor, pos0, logit_index=None,
                 logits_for_all: bool = False, local_logits: bool = False,
                 ring: bool = False) -> torch.Tensor:
        """The engine's forward, configured in exactly one place.
        local_logits: a vocab-sharded engine keeps its vocab slice (the
        sharded sampler's input); otherwise the logits are whole. ring:
        the tokens are this rank's chunk of a ring prefill segment."""
        return forward(self.params, self.spec, tokens, pos0, self.cache,
                       logit_index=logit_index, logits_for_all=logits_for_all,
                       ring=ring, **self._fwd_kwargs(local_logits))

    def _fwd_kwargs(self, local_logits: bool = False) -> dict:
        """The forward's configuration: compute dtype, Q80 activations,
        and the mesh with its reduce and vocab split (the engine's own
        forward, the verify step's and a self-draft's)."""
        return dict(compute_dtype=self.compute_dtype,
                    activation_q80=self.activation_q80, mesh=self._mesh,
                    tp_reduce=self.tp_reduce, shard_vocab=self.shard_vocab,
                    local_logits=local_logits and self.shard_vocab,
                    vocab_axis=self._vocab_axis, pp_gpipe=self.pp_gpipe)

    def _one_sequence(self, name: str) -> None:
        if self.batch != 1:
            raise ValueError(
                f"{name} runs one sequence; this engine holds {self.batch} "
                "slots: drive it with slot_prefill_chunk and "
                "slot_decode_step (runtime/scheduler.py)")

    def _decode_step(self) -> torch.Tensor:
        """Graph 1: the token in `tok` at the position in `pos`."""
        return self._forward(self._buf.tok, self._buf.pos)

    def _greedy_step(self) -> None:
        """Graph ("greedy",): one decode step whose argmax is recorded at
        `count` and fed back as the next token at the next position."""
        b = self._buf
        nxt = torch.argmax(self._forward(b.tok, b.pos), dim=-1)      # (1,)
        b.out.index_copy_(0, b.count, nxt)
        b.tok.copy_(nxt.view(1, 1))
        b.pos.add_(1)
        b.count.add_(1)

    def _sample_step(self, temperature: float, topp: float, n_vocab: int,
                     stops: tuple) -> None:
        """Graph ("dsample", ...): the body of the JAX generate_device loop
        (runtime/engine.py:2045-2063) behind a device `done` flag. A live
        step samples from `logits`, records the token at `count` and ends
        the run at a stop token or at `limit` tokens; then the forward of
        that token runs, unless the run has ended: its position then goes
        to S, where the cache write is dropped. Once done, a replay changes
        no recorded token, RNG state, position or cache slot."""
        b = self._buf
        tok, rng = sample_token(b.logits[0, :n_vocab], b.rng, temperature, topp)
        live = ~b.done
        b.out.index_copy_(0, b.count, tok.view(1))
        b.rng.copy_(torch.where(live, rng, b.rng))
        stop = b.count == b.limit - 1
        for s in stops:
            stop = stop | (tok == s)
        b.count.add_(live.to(torch.int64))
        b.done.logical_or_(live & stop)
        live = ~b.done
        pos = torch.where(live, b.pos, self.seq_len)
        b.logits.copy_(self._forward(tok.view(1, 1), pos))
        b.pos.add_(live.to(torch.int32))

    def _captured(self, key, fn: Callable[[], object]) -> CapturedStep:
        """The graph of `key`, captured from fn at its first use (fn runs
        once eagerly then, with the static buffers as they stand)."""
        if key not in self.graphs:
            COMPILES.pre_compile(self, key)
            self.graphs[key] = capture(fn)._replace(name=compile_key_str(key))
            COMPILES.record(self, key, self.graphs[key].capture_s * 1e3)
        return self.graphs[key]

    @mirrored
    def mark_compile_warm(self) -> None:
        """The serving set is captured (Scheduler.warmup): from here a new
        graph key is a capture after warmup."""
        self._compile_warm = True

    @mirrored
    def release(self) -> None:
        """Give the cache and the captured graphs' pools back to the
        allocator: a supervisor rebuild calls this on the failed engine
        before its factory allocates the next one, so memory does not
        double on every recovery. The engine is unusable afterwards."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()
        for d in self._drafts:
            d.release()
        self._drafts.clear()
        self.cache = None
        self._buf = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @mirrored
    @torch.inference_mode()
    def step(self, tokens: np.ndarray, pos0: int) -> torch.Tensor:
        """Run a (1, T) segment from absolute position pos0; returns the
        last token's logits (1, vocab) f32 on the device, a tensor of its
        own that no later step overwrites. Advances pos. At T = 1 on a
        CUDA engine this replays the captured decode step."""
        self._one_sequence("step")
        b, t = tokens.shape
        if b != 1:
            raise ValueError(f"the engine runs one sequence, got batch {b}")
        if pos0 + t > self.seq_len:
            raise ValueError("context overflow")
        if t == 1 and self.cuda_graphs:
            self._buf.tok.fill_(int(tokens[0, 0]))
            self._buf.pos.fill_(pos0)
            graph = self._captured(1, self._decode_step)
            graph.replay()
            logits = graph.out.clone()
        else:
            tok = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
            logits = self._forward(tok, pos0)
        self.pos = pos0 + t
        return logits

    def fetch_logits(self, logits: torch.Tensor) -> np.ndarray:
        """Bring step() logits to the host (the copy waits for the card).
        step()'s logits are whole on every rank of a mesh (the forward
        gathers a vocab split), so every rank of a cluster reads the same
        logits and its sampler draws the same token (JAX
        runtime/engine.py:737, the protocol's lock-step invariant)."""
        return logits.float().cpu().numpy()

    # -- the benchmark's transfer columns (JAX runtime/engine.py:549-650) --

    def wire_estimate(self):
        """Modeled bytes each rank sends a decoded token, by collective
        (runtime/netstats.estimate_decode_wire: the S column)."""
        from .netstats import estimate_decode_wire

        return estimate_decode_wire(
            self.spec, self.mesh, q80=self.q80_collectives,
            act_bytes=torch.finfo(self.compute_dtype).bits // 8,
            batch=self.batch, shard_vocab=self.shard_vocab,
            vocab_topk=VOCAB_TOPK)

    def measure_transfer_ms(self) -> float:
        """Measured transfer estimate of one decode step (the T column):
        activation-sized collectives timed on the mesh and scaled by the
        decode step's count of each — the tp partial-sum reduces, the ep
        group's MoE reduce, the pp stage hops and the last stage's
        broadcast, and sp's three statistic reduces a layer. Every rank
        runs it, in one order (a cluster's workers on MSG_XFER_BENCH)."""
        return self._segment_ms(1, ring=False)

    def measure_prefill_transfer_ms(self, n_prompt: int) -> float:
        """The same for prefilling an n_prompt-token prompt, segment by
        segment as prefill() runs it: chunks of prefill_chunk (each a
        GPipe schedule over pp when long enough), or over sp the whole
        prompt as one ring segment. Measured once per distinct segment
        length. Returns total ms."""
        m = self._mesh
        if m is None:
            return 0.0
        if m.sp > 1 and m.pp == 1:
            t = n_prompt + (-n_prompt) % m.sp
            return self._segment_ms(t, ring=True)
        n_full, tail = divmod(n_prompt, self.prefill_chunk)
        total = 0.0
        if n_full:
            total += self._segment_ms(self.prefill_chunk, ring=False) * n_full
        if tail:
            total += self._segment_ms(tail, ring=False)
        return total

    def _segment_ms(self, t: int, ring: bool) -> float:
        """Timed collectives of one t-token forward segment over this
        rank's rows (JAX _segment_reduce_ms and _segment_pp_ms, with the
        port's pp and sp schedules)."""
        from ..parallel.pp import gpipe_microbatches
        from .netstats import (measure_allreduce_ms, measure_broadcast_ms,
                               measure_ppermute_ms)

        m, sp = self._mesh, self.spec
        if m is None:
            return 0.0
        act = self._rows * t * sp.dim
        total = 0.0
        if sp.is_moe and m.ep > 1:
            if m.tp > 1:                    # the attention's wo reduce
                total += measure_allreduce_ms(m, act) * sp.n_layers
            total += measure_allreduce_ms(m, act, axes=("ep", "tp")) \
                * sp.n_layers
        elif m.tp > 1:
            per_layer = (1 + sp.n_active_experts) if sp.is_moe else 2
            total += measure_allreduce_ms(m, act) * per_layer * sp.n_layers
        if m.pp > 1:
            mb = gpipe_microbatches(t, m.pp) if self.pp_gpipe else 1
            hop = measure_ppermute_ms(m, self._rows * (t // mb) * sp.dim)
            total += hop * (mb + m.pp - 2) + measure_broadcast_ms(m, act)
        if m.sp > 1:
            heads = self._rows * sp.n_heads
            if ring:     # the K/V blocks' sp - 1 hops a layer
                kv = 2 * self._rows * (t // m.sp) * sp.n_kv_heads * sp.head_size
                total += (measure_ppermute_ms(m, kv, axis="sp")
                          * (m.sp - 1) * sp.n_layers)
            else:        # the statistics' merge: max, then two sums
                total += (measure_allreduce_ms(m, heads * t, axes=("sp",)) * 2
                          + measure_allreduce_ms(m, heads * t * sp.head_size,
                                                 axes=("sp",))) * sp.n_layers
        return total

    def prefill(self, prompt: list[int]) -> torch.Tensor:
        """Feed the prompt in fixed-size chunks; returns the last logits.
        Over sp (and no pp) a prompt from position 0 runs as ONE ring
        segment instead (JAX runtime/engine.py:834-875)."""
        m, n = self._mesh, len(prompt)
        if (m is not None and m.sp > 1 and m.pp == 1 and self.pos == 0
                and n > 1 and n + (-n) % m.sp <= self.seq_len):
            return self._prefill_ring(prompt)
        logits = None
        i, n = 0, len(prompt)
        while i < n:
            chunk = min(self.prefill_chunk, n - i)
            seg = np.asarray(prompt[i:i + chunk], np.int32)[None, :]
            logits = self.step(seg, self.pos)
            i += chunk
        return logits

    @mirrored
    @torch.inference_mode()
    def _prefill_ring(self, prompt: list[int]) -> torch.Tensor:
        """The whole prompt as one sequence-parallel segment (JAX
        _prefill_ring): padded to a multiple of sp, rank i runs chunk i
        through every layer with ring attention, each rank writing the
        positions of its cache shard; the logits are the true last
        position's. Padded positions land in the cache at >= pos, so later
        steps never attend them. An op of its own on a mirrored engine:
        under chat and the legacy api over sp every rank runs the ring in
        rank 0's order."""
        self._one_sequence("prefill")
        m, n = self._mesh, len(prompt)
        t = n + (-n) % m.sp
        tl = t // m.sp
        seg = np.zeros((1, t), np.int64)
        seg[0, :n] = prompt
        c0 = m.sp_rank * tl
        tok = torch.as_tensor(seg[:, c0:c0 + tl], device=self.device)
        logits = self._forward(tok, c0, logit_index=n - 1, ring=True)
        self.pos = n
        return logits

    def generate(
        self,
        prompt: list[int],
        max_tokens: int,
        sampler: Sampler,
        eos_id: int | set[int] | None = None,
        on_token: Callable[[int], None] | None = None,
    ) -> GenerationResult:
        """Prefill + decode loop (ref: src/apps/dllama/dllama.cpp:14-91).
        max_tokens is a hard cap; <= 0 emits nothing (prefill still runs)."""
        self._one_sequence("generate")
        stop_ids = ({eos_id} if isinstance(eos_id, int) else eos_id) or set()
        stats = RunStats()
        out: list[int] = []
        if max_tokens <= 0:
            self.prefill(prompt)
            return GenerationResult(out, stats)

        t0 = time.perf_counter()
        logits_np = self.fetch_logits(self.prefill(prompt))
        t1 = time.perf_counter()
        stats.add(StepStats(generation_ms=(t1 - t0) * 1e3,
                            device_ms=(t1 - t0) * 1e3))
        token = sampler.sample(logits_np[0])
        out.append(token)
        if on_token:
            on_token(token)

        while len(out) < max_tokens and self.pos < self.seq_len:
            if token in stop_ids:
                break
            g0 = time.perf_counter()
            logits_np = self.fetch_logits(
                self.step(np.asarray([[token]], np.int32), self.pos))
            g1 = time.perf_counter()
            token = sampler.sample(logits_np[0])
            g2 = time.perf_counter()
            stats.add(StepStats(generation_ms=(g2 - g0) * 1e3,
                                device_ms=(g1 - g0) * 1e3,
                                host_ms=(g2 - g1) * 1e3))
            out.append(token)
            if on_token:
                on_token(token)
        return GenerationResult(out, stats)

    # -- speculative decoding (runtime/speculative.py, runtime/draft.py) ---

    def _seg_buffer(self, t: int) -> torch.Tensor:
        """The static (rows, t) token buffer of the verify steps of width t
        (this rank's rows of the batch)."""
        seg = self._buf.seg
        if t not in seg:
            seg[t] = torch.zeros((self._rows, t), dtype=torch.int64,
                                 device=self.device)
        return seg[t]

    @mirrored
    @torch.inference_mode()
    def _verify_logits(self, seg: np.ndarray, pos0: int) -> np.ndarray:
        """The verify forward of a batch-1 speculative stream: the (1, T)
        segment [last token] + draft at pos0, every position's logits
        (T, vocab) f32 on the host. On a CUDA engine the captured step
        ("lookup", T) replays over the static (1, T) buffer and the device
        position (JAX engine.py:1062, compiled with logits_for_all)."""
        t = seg.shape[1]
        if not self.cuda_graphs:
            tok = torch.as_tensor(np.asarray(seg, np.int64), device=self.device)
            return self.fetch_logits(
                self._forward(tok, pos0, logits_for_all=True))[0]
        buf = self._seg_buffer(t)
        buf.copy_(torch.from_numpy(np.asarray(seg, np.int64)))
        self._buf.pos.fill_(pos0)
        graph = self._captured(("lookup", t), lambda: self._forward(
            buf, self._buf.pos, logits_for_all=True))
        graph.replay()
        return self.fetch_logits(graph.out)[0]

    def generate_lookup_stream(
        self,
        prompt: list[int],
        max_tokens: int,
        eos_id: int | set[int] | None = None,
        *,
        draft_len: int = 7,
        max_ngram: int = 3,
        history: list[int] | None = None,
        stats: RunStats | None = None,
        vocab_size: int | None = None,
    ) -> Iterator[int]:
        """Prompt-lookup speculative decoding as a token iterator (JAX
        runtime/engine.py:932): each verify forward feeds the last token
        plus a draft mined from the context's own n-grams and emits the
        accepted prefix plus one token. The stream is exactly generate()'s
        greedy stream. `prompt` is fed from self.pos; `history` is the
        whole context drafts are mined from (default: the prompt);
        `vocab_size` caps the argmax at the tokenizer's vocab, as the host
        Sampler truncates. `last_accept_stats` and `last_spec` update at
        every forward."""
        from .speculative import count_accepted

        spec_v = min(vocab_size or self.spec.vocab_size, self.spec.vocab_size)

        def first(row: np.ndarray) -> int:
            return int(np.argmax(row[:spec_v]))

        def verify(seg_logits: np.ndarray, draft: list[int]) -> list[int]:
            greedy = np.argmax(seg_logits[:, :spec_v], axis=-1)
            m = count_accepted(draft, greedy)
            return [int(g) for g in greedy[: m + 1]]

        return self._lookup_loop(prompt, max_tokens, eos_id,
                                 draft_len=draft_len, max_ngram=max_ngram,
                                 history=history, stats=stats,
                                 first_fn=first, verify_fn=verify)

    def _lookup_loop(
        self,
        prompt: list[int],
        max_tokens: int,
        eos_id: int | set[int] | None,
        *,
        draft_len: int,
        max_ngram: int,
        history: list[int] | None,
        stats: RunStats | None,
        first_fn: Callable[[np.ndarray], int],
        verify_fn: Callable[[np.ndarray, list[int]], list[int]],
        draft_fn: Callable | None = None,
    ) -> Iterator[int]:
        """The verify loop every speculative mode shares (JAX
        runtime/engine.py:980): draft sizing, the verify step, eos and
        budget truncation, the position bookkeeping, the accept record and
        the timing split. Modes differ in their callbacks:
        first_fn(logits row) -> the first token; verify_fn(seg_logits
        (T, V), draft) -> the emitted tokens (the accepted draft prefix
        plus exactly one more); draft_fn(hist, k, token, pos0) -> a draft
        (real-draft modes; default: the n-gram miner)."""
        from .speculative import find_draft

        self._one_sequence("speculative decoding")
        stop_ids = ({eos_id} if isinstance(eos_id, int) else eos_id) or set()
        if max_tokens <= 0:
            # the hard-cap contract of generate(): prefill, emit nothing
            self.prefill(prompt)
            self.last_accept_stats = (1, 0)
            self.last_spec = {"forwards": 1, "drafted": 0, "accepted": 0,
                              "emitted": 0}
            return

        t0 = time.perf_counter()
        logits_np = self.fetch_logits(self.prefill(prompt))
        t1 = time.perf_counter()
        if stats is not None:
            stats.add(StepStats(generation_ms=(t1 - t0) * 1e3,
                                device_ms=(t1 - t0) * 1e3))
        token = first_fn(logits_np[0])
        n_out = 1
        self.last_accept_stats = (1, 1)
        # `accepted` counts the draft tokens actually used after eos and
        # budget truncation
        self.last_spec = {"forwards": 1, "drafted": 0, "accepted": 0,
                          "emitted": 1}
        hist = np.asarray((history if history is not None else prompt)
                          + [token], np.int32)
        yield token

        while (n_out < max_tokens and self.pos < self.seq_len
               and token not in stop_ids):
            # the draft fits the budget and the context (the fed token's
            # own K/V write needs a free slot too)
            g0 = time.perf_counter()
            k = min(draft_len, self.seq_len - self.pos - 1,
                    max_tokens - n_out - 1)
            pos0 = self.pos
            if draft_fn is not None:
                draft = draft_fn(hist, k, token, pos0) if k > 0 else []
            else:
                draft = (find_draft(hist, k, max_ngram=max_ngram)
                         if k > 0 else [])
            seg = np.asarray([[token] + draft], np.int32)
            # device ms: the verify forward and its logits copy; mining
            # and accepting are host ms
            d0 = time.perf_counter()
            seg_logits = self._verify_logits(seg, pos0)
            d1 = time.perf_counter()

            emitted = verify_fn(seg_logits, draft)
            # a stop token is emitted (generate() parity), the rest dropped
            for i, t in enumerate(emitted):
                if t in stop_ids:
                    emitted = emitted[: i + 1]
                    break
            emitted = emitted[: max_tokens - n_out]
            # positions pos0..pos0+a hold [token] + the confirmed prefix;
            # unconfirmed draft writes past them are overwritten position
            # by position before any later query attends them
            a = len(emitted) - 1
            self.pos = pos0 + 1 + a
            n_out += len(emitted)
            self.last_accept_stats = (self.last_accept_stats[0] + 1, n_out)
            self.last_spec["forwards"] += 1
            self.last_spec["drafted"] += len(draft)
            self.last_spec["accepted"] += max(a, 0)
            self.last_spec["emitted"] += len(emitted)
            hist = np.concatenate([hist, np.asarray(emitted, np.int32)])
            token = emitted[-1]
            g1 = time.perf_counter()
            if stats is not None:
                stats.add(StepStats(generation_ms=(g1 - g0) * 1e3,
                                    device_ms=(d1 - d0) * 1e3,
                                    host_ms=(g1 - g0 - (d1 - d0)) * 1e3))
            yield from emitted

    @staticmethod
    def _collect(stream: Iterator[int], stats: RunStats,
                 on_token: Callable[[int], None] | None) -> GenerationResult:
        out: list[int] = []
        for t in stream:
            out.append(t)
            if on_token:
                on_token(t)
        return GenerationResult(out, stats)

    def generate_lookup(
        self,
        prompt: list[int],
        max_tokens: int,
        eos_id: int | set[int] | None = None,
        *,
        draft_len: int = 7,
        max_ngram: int = 3,
        on_token: Callable[[int], None] | None = None,
        vocab_size: int | None = None,
        history: list[int] | None = None,
    ) -> GenerationResult:
        """Collecting wrapper over generate_lookup_stream (the CLI path)."""
        stats = RunStats()
        return self._collect(self.generate_lookup_stream(
            prompt, max_tokens, eos_id, draft_len=draft_len,
            max_ngram=max_ngram, stats=stats, vocab_size=vocab_size,
            history=history), stats, on_token)

    def generate_lookup_sampled(
        self,
        prompt: list[int],
        max_tokens: int,
        *,
        temperature: float,
        topp: float,
        seed: int,
        eos_id: int | set[int] | None = None,
        draft_len: int = 7,
        max_ngram: int = 3,
        on_token: Callable[[int], None] | None = None,
        vocab_size: int | None = None,
        history: list[int] | None = None,
    ) -> GenerationResult:
        """Sampled prompt-lookup speculation by rejection resampling (JAX
        runtime/engine.py:1126): every emitted token is distributed as the
        host Sampler's draw on the same logits, on a numpy PCG64 stream
        seeded with `seed` (not the Sampler's xorshift stream)."""
        stats = RunStats()
        return self._collect(self.generate_lookup_sampled_stream(
            prompt, max_tokens, temperature=temperature, topp=topp,
            seed=seed, eos_id=eos_id, draft_len=draft_len,
            max_ngram=max_ngram, vocab_size=vocab_size, history=history,
            stats=stats), stats, on_token)

    def generate_lookup_sampled_stream(
        self,
        prompt: list[int],
        max_tokens: int,
        *,
        temperature: float,
        topp: float,
        seed: int,
        eos_id: int | set[int] | None = None,
        draft_len: int = 7,
        max_ngram: int = 3,
        vocab_size: int | None = None,
        history: list[int] | None = None,
        stats: RunStats | None = None,
    ) -> Iterator[int]:
        """Token-iterator form of generate_lookup_sampled (JAX
        runtime/engine.py:1170). The uniforms are drawn in the JAX order:
        one for the first token, then per draft position one to accept
        and one to resample, and one for the bonus token of a fully
        accepted draft."""
        from .speculative import accept_or_resample, draw, target_dist

        if not temperature > 0:
            raise ValueError("temperature 0 is the greedy mode "
                             "(generate_lookup)")
        spec_v = min(vocab_size or self.spec.vocab_size, self.spec.vocab_size)
        rng = np.random.default_rng(seed)

        def first(row: np.ndarray) -> int:
            return draw(target_dist(row, temperature, topp, spec_v),
                        rng.random())

        def verify(seg_logits: np.ndarray, draft: list[int]) -> list[int]:
            # position i's logits condition on [token] + draft[:i]
            emitted: list[int] = []
            for i, d in enumerate(draft):
                p_i = target_dist(seg_logits[i], temperature, topp, spec_v)
                ok, t = accept_or_resample(p_i, int(d), rng.random(),
                                           rng.random())
                emitted.append(t)
                if not ok:
                    return emitted
            p_k = target_dist(seg_logits[len(draft)], temperature, topp,
                              spec_v)
            emitted.append(draw(p_k, rng.random()))
            return emitted

        return self._lookup_loop(prompt, max_tokens, eos_id,
                                 draft_len=draft_len, max_ngram=max_ngram,
                                 history=history, stats=stats,
                                 first_fn=first, verify_fn=verify)

    def _draft_catchup(self, draft, state: dict, hist: np.ndarray,
                       target_pos: int) -> None:
        """Bring a draft cache's frontier up to target_pos by prefilling
        the tokens it missed (hist[i] is the token at position i), in
        chunks of one fixed width (JAX runtime/engine.py:1230): pad writes
        land past the frontier and are overwritten before the draft
        attends them."""
        c = min(self.prefill_chunk, self.seq_len)
        target = min(int(target_pos), len(hist))
        while state["pos"] < target:
            dp = state["pos"]
            n = min(c, target - dp)
            tok = np.zeros((self.batch, c), np.int32)
            tok[0, :n] = hist[dp:dp + n]
            pos = np.full((self.batch,), self.seq_len, np.int32)
            pos[0] = dp
            state["cache"] = draft.prefill_chunk(state["cache"], tok, pos)
            state["pos"] = dp + n

    def generate_draft_stream(
        self,
        prompt: list[int],
        max_tokens: int,
        eos_id: int | set[int] | None = None,
        *,
        draft,
        draft_len: int = 7,
        history: list[int] | None = None,
        stats: RunStats | None = None,
        vocab_size: int | None = None,
    ) -> Iterator[int]:
        """Greedy real-draft speculation (JAX runtime/engine.py:1254): the
        draft (runtime/draft.py) proposes draft_len tokens in one dispatch
        (one captured step, replayed), the verify forward confirms the
        accepted prefix plus one; the stream is exactly generate()'s greedy
        stream. The draft's cache is zeroed at the start and caught up from
        `history` (default: the prompt), so a stream that continues a
        loaded session or a chat prefills the whole context into it."""
        from .speculative import count_accepted

        self._one_sequence("generate_draft_stream")
        spec_v = min(vocab_size or self.spec.vocab_size, self.spec.vocab_size)
        state = {"cache": draft.new_cache(), "pos": 0}

        def first(row: np.ndarray) -> int:
            return int(np.argmax(row[:spec_v]))

        def verify(seg_logits: np.ndarray, dr: list[int]) -> list[int]:
            greedy = np.argmax(seg_logits[:, :spec_v], axis=-1)
            m = count_accepted(dr, greedy)
            return [int(g) for g in greedy[: m + 1]]

        def draft_fn(hist, k, token, pos0):
            self._draft_catchup(draft, state, hist, pos0)
            # always the full draft_len (one graph), truncated to k: the
            # extra steps' writes sit past the frontier, and every next
            # round re-feeds from its pos0, overwriting each stale
            # position before its own query attends it
            toks, state["cache"] = draft.propose(
                state["cache"], np.asarray([token], np.int32),
                np.asarray([pos0], np.int32), draft_len, n_vocab=spec_v)
            state["pos"] = pos0 + draft_len
            return [int(t) for t in toks[0][:k]]

        return self._lookup_loop(prompt, max_tokens, eos_id,
                                 draft_len=draft_len, max_ngram=0,
                                 history=history, stats=stats,
                                 first_fn=first, verify_fn=verify,
                                 draft_fn=draft_fn)

    def generate_draft(
        self,
        prompt: list[int],
        max_tokens: int,
        eos_id: int | set[int] | None = None,
        *,
        draft,
        draft_len: int = 7,
        on_token: Callable[[int], None] | None = None,
        vocab_size: int | None = None,
        history: list[int] | None = None,
    ) -> GenerationResult:
        """Collecting wrapper over generate_draft_stream (the CLI path)."""
        stats = RunStats()
        return self._collect(self.generate_draft_stream(
            prompt, max_tokens, eos_id, draft=draft, draft_len=draft_len,
            stats=stats, vocab_size=vocab_size, history=history),
            stats, on_token)

    def generate_draft_sampled_stream(
        self,
        prompt: list[int],
        max_tokens: int,
        *,
        draft,
        temperature: float,
        topp: float,
        seed: int,
        eos_id: int | set[int] | None = None,
        draft_len: int = 7,
        vocab_size: int | None = None,
        history: list[int] | None = None,
        stats: RunStats | None = None,
    ) -> Iterator[int]:
        """Sampled real-draft speculation by general rejection resampling
        (JAX runtime/engine.py:1342): the draft samples each proposal from
        its own distribution q, the target accepts with min(1, p/q) and
        resamples max(p - q, 0) on the first reject. The draft loop is
        host-paced: one captured draft step a proposal, its logits to the
        host for target_dist and the draw."""
        from .speculative import accept_or_resample_q, draw, target_dist

        self._one_sequence("generate_draft_sampled_stream")
        if not temperature > 0:
            raise ValueError("temperature 0 is the greedy mode "
                             "(generate_draft)")
        spec_v = min(vocab_size or self.spec.vocab_size, self.spec.vocab_size)
        rng = np.random.default_rng(seed)
        state = {"cache": draft.new_cache(), "pos": 0, "q": []}

        def first(row: np.ndarray) -> int:
            return draw(target_dist(row, temperature, topp, spec_v),
                        rng.random())

        def draft_fn(hist, k, token, pos0):
            self._draft_catchup(draft, state, hist, pos0)
            toks: list[int] = []
            qs: list[np.ndarray] = []
            cur, p, cache = int(token), int(pos0), state["cache"]
            for _ in range(k):
                lg, cache = draft.step_logits(
                    cache, np.asarray([[cur]], np.int32),
                    np.asarray([p], np.int32))
                qd = target_dist(lg[0], temperature, topp, spec_v)
                cur = draw(qd, rng.random())
                toks.append(cur)
                qs.append(qd)
                p += 1
            state["cache"], state["pos"], state["q"] = cache, p, qs
            return toks

        def verify(seg_logits: np.ndarray, dr: list[int]) -> list[int]:
            emitted: list[int] = []
            for i, d in enumerate(dr):
                p_i = target_dist(seg_logits[i], temperature, topp, spec_v)
                ok, t = accept_or_resample_q(p_i, state["q"][i], int(d),
                                             rng.random(), rng.random())
                emitted.append(t)
                if not ok:
                    return emitted
            p_k = target_dist(seg_logits[len(dr)], temperature, topp,
                              spec_v)
            emitted.append(draw(p_k, rng.random()))
            return emitted

        return self._lookup_loop(prompt, max_tokens, eos_id,
                                 draft_len=draft_len, max_ngram=0,
                                 history=history, stats=stats,
                                 first_fn=first, verify_fn=verify,
                                 draft_fn=draft_fn)

    def generate_draft_sampled(
        self,
        prompt: list[int],
        max_tokens: int,
        *,
        draft,
        temperature: float,
        topp: float,
        seed: int,
        eos_id: int | set[int] | None = None,
        draft_len: int = 7,
        on_token: Callable[[int], None] | None = None,
        vocab_size: int | None = None,
        history: list[int] | None = None,
    ) -> GenerationResult:
        """Collecting wrapper over generate_draft_sampled_stream."""
        stats = RunStats()
        return self._collect(self.generate_draft_sampled_stream(
            prompt, max_tokens, draft=draft, temperature=temperature,
            topp=topp, seed=seed, eos_id=eos_id, draft_len=draft_len,
            vocab_size=vocab_size, history=history, stats=stats),
            stats, on_token)

    # -- on-device loops: one captured step, replayed back to back ---------

    @mirrored
    @torch.inference_mode()
    def decode_greedy_device(self, first_token: int,
                             n_tokens: int) -> tuple[np.ndarray, float]:
        """Greedy decode of n_tokens from first_token at self.pos with no
        host round trip per token (JAX runtime/engine.py:2215, the loop the
        JAX bench times). Like the JAX loop, it runs on a fresh cache: the
        cache is zeroed in place first. Returns (tokens (n_tokens, 1) int32,
        seconds); the seconds exclude the graph's capture on the first
        call. Advances pos by n_tokens; a run past the cache raises."""
        self._one_sequence("decode_greedy_device")
        if n_tokens < 0 or self.pos + n_tokens > self.seq_len:
            raise ValueError(f"context overflow: {n_tokens} tokens from "
                             f"pos {self.pos} of {self.seq_len}")
        b, key = self._buf, ("greedy",)

        def start() -> None:
            self._zero_cache()
            b.tok.fill_(first_token)
            b.pos.fill_(self.pos)
            b.count.zero_()
        if self.cuda_graphs and key not in self.graphs:
            start()
            self._captured(key, self._greedy_step)
        start()
        run = self.graphs[key].replay if self.cuda_graphs else self._greedy_step
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(n_tokens):
            run()
        toks = b.out[:n_tokens].cpu()      # the one host read: waits for all
        dt = time.perf_counter() - t0
        self.pos += n_tokens
        return toks.numpy().astype(np.int32).reshape(n_tokens, 1), dt

    @mirrored
    @torch.inference_mode()
    def generate_device(
        self,
        prompt: list[int],
        max_tokens: int,
        *,
        temperature: float,
        topp: float,
        seed: int,
        eos_id: int | set[int] | None = None,
        vocab_size: int | None = None,
    ) -> list[int]:
        """Sampled generation with the decode loop on the device (JAX
        runtime/engine.py:1990): each replay samples (ops/device_sampler.py,
        the reference's xorshift* stream seeded with `seed`) and steps the
        model, with no host round trip per token; the host reads the done
        flag once every _DONE_CHECK_EVERY replays.

        The generate() + Sampler contract: it stops at the first stop token
        (included), the forward of the last emitted token never runs (no
        cache write past it), pos advances by n - 1 for n tokens, and
        last_device_steps is n. The device CDF is summed in f32, so a
        neighbouring token differs from the host Sampler's only within f32
        rounding of a CDF boundary. vocab_size: sample only over the first
        vocab_size logits, as the host Sampler truncates to its vocab."""
        self._one_sequence("generate_device")
        stop_ids = ({eos_id} if isinstance(eos_id, int) else eos_id) or set()
        n_vocab = min(vocab_size or self.spec.vocab_size, self.spec.vocab_size)
        logits = self.prefill(prompt)
        if max_tokens <= 0:      # the hard-cap contract of generate()
            self.last_device_steps = 0
            return []
        # every stepped token writes the cache at pos < seq_len; the last
        # token is never stepped, so the loop may emit at the context edge
        max_tokens = min(max_tokens, self.seq_len - self.pos + 1)
        stops = tuple(sorted(stop_ids))
        key = ("dsample", float(temperature), float(topp), n_vocab, stops)
        b = self._buf

        def step() -> None:
            self._sample_step(float(temperature), float(topp), n_vocab, stops)

        def start(done: bool) -> None:
            b.logits.copy_(logits)
            b.rng.copy_(state_from_seed(seed, self.device))
            b.count.zero_()
            b.done.fill_(done)
            b.pos.fill_(self.pos)
            b.limit.fill_(max_tokens)
        if self.cuda_graphs and key not in self.graphs:
            start(True)     # done: the warm-up run writes no cache slot
            self._captured(key, step)
        start(False)
        run = self.graphs[key].replay if self.cuda_graphs else step
        every = _DONE_CHECK_EVERY if self.cuda_graphs else 1
        for i in range(max_tokens):
            run()
            if (i + 1) % every == 0 and bool(b.done):
                break
        n = int(b.count)
        self.last_device_steps = n
        self.pos += max(n - 1, 0)
        return b.out[:n].tolist()

    # -- batched generation (JAX runtime/engine.py:1683-2188) ---------------

    def _batch_args(self, prompts: list[list[int]]) -> np.ndarray:
        if len(prompts) != self.batch:
            raise ValueError(f"{len(prompts)} prompts for an engine of "
                             f"{self.batch} slots")
        if not all(prompts):
            raise ValueError("empty prompt")
        lens = np.asarray([len(p) for p in prompts], np.int32)
        if int(lens.max()) >= self.seq_len:
            raise ValueError("context overflow")
        return lens

    @mirrored
    def _batch_prefill(self, prompts: list[list[int]]) -> torch.Tensor:
        """Prefill every row's prompt from position 0, right-padded, in
        chunks of prefill_chunk through slot_prefill_chunk: a row whose
        prompt ended in an earlier chunk is gated (position S), and a
        tail chunk's padding writes past the prompt, where decode
        overwrites it before any query attends it. Returns (rows, vocab)
        f32 logits at each of this rank's rows' last prompt token (its
        vocab slice on a vocab-sharded engine)."""
        c = min(self.prefill_chunk, self.seq_len)
        last: list = [None] * self._rows
        for off in range(0, max(len(p) for p in prompts), c):
            tok = np.zeros((self.batch, c), np.int32)
            pos = np.full((self.batch,), self.seq_len, np.int32)
            lidx = np.zeros((self.batch,), np.int32)
            for i, p in enumerate(prompts):
                n = min(c, len(p) - off)
                if n > 0:
                    tok[i, :n] = p[off:off + n]
                    pos[i], lidx[i] = off, n - 1
            logits = self._prefill_chunk(tok, pos, lidx)
            for i, p in enumerate(prompts):
                if self._mine(i) and off < len(p) <= off + c:
                    last[i - self._row0] = logits[i - self._row0]
        return torch.stack(last)

    def _mine(self, row: int) -> bool:
        """Whether this rank holds batch row `row`."""
        return self._row0 <= row < self._row0 + self._rows

    def generate_batch(
        self,
        prompts: list[list[int]],
        max_tokens: int,
        sampler: Sampler,
        eos_id: int | set[int] | None = None,
    ) -> list[list[int]]:
        """B independent sequences at once (JAX runtime/engine.py:1840):
        one token list a row, a row's stop token included as its last
        entry (generate() parity). Greedy rows equal B separate generate()
        runs."""
        out: list[list[int]] = [[] for _ in prompts]
        for step_toks in self.generate_batch_stream(prompts, max_tokens,
                                                    sampler, eos_id):
            for i, t in enumerate(step_toks):
                if t is not None:
                    out[i].append(t)
        return out

    @torch.inference_mode()
    def generate_batch_stream(
        self,
        prompts: list[list[int]],
        max_tokens: int,
        sampler: Sampler,
        eos_id: int | set[int] | None = None,
        stop_flags: np.ndarray | None = None,
    ) -> Iterator[list[int | None]]:
        """Step-level iterator form of generate_batch (JAX
        runtime/engine.py:1863), the batch endpoint's stream. Each yield is
        one decode step's tokens: B entries, a row's new token (a stop
        token included, then the row stops) or None for a row that is
        done or past its budget. max_tokens <= 0 prefills and emits
        nothing. One shared Sampler samples every live row in row order,
        so its coins are drawn as by per-row sample() calls.

        `stop_flags` is the caller's (B,) bool array: setting
        stop_flags[i] between steps retires row i (the server's text-level
        stop scan); a row flagged before the first step never samples (the
        server pads a short batch with such rows). A row decodes while
        unstopped, under budget and with a free cache position; every
        other row passes position S."""
        stop_ids = ({eos_id} if isinstance(eos_id, int) else eos_id) or set()
        lens = self._batch_args(prompts)
        b = self.batch
        logits = self._batch_prefill(prompts)
        self.pos = int(lens.max())
        if max_tokens <= 0:      # the hard-cap contract of generate()
            return

        def sample_rows(lg, mask: np.ndarray) -> np.ndarray:
            out = np.full(b, -1, np.int64)
            if self._mesh is not None and sampler.temperature == 0.0:
                # greedy rows over ranks: only the tokens meet
                toks = self._greedy_rows(lg, int(sampler.vocab_size))
                out[mask] = toks[mask]
                return out
            temps = np.full(b, sampler.temperature or 1.0, np.float32)
            view = self.sample_view(lg, temps, int(sampler.vocab_size))
            for i in np.nonzero(mask)[0]:
                out[i] = view.sample(sampler, int(i))
            return out

        n_out = np.zeros(b, np.int64)
        done = np.zeros(b, bool)
        live0 = (np.ones(b, bool) if stop_flags is None
                 else ~np.asarray(stop_flags, bool))
        # a pre-retired row still feeds a token: a real id, 0
        cur = np.where(live0, sample_rows(logits, live0), 0).astype(np.int64)
        for i in np.nonzero(live0)[0]:
            n_out[i] = 1
            done[i] = int(cur[i]) in stop_ids
        pos = lens.copy()        # next write position a row
        yield [int(c) if live0[i] else None for i, c in enumerate(cur)]

        def alive(i: int) -> bool:
            if stop_flags is not None and stop_flags[i]:
                return False
            return (not done[i] and n_out[i] < max_tokens
                    and pos[i] < self.seq_len)

        while True:
            live = np.asarray([alive(i) for i in range(b)])
            if not live.any():
                return
            lg = self._slot_step(cur[:, None], np.where(live, pos, self.seq_len))
            nxt = sample_rows(lg, live)
            step: list[int | None] = [None] * b
            for i in np.nonzero(live)[0]:
                step[i] = int(nxt[i])
                n_out[i] += 1
                cur[i] = nxt[i]
                done[i] = int(nxt[i]) in stop_ids
            pos = pos + 1
            self.pos = int(np.minimum(pos, self.seq_len).max())
            yield step

    # -- sampling over ranks (ops/sharded_vocab.py, runtime/sampling.py) ----

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows -> every row of the batch, on every rank: the
        dp groups' rows side by side (as they are when dp replicates)."""
        if not self._dp_split:
            return x
        return all_gather(x, self._mesh, DP_AXIS).flatten(0, 1)

    @property
    def shard_sampling(self) -> bool:
        """Whether the samplers read the vocab-split logits' summaries (the
        sharded argmax and top-k candidates): with the vocab split, except
        over more than one node, where they read whole logits (JAX
        runtime/engine.py:747 shard_sampling)."""
        return self.shard_vocab and not self._multihost

    @mirrored
    def _greedy_rows(self, lg: torch.Tensor, n_vocab: int) -> np.ndarray:
        """(B,) greedy tokens over this rank's rows' logits: the sharded
        argmax on a vocab-sharded engine, np.argmax's first maximum over
        the first n_vocab logits otherwise; then the tokens of every row."""
        if self.shard_vocab:
            toks = sharded_argmax(lg, self._mesh, n_vocab, self._vocab_axis)
        else:
            toks = torch.argmax(lg[:, :n_vocab].float(), dim=-1)
        return self._gather_rows(toks).cpu().numpy()

    @mirrored
    def sample_view(self, lg: torch.Tensor, temps: np.ndarray | None,
                    n_vocab: int):
        """Sampling access to one step's logits of every row (JAX
        runtime/engine.py:755), from this rank's rows' logits. Over dp the
        rows' logits (or summaries) meet at every rank, so one shared
        Sampler samples all of them in row order. A vocab-sharded engine
        gives a ShardedLogitsView: the device argmax and per-rank top-k
        candidates (k = VOCAB_TOPK) at each row's temperature (`temps`,
        (B,) f32, a greedy row passing 1; None: all 1), exact by the
        guard, with one replicated row fetched (`fetch_row`) for whatever
        the candidates cannot prove. n_vocab: the tokenizer's vocab, where
        the argmax and the candidates stop."""
        if not self.shard_sampling or self._mesh is None:
            if self.shard_vocab:       # whole rows: every rank's vocab slice
                lg = all_gather(lg, self._mesh, self._vocab_axis) \
                    .movedim(0, -2).flatten(-2)
            return FullLogitsView(self.fetch_logits(self._gather_rows(lg)))
        nv = int(n_vocab)
        k = max(1, min(VOCAB_TOPK, lg.shape[-1]))
        temps = (np.ones(self.batch, np.float32) if temps is None
                 else np.asarray(temps, np.float32))
        t = torch.as_tensor(self._local_rows(temps)[0], device=lg.device)
        amax, cand_p, cand_id, guard = (
            self._gather_rows(x).cpu().numpy()
            for x in sharded_sample_prep(lg, t, self._mesh, nv, k,
                                         self._vocab_axis))
        return ShardedLogitsView(amax, cand_p, cand_id, guard, nv,
                                 functools.partial(self.fetch_row, lg),
                                 stats=self.vocab_sample_stats)

    @mirrored
    def fetch_row(self, lg: torch.Tensor, row: int) -> np.ndarray:
        """One whole (vocab,) row of the vocab-split logits `lg`, on every
        rank: the ranks holding the row put their vocab slice in place,
        the others zeros, and one all-reduce adds them (exact: one value
        and zeros). A sampler asks for it lazily, so on a mirrored engine
        it is an op of its own: followers never sample, they fetch when
        rank 0 does."""
        mesh, vl = self._mesh, lg.shape[-1]
        axis = WORLD if self._dp_split else self._vocab_axis
        # over every rank, one copy of each vocab slice: the ranks of the
        # other axes' first index hold it
        lead = not self._dp_split or all(
            mesh.coords[a] == 0 for a in (SP_AXIS, EP_AXIS, PP_AXIS)
            if a not in axis_parts(self._vocab_axis))
        buf = torch.zeros(self.spec.vocab_size, dtype=torch.float32,
                          device=lg.device)
        if self._mine(row) and lead:
            v0 = mesh.index(self._vocab_axis) * vl
            buf[v0:v0 + vl] = lg[row - self._row0]
        return all_reduce(buf, mesh, axis).cpu().numpy()

    def _row_buffers(self) -> types.SimpleNamespace:
        """generate_batch_device's static per-row buffers: each row's
        logits, RNG state, done flag and recorded tokens."""
        if self._buf.rows is None:
            dev, b = self.device, self._rows
            self._buf.rows = types.SimpleNamespace(
                logits=torch.zeros((b, self.spec.vocab_size),
                                   dtype=torch.float32, device=dev),
                rng=torch.zeros((b, 2), dtype=torch.int64, device=dev),
                done=torch.zeros((b,), dtype=torch.bool, device=dev),
                out=torch.zeros((b, self.seq_len + 2), dtype=torch.int64,
                                device=dev))
        return self._buf.rows

    def _batch_sample_step(self, temperature: float, topp: float,
                           n_vocab: int, stops: tuple) -> None:
        """Graph ("bdsample", ...): one iteration of the JAX
        generate_batch_device while-loop (runtime/engine.py:2152-2175)
        behind a loop flag: the loop runs while fewer than `limit`
        iterations ran and some row is live. A row whose position reached
        S is done; each live row samples from its own logits and RNG
        stream, records its token at column `count` and is done at a stop
        token; then the forward of every row that goes on runs, the rest
        at position S. Once the loop has ended, a replay changes no
        recorded token, RNG state, position or cache slot."""
        b, r = self._buf, self._row_buffers()
        looping = (b.count < b.limit) & ~r.done.all()
        done = r.done | (b.pos >= self.seq_len)
        tok, states = sample_rows(r.logits[:, :n_vocab], r.rng, temperature,
                                  topp)
        record = ~done & looping
        r.out.index_copy_(1, b.count,
                          torch.where(record, tok, -1).view(-1, 1))
        r.rng.copy_(torch.where(record.view(-1, 1), states, r.rng))
        for s in stops:
            done = done | (record & (tok == s))
        feed = b.tok.view(-1)
        feed.copy_(torch.where(record, tok, feed))
        pos = torch.where(~done & looping, b.pos, self.seq_len)
        r.logits.copy_(self._forward(b.tok, pos))
        r.done.copy_(torch.where(looping, done, r.done))
        b.pos.add_(looping.to(torch.int32))
        b.count.add_(looping.to(torch.int64))

    @mirrored
    @torch.inference_mode()
    def generate_batch_device(
        self,
        prompts: list[list[int]],
        max_tokens: int,
        *,
        temperature: float,
        topp: float,
        seed: int,
        eos_id: int | set[int] | None = None,
        vocab_size: int | None = None,
    ) -> list[list[int]]:
        """Batched sampled generation with the decode loop on the device
        (JAX runtime/engine.py:2089): B sequences, row i on its own
        xorshift* stream seeded seed + i, so its tokens match a
        generate_device run of that prompt at seed + i. A row stops at its
        stop token (recorded) or when its cache fills; the loop ends when
        every row is done. On a CUDA engine each iteration is one replay
        of the graph ("bdsample", temperature, top-p, vocab, stops),
        captured once a sampler configuration (max_tokens is a buffer,
        not a key); the host reads the done flags once every
        _DONE_CHECK_EVERY replays. last_device_steps is the loop's
        iteration count. Over dp ranks each rank loops over its own rows
        (row i still on stream seed + i) until they are done, and the rows'
        tokens meet at the end: a finished row's extra iterations record
        nothing, so the longest rank's count is the loop's."""
        stop_ids = ({eos_id} if isinstance(eos_id, int) else eos_id) or set()
        n_vocab = min(vocab_size or self.spec.vocab_size, self.spec.vocab_size)
        lens = self._batch_args(prompts)
        logits = self._batch_prefill(prompts)
        if self.shard_vocab:         # the device sampler reads whole rows
            logits = all_gather(logits, self._mesh, self._vocab_axis) \
                .movedim(0, -2).flatten(-2)
        self.pos = int(lens.max())
        if max_tokens <= 0:      # the hard-cap contract of generate()
            self.last_device_steps = 0
            return [[] for _ in prompts]
        # past this many iterations every row has reached S: the JAX loop
        # ends there too
        limit = min(max_tokens, self.seq_len - int(lens.min()) + 1)
        stops = tuple(sorted(stop_ids))
        key = ("bdsample", float(temperature), float(topp), n_vocab, stops)
        b, r = self._buf, self._row_buffers()

        def step() -> None:
            self._batch_sample_step(float(temperature), float(topp), n_vocab,
                                    stops)

        def start(done: bool) -> None:
            r.logits.copy_(logits)
            r.rng.copy_(torch.stack([state_from_seed(seed + i, self.device)
                                     for i in range(self._row0,
                                                    self._row0 + self._rows)]))
            r.done.fill_(done)
            r.out.fill_(-1)
            b.tok.zero_()
            b.count.zero_()
            b.pos.copy_(torch.from_numpy(self._local_rows(lens)[0]))
            b.limit.fill_(limit)
        if self.cuda_graphs and key not in self.graphs:
            start(True)     # every row done: the warm-up writes nothing
            self._captured(key, step)
        start(False)
        run = self.graphs[key].replay if self.cuda_graphs else step
        every = _DONE_CHECK_EVERY if self.cuda_graphs else 1
        for i in range(limit):
            run()
            if (i + 1) % every == 0 and bool(r.done.all()):
                break
        if self._dp_split:
            n = int(all_reduce(b.count, self._mesh, DP_AXIS, op="max"))
        else:
            n = int(b.count)
        self.last_device_steps = n
        self.pos = int(min(int(lens.max()) + n, self.seq_len))
        # unrecorded slots hold -1: a row's tokens are its recorded ones
        return [[int(x) for x in row if x >= 0]
                for row in self._gather_rows(r.out[:, :limit]).cpu().tolist()]

    def generate_batch_lookup(
        self,
        prompts: list[list[int]],
        max_tokens: int,
        eos_id: int | set[int] | None = None,
        *,
        draft_len: int = 7,
        max_ngram: int = 3,
        vocab_size: int | None = None,
        histories: list[list[int]] | None = None,
        stop_flags: np.ndarray | None = None,
    ) -> list[list[int]]:
        """Batched prompt-lookup speculative decoding (JAX
        runtime/engine.py:1683): every row mines its own draft from its own
        history, the drafts right-pad to the widest live draft (padding
        feeds the row's current token again; its writes sit past the
        accepted prefix and are overwritten like any unconfirmed draft),
        and ONE verify forward of (B, 1 + k_max), the "slot_verify" graph
        of that width, confirms each row's accepted prefix plus one. Each
        row's stream is exactly its greedy stream. Greedy only. Returns one
        token list a row (stop token included); `last_accept_stats` holds
        (verify forwards, tokens) over the rows. `histories[i]` (default:
        prompts[i]) is row i's draft-mining context; rows flagged in
        `stop_flags` before the call never emit."""
        from .speculative import count_accepted, find_draft

        stop_ids = ({eos_id} if isinstance(eos_id, int) else eos_id) or set()
        spec_v = min(vocab_size or self.spec.vocab_size, self.spec.vocab_size)
        lens = self._batch_args(prompts)
        b = self.batch
        logits = self._batch_prefill(prompts)
        self.pos = int(lens.max())
        if max_tokens <= 0:      # the hard-cap contract of generate()
            self.last_accept_stats = (1, 0)
            return [[] for _ in range(b)]
        first = self._greedy_rows(logits, spec_v)
        out: list[list[int]] = [[] for _ in range(b)]
        done = (np.asarray(stop_flags, bool).copy() if stop_flags is not None
                else np.zeros(b, bool))
        cur = first.astype(np.int64)
        hists = [np.asarray((histories[i] if histories is not None
                             else prompts[i]) + [int(first[i])], np.int32)
                 for i in range(b)]
        for i in np.nonzero(~done)[0]:   # a pre-retired row never emits
            out[i].append(int(first[i]))
            done[i] = int(first[i]) in stop_ids
        pos = lens.copy()
        n_forwards = 1
        self.last_accept_stats = (n_forwards, sum(len(o) for o in out))

        def alive(i: int) -> bool:
            return (not done[i] and len(out[i]) < max_tokens
                    and pos[i] < self.seq_len)

        while any(alive(i) for i in range(b)):
            live = [alive(i) for i in range(b)]
            drafts: list[list[int]] = []
            for i in range(b):
                k = (min(draft_len, self.seq_len - pos[i] - 1,
                         max_tokens - len(out[i]) - 1) if live[i] else 0)
                drafts.append(find_draft(hists[i], k, max_ngram=max_ngram)
                              if k > 0 else [])
            k_max = max(len(d) for d in drafts)
            seg = np.repeat(cur[:, None], 1 + k_max, axis=1)
            for i, d in enumerate(drafts):
                seg[i, 1:1 + len(d)] = d
            greedy, _ = self.slot_verify_step(
                seg, np.where(live, pos, self.seq_len), spec_v)
            n_forwards += 1
            for i in np.nonzero(live)[0]:
                m = count_accepted(drafts[i], greedy[i])
                emitted = [int(g) for g in greedy[i][: m + 1]]
                for j, tk in enumerate(emitted):
                    if tk in stop_ids:
                        emitted = emitted[: j + 1]
                        done[i] = True
                        break
                emitted = emitted[: max_tokens - len(out[i])]
                pos[i] += len(emitted)       # 1 + accepted
                out[i].extend(emitted)
                cur[i] = emitted[-1]
                hists[i] = np.concatenate(
                    [hists[i], np.asarray(emitted, np.int32)])
            self.pos = int(np.minimum(pos, self.seq_len).max())
            self.last_accept_stats = (n_forwards, sum(len(o) for o in out))
        return out

    # -- continuous-batching slot steps (runtime/scheduler.py) -------------

    def _slot_args(self, name: str, tokens: np.ndarray, pos: np.ndarray):
        tokens, pos = np.asarray(tokens), np.asarray(pos)
        if tokens.ndim != 2 or tokens.shape[0] != self.batch \
                or pos.shape != (self.batch,):
            raise ValueError(f"{name}: tokens {tokens.shape} and positions "
                             f"{pos.shape} for an engine of {self.batch} slots")
        return tokens.astype(np.int64), pos.astype(np.int32)

    def _local_rows(self, *arrays):
        """This rank's rows of batch-wide host arrays."""
        rows = slice(self._row0, self._row0 + self._rows)
        return tuple(a[rows] for a in arrays)

    @torch.inference_mode()
    def slot_prefill_chunk(self, tokens: np.ndarray, pos: np.ndarray,
                           logit_index: np.ndarray) -> torch.Tensor:
        """One chunked-prefill forward over the slots (JAX
        runtime/engine.py:1449): row r writes its (B, C) chunk's K/V at
        positions pos[r]..pos[r]+C-1 without touching any other row. A row
        not prefilling passes pos[r] == S: its writes land in the spare
        row, so its cache, mid-decode or idle, is untouched. Returns the
        (B, vocab) f32 logits at each row's `logit_index` within the chunk,
        on the device. Runs eagerly; does not touch self.pos."""
        # host side, before any launch, and before the op is sent: a
        # fault here leaves every rank in step
        FAULTS.fire("prefill_raise")
        return self._prefill_chunk(tokens, pos, logit_index)

    @mirrored
    def _prefill_chunk(self, tokens: np.ndarray, pos: np.ndarray,
                       logit_index: np.ndarray) -> torch.Tensor:
        """slot_prefill_chunk's forward over this rank's rows (its vocab
        slice of the logits on a vocab-sharded engine). The profiler's
        entry times the forward alone, its arguments built before it."""
        tokens, pos = self._slot_args("slot_prefill_chunk", tokens, pos)
        tokens, pos, lidx = self._local_rows(
            tokens, pos, np.asarray(logit_index, np.int64))
        dev = self.device
        return PROFILER.timed(
            f"slot_prefill:{tokens.shape[1]}",
            functools.partial(self._forward, local_logits=True),
            torch.as_tensor(tokens, device=dev), torch.as_tensor(pos, device=dev),
            torch.as_tensor(lidx, device=dev))

    # -- prefix-cache arena (runtime/prefix_cache.py) ----------------------

    @mirrored
    def new_prefix_arena(self, num_blocks: int, block_len: int):
        """The radix prefix cache's block arena: zeroed K and V tensors of
        (num_blocks, layers, kv_heads, block_len, head_size) in the cache
        dtype, over this rank's kv heads on a mesh (the cache's: KVH/tp,
        the replicated virtual heads counted; over sp every head, as the
        JAX engine refuses only pp). The arena dies with the
        engine: a supervisor rebuild mints a fresh engine, arena and tree.
        The radix tree stays on rank 0; block ids come from it."""
        self._refuse_pp("prefix cache")
        if num_blocks < 1 or not 1 <= block_len <= self.seq_len:
            raise ValueError(f"prefix arena of {num_blocks} blocks of "
                             f"{block_len} (context {self.seq_len})")
        shape = (num_blocks, self.spec.n_layers, self.cache.k[0].shape[1],
                 block_len, self.spec.head_size)
        return (torch.zeros(shape, dtype=self.cache_dtype, device=self.device),
                torch.zeros(shape, dtype=self.cache_dtype, device=self.device))

    @mirrored
    @torch.inference_mode()
    def slot_seed_prefix(self, arena_k, arena_v, row: int, block_ids) -> None:
        """Seed slot row `row`'s leading cache positions from arena blocks,
        in place (seed_rows_from_blocks): one gather and one copy a layer
        for K and for V, eagerly, on the default stream between the
        scheduler's replays. Does not touch self.pos."""
        PROFILER.timed("prefix_seed", seed_rows_from_blocks, self.cache,
                       arena_k, arena_v, row, block_ids)

    @mirrored
    @torch.inference_mode()
    def slot_publish_block(self, arena_k, arena_v, row: int, offset: int,
                           dst: list[int]) -> None:
        """Copy slot row `row`'s cache positions from `offset` into the
        arena blocks `dst`, in place, block_len positions a block (a
        publish's new blocks cover consecutive positions). One indexed copy
        a layer for K and for V, whatever the number of blocks. The bytes
        came from this engine's own saturating writes, so no guard runs
        here (the seed side owns it, as `saturate_f8_nan_codes` in
        seed_rows_from_blocks and load_session)."""
        PROFILER.timed("prefix_publish", self._publish, arena_k, arena_v,
                       row, offset, dst)

    def _publish(self, arena_k, arena_v, row: int, offset: int,
                 dst: list[int]) -> None:
        ids = torch.as_tensor(np.asarray(dst, np.int64),
                              device=arena_k.device)
        _, _, kvh, bl, hs = arena_k.shape
        mb = int(ids.numel())
        for l in range(self.spec.n_layers):
            for arena, leaf in ((arena_k, self.cache.k[l]),
                                (arena_v, self.cache.v[l])):
                src = _bits(leaf[row, :, offset:offset + mb * bl])
                _bits(arena[:, l]).index_copy_(
                    0, ids, src.view(kvh, mb, bl, hs).transpose(0, 1))

    # -- cross-replica KV block transfer (runtime/kv_transfer.py) ---------

    def _check_transfer(self) -> None:
        if self._mesh is not None:
            # the JAX server runs replicas (and so transfers) on
            # single-process engines only
            raise ValueError("KV block transfer needs a single-rank engine")
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a KV block copy cannot run inside a graph "
                               "capture")

    @torch.inference_mode()
    def block_export(self, arena_k, arena_v, src: int):
        """Arena block `src` as a host (K, V) pair, each (layers, kv_heads,
        block_len, head_size) in the cache dtype: the bytes a donor ships.
        On the card the device-to-host copies land in pinned buffers and
        the stream is synchronized before returning, so the caller reads
        finished bytes."""
        self._check_transfer()
        out = []
        with DEVICE_GATE.shared():
            for arena in (arena_k, arena_v):
                blk = arena[int(src)]
                host = torch.empty(blk.shape, dtype=blk.dtype,
                                   pin_memory=blk.is_cuda)
                host.copy_(blk, non_blocking=blk.is_cuda)
                out.append(host)
            if arena_k.is_cuda:
                torch.cuda.current_stream(arena_k.device).synchronize()
        return out[0], out[1]

    @torch.inference_mode()
    def slot_import_block(self, arena_k, arena_v, k_blk, v_blk,
                          dst: int) -> None:
        """Write one fetched host block pair into arena block `dst`, in
        place (the arenas are never rebound: captured graphs hold cache
        addresses, and a seed reads the arena by index). The bytes land
        raw; the seed side's e4m3 NaN-code guard owns trust
        (seed_rows_from_blocks)."""
        self._check_transfer()
        blocks = [torch.as_tensor(b) for b in (k_blk, v_blk)]
        for arena, blk in zip((arena_k, arena_v), blocks):
            if blk.dtype != arena.dtype or tuple(blk.shape) != tuple(
                    arena.shape[1:]):
                raise ValueError(f"block {tuple(blk.shape)}/{blk.dtype} "
                                 f"does not fit the arena's "
                                 f"{tuple(arena.shape[1:])}/{arena.dtype}")
        with DEVICE_GATE.shared():
            for arena, blk in zip((arena_k, arena_v), blocks):
                arena[int(dst)].copy_(blk)

    def _slot_decode(self) -> torch.Tensor:
        """Graph "slot_decode": row r's token in `tok` at its position in
        `pos`."""
        return self._forward(self._buf.tok, self._buf.pos, local_logits=True)

    @torch.inference_mode()
    def slot_decode_step(self, tokens: np.ndarray,
                         pos: np.ndarray) -> torch.Tensor:
        """One decode step of the slots (JAX runtime/engine.py:1495): row r
        feeds tokens[r, 0] at its own position pos[r]; a row without a
        token passes pos[r] == S (its write is dropped, its logits mean
        nothing). Returns (B, vocab) f32 logits on the device, a tensor of
        its own. On a CUDA engine the host copies the tokens and positions
        into the static buffers and replays the captured graph
        "slot_decode" (captured at the first call, the scheduler's
        warmup). Does not touch self.pos."""
        return self._slot_step(tokens, pos)

    @mirrored
    @torch.inference_mode()
    def _slot_step(self, tokens: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """slot_decode_step over this rank's rows (its vocab slice of the
        logits on a vocab-sharded engine)."""
        tokens, pos = self._slot_args("slot_decode_step", tokens, pos)
        tokens, pos = self._local_rows(tokens, pos)
        if tokens.shape[1] != 1:
            raise ValueError(f"slot_decode_step feeds one token a row, got "
                             f"{tokens.shape}")
        b = self._buf
        b.tok.copy_(torch.from_numpy(tokens))
        b.pos.copy_(torch.from_numpy(pos))
        if not self.cuda_graphs:
            return self._slot_decode()
        graph = self._captured("slot_decode", self._slot_decode)
        graph.replay()
        return graph.out.clone()

    @mirrored
    @torch.inference_mode()
    def slot_verify_step(self, tokens: np.ndarray, pos: np.ndarray,
                         n_vocab: int) -> tuple[np.ndarray, torch.Tensor]:
        """One fixed-width speculative verify step of the slots (JAX
        runtime/engine.py:1524): row r feeds its (1 + K) segment [last
        token, draft...] at positions pos[r]..pos[r]+K (rows without a
        draft pad with their own token; a gated row passes pos[r] == S).
        Returns (greedy (B, 1 + K) int32 on the host: the argmax over the
        first n_vocab logits after each segment position, computed on the
        device; the position-0 logits (B, vocab) f32, a device tensor of
        its own: what slot_decode_step would have returned, for the rows
        that sample). On a CUDA engine one captured graph
        ("slot_verify", 1 + K, n_vocab) over static (B, 1 + K) token and
        (B,) position buffers. Does not touch self.pos.

        Over ranks each rank runs its rows with its kv heads: the greedy
        tokens are the sharded argmax of the vocab-split logits (one
        (B·(1+K),) gather over tp) and every row's tokens meet over dp;
        the position-0 logits stay this rank's rows and, vocab-sharded,
        its vocab slice, as slot_decode_step's do (sample_view reads
        them)."""
        from .draft import batched_verify

        tokens, pos = self._slot_args("slot_verify_step", tokens, pos)
        tokens, pos = self._local_rows(tokens, pos)
        t, nv = tokens.shape[1], int(n_vocab)
        kw = self._fwd_kwargs(local_logits=True)
        if not self.cuda_graphs:
            dev = self.device
            greedy, logits0 = batched_verify(
                self.params, self.spec, torch.as_tensor(tokens, device=dev),
                torch.as_tensor(pos, device=dev), self.cache, n_vocab=nv,
                fwd_kwargs=kw)
            return self._gather_rows(greedy).cpu().numpy(), logits0
        buf, b = self._seg_buffer(t), self._buf
        buf.copy_(torch.from_numpy(tokens))
        b.pos.copy_(torch.from_numpy(pos))
        graph = self._captured(("slot_verify", t, nv), lambda: batched_verify(
            self.params, self.spec, buf, b.pos, self.cache, n_vocab=nv,
            fwd_kwargs=kw))
        graph.replay()
        greedy, logits0 = graph.out
        return self._gather_rows(greedy).cpu().numpy(), logits0.clone()
