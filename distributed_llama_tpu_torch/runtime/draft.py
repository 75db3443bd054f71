"""Real-draft speculative decoding — the port of the JAX package's
runtime/draft.py: a draft forward with its own small KV cache, verified by
the target engine's verify step (runtime/engine.py `_lookup_loop`,
`slot_verify_step`).

  * Self-draft: the target's first ``d`` layers plus the shared embedding,
    final norm and logits head. ``params["layers"]`` is a list slice of the
    target's: the same tensors, no copy, no extra device memory but the
    draft's d-layer cache.
  * Model draft: a separate ``.m`` (``--draft model:PATH``) over the same
    machinery, its depth its full layer count. Its vocab must equal the
    target's (draft tokens are target token ids).

Greedy emission is always the target's argmax over the verify logits, so a
draft only decides how many positions one verify forward confirms; sampled
emission goes through ``speculative.accept_or_resample_q``. A stale draft
cache can lower the accept rate, never change a token.

The JAX draft passes its cache around as a value. Here each DraftModel
owns one cache of the target engine's (batch, seq_len) shape, allocated
once: the draft's captured CUDA graphs hold its address, so ``new_cache``
zeroes it in place and hands back the same tensors, and every method
refuses a cache that is not its own. The scheduler's draft (over its
batch-B engine) keeps the B rows of every slot; a batch-1 stream's draft
keeps one.

Steps, on a CUDA engine:
  * ``propose``: one captured draft step whose argmax over the first
    n_vocab logits is written to ``out[:, count]`` and fed back as the
    next token at the next position, replayed k times back to back, with
    one host read of the k tokens at the end (the JAX ``lax.scan`` of k
    greedy steps, as one dispatch);
  * ``step_logits``: one captured (B, 1) draft step, its logits copied to
    the host (the sampled draft loop, host-paced by design);
  * ``prefill_chunk``: an eager (B, C) chunk, as the engine's prefill
    chunks are; it stops before the final norm and logits head.
Graphs live in ``self.graphs`` and are recorded in the COMPILES ledger
against the target engine (so a capture after the scheduler's warmup
counts as one); ``Engine.release`` releases every draft built over it. On
the CPU, or with ``cuda_graphs=False``, every step runs eagerly.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..models.transformer import KVCache, forward
from ..ops.sharded_vocab import sharded_argmax
from ..parallel.control import mirrored
from .graphs import CapturedStep, capture
from .profiler import COMPILES, PROFILER, compile_key_str


def parse_draft_spec(s: str) -> tuple[str, str]:
    """``--draft`` argument -> ("self", depth-string) | ("model", path).
    Raises ValueError with a CLI-ready message on anything else."""
    kind, _, arg = str(s).partition(":")
    if kind == "self":
        if not arg.isdigit() or int(arg) < 1:
            raise ValueError(
                f"--draft self:<depth> needs a positive layer count, got "
                f"{s!r}")
        return "self", arg
    if kind == "model":
        if not arg:
            raise ValueError("--draft model:<path> needs a .m path")
        return "model", arg
    raise ValueError(
        f"--draft {s!r} is not 'self:<depth>' or 'model:<path>'")


# -- the bodies (JAX runtime/draft.py:88-138) ---------------------------------


def draft_scan_step(params, spec, buf, cache, out, *, n_vocab, fwd_kwargs):
    """One greedy draft step over static buffers, the body of the JAX
    ``draft_scan_tokens`` scan: feed ``buf.tok`` at ``buf.pos``, record the
    argmax over the first n_vocab logits at column ``buf.count`` of `out`
    (B, k), feed it back at the next position. Gated rows (pos == S) write
    to the cache's spare row; their tokens mean nothing."""
    logits = forward(params, spec, buf.tok, buf.pos, cache, **fwd_kwargs)
    nxt = torch.argmax(logits[:, :n_vocab], dim=-1)                 # (B,)
    out.index_copy_(1, buf.count, nxt.view(-1, 1))
    buf.tok.copy_(nxt.view(-1, 1))
    buf.pos.add_(1)
    buf.count.add_(1)


def draft_prefill_cache(params, spec, tok, pos, cache, *, fwd_kwargs) -> None:
    """One (B, C) draft prefill chunk at per-row offsets into the draft
    cache, without the final norm and logits head. Gated rows and tail
    padding follow slot_prefill_chunk: pad writes land beyond the row's
    frontier and are overwritten before the draft attends them."""
    forward(params, spec, tok, pos, cache, logits=False, **fwd_kwargs)


def batched_verify(params, spec, tok, pos, cache, *, n_vocab, fwd_kwargs):
    """The scheduler's fixed-width verify forward: (B, 1 + K) tokens at
    per-row positions with every position's logits, argmaxed on the device
    over the first n_vocab. Returns (greedy (B, 1 + K) int32, the
    position-0 logits (B, V) f32: what a plain decode step would have
    returned, for the rows that sample). With `local_logits` (a
    vocab-sharded engine over ranks) the logits stay each rank's vocab
    slice and the greedy tokens are their sharded argmax, the lowest id
    among equal maxima as np.argmax picks."""
    logits = forward(params, spec, tok, pos, cache, logits_for_all=True,
                     **fwd_kwargs)
    if fwd_kwargs.get("local_logits"):
        b, t = logits.shape[:2]
        greedy = sharded_argmax(logits.flatten(0, 1), fwd_kwargs["mesh"],
                                n_vocab, fwd_kwargs["vocab_axis"]
                                ).view(b, t).to(torch.int32)
    else:
        greedy = torch.argmax(logits[..., :n_vocab], dim=-1).to(torch.int32)
    return greedy, logits[:, 0]


# -- the draft model ----------------------------------------------------------


def _check_vocab(spec, engine) -> None:
    if spec.vocab_size != engine.spec.vocab_size:
        raise ValueError(
            f"draft vocab {spec.vocab_size} != target vocab "
            f"{engine.spec.vocab_size} — draft and target must share "
            "the tokenizer (draft proposals are target token ids)")


class DraftModel:
    """One draft forward (spec, params and its own KV cache) bound to a
    target :class:`runtime.engine.Engine`, whose batch, context, cache
    dtype and forward configuration it takes. Over a tp mesh a self-draft
    runs on the target's shards with the target's reduce and vocab split,
    and its cache holds this rank's kv heads; its steps are ops of the
    target's control channel (parallel/control.py)."""

    _ctl_id = None
    _mirrorable = True

    def __init__(self, engine, spec, params, *, label: str):
        _check_vocab(spec, engine)
        mesh = getattr(engine, "_mesh", None)
        if mesh is not None and mesh.dp > 1:
            # JAX apps/dllama.py:1321-1324
            raise ValueError("--draft is single-sequence outside api mode "
                             "and per-slot inside it; it does not compose "
                             "with --dp")
        if mesh is not None and mesh.pp > 1:
            # JAX apps/dllama.py:1318-1320
            raise ValueError("--draft does not compose with --pp "
                             "(stage-stacked layers cannot be depth-sliced)")
        self.engine = engine
        self.spec = spec
        self.params = params
        self.label = label
        dev, b = engine.device, engine.batch
        self.cache = engine.rank_cache(spec)
        self._buf = types.SimpleNamespace(
            tok=torch.zeros((b, 1), dtype=torch.int64, device=dev),
            pos=torch.zeros((b,), dtype=torch.int32, device=dev),
            count=torch.zeros((1,), dtype=torch.int64, device=dev))
        self._out: dict[int, torch.Tensor] = {}   # k -> (B, k) proposals
        self.graphs: dict[object, CapturedStep] = {}
        engine._drafts.append(self)

    # -- constructors ------------------------------------------------------

    @classmethod
    def self_draft(cls, engine, depth: int) -> "DraftModel":
        """The target's first ``depth`` layers and its shared embedding,
        final norm and logits head: the same tensors, no copy."""
        depth = int(depth)
        if not 1 <= depth < engine.spec.n_layers:
            raise ValueError(
                f"--draft self:{depth}: depth must be in "
                f"1..{engine.spec.n_layers - 1} (the target has "
                f"{engine.spec.n_layers} layers; a full-depth 'draft' "
                "would just run the model twice)")
        spec = dataclasses.replace(engine.spec, n_layers=depth)
        params = dict(engine.params)
        params["layers"] = list(engine.params["layers"][:depth])
        return cls(engine, spec, params, label=f"self{depth}")

    @classmethod
    def from_file(cls, engine, path: str) -> "DraftModel":
        """A separate draft ``.m`` loaded through the port's loader onto
        the engine's device, in the engine's compute dtype; depth = its
        full layer count. Loaded unsharded, so it needs a mesh-less target
        (JAX runtime/draft.py:192-199)."""
        if getattr(engine, "mesh", None) is not None:
            raise ValueError(
                "--draft model:PATH needs a mesh-less target engine "
                "(use --draft self:<depth>, which shares the target's "
                "sharded buffers)")
        from ..io.model_file import read_spec
        from ..models.loader import load_params_streamed

        spec = read_spec(path)
        _check_vocab(spec, engine)   # before the weights load
        params, _ = load_params_streamed(spec, path, engine.device,
                                         dtype=engine.compute_dtype)
        return cls(engine, spec, params, label="model")

    # -- state -------------------------------------------------------------

    @property
    def control(self):
        """The target engine's control channel: a draft's steps are its
        ops."""
        return self.engine.control

    def _kwargs(self) -> dict:
        # the target's forward configuration, whole logits (the argmax and
        # the host draws read every id)
        return self.engine._fwd_kwargs()

    def _own(self, cache) -> None:
        if cache is not self.cache:
            raise ValueError("a DraftModel steps its own cache only (its "
                             "graphs hold that cache's addresses)")

    @mirrored
    def new_cache(self) -> KVCache:
        """The draft cache, zeroed in place: depth layers of the TARGET's
        (batch, seq_len) in the target's cache dtype. Always the same
        tensors."""
        for buf in (*self.cache.k, *self.cache.v):
            buf.zero_()
        return self.cache

    @mirrored
    def release(self) -> None:
        """Give the draft cache and its graphs' pools back (the failed
        engine's drafts, before a supervisor rebuild allocates)."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()
        self.cache = None
        self._buf = None
        self._out.clear()

    def _captured(self, key, fn) -> CapturedStep:
        if key not in self.graphs:
            COMPILES.pre_compile(self.engine, key)
            self.graphs[key] = capture(fn)._replace(name=compile_key_str(key))
            COMPILES.record(self.engine, key, self.graphs[key].capture_s * 1e3)
        return self.graphs[key]

    def _load(self, tok: np.ndarray, pos: np.ndarray) -> None:
        b = self._buf
        b.tok.copy_(torch.from_numpy(
            np.asarray(tok, np.int64).reshape(b.tok.shape)))
        b.pos.copy_(torch.from_numpy(np.asarray(pos, np.int32).reshape(-1)))

    # -- steps -------------------------------------------------------------

    @mirrored
    @torch.inference_mode()
    def prefill_chunk(self, cache: KVCache, tok: np.ndarray,
                      pos: np.ndarray) -> KVCache:
        """One (B, C) draft prefill / catch-up chunk, eagerly (gated rows
        pass pos == seq_len)."""
        self._own(cache)
        dev = self.engine.device
        tok = torch.as_tensor(np.asarray(tok, np.int64), device=dev)
        PROFILER.timed(
            f"draft_prefill:{tok.shape[1]}", lambda: draft_prefill_cache(
                self.params, self.spec, tok,
                torch.as_tensor(np.asarray(pos, np.int32), device=dev),
                self.cache, fwd_kwargs=self._kwargs()))
        return self.cache

    @mirrored
    @torch.inference_mode()
    def propose(self, cache: KVCache, tok: np.ndarray, pos: np.ndarray,
                k: int, *, n_vocab: int) -> tuple[np.ndarray, KVCache]:
        """Greedy draft proposal of k tokens a row: tok (B,) is each row's
        last emitted token, fed at pos (B,), the target's next write
        position. On the card one captured step replayed k times and one
        host read. Returns ((B, k) int32 tokens, the cache)."""
        self._own(cache)
        k, n_vocab = int(k), int(n_vocab)
        if k not in self._out:
            self._out[k] = torch.zeros((self.engine.batch, k),
                                       dtype=torch.int64,
                                       device=self.engine.device)
        out, b = self._out[k], self._buf

        def start() -> None:
            self._load(tok, pos)
            b.count.zero_()

        def step() -> None:
            draft_scan_step(self.params, self.spec, b, self.cache, out,
                            n_vocab=n_vocab, fwd_kwargs=self._kwargs())
        key = ("sdraft_scan", self.label, k, n_vocab)
        if self.engine.cuda_graphs and key not in self.graphs:
            start()
            self._captured(key, step)
        start()
        run = self.graphs[key].replay if self.engine.cuda_graphs else step
        for _ in range(k):
            run()
        return out.cpu().numpy().astype(np.int32), self.cache

    @mirrored
    @torch.inference_mode()
    def step_logits(self, cache: KVCache, tok: np.ndarray,
                    pos: np.ndarray) -> tuple[np.ndarray, KVCache]:
        """One (B, 1) draft forward returning its (B, V) logits on the
        host: the sampled draft loop's step (its next input is drawn on
        the host from these logits). One graph on the card."""
        self._own(cache)
        b = self._buf
        self._load(tok, pos)

        def step() -> torch.Tensor:
            return forward(self.params, self.spec, b.tok, b.pos, self.cache,
                           **self._kwargs())
        if not self.engine.cuda_graphs:
            return step().cpu().numpy(), self.cache
        g = self._captured(("sdraft_step", self.label), step)
        g.replay()
        return g.out.cpu().numpy(), self.cache


def build_draft(engine, spec_str: str) -> DraftModel:
    """``--draft`` string -> DraftModel over ``engine`` (the factory a
    supervisor calls for every generation: a rebuilt engine gets a fresh
    DraftModel over its own tensors). Built through Engine.new_draft, so a
    mirrored engine builds it on every rank."""
    return engine.new_draft(spec_str)


def make_draft(engine, spec_str: str) -> DraftModel:
    """The body of build_draft on one rank."""
    kind, arg = parse_draft_spec(spec_str)
    if kind == "self":
        return DraftModel.self_draft(engine, int(arg))
    return DraftModel.from_file(engine, arg)
