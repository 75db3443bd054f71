"""Inference engine on one device — counterpart of the JAX package's
runtime/engine.py (Engine.__init__ for one device, reset, step, prefill,
generate, fetch_logits, decode_greedy_device, generate_device, and the
continuous-batching slot steps slot_prefill_chunk and slot_decode_step).

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

The engine runs on `cuda` unless the caller asks for the CPU: with no card
present, `Engine(...)` raises instead of running elsewhere.
"""

from __future__ import annotations

import time
import types
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.params import fuse_layer_weights
from ..models.spec import ModelSpec
from ..models.transformer import KVCache, forward
from ..ops.device_sampler import sample_token, state_from_seed
from ..sampler import Sampler
from ..utils.device import resolve_device
from .faults import FAULTS
from .graphs import CapturedStep, capture
from .profiler import COMPILES
from .stats import RunStats, StepStats

# the fp8 (e4m3) cache stores 1 byte per value; writes saturate at +-448
# and K3 upcasts it in registers (ops/cuda_attention.py)
CACHE_DTYPES = (torch.bfloat16, torch.float32, torch.float8_e4m3fn)
# generate_device's host reads the loop's done flag once every this many
# replays: at most this many - 1 forwards run after the stop token
_DONE_CHECK_EVERY = 8

__all__ = ["CACHE_DTYPES", "Engine", "GenerationResult", "resolve_device"]


class GenerationResult(NamedTuple):
    tokens: list[int]
    stats: RunStats


class Engine:
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
    ):
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
        self.spec = spec
        self.seq_len = min(max_seq_len or spec.seq_len, spec.seq_len)
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype
        self.prefill_chunk = prefill_chunk
        # the reference's Q80 activation buffers: every matmul input through
        # the Q80 round trip (JAX runtime/engine.py:125; the CLI's default
        # for Q40 models)
        self.activation_q80 = activation_q80
        # single-device fast path: fused QKV / w1|w3 launches (in place)
        self.params = fuse_layer_weights(params)
        # B slots (rows) of the scheduler, or the one sequence of step()
        self.batch = int(batch)
        self.cache = KVCache.create(spec, self.batch, self.seq_len,
                                    cache_dtype, self.device)
        self.pos = 0
        # the captured steps, keyed like the JAX engine's _steps: 1 (the
        # decode step), ("greedy",), ("dsample", temperature, topp, vocab,
        # stop ids), "slot_decode"; empty on the CPU or with
        # cuda_graphs=False. Every capture is recorded in COMPILES; once
        # the scheduler's warmup marks the engine warm, a new key is a
        # capture after warmup (runtime/profiler.py)
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self.graphs: dict[object, CapturedStep] = {}
        self._compile_warm = False
        # device while-loop iterations of the last generate_device call
        # (== its sampled tokens; forwards run == that - 1)
        self.last_device_steps = 0
        # the steps' static buffers: a graph reads and writes these at
        # replay, so they never move
        dev, i64 = self.device, torch.int64
        self._buf = types.SimpleNamespace(
            tok=torch.zeros((self.batch, 1), dtype=i64, device=dev),
            pos=torch.zeros((self.batch,), dtype=torch.int32, device=dev),
            count=torch.zeros((1,), dtype=i64, device=dev),
            out=torch.zeros((self.seq_len + 2,), dtype=i64, device=dev),
            done=torch.zeros((1,), dtype=torch.bool, device=dev),
            limit=torch.zeros((1,), dtype=i64, device=dev),
            rng=torch.zeros((2,), dtype=i64, device=dev),
            logits=torch.zeros((1, spec.vocab_size), dtype=torch.float32,
                               device=dev))

    def reset(self) -> None:
        """New session: zero the cache (in place) and rewind the position."""
        self._zero_cache()
        self.pos = 0

    def _zero_cache(self) -> None:
        for buf in (*self.cache.k, *self.cache.v):
            buf.zero_()

    # -- steps: the forward over the engine's configuration ---------------

    def _forward(self, tokens: torch.Tensor, pos0,
                 logit_index=None) -> torch.Tensor:
        """The engine's forward, configured in exactly one place."""
        return forward(self.params, self.spec, tokens, pos0, self.cache,
                       compute_dtype=self.compute_dtype,
                       activation_q80=self.activation_q80,
                       logit_index=logit_index)

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
            self.graphs[key] = capture(fn)
            COMPILES.record(key, self.graphs[key].capture_s * 1e3)
        return self.graphs[key]

    def mark_compile_warm(self) -> None:
        """The serving set is captured (Scheduler.warmup): from here a new
        graph key is a capture after warmup."""
        self._compile_warm = True

    def release(self) -> None:
        """Give the cache and the captured graphs' pools back to the
        allocator: a supervisor rebuild calls this on the failed engine
        before its factory allocates the next one, so memory does not
        double on every recovery. The engine is unusable afterwards."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()
        self.cache = None
        self._buf = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

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
        """Bring step() logits to the host (the copy waits for the card)."""
        return logits.float().cpu().numpy()

    def prefill(self, prompt: list[int]) -> torch.Tensor:
        """Feed the prompt in fixed-size chunks; returns the last logits."""
        logits = None
        i, n = 0, len(prompt)
        while i < n:
            chunk = min(self.prefill_chunk, n - i)
            seg = np.asarray(prompt[i:i + chunk], np.int32)[None, :]
            logits = self.step(seg, self.pos)
            i += chunk
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

    # -- on-device loops: one captured step, replayed back to back ---------

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

    # -- continuous-batching slot steps (runtime/scheduler.py) -------------

    def _slot_args(self, name: str, tokens: np.ndarray, pos: np.ndarray):
        tokens, pos = np.asarray(tokens), np.asarray(pos)
        if tokens.ndim != 2 or tokens.shape[0] != self.batch \
                or pos.shape != (self.batch,):
            raise ValueError(f"{name}: tokens {tokens.shape} and positions "
                             f"{pos.shape} for an engine of {self.batch} slots")
        return tokens.astype(np.int64), pos.astype(np.int32)

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
        FAULTS.fire("prefill_raise")   # host side, before any launch
        tokens, pos = self._slot_args("slot_prefill_chunk", tokens, pos)
        dev = self.device
        return self._forward(
            torch.as_tensor(tokens, device=dev), torch.as_tensor(pos, device=dev),
            torch.as_tensor(np.asarray(logit_index, np.int64), device=dev))

    def _slot_decode(self) -> torch.Tensor:
        """Graph "slot_decode": row r's token in `tok` at its position in
        `pos`."""
        return self._forward(self._buf.tok, self._buf.pos)

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
        tokens, pos = self._slot_args("slot_decode_step", tokens, pos)
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
