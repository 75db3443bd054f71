"""Inference engine on one device — counterpart of the JAX package's
runtime/engine.py (Engine.__init__ for one device, reset, step, prefill,
generate, fetch_logits).

The prompt is prefilled in chunks of `prefill_chunk` (256 by default, the Q40
kernel's MAX_T: the fewest whole-weight passes that still take the kernel);
decode then runs one token per step through the host sampler with the
reference's xorshift stream. The KV cache is preallocated once and written
in place. The forward runs eagerly under torch.inference_mode; capturing the
decode step as a CUDA graph is later work.

The engine runs on `cuda` unless the caller asks for the CPU: with no card
present, `Engine(...)` raises instead of running elsewhere.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.params import fuse_layer_weights
from ..models.spec import ModelSpec
from ..models.transformer import KVCache, forward
from ..sampler import Sampler
from ..utils.device import resolve_device
from .stats import RunStats, StepStats

# the fp8 (e4m3) cache stores 1 byte per value; writes saturate at +-448
# and K3 upcasts it in registers (ops/cuda_attention.py)
CACHE_DTYPES = (torch.bfloat16, torch.float32, torch.float8_e4m3fn)

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
    ):
        self.device = resolve_device(device)
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
        # one sequence: batched serving comes with the serving slice
        self.cache = KVCache.create(spec, 1, self.seq_len, cache_dtype,
                                    self.device)
        self.pos = 0

    def reset(self) -> None:
        """New session: zero the cache and rewind the position."""
        for buf in (*self.cache.k, *self.cache.v):
            buf.zero_()
        self.pos = 0

    @torch.inference_mode()
    def step(self, tokens: np.ndarray, pos0: int) -> torch.Tensor:
        """Run a (1, T) segment from absolute position pos0; returns the
        last token's logits (1, vocab) f32 on the device. Advances pos."""
        b, t = tokens.shape
        if b != 1:
            raise ValueError(f"the engine runs one sequence, got batch {b}")
        if pos0 + t > self.seq_len:
            raise ValueError("context overflow")
        tok = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        logits = forward(self.params, self.spec, tok, pos0, self.cache,
                         compute_dtype=self.compute_dtype,
                         activation_q80=self.activation_q80)
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
