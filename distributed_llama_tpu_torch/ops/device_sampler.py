"""On-device token sampling — counterpart of the JAX package's
ops/device_sampler.py: temperature, multinomial and top-p on the device,
so a sampled decode loop needs no host round trip per token
(runtime/engine.py Engine.generate_device replays it inside a CUDA graph).

The RNG is the reference's 64-bit xorshift* (ref: src/utils.cpp:53-64) on
two 32-bit limbs [hi, lo], bit-exact with utils/rng.py for any seed.
torch's uint32 lacks most bitwise operators, so each limb is an int64
holding a value in [0, 2^32), masked after every step that could leave
that range; every product is split into 16-bit limbs so that none leaves
int64 either.

Sampling follows sampler.Sampler step for step, as the JAX sampler does:
its one deviation is the CDF, summed in f32 on the device against the
host's float64, which can pick a neighbouring token only when the coin
lands within f32 rounding of a CDF boundary. JAX takes an exact top-512
window when the nucleus lies inside it and the full stable sort
otherwise, and its tokens are identical either way; a captured graph
cannot branch on data, so this port always runs the full sort.

`sample_rows` samples B rows at once, each on its own RNG state (the JAX
package's `jax.vmap(sample_token)`): every op runs once over the (B,
vocab) logits, so a batched loop's graph launches the sampler's kernels
once, not B times. `sample_token` is its one-row case.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_MULT_HI, _MULT_LO = 0x2545F491, 0x4F6CDD1D   # 0x2545F4914F6CDD1D


def state_from_seed(seed: int, device=None) -> torch.Tensor:
    """(2,) int64 [hi, lo] RNG state from a 64-bit seed."""
    seed &= (1 << 64) - 1
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def _mullo(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for a in [0, 2^32) and a constant b."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    return (a0 * b0 + (((a0 * b1 + a1 * b0) & _M16) << 16)) & _M32


def _mulhi(a: torch.Tensor, b: int) -> torch.Tensor:
    """High 32 bits of a 32x32 multiply, via 16-bit limbs (JAX _mulhi_u32)."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & _M16) + (p10 & _M16)
    return (p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & _M32


def xorshift_step(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One xorshift* step on a (..., 2) [hi, lo] state; returns (state',
    u32 sample as int64) — bit-identical to utils/rng.xorshift_u32."""
    hi, lo = state[..., 0], state[..., 1]
    hi, lo = hi ^ (hi >> 12), lo ^ ((lo >> 12) | ((hi << 20) & _M32))
    hi, lo = hi ^ (((hi << 25) & _M32) | (lo >> 7)), lo ^ ((lo << 25) & _M32)
    hi, lo = hi ^ (hi >> 27), lo ^ ((lo >> 27) | ((hi << 5) & _M32))
    # sample = bits 32..63 of state * 0x2545F4914F6CDD1D (mod 2^64)
    sample = (_mulhi(lo, _MULT_LO) + _mullo(lo, _MULT_HI)
              + _mullo(hi, _MULT_LO)) & _M32
    return torch.stack([hi, lo], dim=-1), sample


def coin_f32(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Random f32 in [0, 1) (ref: src/utils.cpp:61-64)."""
    state, u = xorshift_step(state)
    return state, (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def sample_token(logits: torch.Tensor, state: torch.Tensor,
                 temperature: float, topp: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one token id from (vocab,) logits; returns (token as a 0-dim
    int64 tensor, state'). No value leaves the device."""
    if temperature == 0.0:      # argmax: no coin drawn, the state as it is
        return torch.argmax(logits), state
    tok, state = sample_rows(logits[None], state[None], temperature, topp)
    return tok[0], state[0]


def sample_rows(logits: torch.Tensor, state: torch.Tensor,
                temperature: float, topp: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one token id a row from (B, vocab) logits, row b on its own
    (2,) state state[b]; returns (tokens (B,) int64, states (B, 2)). No
    value leaves the device.

    temperature and topp are fixed per call site (a graph is captured per
    sampler config), with sampler.Sampler.sample's branches: temperature 0
    -> argmax (no coin drawn); topp outside (0, 1) -> plain multinomial;
    else the reference's cutoff prefilter, stable sort and truncated
    nucleus (ref: src/tokenizer.cpp:231-306)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1), state

    x = logits.to(torch.float32)
    # a device divisor: a host scalar would make the card multiply by its
    # reciprocal, which is not the division the JAX sampler does
    x = x / torch.full((), temperature, dtype=torch.float32, device=x.device)
    x = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    probs = x / x.sum(dim=-1, keepdim=True)
    state, coin = coin_f32(state)
    coin = coin[:, None]
    n = probs.shape[-1]

    if topp <= 0 or topp >= 1:
        cdf = torch.cumsum(probs, -1)
        idx = torch.searchsorted(cdf, coin, right=True)
        return idx.clamp(max=n - 1)[:, 0], state

    cutoff = float(np.float32((1.0 - topp) / (n - 1)))
    keep = probs >= cutoff
    # near-uniform probs with topp < 1/n can leave no candidate; keep the
    # (first) argmax then, as the host Sampler does
    first = (torch.arange(n, device=probs.device)[None, :]
             == torch.argmax(probs, dim=-1, keepdim=True))
    keep = torch.where(keep.any(dim=-1, keepdim=True), keep, first)
    # non-candidates carry key -1 < 0 <= any candidate prob, so they sink
    # to the tail of the descending order and add 0 to the cdf
    key = torch.where(keep, probs, -1.0)
    n_cand = keep.sum(dim=-1) - 1   # last candidate position, if none exceed topp
    order = torch.sort(-key, dim=-1, stable=True).indices
    p_sorted = key.gather(-1, order).clamp(min=0.0)
    cum = torch.cumsum(p_sorted, -1)
    over = cum > topp
    last = torch.where(over.any(dim=-1), torch.argmax(over.to(torch.uint8), dim=-1),
                       n_cand.clamp(max=n - 1))[:, None]
    # gathers, not cum[last]: a 0-dim index tensor is read on the host
    r = coin * cum.gather(-1, last)
    idx = torch.searchsorted(cum, r, right=True)
    return order.gather(-1, torch.minimum(idx, last))[:, 0], state
