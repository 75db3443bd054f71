"""Prefill time breakdown on the card: where a 256-token chunk of a Q40
model goes, layer by layer.

Counterpart of the JAX repository's tools/profile_prefill.py:71 main, with
the port's kernels and fused weights, each part run as the engine runs it
for a Q40 model from the CLI (the Q80 round trip of each projection's
input, kernel Q80, then K1):

  * qkv+o   K1 at the wqkv (d + 2 kv_dim, d) and wo (d, d) shapes, t = 256
  * ffn     K1 at w13 (2 hidden, d), the SiLU gate, K1 at w2 (d, hidden)
  * attn    K3 over the chunk at a representative fill (FILL positions
            already in the cache)
  * everything else: the whole chunk (Engine.prefill of a 2048-token
    prompt over 256-token chunks, divided by the chunks) less the layers'
    parts: norms, RoPE, the cache writes, residuals, embedding and the
    head.

Each part is timed by tools/timing.time_ms (replayed from a CUDA graph),
the whole prompt between CUDA events (tools/timing.event_ms), each beside
its bound (tools/timing.bound_ms: bytes or bf16 tensor-core operations).

    python -m distributed_llama_tpu_torch.tools.profile_prefill [--device cuda|cpu]

With --device cpu the parts run once on the plain versions and the host
clock times the prompt: the numbers say nothing of the card.
"""

from __future__ import annotations

import argparse

import torch

from ..models import bench_specs
from ..models.params import synthetic_q40_params
from ..ops import cuda_attention, cuda_q40, cuda_q80
from ..runtime.engine import Engine
from ..utils.device import resolve_device
from .timing import bound_ms, card_label, event_ms, time_ms

T = 256          # the engine's prefill chunk
FILL = 1024      # representative mid-prompt cache fill
PROMPT = 2048


def _k1(x, w, dt):
    return cuda_q40.q40_matmul(cuda_q80.q80_roundtrip(x, dt), w, dt)


def parts(spec, layer: dict, dev, dtype) -> list[tuple]:
    """(name, one call, bytes, operations) of each part of one layer: the
    bytes each input is read and each output written once."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d, hd, hs = spec.dim, spec.hidden_dim, spec.head_size
    x = (torch.randn((T, d), generator=gen, device=dev) * 0.5).to(dtype)

    def qbytes(w):
        return w.packed.numel() + 2 * w.scales.numel()
    wqkv, wo, w13, w2 = (layer[k] for k in ("wqkv", "wo", "w13", "w2"))
    dq = wqkv.packed.shape[0]

    def qkvo():
        _k1(x, wqkv, dtype)
        _k1(x, wo, dtype)

    def ffn():
        h = _k1(x, w13, dtype)
        g, u = h[:, :hd], h[:, hd:]
        _k1(torch.nn.functional.silu(g) * u, w2, dtype)

    q = (torch.randn((1, T, spec.n_heads, hs), generator=gen, device=dev)).to(dtype)
    kc = torch.zeros((1, spec.n_kv_heads, spec.seq_len, hs), dtype=dtype, device=dev)
    pos = (FILL + torch.arange(T, dtype=torch.int32, device=dev))[None, :]   # (B=1, T)

    def attn():
        cuda_attention.flash_attention(q, kc, kc, pos)
    kv_read = 2 * (FILL + T) * spec.n_kv_heads * hs * 2
    return [
        ("qkv+o", qkvo, qbytes(wqkv) + qbytes(wo) + 2 * T * d * 2 + T * (dq + d) * 2,
         2 * T * d * (dq + d)),
        ("ffn", ffn, qbytes(w13) + qbytes(w2) + T * (d + 2 * hd + hd + d) * 2,
         2 * T * d * 2 * hd + 2 * T * hd * d),
        (f"attn (T={T}, fill={FILL})", attn, kv_read + 2 * T * spec.n_heads * hs * 2,
         4 * T * (FILL + T) * spec.n_heads * hs),
    ]


def run(*, spec=None, params=None, device: str = "cuda", card: str | None = None) -> dict:
    dev = resolve_device(device)
    card = card or card_label(dev)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    spec = spec or bench_specs.LLAMA2_7B
    if params is None:
        params = synthetic_q40_params(spec, seed=0, device=dev, dtype=dtype)
    prompt = min(PROMPT, spec.seq_len)
    engine = Engine(spec, params, device=dev, compute_dtype=dtype, cache_dtype=dtype,
                    max_seq_len=prompt, prefill_chunk=T, activation_q80=True)
    tokens = [1] * prompt

    def whole():
        engine.reset()
        engine.prefill(tokens)
    total_ms = event_ms(whole, reps=2)
    engine.release()
    del engine
    n_chunks = max(1, prompt // T)
    per_chunk = total_ms / n_chunks
    rows = parts(spec, params["layers"][0], dev, dtype)
    out = {"whole_ms": total_ms, "tokens": prompt, "tok_per_s": prompt / (total_ms / 1e3),
           "per_chunk_ms": per_chunk, "parts": {}, "device": dev.type, "card": card}
    print(f"[profile_prefill] whole-model: {total_ms:.1f} ms / {prompt} tok "
          f"({out['tok_per_s']:.0f} tok/s) -> {per_chunk:.2f} ms/chunk [{card}]", flush=True)
    acc = 0.0
    for name, fn, nbytes, ops in rows:
        b, by = bound_ms(nbytes, ops, torch.bfloat16)
        if dev.type == "cuda":
            ms = time_ms(fn)
        else:
            fn()
            ms = 0.0
        chunk = ms * spec.n_layers
        acc += chunk
        out["parts"][name] = dict(ms_per_layer=ms, ms_per_chunk=chunk,
                                  share=chunk / per_chunk, bound_ms_per_layer=b,
                                  bound_by=by)
        print(f"[profile_prefill] {name:24s}: {ms:7.3f} ms/layer -> {chunk:7.1f} "
              f"ms/chunk-all-layers ({chunk / per_chunk * 100:5.1f}% of chunk); bound "
              f"{b:.3f} ms/layer ({by}) [{card}]", flush=True)
    rest = per_chunk - acc
    out["everything_else_ms_per_chunk"] = rest
    print(f"[profile_prefill] {'everything else':24s}: {rest:7.1f} ms/chunk "
          f"({rest / per_chunk * 100:5.1f}%) [{card}]", flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="LLAMA2_7B", choices=sorted(bench_specs.BENCH_SPECS))
    args = ap.parse_args(argv)
    return run(spec=bench_specs.BENCH_SPECS[args.model], device=args.device)


if __name__ == "__main__":
    main()
