"""70B rehearsal: a Llama-2-70B-width file over 16 ranks.

Counterpart of the JAX repository's tools/rehearse_70b.py. It

1. writes a `.m` at Llama-2-70B's exact widths (dim 8192, hidden 28672, 64
   heads, 8 kv heads, vocab 32000), cut to N_LAYERS layers for disk
   (~3.1 GB at 4; full depth is the layer bytes x 20), with valid random
   Q40 blocks streamed straight to disk;
2. stream-loads it on each rank of two meshes of 16 ranks, tp = 16 and
   tp = 8 x pp = 2, through models/loader.load_params_streamed (each rank
   keeps its tp shard, its pp stage, its vocab rows; at tp = 16 the 8 kv
   heads are replicated, two ranks a head), with the loader's high-water
   mark of resident host bytes held to twice the largest tensor;
3. runs real greedy steps on each mesh (a short prompt, then decode) and
   checks that the two meshes emit IDENTICAL tokens (same file, same math,
   different partitioning); a decode step's collectives are counted from
   the rank's Mesh.stats (the JAX tool counted them in the optimized HLO);
4. records each rank's parameter bytes (layers, vocab rows, the rest) and
   extrapolates them to 80 layers against one card's memory.

The ranks are one parallel/launch.RankPool of 16 processes that runs one
job a mesh (a pool serves any grid of its size); on one card they share it
(gloo joins them). The engine is f32 with an f32 cache, Q80 activations
(as the CLI builds a Q40 engine) and exact collectives, so that the two
partitionings agree to rounding.

    python -m distributed_llama_tpu_torch.tools.rehearse_70b [--device cuda|cpu]
        [--layers 4] [--tokens 4] [--out PATH] [--model-path PATH] [--keep-file]

It writes the JAX tool's JSON schema to --out (by default
artifacts/MULTICHIP_70B.json beside this file).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

N_LAYERS = 4
FULL_LAYERS = 80
N_TOKENS = 4
PROMPT = [1, 2, 3]
GRIDS = ({"tp": 16}, {"tp": 8, "pp": 2})
OUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                        "MULTICHIP_70B.json")
# rows of a tensor generated at once while the file is written
_CHUNK_BYTES = 1 << 26


def spec70(n_layers: int = N_LAYERS):
    """Llama-2-70B's widths (models/bench_specs.LLAMA2_70B_TRUNC), Q40
    weights, n_layers deep."""
    from ..models.bench_specs import LLAMA2_70B_TRUNC
    from ..quants.types import FloatType

    return dataclasses.replace(LLAMA2_70B_TRUNC, n_layers=n_layers,
                               rope_theta=10000.0, weights_float_type=FloatType.Q40)


def write_file(path: str, spec=None, seed: int = 70) -> int:
    """Stream random-but-valid tensors in the file's plan order: Q40 blocks
    get f16 scales in [0.005, 0.02] and uniform nibble bytes; f32 tensors
    small gaussians (norm weights near 1). Returns the file's bytes."""
    from ..io.model_file import model_tensor_plan, write_header
    from ..quants.types import BLOCK_SIZE, Q40_BLOCK_BYTES, FloatType

    spec = spec or spec70()
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        write_header(f, spec)
        for name, shape, ftype in model_tensor_plan(spec):
            n = shape[-1]
            d = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            if ftype == FloatType.F32:
                rows = max(1, _CHUNK_BYTES // (4 * n))
                for r0 in range(0, d, rows):
                    x = rng.standard_normal((min(rows, d - r0)) * n,
                                            dtype=np.float32) * 0.02
                    if "rms" in name:
                        x += 1.0
                    f.write(x.tobytes())
            elif ftype == FloatType.Q40:
                per_row = n // BLOCK_SIZE
                rows = max(1, _CHUNK_BYTES // (per_row * Q40_BLOCK_BYTES))
                for r0 in range(0, d, rows):
                    nb = min(rows, d - r0) * per_row
                    raw = np.frombuffer(rng.bytes(nb * Q40_BLOCK_BYTES),
                                        np.uint8).reshape(nb, Q40_BLOCK_BYTES).copy()
                    scales = rng.uniform(0.005, 0.02, nb).astype(np.float16)
                    raw[:, :2] = scales.reshape(nb, 1).view(np.uint8)
                    f.write(raw.tobytes())
            else:
                raise AssertionError(ftype)
    size = os.path.getsize(path)
    print(f"[rehearse_70b] wrote {path}: {size / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return size


def rank_job(path: str, grid: dict, device_type: str, prompt: list[int],
             n_tokens: int) -> dict:
    """One rank of one mesh (a RankPool job): load its share of the file,
    greedy-decode, account. Every rank returns its record; the tokens are
    the same on every rank (each rank holds the whole logits row)."""
    import torch

    from ..io.model_file import read_spec
    from ..models.loader import _nbytes, load_params_streamed
    from ..ops import cuda_attention, cuda_q40, cuda_q80
    from ..parallel.mesh import describe, make_mesh
    from ..parallel.sharding import loader_placement, vocab_splits
    from ..runtime.engine import Engine

    counters = {"K1": cuda_q40.q40_matmul, "K2": cuda_q40.q40_expert_matmul,
                "Q80F": cuda_q40.q80_fused, "K3": cuda_attention.flash_attention,
                "Q80": cuda_q80.q80_roundtrip}
    mesh = make_mesh(**grid, device_type=device_type)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    spec = read_spec(path)
    shard_vocab = vocab_splits(spec, mesh.tp)
    t0 = time.perf_counter()
    params, stats = load_params_streamed(
        spec, path, mesh.device, mode="q40", dtype=torch.float32,
        **loader_placement(mesh, spec, shard_vocab))
    load_s = time.perf_counter() - t0
    # the streamed-load contract: host residency is bounded by the largest
    # single tensor (tok_emb f32, 1.05 GB at 70B widths), never the file
    biggest = spec.vocab_size * spec.dim * 4 + (1 << 20)
    if stats.peak_host_bytes > biggest * 2:
        raise AssertionError(f"peak host bytes {stats.peak_host_bytes} > twice the "
                             f"largest tensor {biggest}")
    layer_bytes = sum(_nbytes(w) for lw in params["layers"] for w in lw.values())
    vocab_bytes = sum(_nbytes(params[k]) for k in ("tok_emb", "wcls"))
    other_bytes = _nbytes(params["rms_final"])
    eng = Engine(spec, params, mesh=mesh, compute_dtype=torch.float32,
                 cache_dtype=torch.float32, max_seq_len=256, activation_q80=True,
                 q80_collectives=False, shard_vocab=shard_vocab)
    del params
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    lg = eng.fetch_logits(eng.prefill(list(prompt)))[0]
    toks, logits = [int(np.argmax(lg))], [lg]
    steps = []
    for _ in range(n_tokens - 1):
        mesh.reset_stats()
        ts = time.perf_counter()
        lg = eng.fetch_logits(eng.step(np.asarray([[toks[-1]]], np.int32), eng.pos))[0]
        steps.append((time.perf_counter() - ts, dict(mesh.stats)))
        toks.append(int(np.argmax(lg)))
        logits.append(lg)
    wall_s = time.perf_counter() - t0
    counts = {k: c.launches for k, c in counters.items()}
    step_s = sorted(s for s, _ in steps)
    full = other_bytes + vocab_bytes + layer_bytes * (FULL_LAYERS // spec.n_layers)
    card_bytes = (torch.cuda.get_device_properties(mesh.device).total_memory
                  if on_card else None)
    out = dict(
        rank=mesh.rank, coords=dict(mesh.coords), describe=describe(mesh),
        backend=mesh.backend, graphs=bool(eng.cuda_graphs),
        load_seconds=load_s, file_bytes=os.path.getsize(path),
        peak_host_bytes=stats.peak_host_bytes, loaded_bytes=stats.device_bytes,
        layer_bytes=layer_bytes, vocab_bytes=vocab_bytes, other_bytes=other_bytes,
        param_bytes=layer_bytes + vocab_bytes + other_bytes,
        layers_held=len(eng.params["layers"]), shard_vocab=bool(eng.shard_vocab),
        full_depth_bytes=full, card_bytes=card_bytes,
        tokens=toks, wall_seconds=wall_s,
        logits=np.stack(logits).astype(np.float32) if mesh.rank == 0 else None,
        decode_step_seconds=step_s[len(step_s) // 2] if step_s else None,
        collectives_decode_step=steps[-1][1]["collectives"] if steps else None,
        staged_bytes_decode_step=steps[-1][1]["staged_bytes"] if steps else None,
        counts=counts,
        memory_bytes=(torch.cuda.max_memory_allocated(mesh.device) if on_card else None))
    eng.release()
    return out


def grid_name(grid: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in grid.items())


def summarize(grid: dict, ranks: list[dict], n_layers: int) -> dict:
    """The JAX tool's per-config record from every rank's: byte figures
    are the largest over the ranks (the rank the memory budget binds)."""
    r0 = ranks[0]
    worst = max(ranks, key=lambda r: r["param_bytes"])
    full = max(r["full_depth_bytes"] for r in ranks)
    card = r0["card_bytes"]
    return {
        "config": grid_name(grid),
        "mesh_devices": len(ranks),
        "backend": r0["backend"],
        "file_gb": round(r0["file_bytes"] / 1e9, 3),
        "load_seconds": round(max(r["load_seconds"] for r in ranks), 1),
        "peak_host_mb_during_load": round(max(r["peak_host_bytes"] for r in ranks) / 1e6, 1),
        "per_device_param_mb": round(worst["param_bytes"] / 1e6, 1),
        "per_device_layer_mb": round(max(r["layer_bytes"] for r in ranks) / 1e6, 1),
        "per_device_vocab_mb": round(max(r["vocab_bytes"] for r in ranks) / 1e6, 1),
        "per_device_replicated_mb": round(max(r["other_bytes"] for r in ranks) / 1e6, 1),
        "shard_vocab": r0["shard_vocab"],
        "per_device_param_gb_extrapolated_80_layers": round(full / 1e9, 3),
        "card_memory_gb": None if card is None else round(card / 1e9, 3),
        "budget_met_80_layers": None if card is None else bool(full <= card),
        "collectives_decode_step": r0["collectives_decode_step"],
        "greedy_tokens": r0["tokens"],
        "token_wall_seconds": round(r0["wall_seconds"], 3),
        "decode_tokens_per_s": (None if not r0["decode_step_seconds"]
                                else round(1.0 / r0["decode_step_seconds"], 3)),
        "layers_on_disk": n_layers,
        "rank0_launches": r0["counts"],
        "memory_gb_max_rank": (None if r0["memory_bytes"] is None else
                               round(max(r["memory_bytes"] for r in ranks) / 1e9, 3)),
    }


def rehearse(*, device: str = "cuda", n_layers: int = N_LAYERS, n_tokens: int = N_TOKENS,
             grids=GRIDS, spec=None, model_path: str | None = None,
             out_path: str | None = OUT_PATH, keep_file: bool = False,
             timeout_s: float = 900.0, prompt=PROMPT, pool=None) -> dict:
    """Write the file (unless model_path names one that exists), run every
    grid on one pool of ranks, check the meshes' tokens agree, write the
    artifact. The file is deleted at the end unless kept or given. `pool`:
    a RankPool of the grids' size already started (the caller closes it);
    by default one is started and closed here."""
    from ..parallel.launch import RankPool
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    worlds = {int(np.prod(list(g.values()))) for g in grids}
    if len(worlds) != 1:
        raise ValueError(f"every grid needs the same number of ranks, got {worlds}")
    world = worlds.pop()
    if pool is not None and pool.world != world:
        raise ValueError(f"the pool has {pool.world} ranks, the grids need {world}")
    spec = spec or spec70(n_layers)
    own_file = model_path is None
    if own_file:
        fd, model_path = tempfile.mkstemp(prefix="llama70b_width_", suffix=".m")
        os.close(fd)
    try:
        if own_file or not os.path.exists(model_path):
            write_file(model_path, spec)
        results = []
        t0 = time.perf_counter()
        with (contextlib.nullcontext(pool) if pool is not None else
              RankPool(world, device_type=dev.type, timeout_s=timeout_s)) as pool:
            for grid in grids:
                tg = time.perf_counter()
                ranks = pool.run("distributed_llama_tpu_torch.tools.rehearse_70b:rank_job",
                                 model_path, dict(grid), dev.type, list(prompt), n_tokens)
                if any(r["tokens"] != ranks[0]["tokens"] for r in ranks):
                    raise AssertionError(f"{grid_name(grid)}: ranks disagree on tokens")
                rec = summarize(grid, ranks, spec.n_layers)
                rec["seconds"] = round(time.perf_counter() - tg, 1)
                rec["ranks"] = ranks
                results.append(rec)
                print(f"[rehearse_70b] {rec['config']}: tokens {rec['greedy_tokens']}, "
                      f"{rec['per_device_param_mb']} MB params a rank (layers "
                      f"{rec['per_device_layer_mb']}, vocab {rec['per_device_vocab_mb']}), "
                      f"80 layers {rec['per_device_param_gb_extrapolated_80_layers']} GB a "
                      f"rank, peak host {rec['peak_host_mb_during_load']} MB, "
                      f"{rec['collectives_decode_step']} collectives a decode step, "
                      f"{rec['decode_tokens_per_s']} tokens/s, load "
                      f"{rec['load_seconds']} s, {rec['seconds']} s", flush=True)
        same = all(r["greedy_tokens"] == results[0]["greedy_tokens"] for r in results)
        if not same:
            raise AssertionError("the meshes emit different tokens: " + "; ".join(
                f"{r['config']} {r['greedy_tokens']}" for r in results))
        # every step's logits (rank 0's) against the first mesh's, as a
        # share of their largest magnitude: the tokens alone can agree by
        # a wide margin
        ref = results[0]["ranks"][0]["logits"]
        for r in results:
            lg = r["ranks"][0].pop("logits")
            r["logits_max_rel_diff"] = float(np.abs(lg - ref).max() / np.abs(ref).max())
        for r in results:
            for rank in r["ranks"]:
                rank.pop("logits", None)
        artifact = {
            "model_widths": (f"llama2-70b (dim {spec.dim}, hidden {spec.hidden_dim}, "
                             f"{spec.n_heads}h/{spec.n_kv_heads}kv)"),
            "n_layers_on_disk": spec.n_layers,
            "full_depth": FULL_LAYERS,
            "cross_mesh_greedy_match": True,
            "cross_mesh_logits_max_rel_diff": max(r["logits_max_rel_diff"]
                                                  for r in results),
            "device": dev.type,
            "seconds": round(time.perf_counter() - t0, 1),
            "configs": results,
        }
        if out_path:
            os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(artifact, f, indent=1)
            print(f"[rehearse_70b] wrote {out_path}", flush=True)
        return artifact
    finally:
        if own_file and not keep_file and os.path.exists(model_path):
            os.remove(model_path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=N_LAYERS)
    ap.add_argument("--tokens", type=int, default=N_TOKENS)
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--model-path", default=None,
                    help="use (or write and keep) the file here instead of a "
                         "temporary one")
    ap.add_argument("--keep-file", action="store_true")
    args = ap.parse_args(argv)
    return rehearse(device=args.device, n_layers=args.layers, n_tokens=args.tokens,
                    model_path=args.model_path, out_path=args.out,
                    keep_file=args.keep_file)


if __name__ == "__main__":
    main()
