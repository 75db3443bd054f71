"""The port's kernel timer, shared by chip_smoke.py and the probe tools.

On the card, `time_ms` captures many calls in a CUDA graph and replays it
between CUDA events, so the host's per-launch cost (Python, ctypes,
argument checks) does not pad short kernels; the graph does what the TPU
tools' `slope()` over `lax.scan` repetitions did for the dispatch cost.
`rotating` cycles operands past the 50 MB L2 cache, so each call reads from
device memory as the main path does. `bound_ms` is the least time the card
could take: bytes over its memory rate or operations over its peak rate,
whichever is larger. `pass_rows` prints the probe tools' lines.
"""

from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# dense peaks at 700 W (NVIDIA data sheet): tensor cores for bf16 and int8,
# the CUDA cores for f32
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
L2_BYTES = 50e6


def time_ms(fn, budget_ms: float = 60.0, max_iters: int = 100) -> float:
    """Mean device ms per call of `fn` on the card. An eager call first
    warms up and sizes the count to fill about budget_ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = int(min(max_iters, max(3, budget_ms / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n


def rotating(make, nbytes: int):
    """Enough copies of an operand that cycling through them exceeds the L2
    cache, so every timed call reads its operand from device memory. The
    returned function gives the next copy; its `copies` holds them all."""
    copies = [make() for _ in range(max(1, min(8, math.ceil(2 * L2_BYTES / nbytes))))]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    nxt.copies = copies
    return nxt


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for moving nbytes and doing ops
    operations of dtype on the card."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / PEAK_OPS[dtype] * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def pass_rows(passes, dev: torch.device) -> list[dict]:
    """One line per (label, one_pass, nbytes) of a probe tool, printed and
    returned. On the card: ms per pass (`time_ms`), the bytes a pass really
    moves, GB/s and the share of 3.35 TB/s. On the CPU each pass runs once,
    untimed: the plain versions say nothing of the card's speed."""
    rows = []
    for label, one_pass, nbytes in passes:
        row = dict(name=label, bytes=nbytes, ms=None, gbps=None)
        line = f"{label:10s}: {nbytes / 1e6:.1f} MB/pass"
        if dev.type == "cuda":
            row["ms"] = time_ms(one_pass)
            row["gbps"] = nbytes / (row["ms"] / 1e3) / 1e9
            row["hbm_share"] = row["gbps"] * 1e9 / HBM_BYTES_PER_S
            line = (f"{label:10s}: {row['ms']:.4f} ms/pass, {nbytes / 1e6:.1f} MB/pass "
                    f"-> {row['gbps']:.0f} GB/s = {row['hbm_share']:.3f} of 3.35 TB/s "
                    f"[{torch.cuda.get_device_name(dev)}]")
        else:
            one_pass()
            line += " [cpu: plain versions, run once, not timed]"
        print(line, flush=True)
        rows.append(row)
    return rows
