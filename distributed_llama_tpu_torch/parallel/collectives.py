"""Collectives over a mesh axis — counterpart of the JAX package's
parallel/collectives.py, and the one place where the port's ranks
exchange tensors.

  all_reduce       the exact sum (or max) over the axis: the JAX psum/pmax
  all_gather       every rank's tensor, stacked in rank order
  q80_all_gather   the same with an int8 block payload (JAX :22)
  q80_psum         the one-shot Q80 all-reduce (JAX :33)
  broadcast        one rank's tensor on every rank of the axis (the last
                   pp stage's activations)
  broadcast_object rank 0's picklable object on every rank (a session file)
  send, recv       a tensor from this rank to another, point to point (the
                   pp stage hop: send returns at once, its copy in flight)
  ring_shift       tensors one place round the axis's ring, posted and
                   left in flight (the sp ring's lax.ppermute): each rank
                   sends to the next and receives from the previous
  q80_psum_2shot   the two-shot Q80 all-reduce (JAX :47), the reference's
                   wire trick: each rank quantizes its partial sums chunk
                   by chunk, an all-to-all hands chunk i to rank i, which
                   sums it in f32 and quantizes the sum again, and an
                   all-gather returns every reduced chunk. The quantize
                   order is the JAX one; `d % (32 * n) != 0` falls back to
                   q80_psum, as there.

The Q80 codec is quants/torch_codec.py's (bit-equal to the JAX codec); a
Q80 payload travels as one uint8 tensor, the int8 values and the f16
scales' bytes side by side, so each exchange is one collective. These
stay plain torch ops: in the JAX package XLA fuses them, and there is no
Pallas kernel to port.

Under gloo with tensors on a card (Mesh.stages: ranks sharing one GPU),
every collective copies its input to the host and its output back, here
and nowhere else, counted in Mesh.stats with the host seconds of the
copies and of the collectives. Such a step cannot be captured in a CUDA
graph; under NCCL nothing is staged and a step captures with its
collectives inside.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..quants.torch_codec import dequantize_q80_torch, quantize_q80_torch
from .mesh import TP_AXIS, WORLD, Mesh, axis_parts


def _stage(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t on the host when the backend needs it there (gloo, CUDA tensors)."""
    if not mesh.stages:
        return t
    # the copy waits for the kernels before it; that wait is theirs
    torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    h = t.cpu()
    mesh.stats["staged"] += 1
    mesh.stats["staged_bytes"] += h.numel() * h.element_size()
    mesh.stats["staging_s"] += time.perf_counter() - t0
    return h


def _unstage(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    if not mesh.stages:
        return t
    t0 = time.perf_counter()
    d = t.to(mesh.device)
    torch.cuda.synchronize(mesh.device)
    mesh.stats["staged_bytes"] += t.numel() * t.element_size()
    mesh.stats["staging_s"] += time.perf_counter() - t0
    return d


def _run(mesh: Mesh, op) -> None:
    t0 = time.perf_counter()
    op()
    mesh.stats["collectives"] += 1
    mesh.stats["collective_s"] += time.perf_counter() - t0


def _spans(mesh: Mesh | None, axis: str) -> bool:
    """Whether a collective over `axis` exchanges anything (or, on a
    1-rank mesh, still runs, as the forced shard path asks)."""
    return mesh is not None and mesh.group(axis) is not None


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS,
               op: str = "sum") -> torch.Tensor:
    """The elementwise sum (op="max": maximum) of x over the axis, the
    same on every rank of it; x itself is left as it is."""
    if not _spans(mesh, axis):
        return x
    # the reduce runs in place: on a buffer of its own (the staged copy)
    buf = _stage(mesh, x.contiguous()) if mesh.stages else x.clone(
        memory_format=torch.contiguous_format)
    rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    _run(mesh, lambda: dist.all_reduce(buf, rop, group=mesh.group(axis)))
    return _unstage(mesh, buf)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS) -> torch.Tensor:
    """(n, *x.shape): every rank's x over the axis, in rank order."""
    if not _spans(mesh, axis):
        return x[None]
    h = _stage(mesh, x.contiguous())
    parts = [torch.empty_like(h) for _ in range(mesh.shape[axis])]
    _run(mesh, lambda: dist.all_gather(parts, h, group=mesh.group(axis)))
    return _unstage(mesh, torch.stack(parts))


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """The tensor of the rank at index `src` along `axis` on every rank of
    the axis; every rank passes a tensor of the same shape and dtype (what
    the others pass is overwritten, never read)."""
    if not _spans(mesh, axis):
        return x
    (a,) = axis_parts(axis)
    buf = _stage(mesh, x.contiguous()) if mesh.stages else x.clone(
        memory_format=torch.contiguous_format)
    root = mesh.neighbour(a, src - mesh.coords[a])
    _run(mesh, lambda: dist.broadcast(buf, root, group=mesh.group(axis)))
    return _unstage(mesh, buf)


class Pending:
    """Point-to-point transfers in flight (send, ring_shift): wait() ends
    them and returns what was received, on the mesh's device."""

    def __init__(self, mesh: Mesh, works: list, received: list,
                 keep: list):
        self.mesh, self._works, self._received = mesh, works, received
        self._keep = keep      # the staged sends' host copies, until done

    def wait(self) -> list[torch.Tensor]:
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        self.mesh.stats["collective_s"] += time.perf_counter() - t0
        self._keep = []
        return [_unstage(self.mesh, r) for r in self._received]


def _p2p(mesh: Mesh, sends: list, recvs: list) -> Pending:
    """Post sends [(tensor, dst rank)] and receives [(like tensor, src
    rank)]: NCCL takes them as one batch (so that a pair of ranks sending
    to each other cannot wait on each other), gloo one by one on its own
    threads. Every transfer counts as one collective."""
    # a staged receive lands in host memory; wait() copies it to the card
    out = [torch.empty(like.shape, dtype=like.dtype,
                       device="cpu" if mesh.stages else like.device)
           for like, _ in recvs]
    keep = [_stage(mesh, t.contiguous()) for t, _ in sends]
    t0 = time.perf_counter()
    if mesh.backend == "nccl":
        ops = [dist.P2POp(dist.isend, t, d) for t, (_, d) in zip(keep, sends)]
        ops += [dist.P2POp(dist.irecv, t, s) for t, (_, s) in zip(out, recvs)]
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = [dist.isend(t, d) for t, (_, d) in zip(keep, sends)]
        works += [dist.irecv(t, s) for t, (_, s) in zip(out, recvs)]
    mesh.stats["collectives"] += len(sends) + len(recvs)
    mesh.stats["collective_s"] += time.perf_counter() - t0
    return Pending(mesh, works, out, keep)


def send(x: torch.Tensor, mesh: Mesh, dst: int) -> Pending:
    """Send x to global rank `dst`; the copy stays in flight until the
    returned Pending is waited on (x must not change before then)."""
    return _p2p(mesh, [(x, dst)], [])


def recv(like: torch.Tensor, mesh: Mesh, src: int) -> torch.Tensor:
    """A tensor of `like`'s shape and dtype from global rank `src`."""
    return _p2p(mesh, [], [(like, src)]).wait()[0]


def ring_shift(xs: list[torch.Tensor], mesh: Mesh, axis: str) -> Pending:
    """Every tensor of xs one place round `axis`'s ring: sent to the next
    rank, its counterpart received from the previous one. Returns at once;
    wait() gives the received tensors in xs's order."""
    nxt, prv = mesh.neighbour(axis, 1), mesh.neighbour(axis, -1)
    return _p2p(mesh, [(x, nxt) for x in xs], [(x, prv) for x in xs])


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """Rank `src`'s picklable object on every rank of the mesh (a session
    file's bytes, read once by rank 0)."""
    if mesh.world == 1:
        return obj
    box = [obj]
    _run(mesh, lambda: dist.broadcast_object_list(box, src=src,
                                                  group=mesh.group(WORLD)))
    return box[0]


def _all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x (n, ...): slice i goes to rank i of the axis; returns (n, ...)
    whose slice j came from rank j."""
    h = _stage(mesh, x.contiguous())
    out = torch.empty_like(h)
    _run(mesh, lambda: dist.all_to_all_single(out, h, group=mesh.group(axis)))
    return _unstage(mesh, out)


def _pack(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Q80 blocks (int8 (..., nb, 32), f16 (..., nb)) as one uint8 payload
    (..., 34 nb): the values, then the scales' bytes."""
    lead = q.shape[:-2]
    return torch.cat([q.reshape(*lead, -1).view(torch.uint8),
                      s.contiguous().view(torch.uint8)], dim=-1)


def _unpack(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    nb = p.shape[-1] // 34
    q = p[..., :32 * nb].contiguous().view(torch.int8)
    s = p[..., 32 * nb:].contiguous().view(torch.float16)
    return q.reshape(*q.shape[:-1], nb, 32), s


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis in rank order, one f32 add at a time."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def q80_all_gather(x: torch.Tensor, mesh: Mesh,
                   axis: str = TP_AXIS) -> torch.Tensor:
    """All-gather with an int8 block payload: x (..., n) -> (ranks, ..., n),
    dequantized to f32 (JAX collectives.py:22)."""
    q, s = quantize_q80_torch(x)
    return dequantize_q80_torch(*_unpack(all_gather(_pack(q, s), mesh, axis)))


def q80_psum(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS) -> torch.Tensor:
    """All-reduce of partial sums exchanged as Q80 blocks, summed in f32
    and cast back to x's dtype (JAX collectives.py:33)."""
    return _sum0(q80_all_gather(x, mesh, axis)).to(x.dtype)


def q80_psum_2shot(x: torch.Tensor, mesh: Mesh,
                   axis: str = TP_AXIS) -> torch.Tensor:
    """Two-shot Q80 all-reduce (JAX collectives.py:47): x's last dim cut in
    n chunks; chunk i's partials meet at rank i (int8 all-to-all), are
    summed in f32 and quantized again, and every reduced chunk comes back
    (int8 all-gather). Values are quantized twice, as the reference's Q80
    buffer is a hop. d % (32 n) != 0 falls back to q80_psum."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    d = x.shape[-1]
    if d % (32 * n) != 0:
        return q80_psum(x, mesh, axis)
    lead = x.shape[:-1]
    xc = x.reshape(*lead, n, d // n).movedim(-2, 0)        # (n, ..., d/n)
    got = _unpack(_all_to_all(_pack(*quantize_q80_torch(xc)), mesh, axis))
    red = _sum0(dequantize_q80_torch(*got))                 # my chunk, summed
    back = _unpack(all_gather(_pack(*quantize_q80_torch(red)), mesh, axis))
    out = dequantize_q80_torch(*back).movedim(0, -2).reshape(*lead, d)
    return out.to(x.dtype)


def reduce_partials(x: torch.Tensor, mesh: Mesh, reduce: str) -> torch.Tensor:
    """The column split's reduce of partial sums over tp: "exact" (the JAX
    psum) or "q80" (q80_psum_2shot, --buffer-float-type q80)."""
    if reduce == "q80":
        return q80_psum_2shot(x, mesh, TP_AXIS)
    if reduce != "exact":
        raise ValueError(f"reduce must be exact or q80, got {reduce!r}")
    return all_reduce(x, mesh, TP_AXIS)
