"""The rank grid — counterpart of the JAX package's parallel/mesh.py.

The JAX package's cluster is a `jax.sharding.Mesh` over the devices of one
process. The port runs one process per rank instead, joined by
torch.distributed, and `Mesh` is this process's view of the grid: the axis
sizes under the JAX axis names, this rank's coordinates, its device, and
one process group for each axis larger than 1.

Ranks lie in the JAX mesh's order, tp fastest: rank = dp_index * tp +
tp_index, so each tp group holds consecutive ranks. Only dp and tp are
ported; sp, ep and pp are accepted at 1 and refused otherwise (ROADMAP
item 14).

The backend: NCCL when every rank has a GPU of its own (rank r on
cuda:r), gloo on the CPU and when ranks share a GPU. Under gloo a
collective over CUDA tensors copies them through host memory; that
happens in parallel/collectives.py alone, counted in `Mesh.stats`. The
kernels that compute are the same on both backends.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DP_AXIS = "dp"
SP_AXIS = "sp"
EP_AXIS = "ep"
PP_AXIS = "pp"
TP_AXIS = "tp"
# not a mesh axis: every rank at once (a row fetched across dp groups)
WORLD = "world"
# the axes the port does not run yet, with the ROADMAP item that brings them
UNPORTED_AXES = {SP_AXIS: 14, EP_AXIS: 14, PP_AXIS: 14}


def refuse_unported_axes(**sizes: int) -> list[str]:
    """A message for every unported axis asked for at a size other than 1."""
    return [f"--{a} {n}: the {a} axis is ROADMAP item {UNPORTED_AXES[a]} "
            "and is not ported yet" for a, n in sizes.items()
            if a in UNPORTED_AXES and n != 1]


def choose_backend(device_type: str, world: int) -> str:
    """NCCL when every rank has a GPU of its own; gloo otherwise."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """Rank r's device: cuda:r while the cards last, then shared round
    robin; the CPU for a CPU run."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (dp, tp) grid of `world` ranks."""

    shape: dict
    rank: int
    world: int
    backend: str
    device: torch.device
    groups: dict
    # collective calls made from Python, the host copies gloo needs for
    # CUDA tensors, and their host seconds (a replayed CUDA graph's
    # collectives run without Python and are not counted)
    stats: dict = dataclasses.field(default_factory=lambda: dict(
        collectives=0, collective_s=0.0, staged=0, staged_bytes=0,
        staging_s=0.0))

    @property
    def size(self) -> int:
        """Ranks in all (jax Mesh.size)."""
        return self.world

    @property
    def tp(self) -> int:
        return self.shape[TP_AXIS]

    @property
    def dp(self) -> int:
        return self.shape[DP_AXIS]

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def stages(self) -> bool:
        """Whether a collective over this mesh's tensors copies them
        through host memory: gloo with tensors on a card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def group(self, axis: str):
        """The process group of this rank's `axis` (the default group when
        the axis spans every rank)."""
        return self.groups[axis]

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = type(self.stats[k])()


def init_ranks(rank: int, world: int, init_method: str, device_type: str,
               timeout_s: float, backend: str | None = None) -> str:
    """Join the default process group (once a process). Returns the
    backend; `timeout_s` bounds the rendezvous and every collective, so a
    rank that never arrives fails the others in bounded time."""
    backend = backend or choose_backend(device_type, world)
    if not dist.is_initialized():
        if device_type == "cuda":
            # NCCL binds a communicator to the current card
            torch.cuda.set_device(rank_device(device_type, rank))
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_backend()


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, ep: int = 1,
              pp: int = 1, *, device_type: str | None = None) -> Mesh:
    """This rank's (dp, tp) mesh over the default process group, which
    must be initialised (init_ranks) with world = dp * tp ranks. Every rank
    calls it with the same sizes: the groups are made collectively. The
    ranks run on the GPU unless `device_type` is "cpu" (resolve_device:
    no card raises), whichever backend joined them."""
    device_type = resolve_device(device_type).type
    refused = refuse_unported_axes(sp=sp, ep=ep, pp=pp)
    if refused:
        raise ValueError("; ".join(refused))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the ranks' process group: call "
                           "init_ranks first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp * dp != world:
        raise ValueError(f"mesh dp={dp} x tp={tp} needs {dp * tp} ranks, "
                         f"the group has {world}")
    backend = dist.get_backend()
    groups: dict = {WORLD: dist.group.WORLD}
    for axis, size, members in (
            (TP_AXIS, tp, [[d * tp + t for t in range(tp)] for d in range(dp)]),
            (DP_AXIS, dp, [[d * tp + t for d in range(dp)] for t in range(tp)])):
        if size == world:
            groups[axis] = dist.group.WORLD
            continue
        groups[axis] = None
        if size == 1:
            continue
        for ranks in members:       # every rank makes every group, in order
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    shape = {DP_AXIS: dp, SP_AXIS: 1, EP_AXIS: 1, PP_AXIS: 1, TP_AXIS: tp,
             WORLD: world}
    return Mesh(shape, rank, world, backend, rank_device(device_type, rank),
                groups)


def describe(mesh: Mesh) -> str:
    """One line on how the ranks talk: the backend and why."""
    why = ("every rank has a GPU of its own" if mesh.backend == "nccl"
           else f"{mesh.world} ranks share {torch.cuda.device_count()} "
                "GPU(s): collectives stage through host memory"
           if mesh.device.type == "cuda" else "CPU ranks")
    return (f"mesh dp={mesh.dp} tp={mesh.tp} over {mesh.world} ranks: "
            f"{mesh.backend} ({why})")
