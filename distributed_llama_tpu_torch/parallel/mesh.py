"""The rank grid — counterpart of the JAX package's parallel/mesh.py.

The JAX package's cluster is a `jax.sharding.Mesh` over the devices of one
process. The port runs one process per rank instead, joined by
torch.distributed, and `Mesh` is this process's view of the grid: the axis
sizes under the JAX axis names, this rank's coordinates, its device, and
one process group for each axis larger than 1.

Ranks lie in the JAX mesh's order (dp, sp, ep, pp, tp), tp fastest:

    rank = (((dp_i * sp + sp_i) * ep + ep_i) * pp + pp_i) * tp + tp_i

so each tp group holds consecutive ranks. Two joint groups join the axes
that one reduce spans: (ep, tp), the expert-parallel MoE's partial sums
(parallel/ep_moe.py), and (pp, tp), the vocab split widened over the
stages (ops/sharded_vocab.py); a joint group's ranks lie major to minor
as listed. pp's stage hop and sp's ring run point to point between the
global ranks that `neighbour` names.

The backend: NCCL when every rank has a GPU of its own (rank r on
cuda:r), gloo on the CPU and when ranks share a GPU. Under gloo a
collective over CUDA tensors copies them through host memory; that
happens in parallel/collectives.py alone, counted in `Mesh.stats`. The
kernels that compute are the same on both backends.
"""

from __future__ import annotations

import dataclasses
import datetime
import math

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DP_AXIS = "dp"
SP_AXIS = "sp"
EP_AXIS = "ep"
PP_AXIS = "pp"
TP_AXIS = "tp"
AXES = (DP_AXIS, SP_AXIS, EP_AXIS, PP_AXIS, TP_AXIS)
# joint axes: one group over several mesh axes, major to minor
EP_TP = "ep,tp"
PP_TP = "pp,tp"
JOINT = {EP_TP: (EP_AXIS, TP_AXIS), PP_TP: (PP_AXIS, TP_AXIS)}
# not a mesh axis: every rank at once (a row fetched across dp groups)
WORLD = "world"


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


def axis_parts(axis: str) -> tuple[str, ...]:
    """The mesh axes an axis name spans: itself, or a joint axis's parts."""
    return JOINT.get(axis, (axis,))


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (dp, sp, ep, pp, tp) grid of `world` ranks."""

    shape: dict
    rank: int
    world: int
    backend: str
    device: torch.device
    groups: dict
    # this rank's coordinate on each of AXES
    coords: dict = dataclasses.field(default_factory=dict)
    # collective calls made from Python (point-to-point sends and receives
    # included), the host copies gloo needs for CUDA tensors, and their
    # host seconds (a replayed CUDA graph's collectives run without Python
    # and are not counted)
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
    def sp(self) -> int:
        return self.shape[SP_AXIS]

    @property
    def ep(self) -> int:
        return self.shape[EP_AXIS]

    @property
    def pp(self) -> int:
        return self.shape[PP_AXIS]

    @property
    def tp_rank(self) -> int:
        return self.coords[TP_AXIS]

    @property
    def dp_rank(self) -> int:
        return self.coords[DP_AXIS]

    @property
    def sp_rank(self) -> int:
        return self.coords[SP_AXIS]

    @property
    def ep_rank(self) -> int:
        return self.coords[EP_AXIS]

    @property
    def pp_rank(self) -> int:
        return self.coords[PP_AXIS]

    def index(self, axis: str) -> int:
        """This rank's index along an axis or a joint axis (major to minor:
        its rank in that group)."""
        i = 0
        for a in axis_parts(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def neighbour(self, axis: str, step: int) -> int:
        """The global rank `step` places along `axis` from this one, around
        the axis (the ring's next is step 1, its previous step -1)."""
        stride = math.prod(self.shape[a] for a in AXES[AXES.index(axis) + 1:])
        i = self.coords[axis]
        j = (i + step) % self.shape[axis]
        return self.rank + (j - i) * stride

    @property
    def stages(self) -> bool:
        """Whether a collective over this mesh's tensors copies them
        through host memory: gloo with tensors on a card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def group(self, axis: str):
        """The process group of this rank's `axis` (the default group when
        the axis spans every rank; None when it is one rank wide)."""
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


def _members(sizes: dict, axis: str) -> list[list[int]]:
    """Every group of `axis` (or joint axis): the global ranks of each,
    major to minor along its parts, the other coordinates fixed."""
    parts = axis_parts(axis)
    grid = np.arange(math.prod(sizes[a] for a in AXES)).reshape(
        [sizes[a] for a in AXES])
    moved = np.moveaxis(grid, [AXES.index(a) for a in parts],
                        list(range(-len(parts), 0)))
    return moved.reshape(-1, math.prod(sizes[a] for a in parts)).tolist()


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, ep: int = 1,
              pp: int = 1, *, device_type: str | None = None) -> Mesh:
    """This rank's (dp, sp, ep, pp, tp) mesh over the default process
    group, which must be initialised (init_ranks) with world = dp * sp *
    ep * pp * tp ranks. Every rank calls it with the same sizes: the
    groups are made collectively, in one order. The ranks run on the GPU
    unless `device_type` is "cpu" (resolve_device: no card raises),
    whichever backend joined them."""
    device_type = resolve_device(device_type).type
    sizes = {DP_AXIS: dp, SP_AXIS: sp, EP_AXIS: ep, PP_AXIS: pp, TP_AXIS: tp}
    if min(sizes.values()) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {sizes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the ranks' process group: call "
                           "init_ranks first")
    world, rank = dist.get_world_size(), dist.get_rank()
    need = math.prod(sizes.values())
    if need != world:
        raise ValueError(f"mesh dp={dp} x sp={sp} x ep={ep} x pp={pp} x "
                         f"tp={tp} needs {need} ranks, the group has {world}")
    backend = dist.get_backend()
    groups: dict = {WORLD: dist.group.WORLD}
    made: dict = {}
    for axis in (*AXES, *JOINT):
        n = math.prod(sizes[a] for a in axis_parts(axis))
        if n == world:
            groups[axis] = dist.group.WORLD
            continue
        groups[axis] = None
        if n == 1:
            continue
        for ranks in _members(sizes, axis):   # every rank makes every group
            key = tuple(ranks)
            if key not in made:               # a joint axis may equal an axis
                made[key] = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = made[key]
    coords = dict(zip(AXES, np.unravel_index(
        rank, [sizes[a] for a in AXES])))
    coords = {a: int(i) for a, i in coords.items()}
    shape = dict(sizes, **{j: math.prod(sizes[a] for a in JOINT[j])
                           for j in JOINT}, **{WORLD: world})
    return Mesh(shape, rank, world, backend, rank_device(device_type, rank),
                groups, coords)


def describe(mesh: Mesh) -> str:
    """One line on how the ranks talk: the backend and why."""
    why = ("every rank has a GPU of its own" if mesh.backend == "nccl"
           else f"{mesh.world} ranks share {torch.cuda.device_count()} "
                "GPU(s): collectives stage through host memory"
           if mesh.device.type == "cuda" else "CPU ranks")
    axes = " ".join(f"{a}={mesh.shape[a]}" for a in AXES
                    if mesh.shape[a] > 1 or a in (DP_AXIS, TP_AXIS))
    return (f"mesh {axes} over {mesh.world} ranks: "
            f"{mesh.backend} ({why})")
