"""The rank mesh of the multi-device engine.

The counterpart of `hybridquantization_tpu/parallel/mesh.py` over
`torch.distributed`. JAX puts the devices of one or more processes on a
(data, pop, pixel) mesh; here each rank is one process with one device, and
the mesh puts the ranks of the default group on the same three axes
(SURVEY.md section 2f):

  - "data":  independent images of a batch (BASELINE configs 4-5)
  - "pop":   the SWASA population members of one image (parallel.population)
  - "pixel": the rows or columns of each image (parallel.halo, .fast),
    innermost, so the neighbour exchanges of a line go to adjacent ranks

Rank r has the coordinates (data, pop, pixel) of r in row-major order with
pixel innermost, as JAX's device grid (`mesh.py:51`). Each axis line (the
ranks that differ only in that axis) has its own process group; every rank
creates every group, in the same order, as `torch.distributed.new_group`
requires. `torch.distributed.device_mesh.DeviceMesh` builds the same groups
but ties the device type to the backend; this engine also runs gloo ranks
whose tensors live on a card they share, so it keeps its own small mesh.

Transport: NCCL keeps every operand on the device. gloo reads a tensor's
memory as host memory, so under gloo the collectives below copy a CUDA
operand to the host and the result back, explicitly. Nothing switches
backend or moves work to the CPU when a collective fails.

Without a process group the mesh has one rank and every collective is the
identity.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
POP_AXIS = "pop"
PIXEL_AXIS = "pixel"
AXES = (DATA_AXIS, POP_AXIS, PIXEL_AXIS)


def rank_device(device="cuda", rank: int | None = None) -> torch.device:
    """This rank's device: `device` as given when it names a card or is not
    "cuda"; otherwise card LOCAL_RANK (or the rank) modulo the cards, so
    ranks beyond the cards of a host share them (gloo only)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _grid_lines(shape: dict, axis: str) -> list[tuple[int, ...]]:
    """Every line of the (data, pop, pixel) grid along `axis`, in a fixed
    order: the global ranks that differ only in that axis."""
    n_data, n_pop, n_pixel = (shape[a] for a in AXES)
    rank = lambda d, p, x: (d * n_pop + p) * n_pixel + x  # noqa: E731
    if axis == DATA_AXIS:
        return [tuple(rank(d, p, x) for d in range(n_data)) for p in range(n_pop) for x in range(n_pixel)]
    if axis == POP_AXIS:
        return [tuple(rank(d, p, x) for p in range(n_pop)) for d in range(n_data) for x in range(n_pixel)]
    return [tuple(rank(d, p, x) for x in range(n_pixel)) for d in range(n_data) for p in range(n_pop)]


class _Pending:
    """An all_gather in flight: `wait()` gives the (n, ...) stack on the
    operand's device."""

    def __init__(self, work, parts: list[torch.Tensor], device: torch.device):
        self.work, self.parts, self.device = work, parts, device

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return torch.stack(self.parts).to(self.device)


class Mesh:
    """(data, pop, pixel) coordinates of this rank, its axis groups and its
    device (module doc). A rank beyond the mesh's extent (a mesh smaller
    than the group) has no coordinates and takes part in nothing.

    Every rank of an axis line must call a collective of that axis at the
    same point, with tensors of the same shape.
    """

    def __init__(self, shape: dict, rank: int, device: torch.device, backend: str | None, lines: dict):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        self.backend = backend
        self._lines = lines
        need = self.shape[DATA_AXIS] * self.shape[POP_AXIS] * self.shape[PIXEL_AXIS]
        self.coords = None
        if rank < need:
            n_pop, n_pixel = self.shape[POP_AXIS], self.shape[PIXEL_AXIS]
            self.coords = {DATA_AXIS: rank // (n_pop * n_pixel), POP_AXIS: (rank // n_pixel) % n_pop,
                           PIXEL_AXIS: rank % n_pixel}

    @property
    def member(self) -> bool:
        return self.coords is not None

    def size(self, axis: str | None = None) -> int:
        """Ranks along `axis`, or of the whole mesh for None."""
        return len(self._lines[axis][0])

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_gather_async(self, t: torch.Tensor, axis: str | None = None) -> _Pending:
        """Start gathering `t` from every rank of this rank's `axis` line
        (the whole mesh for None), in line order."""
        ranks, group = self._lines[axis]
        if len(ranks) == 1:
            return _Pending(None, [t], t.device)
        src = t.contiguous()
        if self._staged(src):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in ranks]
        work = dist.all_gather(parts, src, group=group, async_op=True)
        return _Pending(work, parts, t.device)

    def all_gather(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """(n, *t.shape): `t` of every rank of the `axis` line, in line order."""
        return self.all_gather_async(t, axis).wait()

    def exchange(self, to_prev: torch.Tensor, to_next: torch.Tensor, axis: str = PIXEL_AXIS):
        """Neighbour exchange along `axis`: send `to_prev` to the previous
        rank of the line and `to_next` to the next. Returns (from_prev,
        from_next), what those two sent; None at the ends of the line.
        `to_prev` and `to_next` have the same shape on every rank."""
        ranks, group = self._lines[axis]
        i = ranks.index(self.rank)
        dev = to_prev.device
        staged = self._staged(to_prev)
        ops, recv = [], {}
        for key, peer, out in (("prev", i - 1, to_prev), ("next", i + 1, to_next)):
            if not 0 <= peer < len(ranks):
                continue
            out = out.contiguous()
            if staged:
                out = out.cpu()
            # what the neighbour sends this way has the shape of what goes the other way
            like = to_next if key == "prev" else to_prev
            recv[key] = torch.empty(like.shape, dtype=like.dtype, device=out.device)
            ops.append(dist.P2POp(dist.isend, out, ranks[peer], group))
            ops.append(dist.P2POp(dist.irecv, recv[key], ranks[peer], group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        got = {k: v.to(dev) for k, v in recv.items()}
        return got.get("prev"), got.get("next")


def make_mesh(n_data: int = 1, n_pixel: int | None = None, n_pop: int = 1, device="cuda") -> Mesh:
    """(data, pop, pixel) mesh over the ranks of the default group.

    n_pixel None takes the ranks that data x pop leave. Without a process
    group there is one rank. `device` "cuda" means this rank's card
    (`rank_device`); pass "cpu" to run on the CPU. Every rank of the group
    must call this, in the same order as any other mesh it builds.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_pixel is None:
        if world % (n_data * n_pop):
            raise ValueError(f"{world} ranks not divisible by n_data*n_pop={n_data * n_pop}")
        n_pixel = world // (n_data * n_pop)
    if min(n_data, n_pop, n_pixel) < 1:
        raise ValueError(f"mesh {n_data}x{n_pop}x{n_pixel}: every axis needs at least one rank")
    need = n_data * n_pop * n_pixel
    if need > world:
        raise ValueError(f"mesh {n_data}x{n_pop}x{n_pixel} needs {need} ranks, have {world}")
    shape = {DATA_AXIS: n_data, POP_AXIS: n_pop, PIXEL_AXIS: n_pixel}
    lines = {}
    for axis, groups in [(a, _grid_lines(shape, a)) for a in AXES] + [(None, [tuple(range(need))])]:
        for ranks in groups:
            group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                lines[axis] = (ranks, group)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(shape, rank, dev, dist.get_backend() if dist.is_initialized() else None, lines)


def batch_state_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's images of a batch: over data, replicated over pop and
    pixel (JAX's P(DATA_AXIS) for per-image state)."""
    n = mesh.size(DATA_AXIS)
    if batch % n:
        raise ValueError(f"batch {batch} not divisible by data axis {n}")
    b = batch // n
    return slice(mesh.index(DATA_AXIS) * b, (mesh.index(DATA_AXIS) + 1) * b)


def row_sharding(mesh: Mesh, height: int) -> slice:
    """This rank's strip of `height` rows, over pixel (height divisible by
    the pixel axis)."""
    n = mesh.size(PIXEL_AXIS)
    if height % n:
        raise ValueError(f"height {height} not divisible by pixel axis {n}")
    hs = height // n
    return slice(mesh.index(PIXEL_AXIS) * hs, (mesh.index(PIXEL_AXIS) + 1) * hs)


def batch_image_sharding(mesh: Mesh, batch: int, height: int) -> tuple[slice, slice]:
    """This rank's block of a (batch, height, W, 3) stack: images over data,
    rows over pixel (JAX's P(DATA_AXIS, PIXEL_AXIS))."""
    return batch_state_sharding(mesh, batch), row_sharding(mesh, height)


def replicated(mesh: Mesh) -> slice:
    """The whole of an array, on every rank (JAX's P())."""
    return slice(None)
