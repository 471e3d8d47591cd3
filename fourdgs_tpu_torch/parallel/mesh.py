"""A ("data", "tile") mesh of torch.distributed ranks
(counterpart: fourdgs_tpu/parallel/mesh.py).

  * "data": cameras of the batch; each data coordinate renders its slice
    of the global batch, and the parameter gradients are summed over it;
  * "tile": the image tiles within a camera, and the gaussians of the
    per-gaussian pipeline; each tile coordinate blends and backpropagates
    its band of tiles.

Every process is one rank, laid out as JAX reshapes its devices: rank r
sits at (r // n_tile, r % n_tile). A mesh of one rank with no process
group initialised needs no group and runs every collective as the
identity, through the same sharded code path.

NCCL builds a group's communicator at the group's first collective, and
a communicator cannot be built inside a CUDA graph capture. So under
NCCL `make_mesh` runs one all_reduce on each of this rank's groups, in
one order on every rank (the row's, the column's, then every rank's),
before any step or frame is captured: a capture then records launches
on communicators that exist, whichever groups its program reaches, and
the ranks never build communicators in different orders.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (n_data, n_tile) grid and the process groups
    of its collectives: `tile_group` holds the ranks of its data row (one
    camera slice, every band), `data_group` those of its tile column, and
    `group` every rank. A group is None where torch.distributed is not
    initialised (a one-rank mesh)."""
    n_data: int
    n_tile: int
    rank: int = 0
    tile_group: object = None
    data_group: object = None
    group: object = None

    @property
    def shape(self) -> dict:
        """JAX's `mesh.shape`: {"data": n_data, "tile": n_tile}."""
        return {"data": self.n_data, "tile": self.n_tile}

    @property
    def size(self) -> int:
        return self.n_data * self.n_tile

    @property
    def data(self) -> int:
        """This rank's data coordinate."""
        return self.rank // self.n_tile

    @property
    def tile(self) -> int:
        """This rank's tile coordinate."""
        return self.rank % self.n_tile

    @property
    def backend(self) -> str | None:
        """The process group's backend ("nccl" or "gloo"), None without
        one."""
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(n_data: int | None = None, n_tile: int = 1) -> Mesh:
    """The mesh over every rank of the initialised process group (or over
    this one process when none is). `n_data` defaults to the ranks over
    n_tile; n_data * n_tile must be the world size. Every rank builds
    every row's and column's group, in one order, as
    `torch.distributed.new_group` requires."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    if n_data is None:
        n_data = world // n_tile
    if n_data < 1 or n_tile < 1 or n_data * n_tile != world:
        raise ValueError(f"a {n_data}x{n_tile} mesh needs {n_data * n_tile} "
                         f"ranks, have {world}")
    if not initialised:
        return Mesh(n_data, n_tile)
    rank = dist.get_rank()
    tile_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_tile + t for t in range(n_tile)])
        if d == rank // n_tile:
            tile_group = g
    for t in range(n_tile):
        g = dist.new_group([d * n_tile + t for d in range(n_data)])
        if t == rank % n_tile:
            data_group = g
    mesh = Mesh(n_data, n_tile, rank, tile_group, data_group,
                dist.group.WORLD)
    if mesh.backend == "nccl":
        one = torch.ones(1, device="cuda")
        for g in (tile_group, data_group, mesh.group):
            dist.all_reduce(one, group=g)
        torch.cuda.synchronize()
    return mesh


def factor_devices(n: int) -> tuple[int, int]:
    """Split n devices into (data, tile): prefer a square-ish split with
    tile a power of two, falling back to pure data-parallel."""
    best = (n, 1)
    t = 1
    while t * t <= n:
        if n % t == 0:
            best = (n // t, t)
        t *= 2
    return best
