"""Process wiring and per-rank batches
(counterpart: fourdgs_tpu/parallel/multihost.py).

`python -m torch.distributed.run --nproc_per_node N ...` starts N
processes and gives each MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
LOCAL_RANK (the role of JAX's JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES
and JAX_PROCESS_ID); `initialize_distributed` joins them into one process
group. Every rank draws the same permutation of the views from the same
seed and takes the slice of each global batch that its data coordinate
owns (`host_batch_slice`); the ranks of one data row share that slice.

JAX's `global_batch`, which assembles the hosts' slices into one global
array for the jitted step, has no counterpart: each rank holds only its
own slice, and the step's collectives combine what the ranks computed.
"""
from __future__ import annotations

import datetime
import hashlib
import os

import torch
import torch.distributed as dist

from fourdgs_tpu_torch.parallel.mesh import Mesh

BACKENDS = ("nccl", "gloo")
# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(device: str | torch.device | None = None,
                           backend: str | None = None) -> bool:
    """Join torchrun's process group; a no-op outside torchrun (no RANK
    and WORLD_SIZE in the environment). Returns whether a group was set
    up.

    `device` (default cuda) is where the rank's tensors live: on the card
    the rank takes cuda:LOCAL_RANK as its current device, and the backend
    is NCCL; on the CPU it is gloo. Ranks that share a card (more local
    ranks than cards) must ask for `backend="gloo"`, which all-reduces
    CUDA tensors through the host, since NCCL refuses two ranks on one
    device: without it this raises, and it never switches backend on its
    own."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    dev = torch.device("cuda" if device is None else device)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is none of {BACKENDS}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ["WORLD_SIZE"]))
        if cards == 0:
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to train over gloo on the CPU")
        if local_ranks > cards and backend != "gloo":
            raise RuntimeError(
                f"{local_ranks} local ranks share {cards} card(s): NCCL "
                f"takes one rank a card; ask for backend='gloo' "
                f"(FOURDGS_DIST_BACKEND=gloo) to share a card")
        torch.cuda.set_device(local % cards)
        backend = backend or "nccl"
    else:
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA tensors; the CPU takes gloo")
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return True


def host_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """This rank's contiguous slice of a global camera batch: the slice
    of its data coordinate (every rank of a data row takes the same one).
    `global_batch` must be divisible by the mesh's data size (callers
    round the batch size up with `pad_batch_for_hosts`)."""
    n = mesh.shape["data"]
    assert global_batch % n == 0, (global_batch, n)
    per = global_batch // n
    return slice(mesh.data * per, (mesh.data + 1) * per)


def pad_batch_for_hosts(batch: int, mesh: Mesh) -> int:
    """Round a batch size up to a multiple of the mesh's data size."""
    n = mesh.shape["data"]
    return -(-batch // n) * n


def gather_objects(obj, group=None) -> list:
    """Every rank's `obj` (picklable), by rank in `group`; [obj] outside a
    process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def ranks_agree(tensors, group=None) -> tuple[bool, str]:
    """Whether every rank of `group` holds the same bytes in `tensors` (a
    digest of each rank's, gathered): the check that a mesh's ranks kept
    one state. Returns (agree, this rank's digest); one process agrees
    with itself."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    digest = h.hexdigest()
    return len(set(gather_objects(digest, group))) == 1, digest
