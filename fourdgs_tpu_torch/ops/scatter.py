"""Row scatter-add and scalar scatter-set
(counterpart: fourdgs_tpu/ops/pallas/scatter.py, `scatter_add_rows` and
`scatter_set_scalars`).

`scatter_add_rows` launches the CUDA kernel of csrc/scatter.cu (K4) for
tensors on the card and runs `scatter_add_rows_plain` for tensors on the
CPU; `scatter_set_scalars` does the same with K5 and
`scatter_set_scalars_plain`. Neither swaps one for the other: a CUDA tensor
that a kernel cannot take raises. `.launches` on each wrapper counts kernel
launches.

K4 sums each run of consecutive rows with one index before its atomics,
and adds up to four floats per atomic; K5 moves four elements per 16-byte
load. Each launch function fills its output on the stream itself, so a
wrapper allocates with `new_empty` and makes one ctypes call
(`_build._launch`); the library, once loaded, comes back without a CUDA
query.

They run behind the JAX package's switches, read at call time:
  * K4 reduces the per-slot blend backward (K3) per gaussian under
    FOURDGS_PALLAS_GRAD_SCATTER (ops/blend.py), and is the HexPlane gather
    backward under FOURDGS_HEX_BWD=pallas (models/hexplane.py);
  * K5 is the binner's `gidx` scatter under FOURDGS_BIN_SCATTER=pallas
    (ops/rasterize_tiled.py).
"""
from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops._build import _launch, load_library


def _check_rows(idx, rows, n_out):
    if idx.dtype != torch.int32 or rows.dtype != torch.float32:
        raise TypeError("idx must be int32 and rows float32")
    if idx.dim() != 1 or rows.dim() != 2 or rows.shape[0] != idx.shape[0]:
        raise ValueError(f"idx (M,) and rows (M, W) expected, got "
                         f"{tuple(idx.shape)} and {tuple(rows.shape)}")
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    if idx.device != rows.device:
        raise ValueError("idx and rows must share a device")


def scatter_add_rows(idx: torch.Tensor, rows: torch.Tensor, *,
                     n_out: int) -> torch.Tensor:
    """sum rows[i] into out[idx[i]]: idx (M,) int32, clamped to
    [0, n_out - 1], rows (M, W) float32 -> (n_out, W) float32. CUDA tensors
    launch K4 (atomics: the float order changes from run to run); CPU
    tensors run the plain version."""
    _check_rows(idx, rows, n_out)
    if not rows.is_cuda:
        if rows.device.type == "cpu":
            return scatter_add_rows_plain(idx, rows, n_out=n_out)
        raise ValueError(f"no scatter kernel for device {rows.device}")
    lib = load_library()
    idx, rows = idx.contiguous(), rows.contiguous()
    m, w = rows.shape
    out = rows.new_empty((n_out, w))    # zero-filled by the launch
    _launch(lib, lib.scatter_add_rows_launch, rows, idx.data_ptr(),
            rows.data_ptr(), m, w, n_out, out.data_ptr())
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


def scatter_add_rows_plain(idx: torch.Tensor, rows: torch.Tensor, *,
                           n_out: int) -> torch.Tensor:
    """The same sum as one `index_add_` over the clamped indices."""
    _check_rows(idx, rows, n_out)
    out = torch.zeros((n_out, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, idx.clamp(0, n_out - 1).long(), rows)


def _check_scalars(idx, val, n_out):
    if idx.dtype != torch.int32 or val.dtype != torch.int32:
        raise TypeError("idx and val must be int32")
    if idx.dim() != 1 or idx.shape != val.shape:
        raise ValueError(f"idx and val must be (M,), got {tuple(idx.shape)} "
                         f"and {tuple(val.shape)}")
    if idx.device != val.device:
        raise ValueError("idx and val must share a device")


def scatter_set_scalars(idx: torch.Tensor, val: torch.Tensor, *,
                        n_out: int) -> torch.Tensor:
    """out[idx[i]] = val[i] for unique in-range indices -> (n_out,) int32,
    -1 where nothing was written; an index at or past n_out (or below 0)
    is dropped. CUDA tensors launch K5; CPU tensors run the plain
    version."""
    _check_scalars(idx, val, n_out)
    if not idx.is_cuda:
        if idx.device.type == "cpu":
            return scatter_set_scalars_plain(idx, val, n_out=n_out)
        raise ValueError(f"no scatter kernel for device {idx.device}")
    lib = load_library()
    idx, val = idx.contiguous(), val.contiguous()
    out = idx.new_empty(n_out)          # filled with -1 by the launch
    _launch(lib, lib.scatter_set_scalars_launch, idx, idx.data_ptr(),
            val.data_ptr(), idx.shape[0], n_out, out.data_ptr())
    scatter_set_scalars.launches += 1
    return out


scatter_set_scalars.launches = 0


def scatter_set_scalars_plain(idx: torch.Tensor, val: torch.Tensor, *,
                              n_out: int) -> torch.Tensor:
    """The same as indexed assignment into a -1 buffer with a sacrificial
    last slot."""
    _check_scalars(idx, val, n_out)
    out = torch.full((n_out + 1,), -1, dtype=torch.int32, device=idx.device)
    safe = torch.where((idx < 0) | (idx > n_out), n_out, idx)
    out[safe.long()] = val
    return out[:n_out]
