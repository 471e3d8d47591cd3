"""Row gather out[i] = table[idx[i]] (counterpart: the four Pallas gathers
of scripts/exp_pallas_gather.py, D1; on the main path, the forward of the
HexPlane's gathers, models/hexplane.py:_GatherRows).

`gather_rows` launches the CUDA kernel of csrc/gather.cu for tensors on
the card and runs `gather_rows_plain` for tensors on the CPU; a CUDA tensor
that the kernel cannot take raises. `gather_rows.launches` counts kernel
launches. The kernel moves 16 bytes a thread, a row's width a template
parameter, so it takes 16-byte aligned tables whose width is a multiple
of 4.
"""
from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops._build import _launch, load_library


def _check(table, idx):
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("table must be float32 and idx int32")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table (R, W) and idx (M,) expected, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.shape[0] < 1:
        raise ValueError("table has no rows")
    if table.device != idx.device:
        raise ValueError("table and idx must share a device")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (R, W) float32, idx (M,) int32 clamped to [0, R - 1] ->
    (M, W) float32. CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {table.device}")
    table, idx = table.contiguous(), idx.contiguous()
    (r, w), m = table.shape, idx.shape[0]
    if w % 4 or table.data_ptr() % 16:
        raise ValueError(f"the gather kernel needs W % 4 == 0 and a 16-byte "
                         f"aligned table (W {w})")
    if m >= 2 ** 31:
        raise ValueError(f"at most 2^31 - 1 indices, got {m}")
    lib = load_library()
    out = table.new_empty((m, w))
    _launch(lib, lib.gather_rows_launch, table, table.data_ptr(),
            idx.data_ptr(), m, w, r, out.data_ptr())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same gather as one `index_select` over the clamped indices."""
    _check(table, idx)
    return torch.index_select(table, 0, idx.clamp(0, table.shape[0] - 1))
