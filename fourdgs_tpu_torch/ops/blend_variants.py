"""Four stripped forms of the blend forward's loop, which time what bounds
K1 (counterpart: scripts/profile_kernel_variants.py, `k_dma_only`,
`k_exp_only`, `k_slices` and `k_scans`, D6).

`dma_only`, `exp_only`, `slices` and `scans` launch the CUDA kernel of
csrc/blend_variants.cu with their body for tensors on the card and run
their `_plain` versions for tensors on the CPU; a CUDA tensor that the
kernel cannot take raises. `.launches` on each wrapper counts launches.

attrs (nt, nch * chunk, 16) float32 and px (nt, 1, P) or (nt, P) float32
give out shaped like px: for tile t and pixel p, a sum over the nch chunks
of `chunk` rows a of attrs[t] of
  dma_only  a[0][0] * px                  (the chunk's first row only)
  exp_only  sum_r exp(-0.5 x_r^2),  x_r = a[r][0] - px
  slices    sum_r (a[r][0] - px + sum_{i=1..9} a[r][i] px)
  scans     sum_r (P1_r + P2_r), the inclusive prefix products over the
            chunk's rows of (1 - 0.001 x_r) and (1 - 0.002 x_r),
            x_r = a[r][0] px
"""
from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops import launches

ATTR_W = 16
CHUNK = 32           # csrc/blend_variants.cu: kRows
BODIES = ("dma_only", "exp_only", "slices", "scans")
_TILES_PER_STEP = 64  # the plain versions' temporaries: 64 x nch x chunk x P


def _check(attrs, px, chunk):
    if attrs.dtype != torch.float32 or px.dtype != torch.float32:
        raise TypeError("attrs and px must be float32")
    if attrs.dim() != 3 or attrs.shape[2] != ATTR_W or \
            attrs.shape[1] % chunk or px.dim() not in (2, 3) or \
            px.shape[0] != attrs.shape[0] or \
            (px.dim() == 3 and px.shape[1] != 1):
        raise ValueError(f"attrs (nt, nch * {chunk}, {ATTR_W}) and px "
                         f"(nt, 1, P) or (nt, P) expected, got "
                         f"{tuple(attrs.shape)} and {tuple(px.shape)}")
    if attrs.device != px.device:
        raise ValueError("attrs and px must share a device")


def _run(wrapper, plain, attrs, px, chunk):
    _check(attrs, px, chunk)
    if attrs.device.type == "cpu":
        return plain(attrs, px, chunk=chunk)
    if attrs.device.type != "cuda":
        raise ValueError(f"no blend-variant kernel for device "
                         f"{attrs.device}")
    n_pix = px.shape[-1]
    if chunk != CHUNK or not 1 <= n_pix <= 1024:
        raise ValueError(f"the kernel takes chunk {CHUNK} and 1..1024 pixels "
                         f"a tile, got chunk {chunk}, {n_pix} pixels")
    attrs, px = attrs.contiguous(), px.contiguous()
    if attrs.data_ptr() % 16:
        raise ValueError("the kernel reads attrs with 16-byte copies: its data "
                         "must be 16-byte aligned")
    from fourdgs_tpu_torch.ops._build import _launch, load_library
    lib = load_library()
    out = torch.empty_like(px)
    _launch(lib, lib.blend_variant_launch, attrs,
            BODIES.index(wrapper.__name__), attrs.data_ptr(), px.data_ptr(),
            attrs.shape[0], attrs.shape[1] // chunk, n_pix, out.data_ptr())
    launches.count(wrapper)
    return out


def _plain(body, attrs, px, chunk):
    """Tiles a step at a time: a[t, j, r, i] the chunks' rows and x the
    pixels (tiles, 1, 1, P); the chunk sums, then their sum."""
    _check(attrs, px, chunk)
    nt, rows, _ = attrs.shape
    nch = rows // chunk
    flat = px.reshape(nt, -1)
    out = torch.empty_like(flat)
    for lo in range(0, nt, _TILES_PER_STEP):
        hi = min(lo + _TILES_PER_STEP, nt)
        a = attrs[lo:hi].reshape(hi - lo, nch, chunk, ATTR_W)[..., None]
        x = flat[lo:hi][:, None, None, :]
        if body == "dma_only":
            out[lo:hi] = (a[:, :, 0, 0] * x[:, :, 0]).sum(1)
            continue
        if body == "exp_only":
            d = a[:, :, :, 0] - x
            terms = torch.exp(-0.5 * d * d)
        elif body == "slices":
            terms = a[:, :, :, 0] - x
            for i in range(1, 10):
                terms = terms + a[:, :, :, i] * x
        else:
            v = a[:, :, :, 0] * x
            terms = torch.cumprod(1.0 - 0.001 * v, dim=2) \
                + torch.cumprod(1.0 - 0.002 * v, dim=2)
        out[lo:hi] = terms.sum(2).sum(1)
    return out.reshape(px.shape)


def dma_only(attrs: torch.Tensor, px: torch.Tensor, *,
             chunk: int = CHUNK) -> torch.Tensor:
    """Each chunk's first row times px, summed: the attributes' movement
    and little else."""
    return _run(dma_only, dma_only_plain, attrs, px, chunk)


def dma_only_plain(attrs, px, *, chunk: int = CHUNK) -> torch.Tensor:
    return _plain("dma_only", attrs, px, chunk)


def exp_only(attrs: torch.Tensor, px: torch.Tensor, *,
             chunk: int = CHUNK) -> torch.Tensor:
    """One attribute slice and an exp per pixel x row."""
    return _run(exp_only, exp_only_plain, attrs, px, chunk)


def exp_only_plain(attrs, px, *, chunk: int = CHUNK) -> torch.Tensor:
    return _plain("exp_only", attrs, px, chunk)


def slices(attrs: torch.Tensor, px: torch.Tensor, *,
           chunk: int = CHUNK) -> torch.Tensor:
    """Ten attribute slices per pixel x row, no exp, no scans."""
    return _run(slices, slices_plain, attrs, px, chunk)


def slices_plain(attrs, px, *, chunk: int = CHUNK) -> torch.Tensor:
    return _plain("slices", attrs, px, chunk)


def scans(attrs: torch.Tensor, px: torch.Tensor, *,
          chunk: int = CHUNK) -> torch.Tensor:
    """Two prefix products over each chunk's rows per pixel."""
    return _run(scans, scans_plain, attrs, px, chunk)


def scans_plain(attrs, px, *, chunk: int = CHUNK) -> torch.Tensor:
    return _plain("scans", attrs, px, chunk)


for _fn in (dma_only, exp_only, slices, scans):
    _fn.launches = 0
