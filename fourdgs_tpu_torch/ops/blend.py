"""Per-tile alpha-compositing blend, forward
(counterpart: fourdgs_tpu/ops/pallas/blend.py, `_fwd_kernel`, and the XLA
recurrence `_chunk_weights`/`_blend_fwd_scan` of
fourdgs_tpu/ops/rasterize_tiled.py).

`blend_forward` launches the CUDA kernel of csrc/blend_fwd.cu for tensors
on the card, and runs `blend_forward_plain` for tensors on the CPU. It
never swaps one for the other: a CUDA tensor that the kernel cannot take
raises. `blend_forward.launches` counts kernel launches.

Inputs (both versions):
  gidx   (num_tiles, tile_cap) int32, depth-ordered gaussian ids, -1 padded
  counts (num_tiles,) int32, live entries per tile (a prefix of each row)
  table  (N+1, 16) float32 per-gaussian rows
         [pix_x, pix_y, A, B, C, r, g, b, opacity, depth, 0...] with an
         all-zero sentinel row at N (`pack_attr_table`)
Outputs, tile-major: color (num_tiles, P, 3), depth (num_tiles, P) and
final transmittance (num_tiles, P), P = tile_size^2.
"""
from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops.rasterize_ref import ALPHA_MAX, ALPHA_MIN, T_MIN

ATTR_W = 16
_MAX_CHUNK = 1024  # shared memory holds chunk * 48 bytes (< 48 KB)


def pack_attr_table(pix, conic, color, opacity, depth) -> torch.Tensor:
    """(N+1, ATTR_W) per-gaussian packed rows with an all-zero sentinel row
    at N (opacity 0 = no contribution)."""
    n = pix.shape[0]
    table = torch.zeros((n + 1, ATTR_W), dtype=torch.float32,
                        device=pix.device)
    table[:n, 0:2] = pix
    table[:n, 2:5] = conic
    table[:n, 5:8] = color
    table[:n, 8] = opacity
    table[:n, 9] = depth
    return table


def tile_pixel_coords(cfg, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(num_tiles, P) integer pixel x and y coordinates as float32
    (JAX: rasterize_tiled._tile_pixel_coords)."""
    t = cfg.tile_size
    tile = torch.arange(cfg.num_tiles, device=device)
    pix = torch.arange(cfg.pixels_per_tile, device=device)
    px = (tile % cfg.grid_x)[:, None] * t + (pix % t)[None, :]
    py = (tile // cfg.grid_x)[:, None] * t + (pix // t)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def _check_inputs(gidx, counts, table, cfg):
    nt, cap = cfg.num_tiles, cfg.tile_cap
    if gidx.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("gidx and counts must be int32")
    if table.dtype != torch.float32:
        raise TypeError("table must be float32")
    if tuple(gidx.shape) != (nt, cap) or tuple(counts.shape) != (nt,):
        raise ValueError(f"gidx {tuple(gidx.shape)} / counts "
                         f"{tuple(counts.shape)} do not match {nt} tiles x "
                         f"tile_cap {cap}")
    if table.dim() != 2 or table.shape[1] != ATTR_W:
        raise ValueError(f"table must be (N+1, {ATTR_W}), got "
                         f"{tuple(table.shape)}")
    if not (gidx.device == counts.device == table.device):
        raise ValueError("gidx, counts and table must share a device")
    if not (gidx.is_contiguous() and counts.is_contiguous()
            and table.is_contiguous()):
        raise ValueError("gidx, counts and table must be contiguous")
    if cap % cfg.chunk:
        raise ValueError(f"tile_cap {cap} is not a multiple of chunk "
                         f"{cfg.chunk}")


def blend_forward(gidx: torch.Tensor, counts: torch.Tensor,
                  table: torch.Tensor, cfg):
    """Blend every tile. CUDA tensors launch the kernel; CPU tensors run
    the plain version. Returns (color, depth, transmittance)."""
    _check_inputs(gidx, counts, table, cfg)
    if table.device.type == "cpu":
        return blend_forward_plain(gidx, counts, table, cfg)
    if table.device.type != "cuda":
        raise ValueError(f"no blend for device {table.device}")
    ts = cfg.tile_size
    if ts not in (16, 32):
        raise ValueError(f"the blend kernel takes tile_size 16 or 32, got "
                         f"{ts}")
    if not 0 < cfg.chunk <= _MAX_CHUNK:
        raise ValueError(f"chunk {cfg.chunk} outside (0, {_MAX_CHUNK}]")
    if table.data_ptr() % 16:
        raise ValueError("the kernel reads table rows as float4: its data "
                         "must be 16-byte aligned")
    from fourdgs_tpu_torch.ops._build import load_library
    lib = load_library()
    nt, p = cfg.num_tiles, cfg.pixels_per_tile
    with torch.cuda.device(table.device):
        color = torch.empty((nt, p, 3), dtype=torch.float32,
                            device=table.device)
        depth = torch.empty((nt, p), dtype=torch.float32, device=table.device)
        trans = torch.empty((nt, p), dtype=torch.float32, device=table.device)
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.blend_fwd_launch(
            gidx.data_ptr(), counts.data_ptr(), table.data_ptr(),
            table.shape[0] - 1, nt, cfg.tile_cap, cfg.grid_x, ts, cfg.chunk,
            color.data_ptr(), depth.data_ptr(), trans.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    blend_forward.launches += 1
    return color, depth, trans


blend_forward.launches = 0


def blend_forward_plain(gidx: torch.Tensor, counts: torch.Tensor,
                        table: torch.Tensor, cfg):
    """The chunked torch recurrence over the same inputs as the kernel.

    Each step takes `chunk` slots of every tile: an in-chunk exclusive
    cumulative product gives each slot's entering transmittance, and the
    chunk's product carries to the next step. Steps past the fullest
    tile's occupancy are skipped; their padded slots (opacity 0) would add
    nothing.

    Every value that feeds a gate (power, alpha, the entering
    transmittance) is a chain of single float32 operations in a fixed
    order; the kernel computes the same chain with round-to-nearest
    intrinsics, so both take the same gate decisions and differ only in
    the order of the color and depth sums."""
    _check_inputs(gidx, counts, table, cfg)
    nt, p, k = cfg.num_tiles, cfg.pixels_per_tile, cfg.chunk
    dev = table.device
    px, py = tile_pixel_coords(cfg, dev)
    n = table.shape[0] - 1
    idx = torch.where(gidx >= 0, gidx, n).long()
    color = torch.zeros((nt, p, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((nt, p), dtype=torch.float32, device=dev)
    t = torch.ones((nt, p), dtype=torch.float32, device=dev)
    n_live = -(-int(counts.max()) // k) if nt else 0
    for j in range(n_live):
        rows = table[idx[:, j * k:(j + 1) * k]]              # (nt, K, 16)
        dx = rows[:, :, 0:1] - px[:, None, :]                # (nt, K, P)
        dy = rows[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (rows[:, :, 2:3] * dx * dx
                         + rows[:, :, 4:5] * dy * dy)
                 - rows[:, :, 3:4] * dx * dy)
        alpha_u = torch.where(
            power > 0.0, torch.zeros_like(power),
            rows[:, :, 8:9] * torch.exp(torch.clamp(power, max=0.0)))
        alpha = torch.clamp(alpha_u, max=ALPHA_MAX)
        gated = alpha >= ALPHA_MIN
        g = torch.where(gated, alpha, torch.zeros_like(alpha))
        cp = torch.cumprod(1.0 - g, dim=1)
        t_pref = t[:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        use = gated & (t_pref > T_MIN)
        w = torch.where(use, alpha, torch.zeros_like(alpha)) * t_pref
        color += torch.einsum("tkp,tkc->tpc", w, rows[:, :, 5:8])
        depth += (w * rows[:, :, 9:10]).sum(dim=1)
        # The chunk's transmittance product, as K1 takes it: the used
        # slots are a gated prefix, so prod(1 - alpha) over them is the
        # inclusive cumprod at the last used slot, i.e. the masked minimum
        # (1 where nothing is used). This keeps the carried T an exact
        # function of the sequential cumprod, which the CUDA kernel
        # reproduces bit for bit.
        t = t * torch.where(use, cp, torch.ones_like(cp)).amin(dim=1)
    return color, depth, t

