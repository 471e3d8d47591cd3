"""Per-tile alpha-compositing blend, forward and backward
(counterpart: fourdgs_tpu/ops/pallas/blend.py, `_fwd_kernel`,
`_bwd_fused_kernel` and `_bwd_kernel`, and the XLA recurrence and custom
VJP `_chunk_weights`/`_blend_fwd_scan`/`_make_blend` of
fourdgs_tpu/ops/rasterize_tiled.py).

`blend_forward` launches the CUDA kernel of csrc/blend_fwd.cu (K1) for
tensors on the card, and runs `blend_forward_plain` for tensors on the
CPU; `blend_backward` does the same with csrc/blend_bwd.cu (K2) and
`blend_backward_plain`, and `blend_backward_slots` (the per-slot table,
unreduced) with csrc/blend_bwd_slots.cu (K3) and
`blend_backward_slots_plain`. None swaps one for the other: a CUDA tensor
that a kernel cannot take raises. `.launches` on each wrapper counts
kernel launches. `blend` is the differentiable blend (the role of the JAX
package's custom VJP) over them; its backward takes K2, or K3 and a
per-gaussian reduction under the JAX package's switches
(`_Blend.backward`).

Inputs (every version):
  gidx   (num_tiles, tile_cap) int32, depth-ordered gaussian ids, -1 padded
  counts (num_tiles,) int32, live entries per tile (a prefix of each row)
  table  (N+1, 16) float32 per-gaussian rows
         [pix_x, pix_y, A, B, C, r, g, b, opacity, depth, 0...] with an
         all-zero sentinel row at N (`pack_attr_table`)
Forward outputs, tile-major: color (num_tiles, P, 3), depth (num_tiles, P)
and final transmittance (num_tiles, P), P = tile_size^2. The backward takes
those and their cotangents and returns the (N, 10) per-gaussian gradient
rows [pix(2), conic(3), color(3), opacity, depth].
"""
from __future__ import annotations

import os

import torch
from torch.profiler import record_function

from fourdgs_tpu_torch.ops._build import _launch, load_library
from fourdgs_tpu_torch.ops.rasterize_ref import ALPHA_MAX, ALPHA_MIN, T_MIN
from fourdgs_tpu_torch.ops.scatter import scatter_add_rows

ATTR_W = 16
GRAD_W = 10        # [pix(2), conic(3), color(3), opacity, depth]
# K1's shared memory: a ring of 2 x chunk x 48 bytes of rows (96 KB at
# chunk 1024) and the staged slot list, at most _LIST_SLOTS ids (16 KB)
_MAX_CHUNK = 1024
_LIST_SLOTS = 4096
_MAX_CHUNK_BWD = 512  # K2's holds chunk * (48 + 40) bytes (< 48 KB)
_MAX_SMEM = 232_448   # the dynamic shared memory a block can take (K3)


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


def _check_outputs(table, color, depth, trans, cfg, what):
    nt, p = cfg.num_tiles, cfg.pixels_per_tile
    for name, x, shape in (("color", color, (nt, p, 3)),
                           ("depth", depth, (nt, p)), ("t", trans, (nt, p))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{what} {name} must be float32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != table.device or not x.is_contiguous():
            raise ValueError(f"{what} {name} must be contiguous on the "
                             f"table's device")


def _check_kernel(table, cfg, max_chunk):
    """What the CUDA kernels take beyond the plain versions."""
    if table.device.type != "cuda":
        raise ValueError(f"no blend for device {table.device}")
    ts = cfg.tile_size
    if ts not in (16, 32):
        raise ValueError(f"the blend kernels take tile_size 16 or 32, got "
                         f"{ts}")
    if not 0 < cfg.chunk <= max_chunk:
        raise ValueError(f"chunk {cfg.chunk} outside (0, {max_chunk}]")
    if table.data_ptr() % 16:
        raise ValueError("the kernels read table rows as float4: its data "
                         "must be 16-byte aligned")


def blend_forward(gidx: torch.Tensor, counts: torch.Tensor,
                  table: torch.Tensor, cfg):
    """Blend every tile. CUDA tensors launch the kernel; CPU tensors run
    the plain version. Returns (color, depth, transmittance)."""
    _check_inputs(gidx, counts, table, cfg)
    if table.device.type == "cpu":
        return blend_forward_plain(gidx, counts, table, cfg)
    _check_kernel(table, cfg, _MAX_CHUNK)
    lib = load_library()
    nt, p, k = cfg.num_tiles, cfg.pixels_per_tile, cfg.chunk
    # the slots staged at a time: the whole list up to _LIST_SLOTS
    list_len = min(cfg.tile_cap, _LIST_SLOTS // k * k)
    color = table.new_empty((nt, p, 3))
    depth = table.new_empty((nt, p))
    trans = table.new_empty((nt, p))
    _launch(lib, lib.blend_fwd_launch, table, gidx.data_ptr(),
            counts.data_ptr(), table.data_ptr(), table.shape[0] - 1, nt,
            cfg.tile_cap, cfg.grid_x, cfg.tile_size, k, list_len,
            color.data_ptr(), depth.data_ptr(), trans.data_ptr())
    blend_forward.launches += 1
    return color, depth, trans


blend_forward.launches = 0


def _chunk_math(rows, px, py, t):
    """The forward recurrence over one chunk of every tile: rows
    (nt, K, 16), px/py and the entering transmittance t (nt, P). Returns
    (dx, dy, alpha_u, alpha, use, t_pref, w, t_next), the per-slot values
    (nt, K, P) and the transmittance carried to the next chunk (nt, P).

    Every value that feeds a gate (power, alpha, the entering
    transmittance) is a chain of single float32 operations in a fixed
    order; the kernels compute the same chain with round-to-nearest
    intrinsics, so all versions take the same gate decisions."""
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
    # The chunk's transmittance product, as the kernels take it: the used
    # slots are a gated prefix, so prod(1 - alpha) over them is the
    # inclusive cumprod at the last used slot, i.e. the masked minimum
    # (1 where nothing is used). This keeps the carried T an exact
    # function of the sequential cumprod, which the CUDA kernels
    # reproduce bit for bit.
    t_next = t * torch.where(use, cp, torch.ones_like(cp)).amin(dim=1)
    return dx, dy, alpha_u, alpha, use, t_pref, w, t_next


def blend_forward_plain(gidx: torch.Tensor, counts: torch.Tensor,
                        table: torch.Tensor, cfg):
    """The chunked torch recurrence over the same inputs as the kernel.

    Each step takes `chunk` slots of every tile: an in-chunk exclusive
    cumulative product gives each slot's entering transmittance, and the
    chunk's product carries to the next step (`_chunk_math`). Steps past
    the fullest tile's occupancy are skipped; their padded slots (opacity
    0) would add nothing. The kernel differs only in the order of the
    color and depth sums."""
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
        _, _, _, _, _, _, w, t = _chunk_math(rows, px, py, t)
        color += torch.einsum("tkp,tkc->tpc", w, rows[:, :, 5:8])
        depth += (w * rows[:, :, 9:10]).sum(dim=1)
    return color, depth, t


def blend_backward(gidx: torch.Tensor, counts: torch.Tensor,
                   table: torch.Tensor, color: torch.Tensor,
                   depth: torch.Tensor, trans: torch.Tensor,
                   g_color: torch.Tensor, g_depth: torch.Tensor,
                   g_t: torch.Tensor, cfg) -> torch.Tensor:
    """Per-gaussian gradients (N, GRAD_W) of the blend, from its inputs,
    its outputs (color, depth, trans) and their cotangents. CUDA tensors
    launch the kernel, which sums the per-slot gradients into the rows
    with atomics (so the float order varies from run to run); CPU tensors
    run the plain version."""
    _check_inputs(gidx, counts, table, cfg)
    _check_outputs(table, color, depth, trans, cfg, "output")
    _check_outputs(table, g_color, g_depth, g_t, cfg, "cotangent")
    if table.device.type == "cpu":
        return blend_backward_plain(gidx, counts, table, color, depth,
                                    trans, g_color, g_depth, g_t, cfg)
    _check_kernel(table, cfg, _MAX_CHUNK_BWD)
    from fourdgs_tpu_torch.ops._build import load_library
    lib = load_library()
    n = table.shape[0] - 1
    with torch.cuda.device(table.device):
        grads = torch.zeros((n + 1, GRAD_W), dtype=torch.float32,
                            device=table.device)
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.blend_bwd_launch(
            gidx.data_ptr(), counts.data_ptr(), table.data_ptr(), n,
            cfg.num_tiles, cfg.tile_cap, cfg.grid_x, cfg.tile_size,
            cfg.chunk, color.data_ptr(), depth.data_ptr(), trans.data_ptr(),
            g_color.data_ptr(), g_depth.data_ptr(), g_t.data_ptr(),
            grads.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    blend_backward.launches += 1
    return grads[:n]


blend_backward.launches = 0


def _backward_chunks(gidx, counts, table, color, depth, trans, g_color,
                     g_depth, g_t, cfg):
    """Yield (j, cols) per occupied chunk j of the plain backward: cols
    (nt, chunk, GRAD_W) are the chunk's per-slot gradients summed over
    each tile's pixels.

    With rc = c_final . g_c and rd = d_final * g_d per pixel, and the
    running prefix sums after_cg = sum w (c . g_c), after_dg = sum w z g_d
    over the slots up to and including slot i, the alpha gradient of a
    used slot is
        t_pref (c . g_c + z g_d)
          - (rc - after_cg + rd - after_dg + g_t T_final) / max(1 - a, 0.01)
    (straight through the 0.99 clamp), chained to opacity (alpha_u / op)
    and to the power (da * alpha_u), then to pix and the conic; color and
    depth gradients are w g_c and w g_d."""
    nt, p, k = cfg.num_tiles, cfg.pixels_per_tile, cfg.chunk
    dev = table.device
    px, py = tile_pixel_coords(cfg, dev)
    n = table.shape[0] - 1
    idx = torch.where(gidx >= 0, gidx, n).long()
    rc = (color * g_color).sum(-1)                       # (nt, P)
    rd = depth * g_depth
    rt = g_t * trans
    gc = g_color.permute(0, 2, 1)[:, None]               # (nt, 1, 3, P)
    t = torch.ones((nt, p), dtype=torch.float32, device=dev)
    acc_cg = torch.zeros((nt, p), dtype=torch.float32, device=dev)
    acc_dg = torch.zeros((nt, p), dtype=torch.float32, device=dev)
    n_live = -(-int(counts.max()) // k) if nt else 0
    for j in range(n_live):
        rows = table[idx[:, j * k:(j + 1) * k]]              # (nt, K, 16)
        dx, dy, alpha_u, alpha, use, t_pref, w, t = _chunk_math(
            rows, px, py, t)
        cg = (rows[:, :, 5:6] * gc[:, :, 0] + rows[:, :, 6:7] * gc[:, :, 1]
              + rows[:, :, 7:8] * gc[:, :, 2])               # (nt, K, P)
        dg = rows[:, :, 9:10] * g_depth[:, None, :]
        after_cg = acc_cg[:, None] + torch.cumsum(w * cg, dim=1)
        after_dg = acc_dg[:, None] + torch.cumsum(w * dg, dim=1)
        one_m_a = torch.clamp(1.0 - alpha, min=1.0 - ALPHA_MAX)
        da = torch.where(
            use,
            t_pref * (cg + dg)
            - (rc[:, None] - after_cg + rd[:, None] - after_dg
               + rt[:, None]) / one_m_a,
            torch.zeros_like(alpha))
        op = rows[:, :, 8:9]
        d_op = (da * torch.where(op > 0, alpha_u / torch.clamp(op, min=1e-20),
                                 torch.zeros_like(alpha_u))).sum(-1)
        d_pow = da * alpha_u
        a, b, c = rows[:, :, 2:3], rows[:, :, 3:4], rows[:, :, 4:5]
        yield j, torch.stack([
            (d_pow * -(a * dx + b * dy)).sum(-1),
            (d_pow * -(c * dy + b * dx)).sum(-1),
            (-0.5 * d_pow * dx * dx).sum(-1),
            (-d_pow * dx * dy).sum(-1),
            (-0.5 * d_pow * dy * dy).sum(-1),
            (w * gc[:, :, 0]).sum(-1),
            (w * gc[:, :, 1]).sum(-1),
            (w * gc[:, :, 2]).sum(-1),
            d_op,
            (w * g_depth[:, None, :]).sum(-1)], dim=-1)      # (nt, K, 10)
        acc_cg = after_cg[:, -1]
        acc_dg = after_dg[:, -1]


def blend_backward_plain(gidx: torch.Tensor, counts: torch.Tensor,
                         table: torch.Tensor, color: torch.Tensor,
                         depth: torch.Tensor, trans: torch.Tensor,
                         g_color: torch.Tensor, g_depth: torch.Tensor,
                         g_t: torch.Tensor, cfg) -> torch.Tensor:
    """The torch suffix-identity backward (JAX: rasterize_tiled.py
    `_make_blend.blend_bwd`), replaying `_chunk_math` chunk by chunk
    (`_backward_chunks`); the per-gaussian sum is one `index_add_` per
    chunk."""
    _check_inputs(gidx, counts, table, cfg)
    n, k = table.shape[0] - 1, cfg.chunk
    idx = torch.where(gidx >= 0, gidx, n).long()
    grads = torch.zeros((n + 1, GRAD_W), dtype=torch.float32,
                        device=table.device)
    for j, cols in _backward_chunks(gidx, counts, table, color, depth, trans,
                                    g_color, g_depth, g_t, cfg):
        grads.index_add_(0, idx[:, j * k:(j + 1) * k].reshape(-1),
                         cols.reshape(-1, GRAD_W))
    return grads[:n]


def blend_backward_slots(gidx: torch.Tensor, counts: torch.Tensor,
                         table: torch.Tensor, color: torch.Tensor,
                         depth: torch.Tensor, trans: torch.Tensor,
                         g_color: torch.Tensor, g_depth: torch.Tensor,
                         g_t: torch.Tensor, cfg) -> torch.Tensor:
    """The per-slot gradients (num_tiles, tile_cap, GRAD_W) of the blend,
    unreduced: row (t, s) sums slot s's gradient over tile t's pixels.
    Rows of occupied chunks past the count, and of chunks after a tile
    saturated, are zero; rows past a tile's occupied chunks hold nothing
    defined on the card, and a reduction must send their gidx (-1) to a
    sacrificial row. CUDA tensors launch K3 (no atomics: the same result
    from run to run); CPU tensors run the plain version."""
    _check_inputs(gidx, counts, table, cfg)
    _check_outputs(table, color, depth, trans, cfg, "output")
    _check_outputs(table, g_color, g_depth, g_t, cfg, "cotangent")
    if table.device.type == "cpu":
        return blend_backward_slots_plain(gidx, counts, table, color, depth,
                                          trans, g_color, g_depth, g_t, cfg)
    _check_kernel(table, cfg, cfg.tile_cap)
    from fourdgs_tpu_torch.ops._build import load_library
    lib = load_library()
    smem = lib.blend_bwd_slots_smem(cfg.tile_size, cfg.chunk)
    if smem > _MAX_SMEM:
        raise ValueError(f"chunk {cfg.chunk} needs {smem} bytes of shared "
                         f"memory in blend_bwd_slots (at most {_MAX_SMEM})")
    n = table.shape[0] - 1
    with torch.cuda.device(table.device):
        slots = torch.empty((cfg.num_tiles, cfg.tile_cap, GRAD_W),
                            dtype=torch.float32, device=table.device)
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.blend_bwd_slots_launch(
            gidx.data_ptr(), counts.data_ptr(), table.data_ptr(), n,
            cfg.num_tiles, cfg.tile_cap, cfg.grid_x, cfg.tile_size,
            cfg.chunk, color.data_ptr(), depth.data_ptr(), trans.data_ptr(),
            g_color.data_ptr(), g_depth.data_ptr(), g_t.data_ptr(),
            slots.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd_slots launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    blend_backward_slots.launches += 1
    return slots


blend_backward_slots.launches = 0


def blend_backward_slots_plain(gidx: torch.Tensor, counts: torch.Tensor,
                               table: torch.Tensor, color: torch.Tensor,
                               depth: torch.Tensor, trans: torch.Tensor,
                               g_color: torch.Tensor, g_depth: torch.Tensor,
                               g_t: torch.Tensor, cfg) -> torch.Tensor:
    """The per-slot table of the plain backward (`_backward_chunks`),
    zeros past each tile's occupancy."""
    _check_inputs(gidx, counts, table, cfg)
    k = cfg.chunk
    slots = torch.zeros((cfg.num_tiles, cfg.tile_cap, GRAD_W),
                        dtype=torch.float32, device=table.device)
    for j, cols in _backward_chunks(gidx, counts, table, color, depth, trans,
                                    g_color, g_depth, g_t, cfg):
        slots[:, j * k:(j + 1) * k] = cols
    return slots


def reduce_slots(gidx: torch.Tensor, slots: torch.Tensor,
                 n: int) -> torch.Tensor:
    """The per-gaussian sum (n, GRAD_W) of a per-slot table, with -1 slots
    sent to a sacrificial row (JAX: blend.py:588-619). K4
    (`scatter_add_rows`) under FOURDGS_PALLAS_GRAD_SCATTER, else
    `index_add_`, which stands in for the JAX package's XLA reduction."""
    flat = gidx.reshape(-1)
    idx = torch.where(flat >= 0, flat, n).to(torch.int32)
    rows = slots.reshape(-1, GRAD_W)
    if os.environ.get("FOURDGS_PALLAS_GRAD_SCATTER"):
        return scatter_add_rows(idx, rows, n_out=n + 1)[:n]
    acc = torch.zeros((n + 1, GRAD_W), dtype=torch.float32,
                      device=slots.device)
    return acc.index_add_(0, idx.long(), rows)[:n]


class _Blend(torch.autograd.Function):
    """The differentiable blend over the per-gaussian attributes (JAX:
    the custom VJP of `_make_blend` and Pallas `make_blend`)."""

    @staticmethod
    def forward(ctx, gidx, counts, cfg, pix, conic, color, opacity, depth):
        with record_function("raster.pack"):
            table = pack_attr_table(pix, conic, color, opacity, depth)
        out = blend_forward(gidx, counts, table, cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(gidx, counts, table, *out)
        return out

    @staticmethod
    def backward(ctx, g_color, g_depth, g_t):
        gidx, counts, table, color, depth, trans = ctx.saved_tensors
        args = (gidx, counts, table, color, depth, trans,
                g_color.contiguous(), g_depth.contiguous(), g_t.contiguous(),
                ctx.cfg)
        with record_function("raster.blend_backward"):
            # The JAX package takes its per-slot kernel (K3) when the fused
            # kernel's lane-packed accumulator would not fit 12 MiB of VMEM
            # (blend.py:578-580) or FOURDGS_PALLAS_NO_FUSED_BWD is set. K2's
            # accumulator lives in device memory here (about 5 MB at 131k
            # slots), so only the switch selects K3.
            if os.environ.get("FOURDGS_PALLAS_NO_FUSED_BWD"):
                grads = reduce_slots(gidx, blend_backward_slots(*args),
                                     table.shape[0] - 1)
            else:
                grads = blend_backward(*args)
        return (None, None, None, grads[:, 0:2], grads[:, 2:5],
                grads[:, 5:8], grads[:, 8], grads[:, 9])


def blend(gidx: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor,
          conic: torch.Tensor, color: torch.Tensor, opacity: torch.Tensor,
          depth: torch.Tensor, cfg):
    """Differentiable blend of every tile: packs the table, runs
    `blend_forward`, and `blend_backward` in the backward. gidx and
    counts carry no gradient. Returns (color, depth, transmittance)."""
    return _Blend.apply(gidx, counts, cfg, pix, conic, color, opacity, depth)
