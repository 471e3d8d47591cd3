"""Per-tile alpha-compositing blend, forward and backward
(counterpart: fourdgs_tpu/ops/pallas/blend.py, `_fwd_kernel`,
`_bwd_fused_kernel` and `_bwd_kernel`, and the XLA recurrence and custom
VJP `_chunk_weights`/`_blend_fwd_scan`/`_make_blend` of
fourdgs_tpu/ops/rasterize_tiled.py).

`blend_forward` launches the CUDA kernel of csrc/blend_fwd.cu (K1) for
tensors on the card, and runs `blend_forward_plain` for tensors on the
CPU; `blend_backward` does the same with csrc/blend_bwd.cu (K2) and
`blend_backward_plain`, and `blend_backward_slots` (the per-slot table,
unreduced) with the per-slot build of the same kernel (K3) and
`blend_backward_slots_plain`. None swaps one for the other: a CUDA tensor
that a kernel cannot take raises. `.launches` on each wrapper counts
kernel launches. `blend` is the differentiable blend (the role of the JAX
package's custom VJP) over them; its backward takes K2, or K3 and a
per-gaussian reduction under the JAX package's switches
(`_Blend.backward`, `reduce_slots`: K4, or the reassociated reduction
over the binner's slot runs).

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

A band of a tile-sharded render (parallel/sharded.py) passes `tile0`: its
lists are those of the nt = gidx.shape[0] global tiles [tile0, tile0 + nt)
of cfg's grid, and every array above has nt rows in place of num_tiles.
The kernels take their pixel coordinates from the global tile and read and
write everything else at the band-local one; tile0 = 0 with nt = num_tiles
is the whole image.
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
# K2's and K3's: a ring of rows and a double buffer of four warps' partial
# rows, chunk x 416 bytes (208 KB at chunk 512), and the staged slot list
# as K1's
_MAX_CHUNK_BWD = 512


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


def tile_pixel_coords(cfg, device, tile0: int = 0,
                      nt: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(nt, P) integer pixel x and y coordinates as float32 of the global
    tiles [tile0, tile0 + nt), by default every tile (JAX:
    rasterize_tiled._tile_pixel_coords, which the sharded step slices)."""
    t = cfg.tile_size
    nt = cfg.num_tiles - tile0 if nt is None else nt
    tile = torch.arange(tile0, tile0 + nt, device=device)
    pix = torch.arange(cfg.pixels_per_tile, device=device)
    px = (tile % cfg.grid_x)[:, None] * t + (pix % t)[None, :]
    py = (tile // cfg.grid_x)[:, None] * t + (pix // t)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def _check_inputs(gidx, counts, table, cfg, tile0=0) -> int:
    """Check the lists and the table; returns nt, the lists' tiles."""
    cap = cfg.tile_cap
    if gidx.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("gidx and counts must be int32")
    if table.dtype != torch.float32:
        raise TypeError("table must be float32")
    nt = gidx.shape[0] if gidx.dim() == 2 else -1
    if (nt < 0 or gidx.shape[1] != cap or tuple(counts.shape) != (nt,)
            or not 0 <= tile0 <= tile0 + nt <= cfg.num_tiles):
        raise ValueError(f"gidx {tuple(gidx.shape)} / counts "
                         f"{tuple(counts.shape)} from tile {tile0} do not "
                         f"match {cfg.num_tiles} tiles x tile_cap {cap}")
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
    return nt


def _check_outputs(table, color, depth, trans, cfg, what, nt):
    p = cfg.pixels_per_tile
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


def _list_len(cfg) -> int:
    """The slots the kernels stage at a time: the whole list up to
    _LIST_SLOTS, a multiple of the chunk."""
    return min(cfg.tile_cap, _LIST_SLOTS // cfg.chunk * cfg.chunk)


def _check_tally(tally, table, plain_refuses: str):
    """A counting build's tally: a (3,) int64 tensor on the table's card;
    a CPU table runs the plain version, which counts nothing."""
    if tally is None:
        return
    if (tally.dtype != torch.int64 or tally.shape != (3,)
            or tally.device != table.device):
        raise ValueError("tally must be a (3,) int64 tensor on the table's "
                         "device")
    if table.device.type == "cpu":
        raise ValueError(plain_refuses)


def blend_forward(gidx: torch.Tensor, counts: torch.Tensor,
                  table: torch.Tensor, cfg, tile0: int = 0):
    """Blend every tile of the lists (global tiles from `tile0`). CUDA
    tensors launch the kernel; CPU tensors run the plain version. Returns
    (color, depth, transmittance)."""
    nt = _check_inputs(gidx, counts, table, cfg, tile0)
    if table.device.type == "cpu":
        return blend_forward_plain(gidx, counts, table, cfg, tile0)
    _check_kernel(table, cfg, _MAX_CHUNK)
    lib = load_library()
    p, k = cfg.pixels_per_tile, cfg.chunk
    list_len = _list_len(cfg)
    color = table.new_empty((nt, p, 3))
    depth = table.new_empty((nt, p))
    trans = table.new_empty((nt, p))
    _launch(lib, lib.blend_fwd_launch, table, gidx.data_ptr(),
            counts.data_ptr(), table.data_ptr(), table.shape[0] - 1, nt,
            tile0, cfg.tile_cap, cfg.grid_x, cfg.tile_size, k, list_len,
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
                        table: torch.Tensor, cfg, tile0: int = 0):
    """The chunked torch recurrence over the same inputs as the kernel.

    Each step takes `chunk` slots of every tile: an in-chunk exclusive
    cumulative product gives each slot's entering transmittance, and the
    chunk's product carries to the next step (`_chunk_math`). Steps past
    the fullest tile's occupancy are skipped; their padded slots (opacity
    0) would add nothing. The kernel differs only in the order of the
    color and depth sums."""
    nt = _check_inputs(gidx, counts, table, cfg, tile0)
    p, k = cfg.pixels_per_tile, cfg.chunk
    dev = table.device
    px, py = tile_pixel_coords(cfg, dev, tile0, nt)
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
                   g_t: torch.Tensor, cfg,
                   tally: torch.Tensor | None = None,
                   tile0: int = 0) -> torch.Tensor:
    """Per-gaussian gradients (N, GRAD_W) of the blend, from its inputs,
    its outputs (color, depth, trans) and their cotangents. CUDA tensors
    launch the kernel, which sums the per-slot gradients into the rows
    with atomics (so the float order varies from run to run); CPU tensors
    run the plain version. `tally`, for measurement: a (3,) int64 tensor
    on the table's card, to which a counting build of the kernel adds the
    float2 atomics it issued, the batches its warps reduced and the chunks
    its blocks walked. `tile0`: the lists' first global tile."""
    nt = _check_inputs(gidx, counts, table, cfg, tile0)
    _check_outputs(table, color, depth, trans, cfg, "output", nt)
    _check_outputs(table, g_color, g_depth, g_t, cfg, "cotangent", nt)
    _check_tally(tally, table, "the plain backward issues no atomics to "
                 "tally")
    if table.device.type == "cpu":
        return blend_backward_plain(gidx, counts, table, color, depth,
                                    trans, g_color, g_depth, g_t, cfg,
                                    tile0)
    _check_kernel(table, cfg, _MAX_CHUNK_BWD)
    lib = load_library()
    n = table.shape[0] - 1
    grads = table.new_empty((n + 1, GRAD_W))    # zero-filled by the launch
    _launch(lib, lib.blend_bwd_launch, table, gidx.data_ptr(),
            counts.data_ptr(), table.data_ptr(), n, nt, tile0,
            cfg.tile_cap, cfg.grid_x, cfg.tile_size, cfg.chunk,
            _list_len(cfg),
            color.data_ptr(), depth.data_ptr(), trans.data_ptr(),
            g_color.data_ptr(), g_depth.data_ptr(), g_t.data_ptr(),
            grads.data_ptr(), None if tally is None else tally.data_ptr())
    blend_backward.launches += 1
    return grads[:n]


blend_backward.launches = 0


def _backward_chunks(gidx, counts, table, color, depth, trans, g_color,
                     g_depth, g_t, cfg, tile0=0):
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
    depth gradients are w g_c and w g_d. The lists are those of global
    tiles from `tile0`."""
    nt, p, k = gidx.shape[0], cfg.pixels_per_tile, cfg.chunk
    dev = table.device
    px, py = tile_pixel_coords(cfg, dev, tile0, nt)
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
                         g_t: torch.Tensor, cfg,
                         tile0: int = 0) -> torch.Tensor:
    """The torch suffix-identity backward (JAX: rasterize_tiled.py
    `_make_blend.blend_bwd`), replaying `_chunk_math` chunk by chunk
    (`_backward_chunks`); the per-gaussian sum is one `index_add_` per
    chunk."""
    _check_inputs(gidx, counts, table, cfg, tile0)
    n, k = table.shape[0] - 1, cfg.chunk
    idx = torch.where(gidx >= 0, gidx, n).long()
    grads = torch.zeros((n + 1, GRAD_W), dtype=torch.float32,
                        device=table.device)
    for j, cols in _backward_chunks(gidx, counts, table, color, depth, trans,
                                    g_color, g_depth, g_t, cfg, tile0):
        grads.index_add_(0, idx[:, j * k:(j + 1) * k].reshape(-1),
                         cols.reshape(-1, GRAD_W))
    return grads[:n]


def blend_backward_slots(gidx: torch.Tensor, counts: torch.Tensor,
                         table: torch.Tensor, color: torch.Tensor,
                         depth: torch.Tensor, trans: torch.Tensor,
                         g_color: torch.Tensor, g_depth: torch.Tensor,
                         g_t: torch.Tensor, cfg,
                         tally: torch.Tensor | None = None,
                         out: torch.Tensor | None = None,
                         tile0: int = 0) -> torch.Tensor:
    """The per-slot gradients (num_tiles, tile_cap, GRAD_W) of the blend,
    unreduced: row (t, s) sums slot s's gradient over tile t's pixels.
    Rows of occupied chunks past the count, and of chunks after a tile
    saturated, are zero; rows past a tile's occupied chunks hold nothing
    defined on the card, and a reduction must send their gidx (-1) to a
    sacrificial row. CUDA tensors launch K3, the per-slot build of K2's
    kernel, whose blocks sum a tile's rows in a fixed order (no atomics:
    the same result from run to run); CPU tensors run the plain version.
    `tally`, for measurement: a (3,) int64 tensor on the table's card, to
    which a counting build adds the float2 stores it issued, the batches
    its warps reduced and the chunks its blocks walked (each block of a
    tile's cluster walks the tile's). `out`, for checks of what the kernel
    leaves unwritten: a contiguous float32 (num_tiles, tile_cap, GRAD_W)
    tensor on the table's device to write into and return. `tile0`: the
    lists' first global tile (the table then has gidx.shape[0] rows of
    tiles)."""
    nt = _check_inputs(gidx, counts, table, cfg, tile0)
    _check_outputs(table, color, depth, trans, cfg, "output", nt)
    _check_outputs(table, g_color, g_depth, g_t, cfg, "cotangent", nt)
    _check_tally(tally, table, "the plain per-slot backward issues no "
                 "stores to tally")
    shape = (nt, cfg.tile_cap, GRAD_W)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.float32
                            or out.device != table.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 {shape} tensor "
                         f"on the table's device")
    if table.device.type == "cpu":
        plain = blend_backward_slots_plain(gidx, counts, table, color, depth,
                                           trans, g_color, g_depth, g_t, cfg,
                                           tile0)
        return plain if out is None else out.copy_(plain)
    _check_kernel(table, cfg, _MAX_CHUNK_BWD)
    lib = load_library()
    slots = table.new_empty(shape) if out is None else out
    _launch(lib, lib.blend_bwd_slots_launch, table, gidx.data_ptr(),
            counts.data_ptr(), table.data_ptr(), table.shape[0] - 1,
            nt, tile0, cfg.tile_cap, cfg.grid_x, cfg.tile_size,
            cfg.chunk, _list_len(cfg), color.data_ptr(), depth.data_ptr(),
            trans.data_ptr(), g_color.data_ptr(), g_depth.data_ptr(),
            g_t.data_ptr(), slots.data_ptr(),
            None if tally is None else tally.data_ptr())
    blend_backward_slots.launches += 1
    return slots


blend_backward_slots.launches = 0


def blend_backward_slots_plain(gidx: torch.Tensor, counts: torch.Tensor,
                               table: torch.Tensor, color: torch.Tensor,
                               depth: torch.Tensor, trans: torch.Tensor,
                               g_color: torch.Tensor, g_depth: torch.Tensor,
                               g_t: torch.Tensor, cfg,
                               tile0: int = 0) -> torch.Tensor:
    """The per-slot table of the plain backward (`_backward_chunks`),
    zeros past each tile's occupancy."""
    nt = _check_inputs(gidx, counts, table, cfg, tile0)
    k = cfg.chunk
    slots = torch.zeros((nt, cfg.tile_cap, GRAD_W),
                        dtype=torch.float32, device=table.device)
    for j, cols in _backward_chunks(gidx, counts, table, color, depth, trans,
                                    g_color, g_depth, g_t, cfg, tile0):
        slots[:, j * k:(j + 1) * k] = cols
    return slots


def reassociates() -> bool:
    """Whether the per-slot backward reduces by reassociation: under
    FOURDGS_PALLAS_NO_FUSED_BWD without FOURDGS_PALLAS_GRAD_SCATTER (JAX:
    blend.py:583-611), read at call time."""
    return bool(os.environ.get("FOURDGS_PALLAS_NO_FUSED_BWD")
                and not os.environ.get("FOURDGS_PALLAS_GRAD_SCATTER"))


def reduce_slots(gidx: torch.Tensor, table: torch.Tensor, n: int,
                 slots=None) -> torch.Tensor:
    """The per-gaussian sum (n, GRAD_W) of a per-slot table, by the JAX
    package's route (blend.py:588-619): K4 (`scatter_add_rows`, -1 slots
    sent to a sacrificial row) under FOURDGS_PALLAS_GRAD_SCATTER; else,
    given the binner's BlendSlots `slots`, the reassociated reduction
    (rasterize_tiled.reassociate_pair_grads, JAX's default); else one
    `index_add_`, as JAX's fallback for callers without a global slot
    space."""
    rows = table.reshape(-1, GRAD_W)
    if os.environ.get("FOURDGS_PALLAS_GRAD_SCATTER"):
        flat = gidx.reshape(-1)
        idx = torch.where(flat >= 0, flat, n).to(torch.int32)
        return scatter_add_rows(idx, rows, n_out=n + 1)[:n]
    if slots is not None:
        from fourdgs_tpu_torch.ops.rasterize_tiled import \
            reassociate_pair_grads
        return reassociate_pair_grads(rows, slots, n)
    flat = gidx.reshape(-1)
    idx = torch.where(flat >= 0, flat, n)
    acc = torch.zeros((n + 1, GRAD_W), dtype=torch.float32,
                      device=table.device)
    return acc.index_add_(0, idx.long(), rows)[:n]


class _Blend(torch.autograd.Function):
    """The differentiable blend over the per-gaussian attributes (JAX:
    the custom VJP of `_make_blend` and Pallas `make_blend`)."""

    @staticmethod
    def forward(ctx, gidx, counts, cfg, slots, tile0, pix, conic, color,
                opacity, depth):
        with record_function("raster.pack"):
            table = pack_attr_table(pix, conic, color, opacity, depth)
        out = blend_forward(gidx, counts, table, cfg, tile0)
        ctx.cfg = cfg
        ctx.slots = slots
        ctx.tile0 = tile0
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
                grads = reduce_slots(
                    gidx, blend_backward_slots(*args, tile0=ctx.tile0),
                    table.shape[0] - 1, ctx.slots)
            else:
                grads = blend_backward(*args, tile0=ctx.tile0)
        return (None, None, None, None, None, grads[:, 0:2], grads[:, 2:5],
                grads[:, 5:8], grads[:, 8], grads[:, 9])


def blend(gidx: torch.Tensor, counts: torch.Tensor, pix: torch.Tensor,
          conic: torch.Tensor, color: torch.Tensor, opacity: torch.Tensor,
          depth: torch.Tensor, cfg, slots=None, tile0: int = 0):
    """Differentiable blend of every tile of the lists (global tiles from
    `tile0`): packs the table, runs `blend_forward`, and `blend_backward`
    in the backward (or the per-slot backward and `reduce_slots`, which
    takes the binner's BlendSlots `slots` where given). gidx and counts
    carry no gradient. Returns (color, depth, transmittance)."""
    return _Blend.apply(gidx, counts, cfg, slots, tile0, pix, conic, color,
                        opacity, depth)
