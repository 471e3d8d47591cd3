"""Adaptive density control on a fixed-capacity buffer
(counterpart: fourdgs_tpu/train/densify.py).

Clone and split write into FREE slots, the i-th wanted source taking the
i-th free slot (so that two states can be compared slot by slot); prune
clears `alive`; the Adam moments of written slots are zeroed, which gives
new points fresh moments as the reference's optimizer surgery does.

  clone: grad-norm >= tau and max scale <= percent_dense * extent: copy.
  split: grad-norm >= tau and max scale > percent_dense * extent: two
    samples ~ Normal(0, scale) rotated into the world, scale / 1.6; the
    original slot takes the first sample, a free slot the second (only
    when the second found a slot).
  prune: opacity < min_opacity, optionally screen radius > max_screen_size
    or world scale > 0.1 * extent, while more than min_points are alive.
  opacity reset: opacity <- inverse_sigmoid(min(op, 0.01)), the opacity
    moments zeroed.

Each function takes the state and returns it with new tensors for what it
changed; the gaussian fields stay trainable leaves. The random draws come
from a `torch.Generator` on the state's device, or are injected (the
parity tests pass the JAX package's draws). The functions read no value
to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from fourdgs_tpu_torch.ops import transforms
from fourdgs_tpu_torch.train import optim
from fourdgs_tpu_torch.train.state import TrainState, make_trainable


class DensifyStats(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_dropped: torch.Tensor   # candidates that found no free slot


def _alloc_free_slots(alive: torch.Tensor, want: torch.Tensor):
    """Match the i-th wanted source slot to the i-th free slot. Returns
    (dest, ok): dest[j] is the slot allocated for source j, valid where
    ok; ok = want & (rank < n_free)."""
    cap = alive.shape[0]
    free = ~alive
    n_free = free.sum()
    free_rank = torch.cumsum(free, 0) - 1
    want_rank = torch.cumsum(want, 0) - 1
    idx = torch.arange(cap, device=alive.device)
    # dest_of_rank[r] = index of the r-th free slot; taken slots land on
    # the sacrificial entry `cap`
    dest_of_rank = torch.zeros(cap + 1, dtype=torch.long, device=alive.device)
    dest_of_rank.scatter_(0, torch.where(free, free_rank, cap), idx)
    ok = want & (want_rank < n_free)
    dest = dest_of_rank[torch.clamp(want_rank, 0, cap - 1)]
    return dest, ok


def _set_rows(x: torch.Tensor, dest: torch.Tensor, ok: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """x with x[dest[j]] = src[j] where ok[j] (others dropped into a
    sacrificial row)."""
    cap = x.shape[0]
    out = torch.cat([x.detach(), x.new_zeros((1,) + x.shape[1:])])
    out.index_copy_(0, torch.where(ok, dest, cap), src.detach())
    return out[:cap]


def _scatter_params(gauss: GaussianParams, src: GaussianParams,
                    dest: torch.Tensor, ok: torch.Tensor) -> GaussianParams:
    return GaussianParams(**{
        f: _set_rows(getattr(gauss, f), dest, ok, getattr(src, f))
        for f in FIELDS})


def _mark(cap: int, dest: torch.Tensor, ok: torch.Tensor,
          device) -> torch.Tensor:
    """The (cap,) mask of the slots dest[ok]."""
    m = torch.zeros(cap + 1, dtype=torch.bool, device=device)
    m[torch.where(ok, dest, cap)] = True
    return m[:cap]


@torch.no_grad()
def densify(state: TrainState, grad_threshold: float, percent_dense: float,
            extent: float, max_points: int,
            generator: torch.Generator | None = None,
            noise: tuple[torch.Tensor, torch.Tensor] | None = None
            ) -> tuple[TrainState, DensifyStats]:
    """Clone and split pass. `max_points` caps the growth. The split's two
    standard-normal draws (cap, 3) come from `generator` (on the state's
    device) unless `noise` gives them."""
    gauss: GaussianParams = state.params["gauss"]
    cap = state.capacity
    dev = state.alive.device
    alive = state.alive
    grads = torch.where(state.denom > 0,
                        state.xyz_gradient_accum
                        / torch.clamp(state.denom, min=1), 0.0)
    grads = torch.nan_to_num(grads)
    scales = transforms.safe_exp_scales(gauss.scaling)
    max_scale = scales.amax(dim=1)
    over = grads >= grad_threshold
    small = max_scale <= percent_dense * extent
    room = torch.clamp(max_points - alive.sum(), min=0)

    clone_mask = over & small & alive
    split_mask = over & ~small & alive

    # ---- clone: copy into free slots ----
    dest_c, ok_c = _alloc_free_slots(alive, clone_mask)
    new_rank = torch.cumsum(clone_mask, 0) - 1
    ok_c = ok_c & (new_rank < room)
    new_gauss = _scatter_params(gauss, gauss, dest_c, ok_c)
    written = _mark(cap, dest_c, ok_c, dev)
    alive = alive | written
    n_cloned = ok_c.sum()

    # ---- split: original slot replaced by sample0, free slot gets sample1
    room2 = torch.clamp(room - n_cloned, min=0)
    if noise is None:
        noise = tuple(torch.randn((cap, 3), generator=generator, device=dev)
                      for _ in range(2))
    eps0 = noise[0] * scales
    eps1 = noise[1] * scales
    R = transforms.quat_to_rotmat(gauss.rotation)
    off0 = torch.einsum("nij,nj->ni", R, eps0)
    off1 = torch.einsum("nij,nj->ni", R, eps1)
    # 0.8 * N with N=2, in log space so that no scale turns infinite
    new_scaling = (torch.clamp(gauss.scaling, max=transforms.SCALE_LOG_MAX)
                   - math.log(1.6))

    split_rank = torch.cumsum(split_mask, 0) - 1
    dest_s, ok_s = _alloc_free_slots(alive, split_mask)
    ok_s = ok_s & (split_rank < room2)

    # sample 0 overwrites the original slot, only where the split found a
    # slot for its second sample
    sm = (split_mask & ok_s)[:, None]
    new_gauss.xyz = torch.where(sm, gauss.xyz + off0, new_gauss.xyz)
    new_gauss.scaling = torch.where(sm, new_scaling, new_gauss.scaling)
    src = GaussianParams(**{f: getattr(gauss, f) for f in FIELDS})
    src.xyz = gauss.xyz + off1
    src.scaling = new_scaling
    new_gauss = _scatter_params(new_gauss, src, dest_s, ok_s)
    split_to = _mark(cap, dest_s, ok_s, dev)
    alive = alive | split_to
    written = written | (split_mask & ok_s) | split_to
    n_split = ok_s.sum()

    optim.reset_moments_for_slots(state.opt_state, written)
    stats = DensifyStats(
        n_cloned=n_cloned, n_split=n_split,
        n_dropped=(clone_mask.sum() - n_cloned) + (split_mask.sum() - n_split))
    state.params["gauss"] = make_trainable(new_gauss)
    state.alive = alive
    state.xyz_gradient_accum = torch.zeros((cap,), device=dev)
    state.denom = torch.zeros((cap,), device=dev)
    state.max_radii2d = torch.zeros((cap,), device=dev)
    return state, stats


@torch.no_grad()
def prune(state: TrainState, min_opacity: float, extent: float,
          max_screen_size: int | None, min_points: int) -> TrainState:
    """Clear `alive` for transparent (and, with max_screen_size, too big)
    gaussians, while more than min_points are alive."""
    gauss: GaussianParams = state.params["gauss"]
    opacity = torch.sigmoid(gauss.opacity[:, 0])
    mask = opacity < min_opacity
    if max_screen_size:
        big_vs = state.max_radii2d > max_screen_size
        big_ws = torch.exp(gauss.scaling).amax(dim=1) > 0.1 * extent
        mask = mask | big_vs | big_ws
    mask = mask & state.alive
    do_prune = state.alive.sum() > min_points
    state.alive = torch.where(do_prune, state.alive & ~mask, state.alive)
    return state


@torch.no_grad()
def grow(state: TrainState, displacement_scale: float = 1.0,
         quantile: float = 0.8, max_points: int = 360_000,
         generator: torch.Generator | None = None,
         noise: torch.Tensor | None = None) -> tuple[TrainState, torch.Tensor]:
    """Density-based growing (`add_point`): copies of sparse-region points
    with a KNN-scaled displacement into free slots; appearance copied,
    moments of the new slots reset. `noise` (cap, 3) standard normal is
    drawn from `generator` unless given."""
    from fourdgs_tpu_torch.utils.point_grow import grow_points

    gauss: GaussianParams = state.params["gauss"]
    cap = state.capacity
    mask, new_xyz = grow_points(gauss.xyz.detach(), displacement_scale,
                                quantile=quantile, generator=generator,
                                noise=noise)
    mask = mask & state.alive
    room = torch.clamp(max_points - state.alive.sum(), min=0)
    dest, ok = _alloc_free_slots(state.alive, mask)
    ok = ok & ((torch.cumsum(mask, 0) - 1) < room)
    src = GaussianParams(**{f: getattr(gauss, f) for f in FIELDS})
    src.xyz = new_xyz
    new_gauss = _scatter_params(gauss, src, dest, ok)
    written = _mark(cap, dest, ok, state.alive.device)
    optim.reset_moments_for_slots(state.opt_state, written)
    state.params["gauss"] = make_trainable(new_gauss)
    state.alive = state.alive | written
    return state, ok.sum()


@torch.no_grad()
def reset_opacity(state: TrainState) -> TrainState:
    gauss: GaussianParams = state.params["gauss"]
    op = torch.sigmoid(gauss.opacity)
    new_op = transforms.inverse_sigmoid(torch.clamp(op, max=0.01))
    gauss.opacity.copy_(torch.where(state.alive[:, None], new_op,
                                    gauss.opacity))
    optim.reset_moments_for_slots(
        state.opt_state, torch.ones((state.capacity,), dtype=torch.bool,
                                    device=state.alive.device),
        group="opacity")
    return state
