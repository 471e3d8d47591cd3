"""work.py's counts against hand counts at tiny shapes."""
import pytest

from portbench import work
from portbench.core.peaks import FP32_FLOP_S
from portbench.reference.deformation import DeformSpec

SPEC = DeformSpec(resolution=(4, 4, 4, 3), out_dim=2, multires=(1, 2),
                  net_width=3, defor_depth=0)


def test_hexplane_taps_by_hand():
    # per level: 3 spatial planes x 9 + 3 time planes x 3 + 5 products,
    # each per channel (2), two levels
    assert work.hexplane_flops(SPEC) == 2 * (3 * 9 * 2 + 3 * 3 * 2 + 5 * 2)


def test_mlp_by_hand():
    # feature_out 4 -> 3 (feat_dim 2 x 2 levels); heads dx (3), ds (3),
    # dr (4), each Linear(3, 3), ReLU(3), Linear(3, out), a ReLU before
    fo = 2 * 4 * 3
    heads = sum(2 * 3 * 3 + 2 * 3 * out + 2 * 3 for out in (3, 3, 4))
    assert work.mlp_flops(SPEC) == fo + heads


def test_mlp_counts_the_heads_the_config_runs():
    wide = DeformSpec(resolution=(4, 4, 4, 3), out_dim=2, multires=(1, 2),
                      net_width=3, defor_depth=0, no_do=False,
                      no_dshs=False)
    extra = (2 * 9 + 2 * 3 * 1 + 6) + (2 * 9 + 2 * 3 * 48 + 6)
    assert work.mlp_flops(wide) == work.mlp_flops(SPEC) + extra


def test_blend_counts_by_hand():
    assert work.blend_fwd_flops(10, 4) == 10 * 14 + 4 * 9
    assert work.blend_bwd_flops(10, 4) == 10 * 14 + 4 * 30


def test_step_is_three_forwards_plus_blend_adam_and_regularizers():
    n, pixels = 7, 12
    views = [(10, 4), (6, 2)]
    splat = work.splat_flops(SPEC, n)
    want = sum(3 * (splat + 3 * 3 * pixels) + work.blend_fwd_flops(e, c)
               + work.blend_bwd_flops(e, c) for e, c in views)
    want += 11 * (59 * n + work.deform_params(SPEC))
    want += 30 * work.grid_cells(SPEC)
    assert work.step_flops(SPEC, n, views, pixels) == want


def test_grid_cells_by_hand():
    # level 1: three 4x4 planes, three 3x4 time planes; level 2: 8x8 and
    # 3x8, two channels
    assert work.grid_cells(SPEC) == 2 * (3 * 16 + 3 * 12 + 3 * 64 + 3 * 24)


def test_peak_is_the_float32_rate():
    assert FP32_FLOP_S == pytest.approx(66.9e12, rel=1e-3)
    assert work.seconds_at_peak(FP32_FLOP_S) == 1.0
