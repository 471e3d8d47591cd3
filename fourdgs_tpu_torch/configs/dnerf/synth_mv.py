# Synthetic multi-view benchmark scene (data/synth_mv: 5 cams x 30 times,
# 400x400, held-out test cameras). D-NeRF-style schedule; the time-plane
# resolution follows the reference's guidance of ~half the dynamic frame
# count (ref arguments/__init__.py:92 — 30 timestamps -> 16).
_base_ = './dnerf_default.py'

ModelHiddenParams = dict(
    kplanes_config={
        'grid_dimensions': 2,
        'input_coordinate_dim': 4,
        'output_coordinate_dim': 32,
        'resolution': [64, 64, 64, 16],
    },
    # soft delta saturation: without it the fine stage on this scene hits
    # the white-collapse runaway (see PLAN.md / ab sweep logs)
    deform_dx_bound=2.0,
    deform_ds_bound=1.0,
    deform_dr_bound=1.0,
)

RasterParams = dict(
    # one coarse bucket + at most two fine buckets: few step recompiles
    min_bucket=32768,
)
