# Synthetic monocular benchmark (data/synth_mono: one spiral view per
# timestamp, 150 train / 20 test, 400x400) — the D-NeRF protocol of the
# reference's headline benchmark (ref README.md:37). Time resolution
# follows the reference's half-the-frames guidance (150 -> 75, the same
# value as ref arguments/dnerf/bouncingballs.py:8).
_base_ = './dnerf_default.py'

ModelHiddenParams = dict(
    kplanes_config={
        'grid_dimensions': 2,
        'input_coordinate_dim': 4,
        'output_coordinate_dim': 32,
        'resolution': [64, 64, 64, 75],
    },
    # soft delta saturation (stability guard beyond the reference; see
    # models/deformation.py): world / log-scale / quat units
    deform_dx_bound=2.0,
    deform_ds_bound=1.0,
    deform_dr_bound=1.0,
)

RasterParams = dict(
    min_bucket=32768,
)
