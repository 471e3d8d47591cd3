# sweep: time-plane resolution 16 (vs synth_mono's 75)
_base_ = '../synth_mono.py'
ModelHiddenParams = dict(
    kplanes_config={
        'grid_dimensions': 2, 'input_coordinate_dim': 4,
        'output_coordinate_dim': 32, 'resolution': [64, 64, 64, 16],
    },
)
