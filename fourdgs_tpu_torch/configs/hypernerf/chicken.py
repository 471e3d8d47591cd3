_base_ = 'default.py'
# NOTE: the reference puts this kplanes override under ModelParams, which
# its merge silently ignores (kplanes_config is a ModelHiddenParams field);
# behavior preserved for parity (ref arguments/hypernerf/chicken.py).
ModelParams = dict(
    kplanes_config={
        'grid_dimensions': 2,
        'input_coordinate_dim': 4,
        'output_coordinate_dim': 16,
        'resolution': [64, 64, 64, 80],
    },
)
OptimizationParams = dict()
