# sweep: grid LR / 4
_base_ = '../synth_mono.py'
OptimizationParams = dict(
    grid_lr_init=0.0004,
    grid_lr_final=0.000004,
)
