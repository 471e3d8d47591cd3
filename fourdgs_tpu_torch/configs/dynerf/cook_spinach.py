_base_ = './default.py'
OptimizationParams = dict(
    batch_size=2,
)
