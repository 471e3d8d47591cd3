_base_ = './default.py'
OptimizationParams = dict()
