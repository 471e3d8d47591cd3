# sweep: 10x time-smoothness + 10x plane TV
_base_ = '../synth_mono.py'
ModelHiddenParams = dict(
    time_smoothness_weight=0.1,
    plane_tv_weight=0.001,
)
