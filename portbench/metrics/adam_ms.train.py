"""adam_ms.train (layer: optimiser; moves train_rays_per_s): the device
milliseconds a traced step spends in the grouped Adam update, by the
marks the port's captured step writes (fourdgs_tpu_torch/utils/tracing.py,
span train.adam): the device's work between them, the idle inside the
replay apart where the profiler's own records tell them apart, over the
replays the tracer tagged as profiled. None where the run traced nothing
or the port has no tracer."""


def read(outcome, run):
    if not outcome.metrics or outcome.metrics.get("trace") is None:
        return None
    try:
        from fourdgs_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.device_ms("step", ("train.adam",))
