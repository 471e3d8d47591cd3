"""step_host_ms.train (layer: step; moves train_rays_per_s): the host
milliseconds a traced step spends in StepPrograms.run's own phases, the
sum of the port's host spans step.bind, .inputs and .outputs
(fourdgs_tpu_torch/utils/tracing.py:host_ms; the launch is left out: under
the profiler it is CUPTI's cost of each kernel of the graph, and the host
waits in it for the device), over the steps the tracer recorded while the
profiler ran. None where the run traced nothing or the port has no tracer."""


def read(outcome, run):
    if not outcome.metrics or outcome.metrics.get("trace") is None:
        return None
    try:
        from fourdgs_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.host_ms("step")
