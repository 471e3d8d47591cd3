"""splats_ms.serve (layer: splats; moves render_fps): the device
milliseconds a traced frame spends in the splats' segments
(render.splats, splats.hexplane, splats.heads), by the marks the port's
captured frame writes (fourdgs_tpu_torch/utils/tracing.py): the device's
work between them, the idle inside the replay apart where the profiler's
own records tell them apart, over the replays the tracer tagged as
profiled. None where the run traced nothing or the port has no tracer."""

SPANS = ("render.splats", "splats.hexplane", "splats.heads")


def read(outcome, run):
    if not outcome.metrics or outcome.metrics.get("trace") is None:
        return None
    try:
        from fourdgs_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.device_ms("frame", SPANS)
