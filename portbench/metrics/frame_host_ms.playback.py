"""frame_host_ms.playback (layer: captured frame; moves frame_p95_ms): as
frame_host_ms.serve, the host milliseconds a traced frame spends in
Renderer.render's own phases (the port's frame.* host spans, the launch
left out), over the frames of a viewer asking at a fixed rate. None where the run traced nothing or the
port has no tracer."""


def read(outcome, run):
    if not outcome.metrics or outcome.metrics.get("trace") is None:
        return None
    try:
        from fourdgs_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.host_ms("frame")
