"""frame_host_ms.serve (layer: captured frame; moves render_fps): the host
milliseconds a traced frame spends in Renderer.render's own phases, the
sum of the port's host spans frame.camera_in, .key, .inputs and .outputs
(fourdgs_tpu_torch/utils/tracing.py:host_ms; the launch is left out, since
under the profiler it is CUPTI's cost of each kernel of the graph), over
the frames the tracer recorded while the profiler ran. None where the run
traced nothing or the port has no tracer."""


def read(outcome, run):
    if not outcome.metrics or outcome.metrics.get("trace") is None:
        return None
    try:
        from fourdgs_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.host_ms("frame")
