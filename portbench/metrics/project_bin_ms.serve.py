"""project_bin_ms.serve (layer: projection and binner; moves render_fps):
the device milliseconds a traced frame spends projecting the splats and
binning them into tiles (raster.project, raster.bin: the binner's kernels
and its sort), by the marks the port's captured frame writes
(fourdgs_tpu_torch/utils/tracing.py): the device's work between them,
the idle inside the replay apart where the profiler's own records tell
them apart, over the replays the tracer tagged as profiled. None where
the run traced nothing or the port has no tracer."""


def read(outcome, run):
    if not outcome.metrics or outcome.metrics.get("trace") is None:
        return None
    try:
        from fourdgs_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.device_ms("frame", ("raster.project", "raster.bin"))
