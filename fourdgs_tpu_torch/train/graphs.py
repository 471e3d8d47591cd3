"""Captured programs: the training step and the served frame as CUDA graphs,
recorded once per key and replayed (counterpart: `jax.jit` over
`train_step`, fourdgs_tpu/train/loop.py:87-91, and the jitted render of
scripts/render.py:125).

A key holds what the JAX package makes a static argument: every host value
that the program branches on or sizes a buffer by (the stage, the
capacity, the raster config, `track_stats`, the switches read from the
environment; over a mesh also the SH degree, which JAX's sharded step
takes as static). On a single card the SH degree is a device value, as in
JAX's step: the captured step owns a 0-d degree buffer that each replay
copies in, so the SH ramp captures nothing. A graph bakes in the address
of every tensor it reads and writes, so a captured program reads static
buffers:

  * the served frame (`CapturedFrame`) reads the renderer's tensors in
    place, their identity part of its key, and a static camera into which
    each replay copies the camera asked for;
  * the training step (`CapturedStep`) owns a copy of the training state
    (`StateBuffers`): the gaussian leaves, the deformation, the Adam
    moments and count, the densify statistics, `alive`, `aabb` and `step`;
    and the cameras, targets, background and SH degree it reads.
    Before each replay `StateBuffers.bind` copies in every state tensor
    that is not its buffer (densify, prune, grow, a resize and the NaN
    rollback replace tensors) and points the state at the buffers, so
    that the step's in-place updates land in the caller's state: one
    device copy after a surgery, not a recapture.

A capture warms the program up on a stream of its own (on the buffers,
whose values the first bind overwrites, so the training state is left as
it was), on the training thread frees the allocator's cached blocks
(cudaFree), records the program there into a memory pool of its own
(captures take turns across threads), waits on that stream alone, and
logs its seconds. A capture or a replay that fails
raises; nothing falls back to the eager path. A replay returns copies of
the outputs, which the caller may keep across replays.

The prewarmer (counterpart: JAX's `BucketPrewarmer`, loop.py:249-286 and
its `queue_prewarm`, :436-460) builds a step ahead of its key on a daemon
thread while the training thread replays: `run_stage` decides which key
(`loop.BucketPrewarmer`, JAX's triggers) and `StepPrograms.prewarm`
builds it. The thread enqueues copies of the live state, cut or padded to
the key's capacity, on the training thread's stream (ordered after the
replays already there, with no sync; the values do not matter, since the
first bind replaces them), warms the program up and captures it on its
own stream in thread-local mode (the training thread goes on syncing,
reading to the host and allocating meanwhile, which a global-mode capture
forbids in any thread), and waits on that stream alone. At the key's
switch `StepPrograms.run` takes the program, waiting for its thread if
the capture is still running; a prewarmed key that can no longer come (a
cap changed, the statistics stopped, the bucket moved elsewhere) is
dropped with its pool. A prewarm that runs out of memory empties the
allocator's cache and builds once more (`retried`); one that fails prints
`[prewarm] <key> failed: ...` and is counted, and its key's switch
captures on the training thread. A capture on the training thread that
runs out of memory while prewarms hold or build programs drops them and
captures again, so a prewarm never costs the stage a step. While a prewarm thread lives every capture runs in
thread-local mode. `StepPrograms.close` joins every thread at the stage's
end, so no program outlives it.

The test evaluation (`EvalPrograms`, the counterpart of JAX's jitted
`eval_step`, loop.py:170-178) is a `render/serve.py:Renderer` over copies
of its own of the gaussian fields, `alive`, `aabb`, the deformation and
the background, into which `load` copies the live state once an
evaluation; each view's render then replays the renderer's frame of its
key (the stage, the SH degree, the raster config, the copies' identities,
the blend's implementation and the switches) with the camera copied in.
The copies are remade only at another capacity or deformation config, so
an evaluation after a surgery replays the frames the last one captured.

Over a mesh (parallel/sharded.py) the step and the frame hold NCCL
collectives, and every rank captures and replays its own program in
lockstep: the warm-up runs, the capture and each replay are collective.
So every rank must come to the same key at the same iteration, and a
key may be built only from values that are the same on every rank (the
configuration, and what the stage driver reads after a reduction over
the ranks, as every host decision of `run_stage` does). A key read from
one rank's own values would let that rank capture while the others
replay, and the ranks would wait on each other for ever. Inside a
process group the capture runs in CUDA's thread-local capture mode:
ProcessGroupNCCL's watchdog thread queries the events of earlier
collectives, which a global-mode capture forbids in any thread.

What the programs did is the tracer's (utils/tracing.py). The kernel
wrappers' `.launches` count the kernels the host launched. A capture
records the launches made on its stream per wrapper in its program's
record (`Program.launches`) and not on the wrappers, since nothing ran;
another thread's launches meanwhile count as they run. `kernel_runs()` is
the wrappers' launches plus each record's launches times its replays, by
the wrapper's `__name__`: the kernels that ran. A program's record keeps
its capture seconds, the reserved bytes its capture added (its pool) and
its replays, and outlives the program. A captured frame is the tracer's
root span `frame` and a captured step its `step`: the layers' spans
inside mark the device's time in the graph, and the host's phases of a
replay (`frame.*`, `step.*`) are the tracer's host spans.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import threading
import time
import traceback
from collections.abc import Callable, Sequence
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from fourdgs_tpu_torch.ops import blend, gather, rasterize_tiled, scatter
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
from fourdgs_tpu_torch.train import optim
from fourdgs_tpu_torch.train.state import TrainState
from fourdgs_tpu_torch.utils import tracing

# the environment switches that the step and the frame read at call time,
# with the values that turn on the per-slot path (K3, K4, K5)
SWITCHES_ON = {"FOURDGS_PALLAS_NO_FUSED_BWD": "1",
               "FOURDGS_PALLAS_GRAD_SCATTER": "1",
               "FOURDGS_HEX_BWD": "pallas", "FOURDGS_BIN_SCATTER": "pallas"}
SWITCHES = tuple(SWITCHES_ON)
# eager runs before a capture: the first call of each kernel sets its
# attributes and the libraries' handles, which a capture must not do
WARMUP = 2
# the kernel wrappers whose launches a program records, by `__name__`
WRAPPERS = (blend.blend_forward, blend.blend_backward,
            blend.blend_backward_slots, scatter.scatter_add_rows,
            scatter.scatter_set_scalars, rasterize_tiled.bin_tiles,
            gather.gather_rows)
_CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))


def switches() -> tuple:
    return tuple(os.environ.get(k) for k in SWITCHES)


def kernel_runs() -> dict:
    """Kernels that ran, per wrapper name: host launches plus replayed
    ones."""
    replayed = tracing.replayed_kernels()
    return {w.__name__: w.launches + replayed.get(w.__name__, 0)
            for w in WRAPPERS}


def zero_counts() -> None:
    tracing.zero_counts(WRAPPERS)


def _in_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _copy_out(out):
    """A copy of a program's outputs (a NamedTuple): its tensors cloned."""
    return type(out)(*(x.clone() if isinstance(x, torch.Tensor) else x
                       for x in out))


def _copy_camera(dst: Camera, src: Camera) -> None:
    for f in _CAMERA_FIELDS:
        getattr(dst, f).copy_(getattr(src, f))


def _clone_camera(cam: Camera) -> Camera:
    return Camera(**{f: getattr(cam, f).clone() for f in _CAMERA_FIELDS})


# Process-wide, as CUDA's capture modes and the caching allocator are: one
# capture at a time (`_CAPTURING`), the prewarm threads alive (a capture
# runs in thread-local mode while one is), whether this thread builds in
# the background, and the streams that programs being built hold.
_CAPTURING = threading.Lock()
_THREADS = threading.Lock()
_background = {"threads": 0}
_local = threading.local()
_held_streams: set = set()


@contextlib.contextmanager
def _own_stream():
    """A stream of PyTorch's pool that no other program being built holds
    (the pool hands its streams out in turn, so two programs built at once
    on two threads could draw the same one)."""
    with _THREADS:
        for _ in range(64):
            stream = torch.cuda.Stream()
            if stream.cuda_stream not in _held_streams:
                break
        else:
            raise RuntimeError("every pooled stream is held by a capture")
        _held_streams.add(stream.cuda_stream)
    try:
        yield stream
    finally:
        with _THREADS:
            _held_streams.discard(stream.cuda_stream)


def _in_background() -> bool:
    return getattr(_local, "background", False)


class Program:
    """One CUDA graph of `fn` (no arguments; it reads static buffers) in a
    memory pool of its own, with the outputs its replays write and its
    record in the tracer (`record`: its launches per kernel wrapper, its
    replays, its capture seconds and pool bytes, its marks under the root
    span `root`).

    The warm-up and the capture run on a stream of its own, after what the
    calling thread's stream holds; then that stream alone is waited on. On
    the training thread the caller's stream is also made to wait for it
    (a replay may follow at once); a prewarm thread hands its program over
    only after its wait. Captures take turns (`_CAPTURING`). On the
    training thread each first frees the allocator's cached blocks and the
    pools of freed programs (cudaFree, which waits on the whole device), as
    `torch.cuda.graph` does: while a capture is underway anywhere in the
    process the allocator releases nothing, not even to satisfy an
    allocation, so a capture's pool could otherwise run out of memory
    beside a large cache. A prewarm thread skips that wait
    (`StepPrograms.prewarm` empties the cache only after a build runs out
    of memory)."""

    def __init__(self, key, fn: Callable[[], Any], label: str,
                 warmup: int = WARMUP, root: str = "frame"):
        if not torch.cuda.is_available():
            raise RuntimeError("a captured program needs a CUDA device; "
                               "the CPU path runs eagerly")
        t0 = time.perf_counter()
        background = _in_background()
        ranks = _in_process_group()
        mode = ("thread_local" if ranks or background
                or _background["threads"] else "global")
        caller = torch.cuda.current_stream()
        dev = caller.device
        self.graph = torch.cuda.CUDAGraph()
        self.record = tracing.program(label, root)
        with _own_stream() as side:
            side.wait_stream(caller)
            try:
                with torch.cuda.stream(side):
                    for _ in range(warmup):
                        fn()
                    with _CAPTURING, tracing.capturing(side, root,
                                                       dev) as cap:
                        if not background:
                            torch.cuda.empty_cache()
                        reserved = torch.cuda.memory_reserved(dev)
                        self.graph.capture_begin(capture_error_mode=mode)
                        try:
                            tracing.begin(cap)
                            self.outputs = fn()
                            tracing.end(cap, self.record)
                        finally:
                            self.graph.capture_end()
                        self.record.pool_bytes = (
                            torch.cuda.memory_reserved(dev) - reserved)
            finally:
                if not background:
                    caller.wait_stream(side)
                side.synchronize()
        self.key = key
        self.record.seconds = time.perf_counter() - t0
        if not ranks or dist.get_rank() == 0:
            print(f"[{'prewarm' if background else 'capture'}] {label} "
                  f"captured in {self.seconds:.2f}s "
                  f"(launches {self.launches})", flush=True)

    @property
    def launches(self) -> dict:
        return self.record.launches

    @property
    def replays(self) -> int:
        return self.record.replays

    @property
    def seconds(self) -> float:
        return self.record.seconds

    @property
    def pool_bytes(self) -> int:
        return self.record.pool_bytes

    def replay(self):
        """Launch the graph and return its outputs; `last` is the replay's
        number on the tracer's ring (-1 without marks)."""
        self.last = tracing.replayed(self.record)
        self.graph.replay()
        return self.outputs


class CapturedFrame:
    """A render as a captured program: `render_fn(camera)` over a static
    camera. `inputs` holds what the graph reads in place (the renderer's
    tensors), so that their identities in the key stay theirs."""

    def __init__(self, key, render_fn: Callable[[Camera], Any],
                 camera: Camera, inputs: tuple, label: str):
        self.camera = _clone_camera(camera)
        self.inputs = inputs
        self.program = Program(key, lambda: render_fn(self.camera), label)

    def __call__(self, camera: Camera, host: tracing.HostSpans):
        """The frame at `camera`; `host` laps the camera's copy in, the
        launch and the outputs' copies (`frame.inputs`, `frame.launch`,
        `frame.outputs`)."""
        _copy_camera(self.camera, camera)
        host.lap(tracing.now())
        out = self.program.replay()
        host.lap(tracing.now())
        out = _copy_out(out)
        host.lap(tracing.now())
        host.close(self.program.last)
        return out


class StateBuffers:
    """Static copies of every tensor of a TrainState that the step reads
    or writes, and `bind`, which makes a state use them. With `own` the
    state given is already a copy of its own (`TrainState.to`), and its
    tensors become the buffers."""

    def __init__(self, state: TrainState, own: bool = False):
        self.state = state if own else state.to(state.alive.device)
        self.binds = 0       # binds that copied something in

    @torch.no_grad()
    def bind(self, state: TrainState) -> bool:
        """Copy into the buffers each tensor of `state` that is not its
        buffer, and point `state` at the buffers (new containers, the
        buffers' tensors). Returns whether anything was copied."""
        b = self.state
        if state.capacity != b.capacity:
            raise ValueError(f"a state of capacity {state.capacity} bound "
                             f"to buffers of {b.capacity}")
        copied = False

        def take(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
            nonlocal copied
            if x is not buf:
                if x.shape != buf.shape or x.dtype != buf.dtype:
                    raise ValueError(f"{x.dtype} {tuple(x.shape)} bound to a "
                                     f"{buf.dtype} {tuple(buf.shape)} buffer")
                buf.copy_(x)
                copied = True
            return buf

        def gauss(bg: GaussianParams, g: GaussianParams) -> GaussianParams:
            return GaussianParams(**{f: take(getattr(bg, f), getattr(g, f))
                                     for f in FIELDS})

        def tree(bt: dict, t: dict) -> dict:
            return {"gauss": gauss(bt["gauss"], t["gauss"]),
                    "deform": {k: take(v, t["deform"][k])
                               for k, v in bt["deform"].items()}}

        deform = b.params["deform"]
        if state.params["deform"] is not deform:
            src = dict(state.params["deform"].named_parameters())
            for name, p in deform.named_parameters():
                take(p, src[name])
            copied = True
        opt, bo = state.opt_state, b.opt_state
        state.params = {"gauss": gauss(b.params["gauss"],
                                       state.params["gauss"]),
                        "deform": deform}
        state.opt_state = optim.AdamGroupState(
            count=take(bo.count, opt.count), mu=tree(bo.mu, opt.mu),
            nu=tree(bo.nu, opt.nu))
        for name in ("alive", "aabb", "xyz_gradient_accum", "denom",
                     "max_radii2d", "step"):
            setattr(state, name, take(getattr(b, name), getattr(state, name)))
        self.binds += copied
        return copied


class CapturedStep:
    """A training step as a captured program over its own state buffers
    and static cameras, targets, background and SH degree.
    `step_fn(state, cameras, gts, bg, active_sh)` runs one step in place on
    `state` and returns its aux; `state` gives the buffers their first
    values and is left as it was (with `own`, a copy of its own becomes
    the buffers). The degree is a 0-d int32 buffer that each call copies
    in, or over a mesh the key's `active_sh` (static)."""

    def __init__(self, key: "StepKey", step_fn: Callable, state: TrainState,
                 cameras: Sequence[Camera], gts: torch.Tensor,
                 bg: torch.Tensor, label: str, own: bool = False):
        self.buffers = StateBuffers(state, own)
        self.cameras = [_clone_camera(c) for c in cameras]
        self.gts, self.bg = gts.clone(), bg.clone()
        self.sh = (torch.zeros((), dtype=torch.int32, device=gts.device)
                   if key.active_sh is None else key.active_sh)
        self.program = Program(key, lambda: step_fn(
            self.buffers.state, self.cameras, self.gts, self.bg, self.sh),
            label, root="step")

    @property
    def key(self):
        return self.program.key

    def __call__(self, state: TrainState, cameras: Sequence[Camera],
                 gts: torch.Tensor, bg: torch.Tensor, active_sh,
                 host: tracing.HostSpans):
        """One replay on `state`; `host` laps the bind, the inputs'
        copies, the launch and the outputs' copies (`step.bind`,
        `step.inputs`, `step.launch`, `step.outputs`)."""
        self.buffers.bind(state)
        host.lap(tracing.now())
        for dst, src in zip(self.cameras, cameras, strict=True):
            _copy_camera(dst, src)
        self.gts.copy_(gts)
        self.bg.copy_(bg)
        if isinstance(self.sh, torch.Tensor):
            self.sh.copy_(active_sh)
        host.lap(tracing.now())
        out = self.program.replay()
        host.lap(tracing.now())
        out = _copy_out(out)
        host.lap(tracing.now())
        host.close(self.program.last)
        return out


class StepKey(NamedTuple):
    """The static arguments of a captured training step; over a mesh also
    `mesh` (`parallel.sharded.mesh_key`: the mesh's shape, this rank's
    tile coordinate, its band of tiles and the binner's route) and
    `active_sh`, the SH degree (None on a single card, where the step
    reads it from its degree buffer)."""
    stage: str
    capacity: int
    raster_cfg: RasterConfig
    track_stats: bool
    batch: int
    lambda_dssim: float
    reg_weights: tuple
    switches: tuple
    mesh: Any = None
    active_sh: int | None = None

    def label(self) -> str:
        rc = self.raster_cfg
        return (f"step {self.stage} capacity {self.capacity} tile_cap "
                f"{rc.tile_cap} pairs {rc.bin_pairs_per_chunk} stats "
                f"{'on' if self.track_stats else 'off'}"
                + ("" if self.active_sh is None else f" sh {self.active_sh}")
                + ("" if self.mesh is None else f" {self.mesh.label()}"))


def _changed(before: StepKey | None, key: StepKey) -> list:
    """The fields in which `key` differs from `before`."""
    if before is None:
        return ["first"]
    return [f for f in StepKey._fields
            if getattr(before, f) != getattr(key, f)]


def _stale(p: "Prewarm", live: StepKey) -> bool:
    """Whether a prewarm's key can no longer come once the stage has
    switched to `live`: a field other than the capacity and the
    statistics changed (a cap grew or shrank), the statistics stopped, or
    the bucket moved to a capacity that is neither the key's nor the one
    it was queued at."""
    key = p.key
    return (key._replace(capacity=live.capacity,
                         track_stats=live.track_stats) != live
            or (key.track_stats and not live.track_stats)
            or live.capacity not in (key.capacity, p.origin))


@dataclasses.dataclass
class Prewarm:
    """One key's prewarm: the capacity it was queued at, its thread, the
    program it built (held until the switch takes it or it is dropped),
    and what became of it."""
    key: StepKey
    origin: int
    thread: threading.Thread | None = None
    step: CapturedStep | None = None
    built: bool = False
    error: str | None = None
    seconds: float = 0.0      # the build's, on its thread
    retried: int = 0          # builds again after running out of memory
    wait: float = 0.0         # the training thread's, at the switch
    used: bool = False
    dropped: bool = False

    def building(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def record(self) -> dict:
        return {"key": self.key.label(), "prewarmed": self.built,
                "used": self.used, "dropped": self.dropped,
                "failed": self.error is not None, "error": self.error,
                "retried": self.retried, "wait": self.wait,
                "seconds": self.seconds}


class StepPrograms:
    """A stage's captured steps: the live one, captured when the key of a
    step differs from its own (the previous one is evicted with its
    pool), or taken from a prewarm of that key (`prewarm`). `step_fn(key)`
    gives the step function of a key (`loop.step_of_key`, or
    `parallel.sharded.step_of_key` over a mesh, whose ranks must all run
    the same keys in the same order). `captures` logs each capture on the
    training thread: its key's label, seconds, pool bytes, the stage's
    step it came at (1 for the first) and the key's fields that changed; `prewarms` each prewarm. `close`
    ends the stage's prewarms."""

    def __init__(self, step_fn: Callable[[StepKey], Callable]):
        self.step_fn = step_fn
        self.live: CapturedStep | None = None
        self.captures: list[dict] = []
        self.prewarms: list[Prewarm] = []
        self._pending: dict[StepKey, Prewarm] = {}
        self._evicted_binds = 0
        self._runs = 0
        self._close_wait = 0.0
        self._oom_drops = 0   # prewarms dropped for a capture's memory
        # ms between the starts of consecutive steps, after a step that
        # began while a prewarm thread lived, and after one that did not
        self._gaps = {"prewarming": [], "quiet": []}
        self._last = None

    def prewarm(self, key: StepKey, state: TrainState, cameras, gts, bg):
        """Build the step of `key` on a daemon thread while this thread
        goes on, from a snapshot of `state` cut or padded to the key's
        capacity. `cameras`, `gts` and `bg` give the program's static
        inputs their shapes."""
        dev = state.alive.device
        origin = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                  else None)
        # the containers as they are now (a surgery replaces their tensors)
        snap = dataclasses.replace(state, params=dict(state.params))
        p = Prewarm(key, state.capacity)
        p.thread = threading.Thread(
            target=self._build,
            args=(p, snap, list(cameras), gts, bg, origin),
            name=f"prewarm {key.label()}", daemon=True)
        self._pending[key] = p
        self.prewarms.append(p)
        with _THREADS:
            _background["threads"] += 1
        p.thread.start()

    def _build(self, p: Prewarm, snap: TrainState, cameras, gts, bg,
               origin) -> None:
        """A prewarm thread: the buffers' first values enqueued on the
        training thread's stream (`origin`), then the program."""
        t0 = time.perf_counter()
        _local.background = True
        try:
            with (torch.cuda.stream(origin) if origin is not None
                  else contextlib.nullcontext()):
                seed = snap.to(snap.alive.device, capacity=p.key.capacity)
                del snap
                for attempt in range(2):
                    try:
                        p.step = CapturedStep(p.key, self.step_fn(p.key),
                                              seed, cameras, gts, bg,
                                              p.key.label(), own=True)
                        break
                    except torch.cuda.OutOfMemoryError as e:
                        if attempt:
                            raise
                        error = str(e)
                    # out of the handler, so that the failed build's frames
                    # and its pool are gone
                    print(f"[prewarm] {p.key.label()} out of memory "
                          f"({error}); emptying the allocator's cache (a "
                          "device-wide wait) and building again", flush=True)
                    p.retried += 1
                    with _CAPTURING:
                        torch.cuda.empty_cache()
                p.built = True
        except Exception as e:   # the switch captures on the training thread
            p.error = f"{type(e).__name__}: {e}"
            print(f"[prewarm] {p.key.label()} failed: {p.error}\n"
                  + traceback.format_exc(), flush=True)
        finally:
            p.seconds = time.perf_counter() - t0
            with _THREADS:
                _background["threads"] -= 1

    def _switch(self, key: StepKey, state: TrainState, cameras, gts, bg):
        before = None if self.live is None else self.live.key
        if self.live is not None:
            self._evicted_binds += self.live.buffers.binds
        self.live = None
        p = self._pending.pop(key, None)
        for other in list(self._pending.values()):
            if _stale(other, key):
                del self._pending[other.key]
                other.dropped = True
        for other in self.prewarms:
            if other.dropped and not other.building():
                other.step = None        # its graph and pool go
        if p is not None:
            t0 = time.perf_counter()
            p.thread.join()
            p.wait = time.perf_counter() - t0
            if p.built:
                self.live, p.step, p.used = p.step, None, True
        if self.live is None:
            self.live = self._capture(key, state, cameras, gts, bg)
            self.captures.append(dict(
                key=key.label(), seconds=self.live.program.seconds,
                pool_bytes=self.live.program.pool_bytes, step=self._runs + 1,
                changed=_changed(before, key)))

    def _capture(self, key: StepKey, state: TrainState, cameras, gts, bg):
        """The step of `key` captured on this thread. If that runs out of
        memory while prewarms hold or build programs, they are dropped
        with their pools (their threads joined) and the capture runs once
        more: a prewarm never costs the stage its step."""
        try:
            return CapturedStep(key, self.step_fn(key), state, cameras, gts,
                                bg, key.label())
        except torch.cuda.OutOfMemoryError as e:
            held = [p for p in self._pending.values() if p.error is None]
            if not held:
                raise
            print(f"[prewarm] capturing {key.label()} ran out of memory "
                  f"({e}); dropping {len(held)} prewarm(s) and capturing "
                  "again", flush=True)
            for p in held:
                p.thread.join()
                p.dropped, p.step = True, None
                del self._pending[p.key]
            self._oom_drops += len(held)
        return CapturedStep(key, self.step_fn(key), state, cameras, gts, bg,
                            key.label())

    def run(self, key: StepKey, state: TrainState, cameras, gts, bg,
            active_sh):
        """One step of `state` at SH degree `active_sh` (a 0-d int32
        tensor on the state's device; over a mesh the key's int), by the
        program of `key`: the live one, a prewarmed one, or one captured
        now. The host's phases are the tracer's `step.*` spans (a switch
        of program falls in `step.bind`)."""
        host = tracing.HostSpans("step")
        now = time.perf_counter()
        if self._last is not None:
            then, prewarming = self._last
            self._gaps["prewarming" if prewarming else "quiet"].append(
                1e3 * (now - then))
        if self.live is None or self.live.key != key:
            self._switch(key, state, cameras, gts, bg)
        self._runs += 1
        out = self.live(state, cameras, gts, bg, active_sh, host)
        self._last = (now, any(p.building() for p in self.prewarms))
        return out

    def close(self) -> None:
        """Join every prewarm thread and drop every prewarmed program not
        in use: nothing built ahead outlives the stage."""
        t0 = time.perf_counter()
        for p in self.prewarms:
            p.thread.join()
            p.dropped = p.dropped or (p.built and not p.used)
            p.step = None
        self._pending.clear()
        self._close_wait = time.perf_counter() - t0

    def report(self) -> dict:
        """What the stage's programs did: the training thread's captures
        (each with its key, seconds, pool bytes, step and changed fields),
        binds that copied state in, replays; each prewarm (its key, whether it was
        prewarmed, used, dropped or failed, the switch's wait and the
        thread's seconds, builds again after running out of memory) and
        their sums, and the prewarms dropped because a capture on this
        thread ran out of memory; the ms between steps after one
        that began while a prewarm thread lived and after one that did
        not; the seconds `close` waited."""
        held = [self.live] if self.live is not None else []
        pre = [p.record() for p in self.prewarms]

        def gaps(ms):
            return {"steps": len(ms),
                    "mean_ms": sum(ms) / len(ms) if ms else None,
                    "median_ms": sorted(ms)[len(ms) // 2] if ms else None}
        return {"captures": self.captures,
                "rebinds": self._evicted_binds
                + sum(s.buffers.binds for s in held),
                "replays": self._runs,
                "prewarms": pre,
                "prewarmed": sum(r["prewarmed"] for r in pre),
                "prewarms_used": sum(r["used"] for r in pre),
                "prewarms_dropped": sum(r["dropped"] for r in pre),
                "prewarms_failed": sum(r["failed"] for r in pre),
                "prewarms_retried": sum(r["retried"] for r in pre),
                "prewarms_dropped_for_memory": self._oom_drops,
                "prewarm_wait_s": sum(r["wait"] for r in pre),
                "prewarm_s": sum(r["seconds"] for r in pre),
                "close_wait_s": self._close_wait,
                "step_gaps": {k: gaps(v) for k, v in self._gaps.items()}}


class EvalPrograms:
    """The test evaluation's renders as captured frames: one
    `render/serve.py:Renderer` over static copies of what the render reads
    of a training state (its gaussian fields, `alive`, `aabb` and
    deformation) and of the background. `load(state, bg)` copies the live
    state in, once an evaluation; at another capacity or deformation
    config it makes new copies and a new renderer (no frame kept: their
    graphs read the old copies). `render` sets the renderer's raster
    config and SH degree and replays the frame of the view's key, captured
    at its first render (`Renderer.replay`). The copies outlive every
    surgery, so the identities in that key do too. `captures` logs each
    capture: its key's label and seconds.

    The copies cost 237 bytes a slot (59 float32 fields and `alive`)
    besides the deformation's parameters (a Parameter's deepcopy carries
    no `.grad`, and the step takes its gradients by `torch.autograd.grad`),
    and each held frame its graph's memory pool."""

    def __init__(self, held: int = 4):
        # held: the run's caps and an overflowing view's doubled caps, at
        # two stages
        self.held = held
        self.renderer = None
        self.shapes = None
        self.captures: list[dict] = []
        self.loads = 0
        self.replays = 0

    @torch.no_grad()
    def load(self, state: TrainState, bg: torch.Tensor) -> None:
        from fourdgs_tpu_torch.render.serve import Renderer
        g, deform = state.params["gauss"], state.params["deform"]
        shapes = (state.alive.shape[0], deform.cfg)
        r = self.renderer
        if r is None or self.shapes != shapes:
            self.renderer = None
            self.renderer = Renderer(
                gauss=GaussianParams(**{f: getattr(g, f).detach().clone()
                                        for f in FIELDS}),
                alive=state.alive.clone(), deform=copy.deepcopy(deform),
                aabb=state.aabb.clone(), bg=bg.clone(), raster_cfg=None,
                sh_degree=0, device=state.alive.device, capture=True,
                held=self.held)
            self.shapes = shapes
        else:
            for f in FIELDS:
                getattr(r.gauss, f).copy_(getattr(g, f))
            src = dict(deform.named_parameters())
            for name, p in r.deform.named_parameters():
                p.copy_(src[name])
            r.alive.copy_(state.alive)
            r.aabb.copy_(state.aabb)
            r.bg.copy_(bg)
        self.loads += 1

    def render(self, camera: Camera, *, stage: str, active_sh: int,
               raster_cfg: RasterConfig):
        """`loop.eval_step` of the loaded state at `camera`, as a
        replay."""
        r = self.renderer
        if r is None:
            raise RuntimeError("EvalPrograms.render before load")
        r.raster_cfg, r.sh_degree = raster_cfg, active_sh
        captured, seconds = r.captured, r.capture_s
        out = r.render(camera, stage)
        self.replays += 1
        if r.captured > captured:
            rc = raster_cfg
            self.captures.append(dict(
                key=f"eval {stage} capacity {self.shapes[0]} "
                f"{rc.img_width}x{rc.img_height} tile_cap {rc.tile_cap} "
                f"pairs {rc.bin_pairs_per_chunk} sh {active_sh}",
                seconds=r.capture_s - seconds))
        return out

    def report(self) -> dict:
        """What the evaluation programs did: captures (each with its key
        and seconds), loads of the state, replays."""
        return {"captures": self.captures, "loads": self.loads,
                "replays": self.replays}
