"""Captured programs: the training step and the served frame as CUDA graphs,
recorded once per key and replayed (counterpart: `jax.jit` over
`train_step`, fourdgs_tpu/train/loop.py:87-91, and the jitted render of
scripts/render.py:125).

JAX's `BucketPrewarmer` (loop.py:249) compiles the next bucket's step on a
thread while training goes on. A capture here runs on the training thread
and costs the same ahead of a key change as at it (0.1-0.7 s), so a step
is captured when its key first comes up, and `prewarm` is not read.

A key holds what the JAX package makes a static argument: every host value
that the program branches on or sizes a buffer by (the stage, the
capacity, the raster config, the SH degree, `track_stats`, the switches
read from the environment). A graph bakes in the address of every tensor
it reads and writes, so a captured program reads static buffers:

  * the served frame (`CapturedFrame`) reads the renderer's tensors in
    place, their identity part of its key, and a static camera into which
    each replay copies the camera asked for;
  * the training step (`CapturedStep`) owns a copy of the training state
    (`StateBuffers`): the gaussian leaves, the deformation, the Adam
    moments and count, the densify statistics, `alive`, `aabb` and `step`.
    Before each replay `StateBuffers.bind` copies in every state tensor
    that is not its buffer (densify, prune, grow, a resize and the NaN
    rollback replace tensors) and points the state at the buffers, so
    that the step's in-place updates land in the caller's state: one
    device copy after a surgery, not a recapture.

A capture warms the program up on a side stream (on the buffers, whose
values the first bind overwrites, so the training state is left as it
was), records it into a memory pool of its own, and logs its seconds. A
capture or a replay that fails raises; nothing falls back to the eager
path. A replay returns copies of the outputs, which the caller may keep
across replays.

The kernel wrappers' `.launches` count the kernels the host launched. A
capture records its launches per wrapper on the program (`launches`) and
takes them back from the wrappers, since nothing ran; each replay adds
them to `REPLAYED`. `kernel_runs()` is the sum, by the wrapper's
`__name__`: the kernels that ran.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from collections.abc import Callable, Sequence
from typing import Any, NamedTuple

import torch

from fourdgs_tpu_torch.data.camera import Camera
from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from fourdgs_tpu_torch.ops import blend, scatter
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
from fourdgs_tpu_torch.train import optim
from fourdgs_tpu_torch.train.state import TrainState

# the environment switches that the step and the frame read at call time
SWITCHES = ("FOURDGS_PALLAS_NO_FUSED_BWD", "FOURDGS_PALLAS_GRAD_SCATTER",
            "FOURDGS_HEX_BWD", "FOURDGS_BIN_SCATTER")
# eager runs before a capture: the first call of each kernel sets its
# attributes and the libraries' handles, which a capture must not do
WARMUP = 2
# the kernel wrappers whose launches a program records, by `__name__`
WRAPPERS = (blend.blend_forward, blend.blend_backward,
            blend.blend_backward_slots, scatter.scatter_add_rows,
            scatter.scatter_set_scalars)
REPLAYED: collections.Counter = collections.Counter()
_CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))


def switches() -> tuple:
    return tuple(os.environ.get(k) for k in SWITCHES)


def kernel_runs() -> dict:
    """Kernels that ran, per wrapper name: host launches plus replayed
    ones."""
    return {w.__name__: w.launches + REPLAYED[w.__name__] for w in WRAPPERS}


def zero_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    REPLAYED.clear()


def _copy_out(out):
    """A copy of a program's outputs (a NamedTuple): its tensors cloned."""
    return type(out)(*(x.clone() if isinstance(x, torch.Tensor) else x
                       for x in out))


def _copy_camera(dst: Camera, src: Camera) -> None:
    for f in _CAMERA_FIELDS:
        getattr(dst, f).copy_(getattr(src, f))


def _clone_camera(cam: Camera) -> Camera:
    return Camera(**{f: getattr(cam, f).clone() for f in _CAMERA_FIELDS})


class Program:
    """One CUDA graph of `fn` (no arguments; it reads static buffers) in a
    memory pool of its own, with the outputs its replays write, its
    launches per kernel wrapper, its replays and its capture seconds."""

    def __init__(self, key, fn: Callable[[], Any], label: str,
                 warmup: int = WARMUP):
        if not torch.cuda.is_available():
            raise RuntimeError("a captured program needs a CUDA device; "
                               "the CPU path runs eagerly")
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        before = [w.launches for w in WRAPPERS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn()
        self.launches = {w.__name__: w.launches - n
                         for w, n in zip(WRAPPERS, before) if w.launches != n}
        for w, n in zip(WRAPPERS, before):
            w.launches = n
        torch.cuda.synchronize()
        self.key = key
        self.replays = 0
        self.seconds = time.perf_counter() - t0
        print(f"[capture] {label} captured in {self.seconds:.2f}s "
              f"(launches {self.launches})", flush=True)

    def replay(self):
        self.graph.replay()
        self.replays += 1
        REPLAYED.update(self.launches)
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

    def __call__(self, camera: Camera):
        _copy_camera(self.camera, camera)
        return _copy_out(self.program.replay())


class StateBuffers:
    """Static copies of every tensor of a TrainState that the step reads
    or writes, and `bind`, which makes a state use them."""

    def __init__(self, state: TrainState):
        self.state = state.to(state.alive.device)
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
    and static cameras, targets and background.
    `step_fn(state, cameras, gts, bg)` runs one step in place on `state`
    and returns its aux; `state` gives the buffers their first values and
    is left as it was."""

    def __init__(self, key, step_fn: Callable, state: TrainState,
                 cameras: Sequence[Camera], gts: torch.Tensor,
                 bg: torch.Tensor, label: str):
        self.buffers = StateBuffers(state)
        self.cameras = [_clone_camera(c) for c in cameras]
        self.gts, self.bg = gts.clone(), bg.clone()
        self.program = Program(key, lambda: step_fn(
            self.buffers.state, self.cameras, self.gts, self.bg), label)

    @property
    def key(self):
        return self.program.key

    def __call__(self, state: TrainState, cameras: Sequence[Camera],
                 gts: torch.Tensor, bg: torch.Tensor):
        self.buffers.bind(state)
        for dst, src in zip(self.cameras, cameras, strict=True):
            _copy_camera(dst, src)
        self.gts.copy_(gts)
        self.bg.copy_(bg)
        return _copy_out(self.program.replay())


class StepKey(NamedTuple):
    """The static arguments of a captured training step."""
    stage: str
    capacity: int
    raster_cfg: RasterConfig
    active_sh: int
    track_stats: bool
    batch: int
    lambda_dssim: float
    reg_weights: tuple
    switches: tuple

    def label(self) -> str:
        rc = self.raster_cfg
        return (f"step {self.stage} capacity {self.capacity} tile_cap "
                f"{rc.tile_cap} pairs {rc.bin_pairs_per_chunk} sh "
                f"{self.active_sh} stats {'on' if self.track_stats else 'off'}")


class StepPrograms:
    """A stage's captured steps: the live one, captured when the key of a
    step differs from its own (the previous one is evicted with its
    pool). `step_fn(key)` gives the step function of a key. `captures`
    logs each capture: its key's label and seconds."""

    def __init__(self, step_fn: Callable[[StepKey], Callable]):
        self.step_fn = step_fn
        self.live: CapturedStep | None = None
        self.captures: list[dict] = []
        self._evicted = {"binds": 0, "replays": 0}

    def run(self, key: StepKey, state: TrainState, cameras, gts, bg):
        """One step of `state`, by the program of `key`: the live one, or
        one captured now."""
        if self.live is None or self.live.key != key:
            if self.live is not None:
                self._evicted["binds"] += self.live.buffers.binds
                self._evicted["replays"] += self.live.program.replays
            self.live = None
            self.live = CapturedStep(key, self.step_fn(key), state, cameras,
                                     gts, bg, key.label())
            self.captures.append(dict(key=key.label(),
                                      seconds=self.live.program.seconds))
        return self.live(state, cameras, gts, bg)

    def report(self) -> dict:
        """What the stage's programs did: captures (each with its key and
        seconds), binds that copied state in, replays."""
        held = [self.live] if self.live is not None else []
        return {"captures": self.captures,
                "rebinds": self._evicted["binds"]
                + sum(s.buffers.binds for s in held),
                "replays": self._evicted["replays"]
                + sum(s.program.replays for s in held)}
