"""Serving a trained snapshot: load once, render cameras on demand
(counterpart: the snapshot-loading and cap-probe part of the JAX package's
scripts/render.py).

    renderer = Renderer.from_snapshot("output/scene")     # on cuda
    out = renderer.render(camera)                          # RenderOutput

On the card a frame is a captured program (train/graphs.py, the
counterpart of the JAX render CLI's jit): one CUDA graph per key (the
raster config, the stage, the identity of the renderer's tensors, the
blend's implementation and the switches; `Renderer.replay`, which
`tools/render.py:MeshRenderer` also captures its sharded frames
through), replayed with the camera copied into its static buffers.
`capture=False` renders eagerly; the CPU always does.

CLI: render a look-at orbit over t in [0, 1] and print frame count,
seconds and FPS:

    python -m fourdgs_tpu_torch.render.serve -m output/scene --frames 30
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import Camera, look_at_camera
from fourdgs_tpu_torch.data.png import write_png
from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from fourdgs_tpu_torch.ops import blend
from fourdgs_tpu_torch.ops.rasterize_ref import RenderOutput
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
from fourdgs_tpu_torch.render.render import render
from fourdgs_tpu_torch.train import checkpoint
from fourdgs_tpu_torch.train import config as config_mod
from fourdgs_tpu_torch.train import graphs
from fourdgs_tpu_torch.utils.device import resolve_device

# cap probe bounds (as in the JAX render CLI)
PROBE_ROUNDS = 5
_TILE_CAP_MAX = 8192
_PAIRS_PER_CHUNK_MAX = 1 << 18
_FRAMES_HELD = 2     # captured frames a renderer keeps, the newest


def overflows(dropped_pairs: int, dropped_tile: int,
              num_pairs: int) -> tuple[bool, bool]:
    """Whether a render dropped pairs to the pair budget, and whether its
    tile-cap drops pass 0.5 % of its pairs (at least 64): the counter is an
    upper bound, so fewer are not worth a larger cap."""
    return dropped_pairs > 0, dropped_tile > max(64, num_pairs // 200)


def _full_float32():
    # The deformation MLP heads must run in full float32 for parity with
    # the reference: TF32 matmuls keep about three decimal digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Renderer:
    gauss: GaussianParams
    alive: torch.Tensor
    deform: Deformation
    aabb: torch.Tensor
    bg: torch.Tensor
    raster_cfg: RasterConfig
    sh_degree: int
    device: torch.device
    iteration: int = -1
    probe_renders: int = 0   # renders the cap probe made
    capture: bool | None = None   # None: capture frames on the card
    captured: int = 0        # frames captured, and renders replayed
    replayed: int = 0
    frames: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @classmethod
    def from_snapshot(cls, model_path: str, iteration: int = -1,
                      device: str | torch.device | None = None,
                      width: int = 800, height: int = 800,
                      configs: str = "",
                      capture: bool | None = None,
                      probe_camera: Camera | None = None) -> "Renderer":
        """Load the newest (or the given) snapshot under `model_path`, with
        configs from its `cfg_args.json` (plus an optional config file),
        and run the cap probe (eagerly) on `probe_camera`, by default the
        look-at camera."""
        dev = resolve_device(device)
        _full_float32()
        cfg, gauss, alive, deform, aabb, it = checkpoint.load_model(
            model_path, iteration, dev, configs)
        bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                          else [0.0, 0.0, 0.0], device=dev)
        renderer = cls(gauss=gauss, alive=alive, deform=deform, aabb=aabb,
                       bg=bg,
                       raster_cfg=config_mod.raster_config_from(
                           cfg, width, height),
                       sh_degree=cfg.model.sh_degree, device=dev,
                       iteration=it, capture=capture)
        renderer.probe_caps(probe_camera if probe_camera is not None
                            else look_at_camera(device=dev))
        return renderer

    def probe_caps(self, camera: Camera) -> None:
        """The snapshot may hold far more gaussians than the saved binner
        caps were sized for: render one view and double the overflowing
        cap until the render is drop-free."""
        for _ in range(PROBE_ROUNDS):
            out = self.render_eager(camera)
            self.probe_renders += 1
            dp, dt = int(out.dropped_pairs), int(out.dropped_tile)
            changes = self.grow_caps(*overflows(dp, dt, int(out.num_pairs)))
            if not changes:
                return
            print(f"binner overflow at saved caps ({dp} pairs/{dt} tile): "
                  f"growing {changes}")

    def grow_caps(self, pairs: bool, tile: bool) -> dict:
        """Double the pair budget (`pairs`) and the tile cap (`tile`) below
        their limits; returns what changed."""
        rc = self.raster_cfg
        changes = {}
        if tile and rc.tile_cap < _TILE_CAP_MAX:
            changes["tile_cap"] = rc.tile_cap * 2
        if pairs and rc.bin_pairs_per_chunk < _PAIRS_PER_CHUNK_MAX:
            changes["bin_pairs_per_chunk"] = rc.bin_pairs_per_chunk * 2
        if changes:
            self.raster_cfg = dataclasses.replace(rc, **changes)
        return changes

    def captures(self) -> bool:
        return self.device.type == "cuda" if self.capture is None \
            else self.capture

    @torch.no_grad()
    def render_eager(self, camera: Camera, stage: str = "fine",
                     scale_modifier: float = 1.0) -> RenderOutput:
        return render(self.gauss, self.deform, camera.to(self.device),
                      self.bg, self.raster_cfg, self.aabb, self.alive,
                      self.sh_degree, stage=stage,
                      scale_modifier=scale_modifier)

    @torch.no_grad()
    def render(self, camera: Camera, stage: str = "fine",
               scale_modifier: float = 1.0) -> RenderOutput:
        """The frame at `camera`: a replay of the captured frame of the
        renderer's present key, or an eager render (`capture` False, or
        the CPU)."""
        if not self.captures():
            return self.render_eager(camera, stage, scale_modifier)
        return self.replay(
            (stage, scale_modifier),
            lambda cam: self.render_eager(cam, stage, scale_modifier),
            camera, f"frame {stage}")

    @torch.no_grad()
    def replay(self, kind: tuple, render_fn, camera: Camera,
               label: str) -> RenderOutput:
        """`render_fn(camera)` as a replay of its captured frame, captured
        at its key's first render: `kind` (what `render_fn` is static in
        besides the renderer) with the raster config, the SH degree, the
        identity of the renderer's tensors, the blend's implementation
        and the switches. The newest _FRAMES_HELD frames are kept."""
        camera = camera.to(self.device)
        inputs = tuple(getattr(self.gauss, f) for f in FIELDS) + (
            self.alive, self.aabb, self.bg, self.deform)
        key = (self.raster_cfg, self.sh_degree, kind,
               tuple(map(id, inputs)), blend.blend_forward,
               graphs.switches())
        frame = self.frames.get(key)
        if frame is None:
            while len(self.frames) >= _FRAMES_HELD:
                del self.frames[next(iter(self.frames))]
            rc = self.raster_cfg
            frame = self.frames[key] = graphs.CapturedFrame(
                key, render_fn, camera, inputs,
                f"{label} {rc.img_width}x{rc.img_height} tile_cap "
                f"{rc.tile_cap} pairs {rc.bin_pairs_per_chunk}")
            self.captured += 1
        self.replayed += 1
        return frame(camera)

    def gui_frame(self, camera: Camera, width: int, height: int,
                  scaling_modifier: float = 1.0) -> torch.Tensor:
        """The viewer bridge's render function
        (viewer/network_gui.py:NetworkGui.poll): the (H, W, 3) frame at the
        client's size and scaling modifier, the raster config resized to
        it (its caps kept), each size and modifier a captured frame of its
        own on the card."""
        rc = self.raster_cfg
        if (rc.img_width, rc.img_height) != (width, height):
            self.raster_cfg = dataclasses.replace(rc, img_width=width,
                                                  img_height=height)
        return self.render(camera, scale_modifier=scaling_modifier).color


def orbit_cameras(frames: int, device) -> list[Camera]:
    """A look-at orbit: frame i at angle 2*pi*i/frames and t = i/(frames-1),
    so t spans [0, 1]."""
    return [look_at_camera(theta=2 * math.pi * i / frames,
                           time=i / max(frames - 1, 1), device=device)
            for i in range(frames)]


def main(argv=None):
    parser = argparse.ArgumentParser(description="render a snapshot orbit")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=800)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    parser.add_argument("--configs", default="")
    parser.add_argument("--out", default="",
                        help="output dir (default: <model_path>/serve)")
    args = parser.parse_args(argv)

    renderer = Renderer.from_snapshot(args.model_path, args.iteration,
                                      args.device, args.width, args.height,
                                      configs=args.configs)
    dev = renderer.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    cams = orbit_cameras(args.frames, dev)
    renderer.render(cams[0])                     # warm-up, untimed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    frames = [renderer.render(c).color for c in cams]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    print(f"device: {name}; frames: {len(frames)}; seconds: {seconds:.3f}; "
          f"FPS: {len(frames) / seconds:.2f}")

    out_dir = args.out or os.path.join(args.model_path, "serve")
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        img = f.cpu().numpy()
        np.save(os.path.join(out_dir, f"{i:05d}.npy"), img)
        write_png(os.path.join(out_dir, f"{i:05d}.png"),
                  (np.clip(img, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {len(frames)} frames (.npy and .png) to {out_dir}")


if __name__ == "__main__":
    main()
