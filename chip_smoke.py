#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (fourdgs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--frames 24] [--steps 30]
                          [--coarse 300] [--fine 1200]

Phases, each of which raises on failure (so the exit code is nonzero):
  1. device: the card's name and power limit;
  2. build:  the CUDA kernels from fourdgs_tpu_torch/csrc with nvcc;
 18. host:   run right after phase 2: the host library (csrc/host, C++)
             built with the host compiler, its seconds; then each route
             against its plain version (numpy, Python) on this run's
             inputs, equal bit for bit, with both times: a photograph-
             like 1352x1014 Paeth PNG, a 1008x756 quality-95 4:2:0 JPEG
             from data/jpeg.py's encoder, the progressive fixtures of
             tests/jpeg_fixtures against the sha256 of Pillow's pixels
             beside them, LANCZOS 2704x2028 -> 1352x1014, a
             1,000,000-point points3D.bin with tracks of 2-8; then 16
             DyNeRF frames decoded in batches of 4 by 4 threads and by 4
             spawned processes (ms a batch, each pool's start);
  3. slice:  a synthetic snapshot (100,000 Gaussians, D-NeRF deformation
             width, random weights from --seed) served through
             Renderer.from_snapshot at 800x800 for --frames frames, each
             a replay of the captured frame (train/graphs.py), with the
             kernels' runs read around that run; the same frames rendered
             eagerly, equal bit for bit; each mode's ms/frame, FPS, peak
             memory and, from a profile of a few frames, its syncs, copies
             from the host, graph and kernel launches a frame (none of
             the first two in a replay; the eager one's raster.bin and
             render.splats kernel time); the runs of K1, the binner
             kernel and D1 a frame, counted over the replays; and checks
             of the images against the plain blend on the card and the
             CPU path on a small image;
 19. bench:  run right after phase 3: tools/bench_fps.py's bench at its
             defaults (100,000 points, 800x800, tile_cap 512, 100 frames),
             its JSON line printed; its frames replays only (one capture,
             no host launch beyond the capture's warm-up, and from a
             profile of a few replays no sync, no copy from the host, one
             graph launch a frame), the first replay equal to an eager
             frame of the same state bit for bit and, within TOL with
             equal drops, to the frame through the plain blend, binner and
             gather; K1, the binner kernel and D1 on the bench's first
             frame against their plain versions (phase 4's checks and
             times at the bench's shapes); K1, the binner kernel and D1
             run on every replay; its ms/frame and FPS beside phase 3's,
             and its drops;
  4. kernel: K1 (blend forward) against its plain PyTorch version, on the
             inputs that one of phase 3's frames gives it (the caps after
             the cap probe), with CUDA-event, device and host-enqueue
             times, and where its time can go
             (tools/profile_blend_split.py:blend_work: the tiles'
             occupancy, the heaviest tile's one-SM time, the evaluations
             that warps of either shape issue); on the same frame's
             input, the binner kernel (csrc/binner.cu) against the plain
             binner (equal) and D1 at each HexPlane gather of the frame
             against `index_select` (equal), each with CUDA-event,
             device and host times, its bound and the plain or library
             route's time;
  5. train:  a TrainState of the same scene (capacity 1<<17, the first
             100,000 slots alive) takes --steps fine train_steps at
             800x800 toward four targets that eval_step rendered before
             seeded noise moved its colors and opacities, eagerly and
             then as replays of the captured step, each from the same
             state, with the kernels' runs read around both; the loss must
             fall in each, the captured run's leaves after one step must
             equal the eager run's (GRAD_TOL) and its losses follow
             (STEP_LOSS_RTOL); each mode's ms/step, rays/s, peak memory
             and, from a profile of a few steps, its syncs, copies from
             the host, graph and kernel launches and kernel time a step
             (the eager one's spans too: raster.bin and render.splats
             printed); the binner kernel and D1 ran each step, counted
             over the replays; and one step's gradients with K2 must
             equal those with the plain backward on the card, on each
             training view and on phase 6's view; then batch 2, two
             cameras a step, eagerly and captured from copies of the
             state (leaves after one step to GRAD_TOL, losses to
             STEP_LOSS_RTOL);
  6. kernel: K2 (blend backward) against its plain version on the step
             input of the trained state's frame at t = 0.5 (its
             cotangents, its caps), with CUDA-event, device and
             host-enqueue times, the float2 atomics, reduced warp
             batches and block chunks that a counting build of K2 tallies
             on that input, and where its sums can go
             (tools/profile_blend_split.py:bwd_work); on the same step
             input, the binner kernel and D1 as in phase 4;
  7. driver: the training CLI (tools.train.main) on a synthetic D-NeRF
             scene (tools.make_synthetic_scene: 60 train and 10 test views
             at 800x800) at the D-NeRF width of dnerf_default.py, its
             schedule cut to --coarse/--fine iterations, with the four
             switches of the per-slot path set (K3 for the blend backward,
             K4 for its reduction and the HexPlane gather backward, K5 for
             the binner): densify, prune, opacity reset, bucket resizes,
             the SH ramp, test evaluations, a snapshot and a checkpoint,
             then a 20-iteration resume from that checkpoint, then
             Renderer.from_snapshot on the trained snapshot rendering test
             view 0 at its probed caps and as the run's eval rendered it
             (the eval's caps, the run's buffer capacity), each render's
             drops and caps printed; the CLI replays captured steps (its
             default on the card), and the phase prints the capture
             seconds of each key, the recaptures, the rebinds after
             surgeries and the replays; the kernels' runs are read around
             the whole phase;
 10. eval:   run right after phase 7, on its trained model: the render
             CLI (tools.render) writes the train, test and video splits'
             PNGs, each frame a replay of the captured frame, and prints
             each split's FPS; the metrics CLI (tools.metrics) scores the
             test renders into results.json and per_view.json, with LPIPS
             skipped unless its weights are present; the kernels' runs are
             read around both, every render must have run K1, the binner
             kernel and D1, and the post-hoc test PSNR must read phase 7's
             last in-loop eval within RENDER_PSNR_TOL;
 21. prewarm: run right after phase 10: the training CLI on phase 7's
             scene, config and switches with the config's prewarmer on,
             off, off and on (the off runs through `prewarm=False`), the
             kernels' runs read around the four; for each run and stage
             the captures on the training thread (key, step, the key's
             changed fields, seconds), what each prewarm did (used,
             dropped, failed, the switch's wait, its thread's seconds),
             ms an iteration, the ms between steps while a prewarm thread
             lived and while none did, peak memory and the test PSNR; it
             fails on a failed prewarm, a run with the prewarmer on that
             used none, a capture at an SH ramp (at 1000 only the
             densify statistics' stop may capture, and with the prewarmer
             on nothing), an iteration that did not replay; then once
             off and once on on phase 17(a)'s run-to-run-equal route
             (two runs of one setting on phase 7's route part by up to
             0.3 dB), where the two test PSNRs must agree within
             RENDER_PSNR_TOL (printed: whether they, the last losses and
             the events are equal bit for bit);
 22. standalone: run after phase 21: the train CLI, then the render CLI
             (--skip_train) and the metrics CLI, in a fresh interpreter
             under utils/standalone.py's audit hook, which refuses and
             counts every open of a path under fourdgs_tpu/ and every
             import of jax, jaxlib or the JAX package: phase 7's scene at
             the full D-NeRF widths of the port's
             configs/dnerf/bouncingballs.py (an include of it that cuts
             the schedule to STANDALONE_ITERS), on the default route (no
             switch set: K1, K2, the binner and D1, captured); it fails
             unless the run exits 0 with no refused event, the post-hoc
             test PSNR reads the last in-loop eval within
             RENDER_PSNR_TOL, and K1, K2, the binner and D1 ran in it (and
             K3-K5 did not); its fine ms/iteration, PSNRs, FPS and runs
             are printed;
 11. nerfies: run after phase 10: a vrig-like HyperNeRF capture of the
             ball scene (write_nerfies_scene: two cameras x 40 timestamps,
             rgb/2x at 536x960, covisible masks, 2,000 random points)
             trained by the train CLI at configs/hypernerf/default.py's
             widths and batch 2, its schedule cut (LAYOUTS), then the
             render and metrics CLIs; the kernels' runs read around each
             (K2 batch times a step, K1 and the binner every render, D1
             every fine render), the post-hoc test PSNR within
             RENDER_PSNR_TOL of the last in-loop eval; then on the trained
             model K1 on a test frame (as phase 4), one step's gradients
             with K2 against the plain backward's (GRAD_TOL) and its 54
             16-wide HexPlane gathers against index_select;
 12. dynerf: the same on a DyNeRF (Neu3D) capture (write_dynerf_scene:
             poses_bounds.npy for four cameras, cam00 held out, 24 frames
             a camera at 1352x1014 under camNN/images/, empty camNN.mp4
             placeholders) at configs/dynerf/default.py's widths and batch
             4 (36 gathers a view); then the bank check: the train split's
             device, host and lazy banks equal bit for bit over every
             view, and BANK_STEPS captured steps of run_stage from one
             state with the device bank and with the lazy bank and its
             prefetch, losses within STEP_LOSS_RTOL, with each one's ms a
             step, the lazy over the device bank's, the lazy bank's decode
             ms a view (the host library), prefetched batches and wait a
             step (both with the prewarmer off); then the device bank once
             more with the prewarmer on: its build beside the steps, none
             failed, losses within STEP_LOSS_RTOL, each run's peak memory;
 13. multipleview: the same on a MultipleView rig (write_multipleview_
             scene: DYNERF_RIG's four cameras in sparse_/ x 20 frames at
             960x540, camNN/frame_*.jpg, poses_bounds_multipleview.npy for
             the 300-pose spiral) at configs/multipleview/default.py
             (16-wide planes, multires [1, 2], batch 1);
 14. panoptic: a PanopticSports sequence (write_panoptic_scene: four
             train cameras and one test camera x 20 timesteps at 640x360,
             each K's principal point off centre by up to 6 % of the width
             and height, ims/<cam>/<t>.jpg, init_pt_cld.npz) at the config
             defaults (32-wide planes, multires [1, 2, 4, 8]);
 15. colmap: a monocular COLMAP capture (write_colmap_scene: 24 views of
             an orbit at 1008x756, a PINHOLE camera with fx != fy,
             sparse/0/ binary, images/*.jpg, llffhold 8) at the config
             defaults, 100 + 100 iterations. Phases 13-15 write their
             JPEGs with data/jpeg.py's encoder (quality 95, 4:2:0) and
             print one view's decode ms on one thread and Scene.load's
             seconds beside the checks of phases 11-12;
 16. tools:  (a) the viewer bridge (viewer/network_gui.py) on a loopback
             port serving phase 3's snapshot through its Renderer
             (Renderer.gui_frame, captured frames) to a client thread, 30
             frames at 800x800 and 10 at 1280x720: every reply's size,
             one 800x800 reply equal to the Renderer's frame, the
             bridge's ms a frame at each size; (b) the train CLI with
             --gui and render_process on phase 7's scene, 50 + 150
             iterations, a client asking for 20 frames without `train`
             and then one an iteration: the run's end, the triptychs
             (H, 3W, 3), the served frames' ms, the stages' ms an
             iteration against phase 7's; (c) tools/export_perframe.py
             on phase 3's snapshot at 4 timestamps, one PLY against
             get_state_at_time on the card; (d) tools/merge_many.py on
             that snapshot twice (offsets +-0.6) over 12 of phase 7's
             video cameras, frame 0 through K1 against the plain blend
             (TOL), ms a frame and the drops; (e) the train CLI with
             empty_voxel, 50 + 100 iterations: finite losses, the leaf
             in the snapshot, read back equal;
 17. mesh:   run after phase 16 (fourdgs_tpu_torch/parallel): (a) one
             rank over NCCL in this process, a (1, 1) mesh's sharded step
             against train_step; then at the same inputs (batch 2) the
             single-card step captured, the sharded step captured (its
             NCCL collectives recorded in the graph) and eager, 30 steps
             each from one state: the captured sharded run's leaves after
             one step within GRAD_TOL of the eager run's and its losses
             within STEP_LOSS_RTOL on average (the largest step printed
             beside a second eager run's); then the eager pair again on
             the run-to-run-equal route (K3's cluster with the
             reassociated reduction, torch's deterministic algorithms,
             and the HexPlane backward's rows summed in one order:
             index_add_ where the card's PyTorch makes it deterministic,
             else a sorted reduction), the first step and leaf where the
             pair parts, and where it agrees within STEP_LOSS_RTOL at
             every step the captured sharded step on that route held to
             it at every step; the captured program's kernel runs,
             ms a step of each (the two captured ones timed again in the
             other order) and a profile of the two replays by kernel
             name; the captured sharded frame of each camera equal to the
             eager one; (b) two ranks spawned on the one card
             over gloo (NCCL takes one rank a card), each building phase
             5's gaussians from the seed at tile 16 (50 x 50 tiles, two
             bands), one sharded step at (1, 2) (the band route, the
             gaussians split) and at (2, 1), each against the single-card
             step from the same state (tests/test_parallel.py's
             tolerances), the ranks' states equal, the kernels' runs
             counted around each step, 3 more steps timed; the first
             camera rendered tile-sharded against the single-card frame
             (TOL); then on rank 1's band (tile0 1,250) K1, K2, K3 and the
             band binner (the cull off) against their plain versions at
             that offset, K3's table reduced over the band's BlendSlots
             against K2, each timed; (c) the train CLI under
             torch.distributed.run at --mesh 1,2 on phase 7's scene at
             tile 16, 20 + 40 iterations, then the render CLI at
             --mesh 1,2 on the test split: the ranks' final states equal,
             the PNGs' PSNR within RENDER_PSNR_TOL of the in-loop eval,
             and every rank's runs. Times of (b) and (c) are two ranks
             sharing one card, not a scaling figure; (b) and (c) run
             eagerly (gloo cannot be captured); (d) the train CLI at
             --distributed --mesh 1,1 over one NCCL rank in this process,
             on phase 7's scene, config, schedule and switches, every step
             a replay of the captured sharded step and every sharded eval
             a replay of a captured sharded frame, its fine ms/iteration
             against phase 7's, then the render CLI at --mesh 1,1 on the
             test split (captured sharded frames), its PNGs' PSNR within
             RENDER_PSNR_TOL of the in-loop eval; (e)
             tools/bench_scaling.py over every card of the machine (one
             NCCL rank a card, captured): a line a mesh;
  8. kernel: K3, K4 and K5 against their plain versions on phase 6's step
             input (K4 also at a HexPlane plane's shape, K5 at the
             binner's), one step's gradients through K3 + K4 against
             K2's, with CUDA-event times, the device time (torch.profiler,
             fills included) and the host's time to enqueue one call, and
             the PyTorch call that computes the same function where there
             is one; K3's table twice, bit for bit, and what a counting
             build of K3 tallies (its float2 stores, five a row of the
             tiles' occupied chunks, its reduced warp batches, equal to
             phase 6's count of K2's, and the chunks its blocks walk,
             against those of K2's sub-tile blocks: the coupled exit);
             and the reduction without FOURDGS_PALLAS_GRAD_SCATTER (the
             reassociation over the binner's BlendSlots) on K3's table:
             against index_add_ (SCATTER_TOL), bit for bit twice, finite
             over a table that was NaN before K3's launch, one step's
             gradients through it against K2's (GRAD_TOL), and its,
             index_add_'s and K4's time by CUDA events;
 20. eval programs and tools: run after phase 15: (a) on phase 7's final
             state (its snapshot in the run's capacity, the run's final
             raster config and SH degree) and its test views, an
             evaluation as the train CLI makes it (every test view and 5
             train views through tools/train.py:eval_output, its cap
             growth and PSNRs) eagerly, through the evaluation programs
             (graphs.EvalPrograms, the counterpart of JAX's jitted
             eval_step) twice, and eagerly again, each timed with its
             captures counted apart: the second captured evaluation
             captures nothing, every view's replay equals the eager
             render bit for bit, K1, the binner kernel and D1 ran every
             render, the first test view's replay matches the frame
             through the plain blend, binner and gather (TOL, counters
             equal), and K1, the binner and D1 against their plain
             versions at that view's shapes (phase 4's checks); phase 7's
             train CLI's evaluation programs (captures, loads, replays,
             each evaluation's seconds); (b) the nine tools that port the
             JAX package's preparation, point and report scripts, each
             through its `main` on files earlier phases wrote:
             poses2colmap on phase 7's Blender scene and (in phase 11) on
             the nerfies capture, colmap_converter (in phase 15) from
             .bin to .txt and back with the records equal,
             preprocess_dynerf (in phase 12) on the DyNeRF layout, listing
             its frames, and on a video without frames with OpenCV hidden
             (a `cv2` that raises ImportError first on the path), which
             must exit nonzero with the named ImportError,
             downsample_point on phase 18's million points down to
             40,000, grow_point on the card on that result and on the
             million points (timed), merge_point on the two,
             cal_modelsize, visualize_hexplane (its PNGs read back) and
             diag_checkpoint on phase 7's model and checkpoint;
  9. dev:    the six tools of fourdgs_tpu_torch/tools that port the Pallas
             prototypes of scripts/ (D1-D6), each through its `main` at its
             script's shapes, with the launch counts read around the six;
             then each kernel against its plain version on its tool's
             inputs (D1, D2, D4a, D4b equal; D3 to SCATTER_TOL; D5, K1 at
             tile 16, to TOL; D6 to DEV_TOL), with the tools' CUDA-event
             times and bounds, and for D4 and D6 the device time
             (torch.profiler, or where it keeps no record, CUDA events
             behind a held stream) and the held stream's time beside it.
The second-to-last line of stdout is the kernels JSON, the last line the
result JSON. It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from fourdgs_tpu_torch.tools.profile_blend_split import (BLEND_FP32_INSTR,
                                                         blend_work,
                                                         bwd_work)
from fourdgs_tpu_torch.train.config import CONFIG_DIR
from fourdgs_tpu_torch.utils.timing import (FP32_ISSUE_S, HBM_BYTES_S,
                                            HELD_STREAM, MUFU_OP_S,
                                            NoKernelRecords, held_stream_ms,
                                            kernel_records, per_call_ms,
                                            time_call, time_pair)

ROOT = Path(__file__).resolve().parent
N_GAUSS = 100_000
SIZE = 800
OPACITY_LOGIT = 2.197          # sigmoid = 0.9, a trained-like opacity
RASTER = dict(tile_size=32, tile_cap=768, chunk=32, bin_chunk=4096,
              bin_pairs_per_chunk=18432)
KERNEL_CHECK_FRAME = 0.5       # the main-path frame at t = 0.5
TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}
GRAD_TOL = 1e-4                # gradients, normalised by their max |.|
# phase 5: the captured run's losses against the eager run's, relative;
# the two backward passes sum with float atomics in different orders, and
# Adam's division by sqrt(nu) carries the last bits on from step to step
STEP_LOSS_RTOL = 1e-3
BATCH_TWO_STEPS = 6            # phase 5's batch-2 check, steps a mode
# the kernels of the main paths: reported name -> wrapper name
REPORTED = {"blend_fwd": "blend_forward", "blend_bwd": "blend_backward",
            "blend_bwd_slots": "blend_backward_slots",
            "scatter_add_rows": "scatter_add_rows",
            "scatter_set_scalars": "scatter_set_scalars",
            "binner": "bin_tiles", "gather_rows": "gather_rows"}
# the kernels of the serve and step paths, each run once a frame or step
# (K1, K2 the step only, the binner), and the HexPlane's forward gathers
# (D1): 12 for a level's three spatial planes, 6 for its three time planes
# at one timestamp
PATH_KERNELS = ("blend_fwd", "blend_bwd", "binner", "gather_rows")
HEX_GATHERS_PER_LEVEL = 18
TRAIN_CAPACITY = 1 << 17
TRAIN_TIMES = (0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0)
UNTIMED_STEPS = 3
PROFILED_STEPS = 4             # after the checked run, under torch.profiler
SPATIAL_LR_SCALE = 1.0
# seeded noise on the trained fields, in raw units (SH DC, opacity logit)
NOISE_DC, NOISE_OPACITY = 0.3, 1.0
GRAD_COLUMNS = ("pix_x", "pix_y", "conic_a", "conic_b", "conic_c", "red",
                "green", "blue", "opacity", "depth")
FRAME_TOL = 1e-4               # one frame: kernel blend vs plain blend
MEAN_ALPHA_FLOOR = 0.1
# a small image rendered on the card and on the CPU (plain path): the two
# differ in float association only, except where a gate decision
# (alpha >= 1/255, T > 1e-4) flips on a last-bit difference, which moves a
# pixel by at most alpha * T < 5e-3
SMALL = 160
SMALL_TOL_MEAN, SMALL_TOL_MAX = 1e-5, 5e-3

# FP32-pipe instructions of csrc/blend_bwd.cu's loop body per pixel x slot
# evaluation, as its sm_90a SASS has them: the replay up to the alpha test
# is K1's (12 and 9); a used slot runs T x cp and its test (2), the
# gradient chain and the two IEEE divisions (each MUFU.RCP, FCHK and five
# FFMA), 53 in all. The bound adds the 10 additions per used pixel x slot
# that any sum into the per-gaussian rows needs, and counts one MUFU.EX2
# per expf and two MUFU.RCP per used slot.
BLEND_BWD_FP32_INSTR = {"eval": 12, "exp": 9, "used": 53}
# K3 (csrc/blend_bwd.cu's per-slot build) runs K2's replay and gradient
# chain; its per-slot sums over the tile's pixels need the same 10
# additions per used pixel x slot, so its bound counts K2's instructions.

DRIVER_SIZE = 800              # data/blender.py RESOLUTION
DRIVER_VIEWS = (60, 10)        # train, test: the JAX scene script's defaults
RESUME_ITERS = 20
# configs/dnerf/dnerf_default.py's values; the schedule is cut
# to the run's length (densify, prune and reset every 100/100/600
# iterations, densify until 1000, prune above 1000 live points), and the
# capacity buckets start at 1,024 (of 4,096) so that the cut run's few
# thousand points cross bucket sizes: its count ends near the 4,096
# bucket's 2,730-point edge, on either side from run to run
DRIVER_CONFIG = """\
OptimizationParams = dict(
    coarse_iterations={coarse},
    deformation_lr_init=0.00016,
    deformation_lr_final=0.0000016,
    deformation_lr_delay_mult=0.01,
    grid_lr_init=0.0016,
    grid_lr_final=0.000016,
    iterations={fine},
    pruning_interval=100,
    percent_dense=0.01,
    densify_from_iter=100,
    pruning_from_iter=100,
    densification_interval=100,
    opacity_reset_interval=600,
    densify_until_iter=1000,
    prune_min_points=1000,
)
ModelHiddenParams = dict(
    multires=[1, 2],
    defor_depth=0,
    net_width=64,
    plane_tv_weight=0.0001,
    time_smoothness_weight=0.01,
    l1_time_planes=0.0001,
    weight_decay_iteration=0,
    bounds=1.6,
)
RasterParams = dict(min_bucket=1024)
"""
RENDER_PSNR_TOL = 0.1          # dB: the snapshot's render vs the run's eval
# phase 22: the train CLI on phase 7's scene from the port's bouncingballs
# config (HexPlane [64, 64, 64, 75] x 32 features, multires [1, 2], net
# width 64, depth 0), its schedule cut to (coarse, fine) iterations with
# densify and prune from iteration 100 (of 500) so that both stages densify
STANDALONE_ITERS = (300, 600)
STANDALONE_CONFIG = """\
_base_ = {base!r}
OptimizationParams = dict(coarse_iterations={coarse}, iterations={fine},
                          densify_from_iter=100, pruning_from_iter=100)
"""
STANDALONE_TIMEOUT = 600       # seconds the guarded run may take
SCATTER_TOL = 1e-5             # K4 vs plain, max |a - b| / max |b|
# phase 9: D6's four bodies vs plain, max |a - b| / max |b|; the same sums
# of 768 terms a pixel in another association
DEV_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)
    return name


def phase_build():
    from fourdgs_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    info = _build.build_info
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s, cached={info['cached']}) "
        f"-> {Path(info['path']).relative_to(ROOT)}")
    for line in info["ptxas"]:
        log(f"  {line}")


# ---------------------------------------------------------------------------
# the synthetic scene
# ---------------------------------------------------------------------------

def make_scene(torch, seed: int, device):
    """100,000 Gaussians by the JAX package's benchmark point rule
    (uniform in [-1, 1]^3, random colors), scales from the mean 3-NN
    squared distance as at initialisation, opacity 0.9, random SH rest
    bands, and a D-NeRF-width deformation with random time planes."""
    from scipy.spatial import cKDTree

    from fourdgs_tpu_torch import convert
    from fourdgs_tpu_torch.models.deformation import Deformation
    from fourdgs_tpu_torch.ops import sh
    from fourdgs_tpu_torch.train import config as config_mod

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (N_GAUSS, 3)).astype(np.float32)
    cols = rng.uniform(0.0, 1.0, (N_GAUSS, 3)).astype(np.float32)
    dist, _ = cKDTree(pts).query(pts, k=4)
    d2 = np.maximum((dist[:, 1:] ** 2).mean(-1), 1e-7)
    fields = dict(
        xyz=pts,
        features_dc=sh.rgb_to_sh(cols)[:, None, :],
        features_rest=rng.normal(0.0, 0.1, (N_GAUSS, 15, 3)),
        scaling=np.repeat(np.log(np.sqrt(d2))[:, None], 3, 1),
        rotation=np.tile([1.0, 0.0, 0.0, 0.0], (N_GAUSS, 1)),
        opacity=np.full((N_GAUSS, 1), OPACITY_LOGIT))
    gauss = convert.gaussians_from_numpy(fields, device)

    cfg = config_mod.Config()
    cfg.hidden.multires = [1, 2]        # configs/dnerf/dnerf_default.py
    cfg.hidden.defor_depth = 0
    cfg.hidden.net_width = 64
    cfg.raster = config_mod.RasterParams(capacity=1 << 17, **RASTER)
    gen = torch.Generator().manual_seed(seed)
    deform = Deformation(config_mod.deform_config_from(cfg), generator=gen)
    with torch.no_grad():
        for key, p in deform.grid.planes.items():
            if key[-1] in "245":        # the time planes (x,t) (y,t) (z,t)
                p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    b = cfg.hidden.bounds
    aabb = np.array([[b, b, b], [-b, -b, -b]], np.float32)
    alive = torch.ones(N_GAUSS, dtype=torch.bool, device=device)
    return cfg, gauss, alive, deform.to(device).eval(), aabb


# ---------------------------------------------------------------------------
# phase 3: the serving slice
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_version(name: str):
    """Route the differentiable blend through the plain version of
    `name` ("blend_forward" or "blend_backward") for one comparison."""
    from fourdgs_tpu_torch.ops import blend
    saved = getattr(blend, name)
    setattr(blend, name, getattr(blend, name + "_plain"))
    try:
        yield
    finally:
        setattr(blend, name, saved)


def host_calls(prof: dict, label: str) -> dict:
    """A profile's host syncs, copies from the host and graph launches a
    call (tools/profile_render.py:profile_calls). A sync of the path (a
    `.item()`, a data-dependent size, a copy from pageable host memory)
    is a cudaStreamSynchronize; the cudaDeviceSynchronize calls are the
    profile window's own `torch.cuda.synchronize()`."""
    calls = prof[f"runtime_calls_per_{label}"]
    return {"syncs": calls.get("cudaStreamSynchronize", 0.0),
            "window_device_syncs": calls.get("cudaDeviceSynchronize", 0.0),
            "copies_from_host": prof[f"device_copies_per_{label}"]["HtoD"],
            "graph_launches": calls.get("cudaGraphLaunch", 0.0),
            "kernel_launches": prof[f"kernel_launches_per_{label}"],
            "kernel_ms": prof[f"kernel_ms_per_{label}"],
            "device_busy_share": prof["device_busy_share"]}


def phase_slice(torch, scene, device, frames: int, work: Path):
    """The served frames, captured (the Renderer's default on the card)
    and eager, in one call; returns what phase 4 needs and each mode's
    numbers."""
    from fourdgs_tpu_torch.data.camera import look_at_camera
    from fourdgs_tpu_torch.render.serve import Renderer
    from fourdgs_tpu_torch.tools.profile_render import profile_calls
    from fourdgs_tpu_torch.train import checkpoint, graphs
    from fourdgs_tpu_torch.train import config as config_mod

    cfg, gauss, alive, deform, aabb = scene
    model = work / "model"
    checkpoint.save_snapshot(str(model), 1, gauss, alive, deform, aabb)
    config_mod.save_cfg(cfg, str(model / "cfg_args.json"))
    cams = [look_at_camera(time=i / frames, device=device)
            for i in range(frames)]

    # ---- the main path, with the launch counts read around it: the
    # snapshot loaded, one untimed frame (the capture), then the frames ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graphs.zero_counts()
    t0 = time.perf_counter()
    renderer = Renderer.from_snapshot(str(model), width=SIZE, height=SIZE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    renderer.render(cams[0])
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [renderer.render(c) for c in cams]
    torch.cuda.synchronize()
    t_frames = time.perf_counter() - t0
    ran = kernel_runs()
    launches = {k: ran[k] for k in ("blend_fwd", "binner", "gather_rows")}
    peak = torch.cuda.max_memory_allocated()
    (frame,) = renderer.frames.values()
    replays = frame.program.replays

    renders = renderer.probe_renders + graphs.WARMUP + 1 + frames
    gathers = HEX_GATHERS_PER_LEVEL * len(cfg.hidden.multires)
    log(f"slice: from_snapshot {t_load:.3f} s ({renderer.probe_renders} "
        f"probe renders, caps {renderer.raster_cfg}); captured: first "
        f"frame (capture) {t_capture:.3f} s, {frames} frames in "
        f"{t_frames:.3f} s = {1e3 * t_frames / frames:.3f} ms/frame "
        f"({frames / t_frames:.2f} FPS); peak memory "
        f"{peak / 2**20:.1f} MiB; graph replays {replays}")
    log(f"slice: kernel runs over {renders} renders (replays counted): "
        f"{launches}; a frame: blend_fwd "
        f"{launches['blend_fwd'] / renders:g}, binner "
        f"{launches['binner'] / renders:g}, gather_rows "
        f"{launches['gather_rows'] / renders:g}; the captured frame's "
        f"launches {frame.program.launches}")
    want = {"blend_fwd": renders, "binner": renders,
            "gather_rows": gathers * renders}
    if launches != want or replays != frames + 1:
        raise AssertionError(f"kernel runs {launches} ({replays} replays) "
                             f"for {renders} renders, not {want}")

    # ---- the same frames rendered eagerly, and both modes profiled ----
    eager = dataclasses.replace(renderer, capture=False)
    eager.render(cams[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eager_outs = [eager.render(c) for c in cams]
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    peak_eager = torch.cuda.max_memory_allocated()
    modes = {}
    for name, r, seconds, pk in (("captured", renderer, t_frames, peak),
                                 ("eager", eager, t_eager, peak_eager)):
        it = iter(cams[:PROFILED_STEPS])
        prof = profile_calls(lambda: r.render(next(it)), PROFILED_STEPS)
        modes[name] = {"ms_per_frame": 1e3 * seconds / frames,
                       "fps": frames / seconds, "peak_mib": pk / 2**20,
                       **host_calls(prof, "frame")}
        if name == "eager":
            modes[name]["spans"] = prof["spans"]
            log("slice eager: kernels a frame by span: " + ", ".join(
                f"{k} {prof['spans'][k]['kernel_ms']:.4f} ms"
                for k in ("render.splats", "raster.bin")))
        log(f"slice {name}: {modes[name]['ms_per_frame']:.3f} ms/frame "
            f"({modes[name]['fps']:.2f} FPS); per frame: syncs "
            f"{modes[name]['syncs']:g}, copies from the host "
            f"{modes[name]['copies_from_host']:g}, graph launches "
            f"{modes[name]['graph_launches']:g}, kernel launches "
            f"{modes[name]['kernel_launches']:g}, kernels "
            f"{modes[name]['kernel_ms']:.3f} ms; peak memory "
            f"{modes[name]['peak_mib']:.1f} MiB")
    modes["captured"].update(replays=replays,
                             capture_s=frame.program.seconds)
    if modes["captured"]["syncs"] or modes["captured"]["copies_from_host"]:
        raise AssertionError(f"a replayed frame synced or copied from the "
                             f"host: {modes['captured']}")
    differ = [i for i, (a, b) in enumerate(zip(outs, eager_outs))
              if not all(torch.equal(getattr(a, f), getattr(b, f))
                         for f in ("color", "depth", "alpha", "radii"))]
    log(f"slice: captured frames against eager, bit for bit: "
        f"{frames - len(differ)}/{frames} equal")
    if differ:
        raise AssertionError(f"captured frames {differ} differ from eager")

    alphas = [float(o.alpha.mean()) for o in outs]
    for o in outs:
        if o.color.shape != (SIZE, SIZE, 3) or not bool(
                torch.isfinite(o.color).all() & torch.isfinite(o.depth).all()):
            raise AssertionError("non-finite or misshapen frame")
    if min(alphas) < MEAN_ALPHA_FLOOR:
        raise AssertionError(f"mean alpha {min(alphas)} < {MEAN_ALPHA_FLOOR}")
    num_pairs = [int(o.num_pairs) for o in outs]
    log(f"slice: mean alpha {min(alphas):.4f}..{max(alphas):.4f}; "
        f"num_pairs {min(num_pairs)}..{max(num_pairs)}; max_dropped_pairs "
        f"{max(int(o.dropped_pairs) for o in outs)}; max_dropped_tile "
        f"{max(int(o.dropped_tile) for o in outs)}; frame 0 vs frame -1 "
        f"max diff {float((outs[0].color - outs[-1].color).abs().max()):.4f}")

    # ---- frame 0 through the plain blend on the card (eagerly: a
    # captured frame would replay the kernel) ----
    with plain_version("blend_forward"):
        ref = eager.render(cams[0])
    diff = float((outs[0].color - ref.color).abs().max())
    log(f"slice: frame 0, kernel vs plain blend: color max abs err "
        f"{diff:.3g} (tol {FRAME_TOL:g})")
    if not diff <= FRAME_TOL:
        raise AssertionError(f"frame 0 kernel vs plain blend {diff}")

    # ---- a small image on the card and on the CPU path ----
    small = dataclasses.replace(renderer.raster_cfg, img_width=SMALL,
                                img_height=SMALL)
    gpu = dataclasses.replace(eager, raster_cfg=small)
    cpu = dataclasses.replace(
        renderer, gauss=renderer.gauss.to("cpu"),
        alive=renderer.alive.cpu(),
        deform=copy.deepcopy(renderer.deform).to("cpu"),
        aabb=renderer.aabb.cpu(), bg=renderer.bg.cpu(), raster_cfg=small,
        device=torch.device("cpu"))
    cam = look_at_camera(time=0.3, device=device)
    a = gpu.render(cam).color.cpu()
    b = cpu.render(cam).color
    d = (a - b).abs()
    log(f"slice: {SMALL}x{SMALL} card vs CPU path: color mean abs err "
        f"{float(d.mean()):.3g} (tol {SMALL_TOL_MEAN:g}), max "
        f"{float(d.max()):.3g} (tol {SMALL_TOL_MAX:g})")
    if not (float(d.mean()) <= SMALL_TOL_MEAN
            and float(d.max()) <= SMALL_TOL_MAX):
        raise AssertionError("card and CPU paths disagree")
    return renderer, cams, launches, renders, modes


# ---------------------------------------------------------------------------
# phase 19 (after phase 3): tools/bench_fps.py, the serving metric's bench
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_path():
    """Route an eager frame through the plain versions of K1, the binner
    and D1: the frame that the kernels' frame is held to."""
    from fourdgs_tpu_torch.models import hexplane
    from fourdgs_tpu_torch.ops import gather
    from fourdgs_tpu_torch.ops import rasterize_tiled as rt
    saved = rt.bin_gaussians_count, hexplane.gather_rows
    rt.bin_gaussians_count = rt.bin_gaussians_count_plain
    hexplane.gather_rows = gather.gather_rows_plain
    try:
        with plain_version("blend_forward"):
            yield
    finally:
        rt.bin_gaussians_count, hexplane.gather_rows = saved


def phase_bench_fps(torch, serve: dict) -> dict:
    """tools/bench_fps.py's bench in this process at its defaults (its
    JSON line printed here, never last); then checks that its frames were
    replays only (one capture, the wrappers' host launches its warm-up's
    alone; a profile of a few replays: no sync, no copy from the host, one
    graph launch a frame), that the first replay equals an eager frame of
    the same state bit for bit and the frame through the plain blend,
    binner and gather within TOL with equal drop counters, that K1, the
    binner kernel and D1 ran on every replay, and holds each of them
    against its plain version on the first frame's inputs
    (`phase_kernels`); prints its ms a frame and FPS beside phase 3's
    (`serve`: its modes) and its drops, zero or not. Returns the runs by
    kernel, the kernel checks and the numbers."""
    from fourdgs_tpu_torch.tools import bench_fps
    from fourdgs_tpu_torch.tools.profile_render import profile_calls
    from fourdgs_tpu_torch.train import graphs
    from fourdgs_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    graphs.zero_counts()
    line, renderer, cams, first = bench_fps.run(device="cuda")
    replayed = tracing.replayed_kernels()
    host = {w.__name__: w.launches for w in graphs.WRAPPERS}
    print(json.dumps(line), flush=True)
    d = line["detail"]
    frames = d["frames"]
    (frame,) = renderer.frames.values()
    # the capture's replay (the untimed frame), the timed frames, the drops'
    replays = 1 + 2 * frames
    gathers = (HEX_GATHERS_PER_LEVEL
               * len(bench_fps.bench_config(d["points"]).hidden.multires))
    runs = {"blend_fwd": replayed.get("blend_forward", 0),
            "binner": replayed.get("bin_tiles", 0),
            "gather_rows": replayed.get("gather_rows", 0)}
    want = {"blend_fwd": replays, "binner": replays,
            "gather_rows": gathers * replays}
    warm = {"blend_forward": graphs.WARMUP, "bin_tiles": graphs.WARMUP,
            "gather_rows": gathers * graphs.WARMUP}
    eager_launches = {k: host[k] for k in warm}
    log(f"bench_fps: {renderer.captured} capture, {frame.program.replays} "
        f"replays; kernel runs over the replays {runs} "
        f"({runs['blend_fwd'] / replays:g} K1, "
        f"{runs['binner'] / replays:g} binner, "
        f"{runs['gather_rows'] / replays:g} D1 a frame); host launches "
        f"{eager_launches} (the capture's warm-up: {warm})")
    failed = []
    if (renderer.captured != 1 or frame.program.replays != replays
            or renderer.replayed != replays):
        failed.append(f"{renderer.captured} captures, "
                      f"{frame.program.replays} replays, not 1 and {replays}")
    if runs != want:
        failed.append(f"kernel runs {runs}, not {want}")
    if eager_launches != warm:
        failed.append(f"host launches {eager_launches} beyond the warm-up's "
                      f"{warm}: an eager frame")

    it = iter(cams[:PROFILED_STEPS])
    prof = profile_calls(lambda: renderer.render(next(it)), PROFILED_STEPS)
    calls = host_calls(prof, "frame")
    log(f"bench_fps: a replay (profile of {PROFILED_STEPS}): syncs "
        f"{calls['syncs']:g}, copies from the host "
        f"{calls['copies_from_host']:g}, graph launches "
        f"{calls['graph_launches']:g}, kernels {calls['kernel_ms']:.3f} ms, "
        f"device busy {calls['device_busy_share']:.3f}")
    if (calls["syncs"] or calls["copies_from_host"]
            or calls["graph_launches"] != 1):
        failed.append(f"a replay synced, copied from the host or launched "
                      f"other than one graph: {calls}")

    eager = renderer.render_eager(cams[0])
    equal = all(torch.equal(getattr(first, f), getattr(eager, f))
                for f in ("color", "depth", "alpha", "radii"))
    log(f"bench_fps: the first replay against an eager frame of the same "
        f"state, bit for bit: {equal}")
    if not equal:
        failed.append("the first replay differs from the eager frame")
    if not bool(torch.isfinite(first.color).all()) or tuple(
            first.color.shape) != (d["image"], d["image"], 3):
        failed.append("non-finite or misshapen frame")

    # ---- the first replay against the frame through the plain versions
    # of K1, the binner and D1 (eagerly: a capture would replay them) ----
    with plain_path():
        ref = renderer.render_eager(cams[0])
    plain = {k: float((getattr(first, k) - getattr(ref, k)).abs().max())
             for k in ("color", "depth")}
    counters = {k: (int(getattr(first, k)), int(getattr(ref, k)))
                for k in ("num_pairs", "dropped_pairs", "dropped_tile")}
    log(f"bench_fps: the first replay against the plain blend, binner and "
        f"gather: max abs err " + ", ".join(
            f"{k} {v:.3g} (tol {TOL[k]:g})" for k, v in plain.items())
        + f"; counters (replay, plain) {counters}")
    if not all(v <= TOL[k] for k, v in plain.items()):
        failed.append(f"the first replay differs from the plain frame: "
                      f"{plain}")
    if any(a != b for a, b in counters.values()):
        failed.append(f"drop counters differ from the plain frame: "
                      f"{counters}")

    cap = serve["captured"]
    drops = (f"max_dropped_pairs {d['max_dropped_pairs']}, max_dropped_tile "
             f"{d['max_dropped_tile']}")
    if d["max_dropped_pairs"] or d["max_dropped_tile"]:
        drops += (" (nonzero: the bench's frames drop at tile_cap "
                  f"{renderer.raster_cfg.tile_cap}, pairs "
                  f"{renderer.raster_cfg.bin_pairs_per_chunk} a chunk)")
    log(f"bench_fps: {d['ms_per_frame']} ms/frame, {line['value']} FPS "
        f"({frames} frames, {d['points']} points, {d['image']}x{d['image']}, "
        f"tile_cap {renderer.raster_cfg.tile_cap}, vs_baseline "
        f"{line['vs_baseline']}); phase 3's captured frame "
        f"{cap['ms_per_frame']:.3f} ms/frame, {cap['fps']:.2f} FPS (tile_cap "
        f"{RASTER['tile_cap']}); {drops}; {d['device']}")
    if failed:
        raise AssertionError(f"bench_fps phase: {failed}")

    # ---- each kernel against its plain version at the bench's shapes ----
    k1, checks = phase_kernels(torch, renderer, cams[0], "bench_fps")
    checks["blend_fwd"] = {k: k1[k] for k in (
        "max_abs_err", "max_abs_err_depth", "max_abs_err_t", "ms",
        "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by")}
    seconds = time.perf_counter() - t_phase
    log(f"bench_fps: phase {seconds:.2f} s")
    return {"runs": runs, "replays": replays, "line": line,
            "replay_profile": calls, "capture_s": frame.program.seconds,
            "first_equals_eager": equal, "plain_frame": {
                "max_abs_err": plain, "counters": counters},
            "checks": checks, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 4: the kernels against their plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_gathers(calls: list):
    """Record the (table, idx) of each D1 call that the HexPlane's
    forward makes in a block (models/hexplane.py:_GatherRows)."""
    from fourdgs_tpu_torch.models import hexplane
    real = hexplane.gather_rows

    def record(table, idx):
        calls.append((table, idx))
        return real(table, idx)

    hexplane.gather_rows = record
    try:
        yield calls
    finally:
        hexplane.gather_rows = real


def check_binner(torch, label: str, proj, rc) -> dict:
    """The binner on a path's projection: the kernel route
    (`bin_gaussians_count` on the card: the depth sort and items in
    PyTorch, then csrc/binner.cu) against the plain binner, every field
    equal; its CUDA-event, device and host times beside the plain route's
    and its byte bound (each input of the projection read once, the lists
    and counts written once)."""
    from fourdgs_tpu_torch.ops import rasterize_tiled as rt

    def kernel():
        return rt.bin_gaussians_count(proj, rc)

    def plain():
        return rt.bin_gaussians_count_plain(proj, rc)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    # every field but `slots`, which neither route was asked for
    differ = [f for f in rt.BinnedTiles._fields if f != "slots"
              and not torch.equal(getattr(got, f), getattr(want, f))]
    ms, plain_ms = time_pair(kernel, plain, launches=20)
    dev = device_ms(kernel)
    # csrc/binner.cu's own kernels: the items' gather, the rank, the counts
    own_ms = sum(v for k, v in dev["kernels"].items()
                 if k.startswith(("bin_", "rank_")))
    n, nt = proj.depth.shape[0], rc.num_tiles
    # pix 8, depth 4, rect_min 8, rect_max 8, tiles_touched 4, cull_r2 4
    nbytes = 36 * n + 4 * nt * rc.tile_cap + 8 * nt + 12
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    pairs = int(want.num_pairs)
    log(f"kernel binner ({label}) vs plain: {n} gaussians, {pairs} pairs, "
        f"{int(want.counts.sum())} ranked into {nt} tiles x tile_cap "
        f"{rc.tile_cap}, {int(want.dropped_pairs)} past the budget, "
        f"{int(want.dropped_tile)} past tile_cap; equal on every field: "
        f"{not differ}")
    if differ:
        raise AssertionError(f"binner ({label}) differs from plain in "
                             f"{differ}")
    log(f"binner ({label}): {ms:.4f} ms/call, device {dev['ms']:.4f} ms "
        f"(csrc/binner.cu's kernels {own_ms:.4f} ms) "
        f"{dev['kernels']}, host {dev['host_ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms; {nbytes} bytes, bound {bound_ms:.4f} ms "
        f"(hbm bytes)")
    return {"ms": ms, "device_ms": dev["ms"], "own_device_ms": own_ms,
            "device_kernels": dev["kernels"],
            "device_records": dev["records"], "host_ms": dev["host_ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "nbytes": nbytes,
            "gaussians": n, "pairs": pairs,
            "ranked": int(want.counts.sum()) + int(want.dropped_tile)}


def check_gathers(torch, label: str, calls: list) -> dict:
    """D1 on each HexPlane gather of a path's frame or step (`calls`, the
    recorded (table, idx)): equal to `index_select`; the CUDA-event,
    device and host times of all of them as one call, beside the plain
    version's and index_select's, and each shape's alone; the byte bound
    (the indices and each row named read once, the output written
    once)."""
    from fourdgs_tpu_torch.ops import gather

    differ = [i for i, (t, x) in enumerate(calls)
              if not torch.equal(gather.gather_rows(t, x),
                                 torch.index_select(t, 0, x))]
    torch.cuda.synchronize()
    if differ:
        raise AssertionError(f"gather_rows ({label}) differs from "
                             f"index_select in calls {differ}")

    def nbytes_of(t, x):
        rows = int(torch.unique(x).numel())
        return 4 * x.numel() + 4 * t.shape[1] * (rows + x.numel())

    def timed(group):
        def kernel():
            return [gather.gather_rows(t, x) for t, x in group]

        def plain():
            return [gather.gather_rows_plain(t, x) for t, x in group]

        def library():
            return [torch.index_select(t, 0, x) for t, x in group]

        ms, plain_ms = time_pair(kernel, plain, launches=20)
        lib_ms = time_call(library)
        dev, lib_dev = device_ms(kernel), device_ms(library)
        nbytes = sum(nbytes_of(t, x) for t, x in group)
        return {"ms": ms, "device_ms": dev["ms"], "host_ms": dev["host_ms"],
                "device_records": dev["records"], "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_device_ms": lib_dev["ms"],
                "library_host_ms": lib_dev["host_ms"], "nbytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_S * 1e3}

    shapes = {}
    for t, x in calls:
        shapes.setdefault((t.shape[0], t.shape[1], x.numel()),
                          []).append((t, x))
    per_shape = {}
    for (rows, w, m), group in sorted(shapes.items()):
        rec = timed(group[:1])
        per_shape[f"{rows}x{w} <- {m}"] = {"calls": len(group), **rec}
        log(f"gather_rows ({label}) at a ({rows}, {w}) table, {m} indices "
            f"({len(group)} calls a pass): {rec['ms']:.4f} ms, device "
            f"{rec['device_ms']:.4f} ms, host {rec['host_ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, index_select "
            f"{rec['library_ms']:.4f} ms (device "
            f"{rec['library_device_ms']:.4f} ms); bound "
            f"{rec['bound_ms']:.4f} ms")
    rec = timed(calls)
    log(f"kernel gather_rows ({label}) vs index_select: {len(calls)} "
        f"HexPlane gathers, all equal; together {rec['ms']:.4f} ms, device "
        f"{rec['device_ms']:.4f} ms, host {rec['host_ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, index_select {rec['library_ms']:.4f} ms "
        f"(device {rec['library_device_ms']:.4f} ms); {rec['nbytes']} "
        f"bytes, bound {rec['bound_ms']:.4f} ms (hbm bytes)")
    return {**rec, "calls": len(calls), "shapes": per_shape}


def phase_kernels(torch, renderer, cam, label: str = "serve"):
    """K1 against its plain version on the inputs that the main path's
    frame at `cam` gives it: the renderer's objects and its caps after
    the cap probe; then the binner kernel and D1 on the same frame (their
    lines tagged `label`)."""
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops.rasterize_tiled import prepare_blend
    from fourdgs_tpu_torch.render.render import splats_at

    rc = renderer.raster_cfg
    cam = cam.to(renderer.device)
    with torch.no_grad(), recorded_gathers([]) as gathers:
        splats = splats_at(renderer.gauss, renderer.deform, cam,
                           renderer.aabb, renderer.sh_degree)
        proj, binned, table = prepare_blend(*splats, cam, rc,
                                            renderer.alive)
    gidx, counts = binned.gidx, binned.counts
    log(f"kernel input: frame at t={float(cam.time):g}, caps tile_cap "
        f"{rc.tile_cap}, bin_pairs_per_chunk {rc.bin_pairs_per_chunk}; "
        f"{int(binned.num_pairs)} pairs, {int(binned.dropped_pairs)} dropped "
        f"by the pair budget, {int(binned.overflow.sum())} past tile_cap")
    out = blend.blend_forward(gidx, counts, table, rc)
    ref = blend.blend_forward_plain(gidx, counts, table, rc)
    torch.cuda.synchronize()
    err = {name: float((a - b).abs().max())
           for name, a, b in zip(("color", "depth", "t"), out, ref)}
    log(f"kernel blend_fwd vs plain at {rc.num_tiles} tiles x "
        f"{rc.pixels_per_tile} px, tile_cap {rc.tile_cap}, "
        f"{int(counts.sum())} pairs: max abs err " +
        ", ".join(f"{k} {v:.3g} (tol {TOL[k]:g})" for k, v in err.items()))
    for k, v in err.items():
        if not v <= TOL[k]:
            raise AssertionError(f"blend_fwd disagrees with plain: {k} {v}")

    def kernel():
        return blend.blend_forward(gidx, counts, table, rc)

    ms, plain_ms = time_pair(
        kernel, lambda: blend.blend_forward_plain(gidx, counts, table, rc))
    dev = device_ms(kernel)
    work = blend_work(gidx, counts, table, rc)
    instr = sum(BLEND_FP32_INSTR[k] * work[k] for k in BLEND_FP32_INSTR)
    n_rows = int(torch.unique(gidx[gidx >= 0]).numel())
    nbytes = (4 * rc.num_tiles + 4 * int(counts.sum()) + 48 * n_rows
              + 5 * 4 * rc.num_tiles * rc.pixels_per_tile)
    bounds = {"hbm bytes": nbytes / HBM_BYTES_S,
              "fp32 issue": instr / FP32_ISSUE_S,
              "mufu (expf)": work["exp"] / MUFU_OP_S}
    resource = max(bounds, key=bounds.get)
    where = {k: work.pop(k) for k in ("occupancy", "heaviest_tile",
                                      "heaviest_sub_tile", "warp_issued")}
    log(f"blend_fwd: {ms:.4f} ms/launch, device {dev['ms']:.4f} ms "
        f"{dev['kernels']}, host {dev['host_ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms; pixel x slot evaluations {work}, {instr} FP32 "
        f"instructions, {nbytes} bytes; bounds " +
        ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in bounds.items()) +
        f"; bound by {resource}")
    log(f"blend_fwd: occupancy {where['occupancy']}; heaviest tile "
        f"{where['heaviest_tile']}; heaviest sub-tile "
        f"{where['heaviest_sub_tile']}; warp-issued evaluations "
        f"{where['warp_issued']} against {work['lanes_walked']} walked and "
        f"{work['eval']} needed")
    return {
        "name": "blend_fwd",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "fourdgs_tpu/ops/pallas/blend.py:80",
        "tpu_kernel": "fourdgs_tpu/ops/pallas/blend.py:_fwd_kernel",
        "max_abs_err": err["color"],
        "max_abs_err_depth": err["depth"],
        "max_abs_err_t": err["t"],
        "ms": ms,
        "device_ms": dev["ms"],
        "device_kernels": dev["kernels"],
        "device_records": dev["records"],
        "host_ms": dev["host_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bounds[resource] * 1e3,
        "bound_by": "bytes" if resource == "hbm bytes" else "operations",
        "bound_resource": resource,
        "library_ms": None,        # no single PyTorch call blends
        "evaluations": work,
        **where,
        "ok": True,
    }, {"binner": check_binner(torch, label, proj, rc),
        "gather_rows": check_gathers(torch, label, gathers)}


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------

def padded(torch, gauss, alive, capacity: int):
    """Gaussians and their alive mask in a buffer of `capacity` slots, the
    given ones first; the slots after them dead, with identity
    rotations."""
    from fourdgs_tpu_torch.models.gaussians import FIELDS, GaussianParams

    n = alive.shape[0]

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        out[:n] = x
        return out

    out = GaussianParams(**{f: pad(getattr(gauss, f)) for f in FIELDS})
    out.rotation[n:, 0] = 1.0
    return out, pad(alive, False)


def make_train_state(torch, scene, device):
    """The scene's gaussians in a capacity-TRAIN_CAPACITY buffer with the
    first N_GAUSS slots alive, and a copy of its deformation."""
    from fourdgs_tpu_torch.train.state import create_state

    cfg, gauss, alive, deform, aabb = scene
    cfg = copy.deepcopy(cfg)
    cfg.raster.capacity = TRAIN_CAPACITY
    gauss, alive = padded(torch, gauss, alive, TRAIN_CAPACITY)
    state = create_state(cfg, None, None, SPATIAL_LR_SCALE, aabb=aabb,
                         deform=copy.deepcopy(deform), gauss=gauss,
                         alive=alive, device=device)
    return cfg, state


def grads_agree(a, b) -> float:
    """Largest normalised difference of two gradients of one leaf, the
    difference divided by the leaf's largest |b| (b the reference), as
    the JAX package's gradient tests normalise."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_train(torch, scene, renderer, device, steps: int, seed: int):
    """Fine train_steps at 800x800 on the scene, with the caps the cap
    probe found; returns what phase 6 needs."""
    from fourdgs_tpu_torch.data.camera import look_at_camera
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.tools.profile_render import (TRAIN_SPANS,
                                                        profile_calls)
    from fourdgs_tpu_torch.train import graphs, loop, optim

    cfg, state = make_train_state(torch, scene, device)
    rc, bg, sh = renderer.raster_cfg, renderer.bg, cfg.model.sh_degree
    cams = [look_at_camera(theta=0.3 + 0.2 * i, time=t, device=device)
            for i, t in enumerate(TRAIN_TIMES)]
    check_cam = look_at_camera(time=KERNEL_CHECK_FRAME, device=device)
    gts = [loop.eval_step(state, c, bg, stage="fine", active_sh=sh,
                          raster_cfg=rc).color for c in cams + [check_cam]]
    rng = np.random.default_rng(seed + 1)
    g = state.params["gauss"]
    with torch.no_grad():
        g.features_dc[:N_GAUSS] += torch.from_numpy(rng.normal(
            0.0, NOISE_DC, (N_GAUSS, 1, 3)).astype(np.float32)).to(device)
        g.opacity[:N_GAUSS] += torch.from_numpy(rng.normal(
            0.0, NOISE_OPACITY, (N_GAUSS, 1)).astype(np.float32)).to(device)
    tx = optim.build_optimizer(cfg.opt, SPATIAL_LR_SCALE)
    reg = (cfg.hidden.time_smoothness_weight, cfg.hidden.l1_time_planes,
           cfg.hidden.plane_tv_weight)
    kw = dict(stage="fine", raster_cfg=rc, lambda_dssim=cfg.opt.lambda_dssim,
              reg_weights=reg)

    start = state.to(device)     # both modes start from this state
    key = graphs.StepKey("fine", state.capacity, rc, True, 1,
                         float(cfg.opt.lambda_dssim), reg, graphs.switches())
    # the degree as run_stage passes it on a single card: a device value
    sh_t = torch.full((), sh, dtype=torch.int32, device=device)
    step_fn = loop.step_of_key(tx)       # run_stage's step of a key
    programs = graphs.StepPrograms(step_fn)
    states = {"eager": start.to(device), "captured": start.to(device)}
    del start
    run = {"eager": lambda st, c, g: step_fn(key)(st, c, g, bg, sh_t),
           "captured": lambda st, c, g: programs.run(key, st, c, g, bg,
                                                     sh_t)}

    def step(mode, i):
        return run[mode](states[mode], [cams[i % len(cams)]],
                         gts[i % len(cams)][None])

    # ---- the main path, both modes from one state, with the launch
    # counts read around the two runs ----
    modes, after_one, launches = {}, {}, {}
    graphs.zero_counts()
    for mode in ("eager", "captured"):
        before = kernel_runs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        auxes = []
        for i in range(steps):
            if i == UNTIMED_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            auxes.append(step(mode, i))
            if i == 0:
                after_one[mode] = states[mode].to(device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ran = kernel_runs()
        launches[mode] = {k: ran[k] - before[k] for k in PATH_KERNELS}
        ms = 1e3 * seconds / (steps - UNTIMED_STEPS)
        losses = [float(a.loss) for a in auxes]
        modes[mode] = {"ms_per_step": ms, "rays_per_s": SIZE * SIZE
                       / (ms / 1e3), "peak_mib": peak / 2**20,
                       "losses": losses}
        log(f"train {mode}: {steps} fine steps at {SIZE}x{SIZE}, {N_GAUSS} "
            f"gaussians in capacity {TRAIN_CAPACITY}, caps {rc}; {ms:.3f} "
            f"ms/step over the last {steps - UNTIMED_STEPS} = "
            f"{SIZE * SIZE / (ms / 1e3):.0f} rays/s; peak memory "
            f"{peak / 2**20:.1f} MiB; kernel runs {launches[mode]}")
        log(f"train {mode}: loss first {losses[0]:.6f}, last-5 mean "
            f"{np.mean(losses[-5:]):.6f}, psnr first "
            f"{float(auxes[0].psnr):.3f} last {float(auxes[-1].psnr):.3f}; "
            f"max dropped_pairs {max(int(a.dropped_pairs) for a in auxes)}, "
            f"max dropped_tile {max(int(a.dropped_tile) for a in auxes)}; "
            f"num_pairs {int(auxes[0].num_pairs)}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{mode}: non-finite loss: {losses}")
        if not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"{mode}: the loss did not fall: {losses}")
        nan = sum(int(torch.isnan(p).sum()) for p in optim.param_leaves(
            states[mode].params))
        if nan:
            raise AssertionError(f"{mode}: {nan} NaN parameter values")

    live = programs.live.program
    gathers = HEX_GATHERS_PER_LEVEL * len(cfg.hidden.multires)
    a_step = {"blend_fwd": 1, "blend_bwd": 1, "binner": 1,
              "gather_rows": gathers}
    want = {"eager": {k: v * steps for k, v in a_step.items()},
            "captured": {k: v * (steps + graphs.WARMUP)
                         for k, v in a_step.items()}}
    runs = {mode: steps + (mode == "captured") * graphs.WARMUP
            for mode in launches}
    log("train: kernel runs a step (replays counted): " + "; ".join(
        f"{mode} " + ", ".join(f"{k} {v / runs[mode]:g}"
                               for k, v in launches[mode].items())
        for mode in launches) + f"; the captured step's launches "
        f"{live.launches}")
    if (launches != want or live.replays != steps
            or live.launches != {REPORTED[k]: v for k, v in a_step.items()}):
        raise AssertionError(f"kernel runs {launches} ({live.replays} "
                             f"replays of {live.launches}) for {steps} "
                             f"steps a mode, not {want}")

    # ---- the captured step against the eager one: every leaf after one
    # step, and the losses of the whole run ----
    def leaves(st):
        return (optim.param_leaves(st.params)
                + optim.moment_leaves(st.opt_state.mu)
                + optim.moment_leaves(st.opt_state.nu)
                + [st.xyz_gradient_accum, st.denom, st.max_radii2d])
    one_step = max(grads_agree(a.detach(), b.detach()) for a, b in zip(
        leaves(after_one["captured"]), leaves(after_one["eager"]),
        strict=True))
    le = np.array(modes["eager"]["losses"])
    lc = np.array(modes["captured"]["losses"])
    loss_err = float(np.max(np.abs(lc - le) / np.abs(le)))
    log(f"train: captured against eager: after one step, every leaf "
        f"within {one_step:.3g} normalised (tol {GRAD_TOL:g}); losses of "
        f"the {steps} steps within {loss_err:.3g} relative (tol "
        f"{STEP_LOSS_RTOL:g})")
    if not one_step <= GRAD_TOL:
        raise AssertionError(f"captured step leaves off by {one_step}")
    if not loss_err <= STEP_LOSS_RTOL:
        raise AssertionError(f"captured losses off by {loss_err}")
    del after_one

    # ---- both modes profiled: spans (eager only: a replay opens none),
    # syncs, copies from the host, graph launches, kernel time ----
    state = states["eager"]
    for mode in ("captured", "eager"):
        it = iter(range(PROFILED_STEPS))
        prof = profile_calls(lambda: step(mode, next(it)), PROFILED_STEPS,
                             spans=TRAIN_SPANS, label="step")
        modes[mode].update(host_calls(prof, "step"),
                           runtime_calls=prof["runtime_calls_per_step"])
        if mode == "eager":
            modes[mode]["spans"] = prof["spans"]
            log("train eager: kernels a step by span: " + ", ".join(
                f"{k} {prof['spans'][k]['kernel_ms']:.4f} ms"
                for k in ("render.splats", "raster.bin")))
    modes["captured"].update(replays=live.replays, capture_s=live.seconds)
    for mode, m in modes.items():
        log(f"train {mode}: per step: syncs {m['syncs']:g}, copies from the "
            f"host {m['copies_from_host']:g}, graph launches "
            f"{m['graph_launches']:g}, kernel launches "
            f"{m['kernel_launches']:g}, kernels {m['kernel_ms']:.3f} ms, "
            f"device busy {100 * m['device_busy_share']:.1f}%"
            + (f"; {m['replays']} replays, captured in {m['capture_s']:.3f} "
               f"s" if mode == "captured" else ""))
    if modes["captured"]["syncs"] or modes["captured"]["copies_from_host"]:
        raise AssertionError(f"a replayed step synced or copied from the "
                             f"host: {modes['captured']}")
    launches = {k: launches["eager"][k] + launches["captured"][k]
                for k in PATH_KERNELS}

    # ---- one step's gradients with K2 and with the plain backward, on
    # each training view and the kernel check's view ----
    def grads(cam, gt):
        sg = loop.step_gradients(state, [cam], gt[None], bg, sh, **kw)
        return [x for x in sg.grads + [sg.ndc_grad] if x is not None]

    errs = []
    for view, (cam, gt) in enumerate(zip(cams + [check_cam], gts)):
        with_k2 = grads(cam, gt)
        with plain_version("blend_backward"):
            plain = grads(cam, gt)
        leaf_errs = [grads_agree(a, b) for a, b in zip(with_k2, plain)]
        errs.append(max(leaf_errs))
        if not errs[-1] <= GRAD_TOL:
            leaf = int(np.argmax(leaf_errs))
            raise AssertionError(
                f"K2 step gradients disagree on view {view}: {errs[-1]} in "
                f"leaf {leaf} of shape {tuple(plain[leaf].shape)}")
    log(f"train: one step's gradients, K2 vs plain backward on the card: "
        f"{len(plain)} leaves, normalised max abs err per view "
        f"{', '.join(f'{e:.3g}' for e in errs)} (tol {GRAD_TOL:g})")
    batch_two = check_batch_two(torch, state, step_fn, key, cams, gts, bg,
                                sh_t, leaves, a_step)
    return state, rc, bg, sh, check_cam, gts[-1], launches, {
        **modes, "captured_vs_eager": {"one_step_leaves": one_step,
                                       "losses": loss_err},
        "step_grad_errs": errs, "batch_two": batch_two}


def check_batch_two(torch, state, step_fn, key, cams, gts, bg, sh_t, leaves,
                    a_step: dict):
    """Batch 2: BATCH_TWO_STEPS steps of two cameras each, eagerly and as
    replays of the captured step, from copies of `state` (left as it
    is): every leaf after one step within GRAD_TOL normalised, the losses
    within STEP_LOSS_RTOL."""
    from fourdgs_tpu_torch.train import graphs

    key = key._replace(batch=2)
    device = state.alive.device
    programs = graphs.StepPrograms(step_fn)
    run = {"eager": lambda st, c, g: step_fn(key)(st, c, g, bg, sh_t),
           "captured": lambda st, c, g: programs.run(key, st, c, g, bg,
                                                     sh_t)}
    losses, after_one, ms = {}, {}, {}
    for mode in ("eager", "captured"):
        st = state.to(device)
        losses[mode] = []
        for i in range(BATCH_TWO_STEPS):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            views = [(2 * i + j) % len(cams) for j in range(2)]
            aux = run[mode](st, [cams[v] for v in views],
                            torch.stack([gts[v] for v in views]))
            losses[mode].append(aux.loss)
            if i == 0:
                after_one[mode] = st.to(device)
        torch.cuda.synchronize()
        ms[mode] = 1e3 * (time.perf_counter() - t0) / (BATCH_TWO_STEPS - 1)
        losses[mode] = [float(x) for x in losses[mode]]
        del st
    one_step = max(grads_agree(a.detach(), b.detach()) for a, b in zip(
        leaves(after_one["captured"]), leaves(after_one["eager"]),
        strict=True))
    le, lc = np.array(losses["eager"]), np.array(losses["captured"])
    loss_err = float(np.max(np.abs(lc - le) / np.abs(le)))
    live = programs.live.program
    log(f"train batch 2: {BATCH_TWO_STEPS} steps a mode, eager "
        f"{ms['eager']:.3f} ms/step, captured {ms['captured']:.3f} ms/step "
        f"({live.replays} replays of {live.launches}); captured against "
        f"eager: after one step every leaf within {one_step:.3g} normalised "
        f"(tol {GRAD_TOL:g}), losses within {loss_err:.3g} relative (tol "
        f"{STEP_LOSS_RTOL:g})")
    want = {REPORTED[k]: 2 * v for k, v in a_step.items()}
    if live.launches != want or live.replays != BATCH_TWO_STEPS:
        raise AssertionError(f"batch 2: {live.replays} replays of "
                             f"{live.launches}, not {BATCH_TWO_STEPS} of "
                             f"{want}")
    if not one_step <= GRAD_TOL:
        raise AssertionError(f"batch 2: captured leaves off by {one_step}")
    if not loss_err <= STEP_LOSS_RTOL:
        raise AssertionError(f"batch 2: captured losses off by {loss_err}")
    return {"ms_per_step": ms, "one_step_leaves": one_step,
            "losses": loss_err}


# ---------------------------------------------------------------------------
# phase 6: K2 against its plain version
# ---------------------------------------------------------------------------

def phase_kernels_bwd(torch, state, rc, bg, sh, cam, gt):
    """K2 on the step input of the trained state's frame at `cam`: K1's
    outputs and the cotangents that the step's L1 loss gives them."""
    from fourdgs_tpu_torch.ops import blend, losses
    from fourdgs_tpu_torch.ops.rasterize_tiled import _untile, prepare_blend
    from fourdgs_tpu_torch.render.render import splats_at

    g = state.params["gauss"]
    with torch.no_grad(), recorded_gathers([]) as gathers:
        splats = splats_at(g, state.params["deform"], cam, state.aabb, sh)
        proj, binned, table = prepare_blend(*splats, cam, rc, state.alive)
        out = blend.blend_forward(binned.gidx, binned.counts, table, rc)
    leaves = [o.clone().requires_grad_(True) for o in out]
    color = _untile(leaves[0], rc) + _untile(leaves[2], rc)[..., None] * bg
    loss = losses.l1_loss(color[None], gt[None])
    cot = torch.autograd.grad(loss, leaves, allow_unused=True)
    cot = [torch.zeros_like(o) if c is None else c.contiguous()
           for o, c in zip(out, cot)]
    gidx, counts = binned.gidx, binned.counts
    args = (gidx, counts, table, *out, *cot, rc)
    got = blend.blend_backward(*args)
    ref = blend.blend_backward_plain(*args)
    torch.cuda.synchronize()
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    col_err = ((got - ref).abs() / scale).amax(dim=0).tolist()
    abs_err = float((got - ref).abs().max())
    log(f"kernel input: frame at t={float(cam.time):g}, caps tile_cap "
        f"{rc.tile_cap}; {int(counts.sum())} pairs, "
        f"{int(binned.overflow.sum())} past tile_cap")
    log("kernel blend_bwd vs plain: normalised max abs err per column " +
        ", ".join(f"{n} {e:.3g}" for n, e in zip(GRAD_COLUMNS, col_err)) +
        f" (tol {GRAD_TOL:g}); max abs err {abs_err:.3g}")
    if not max(col_err) <= GRAD_TOL:
        raise AssertionError(f"blend_bwd disagrees with plain: {col_err}")

    def kernel():
        return blend.blend_backward(*args)

    ms, plain_ms = time_pair(kernel,
                             lambda: blend.blend_backward_plain(*args),
                             launches=20)
    dev = device_ms(kernel)
    work = blend_work(gidx, counts, table, rc)
    sums = bwd_work(gidx, counts, table, rc)
    instr = (sum(BLEND_BWD_FP32_INSTR[k] * work[k]
                 for k in BLEND_BWD_FP32_INSTR) + 10 * work["used"])
    mufu = work["exp"] + 2 * work["used"]
    n_rows = int(torch.unique(gidx[gidx >= 0]).numel())
    pixels = rc.num_tiles * rc.pixels_per_tile
    nbytes = (4 * rc.num_tiles + 4 * int(counts.sum()) + 48 * n_rows
              + 10 * 4 * pixels + 10 * 4 * table.shape[0])
    bounds = {"hbm bytes": nbytes / HBM_BYTES_S,
              "fp32 issue": instr / FP32_ISSUE_S,
              "mufu (expf, 2 rcp)": mufu / MUFU_OP_S}
    resource = max(bounds, key=bounds.get)
    # the atomics, reduced batches and block chunks that K2's counting
    # build tallies on this input; the timed build is the same kernel
    # without the tally
    tally = torch.zeros(3, dtype=torch.int64, device=table.device)
    counted = blend.blend_backward(*args, tally=tally)
    torch.cuda.synchronize()
    atomics, batches, chunks = tally.tolist()
    count_err = float(((counted - ref).abs() / scale).max())
    if not count_err <= GRAD_TOL:
        raise AssertionError(f"K2's counting build disagrees: {count_err}")
    # what the counts imply: 45 shuffles a reduced batch, no shared
    # atomics, and at most five float2 atomics a slot a 16 x 8 sub-tile
    # used (a pair whose sum is zero issues none); the first K2 took ten
    # shuffle sums of 5 steps and ten shared atomics per slot a 32-pixel
    # warp used, and ten float atomics per slot a tile used
    first = {"atomics": {"global": 10 * sums["block_slots"]["tile"],
                         "shared": 10 * sums["warp_slots"]["row"]},
             "shuffles": 50 * sums["warp_slots"]["row"]}
    log(f"blend_bwd: {ms:.4f} ms/launch, device {dev['ms']:.4f} ms "
        f"{dev['kernels']}, host {dev['host_ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms; pixel x slot work {work}; {instr} FP32 "
        f"instructions, {mufu} MUFU, {nbytes} bytes; bounds " +
        ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in bounds.items()) +
        f"; bound by {resource}")
    log(f"blend_bwd: sums over pixels {sums}; counted by the kernel: "
        f"{atomics} float2 atomics (at most "
        f"{5 * sums['block_slots']['sub_tile']}), 0 shared, {batches} "
        f"batches reduced, so {45 * batches} warp shuffles; {chunks} "
        f"chunks walked by its sub-tile blocks (blend_work's walk: "
        f"{work['block_chunks']['sub_tile']}); the first design's at these "
        f"counts: {first}; counting build's normalised max abs err "
        f"{count_err:.3g}")
    return {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "fourdgs_tpu/ops/pallas/blend.py:197",
        "tpu_kernel": "fourdgs_tpu/ops/pallas/blend.py:_bwd_fused_kernel",
        "max_abs_err": abs_err,
        "max_normalised_err": max(col_err),
        "ms": ms,
        "device_ms": dev["ms"],
        "device_kernels": dev["kernels"],
        "device_records": dev["records"],
        "host_ms": dev["host_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bounds[resource] * 1e3,
        "bound_by": "bytes" if resource == "hbm bytes" else "operations",
        "bound_resource": resource,
        "library_ms": None,   # no single PyTorch call computes it
        "evaluations": work,
        "sums": sums,
        "float2_atomics": atomics,
        "reduced_batches": batches,
        "block_chunks": chunks,
        "ok": True,
    }, args, work, {"binner": check_binner(torch, "step", proj, rc),
                    "gather_rows": check_gathers(torch, "step", gathers)}


# ---------------------------------------------------------------------------
# phase 7: the training driver with the per-slot path's switches
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def switches_set(values: dict):
    """Set environment variables for a block, and restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def kernel_runs() -> dict:
    """The kernels that ran, launched by the host or by graph replays
    (train/graphs.py:kernel_runs), by the names the kernels line reports
    them under."""
    from fourdgs_tpu_torch.train import graphs
    runs = graphs.kernel_runs()
    return {name: runs[wrapper] for name, wrapper in REPORTED.items()}


def surgery_counts(events, start: int):
    """The live count after each densify, prune and grow, and how many
    densify calls grew it."""
    counts, grew, last = [], 0, start
    for e in events:
        if e["kind"] in ("densify", "prune", "grow", "rollback"):
            counts.append((e["iter"], e["kind"], e["points"]))
            grew += e["kind"] == "densify" and e["points"] > last
            last = e["points"]
    return counts, grew


def as_run_eval(torch, renderer, raster_cfg: dict, capacity: int,
                caps: dict):
    """The Renderer as the run's eval renders a view: the snapshot's
    gaussians in a buffer of the run's capacity, since the binner's pair
    budget is ceil(buffer / bin_chunk) x bin_pairs_per_chunk slots, at the
    run's final raster config with the caps that the eval grew on the
    view. The buffer keeps the run's order of the live gaussians, so the
    binner makes and drops the same pairs."""
    from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig

    gauss, alive = padded(torch, renderer.gauss, renderer.alive, capacity)
    rc = dataclasses.replace(RasterConfig(**raster_cfg),
                             tile_cap=caps["tile_cap"],
                             bin_pairs_per_chunk=caps["bin_pairs_per_chunk"])
    return dataclasses.replace(renderer, gauss=gauss, alive=alive,
                               raster_cfg=rc)


def render_drops(out, rc) -> dict:
    """What a render dropped, at which caps."""
    return {"dropped_pairs": int(out.dropped_pairs),
            "dropped_tile": int(out.dropped_tile),
            "num_pairs": int(out.num_pairs), "tile_cap": rc.tile_cap,
            "bin_pairs_per_chunk": rc.bin_pairs_per_chunk}


def phase_driver(torch, device, work: Path, coarse: int, fine: int,
                 seed: int):
    """The training CLI through both stages with the per-slot path, its
    resume, and the Renderer on the trained snapshot. Returns the launch
    counts of the whole phase and what it measured."""
    from fourdgs_tpu_torch.data.blender import read_cameras_from_transforms
    from fourdgs_tpu_torch.data.blender import read_timeline
    from fourdgs_tpu_torch.data.scene import camera_from_info
    from fourdgs_tpu_torch.ops import losses
    from fourdgs_tpu_torch.render.serve import Renderer
    from fourdgs_tpu_torch.tools import make_synthetic_scene
    from fourdgs_tpu_torch.tools import train as train_cli
    from fourdgs_tpu_torch.train import checkpoint, graphs

    scene, model = work / "scene", work / "driver"
    resumed = work / "driver_resume"
    for d in (model, resumed):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_scene.main([str(scene), "--size", str(DRIVER_SIZE),
                               "--n_train", str(DRIVER_VIEWS[0]),
                               "--n_test", str(DRIVER_VIEWS[1]),
                               "--device", device.type])
    torch.cuda.synchronize()
    log(f"driver: synthetic scene {DRIVER_VIEWS[0]} + {DRIVER_VIEWS[1]} "
        f"views at {DRIVER_SIZE}x{DRIVER_SIZE} in "
        f"{time.perf_counter() - t0:.2f} s")
    config = work / "dnerf_smoke.py"
    config.write_text(DRIVER_CONFIG.format(coarse=coarse, fine=fine))
    ckpt_it = fine - RESUME_ITERS
    common = ["-s", str(scene), "--configs", str(config), "--quiet",
              "--seed", str(seed), "--device", device.type]

    # ---- the main path, with the launch counts read around it ----
    with switches_set(graphs.SWITCHES_ON):
        torch.cuda.synchronize()
        graphs.zero_counts()
        t0 = time.perf_counter()
        summary = train_cli.main(common + [
            "-m", str(model), "--test_iterations", str(coarse), str(fine),
            "--save_iterations", str(fine),
            "--checkpoint_iterations", str(ckpt_it)])
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        resume = train_cli.main(common + [
            "-m", str(resumed), "--test_iterations", str(fine),
            "--start_checkpoint", str(model / f"chkpnt_fine_{ckpt_it}.npz")])
        t_resume = time.perf_counter() - t0
        renderer = Renderer.from_snapshot(str(model), device=device,
                                          width=DRIVER_SIZE,
                                          height=DRIVER_SIZE)
        mapper, _ = read_timeline(str(scene))
        test0 = read_cameras_from_transforms(
            str(scene), "transforms_test.json", True, ".png", mapper,
            (DRIVER_SIZE, DRIVER_SIZE))[0]
        test_cam = camera_from_info(test0, device)
        out = renderer.render(test_cam)
        # the same view as the run's eval rendered it (its last record)
        with open(model / "train_log.jsonl") as f:
            last_eval = [r for r in map(json.loads, f)
                         if r.get("eval") == "test"][-1]
        twin = as_run_eval(torch, renderer, summary["stages"][-1]["raster_cfg"],
                           last_eval["capacity"],
                           last_eval["render_per_view"][0])
        twin_out = twin.render(test_cam)
        torch.cuda.synchronize()
        launches = kernel_runs()

    # ---- what the run reports, and its checks ----
    stats = {"seconds_train_cli": t_train, "seconds_resume_cli": t_resume,
             "stages": {}}
    for st in summary["stages"]:
        n_it = st["iterations"] - st["start"]
        hist = st["history"]
        counts, grew = surgery_counts(st["events"], hist[0]["points"])
        kinds = [e["kind"] for e in st["events"]]
        rec = {"iterations": n_it, "ms_per_iteration":
               1e3 * st["wall_time"] / n_it,
               "iterations_per_s": n_it / st["wall_time"],
               "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
               "points_last": hist[-1]["points"],
               "capacity_last": hist[-1]["capacity"],
               "test_psnr": st["test_psnr"], "active_sh": st["active_sh"],
               "peak_mib": (st["peak_bytes"] or 0) / 2**20,
               "densify_grew": grew, "events": {k: kinds.count(k)
                                                for k in sorted(set(kinds))},
               "tile_cap": st["raster_cfg"]["tile_cap"]}
        g = st["graphs"]
        rec["graphs"] = {
            "captures": len(g["captures"]),
            "recaptures": len(g["captures"]) - 1,
            "rebinds": g["rebinds"], "replays": g["replays"],
            "capture_s": sum(c["seconds"] for c in g["captures"]),
            "capture_s_per_key": [(c["key"], c["seconds"])
                                  for c in g["captures"]]}
        stats["stages"][st["stage"]] = rec
        log(f"driver {st['stage']}: {n_it} iterations, "
            f"{rec['ms_per_iteration']:.3f} ms/iteration "
            f"({rec['iterations_per_s']:.2f} it/s); loss first (it "
            f"{hist[0]['iter']}) {hist[0]['loss']:.6f}, last (it "
            f"{hist[-1]['iter']}) {hist[-1]['loss']:.6f}; test PSNR "
            f"{st['test_psnr']}; SH degree {st['active_sh']}; peak memory "
            f"{rec['peak_mib']:.1f} MiB; events {rec['events']}")
        log(f"driver {st['stage']}: live count after each surgery "
            f"(iteration, kind, points): {counts}")
        gr = rec["graphs"]
        log(f"driver {st['stage']}: captured steps: {gr['captures']} "
            f"captures ({gr['recaptures']} recaptures), {gr['rebinds']} "
            f"rebinds, {gr['replays']} replays, {gr['capture_s']:.2f} s "
            f"capturing")
        for key, sec in gr["capture_s_per_key"]:
            log(f"driver {st['stage']}:   {key}: {sec:.3f} s")
    (res_stage,) = resume["stages"]
    log(f"driver resume: fine from iteration {res_stage['start']} to "
        f"{res_stage['iterations']}, {t_resume:.2f} s; loss last "
        f"{res_stage['history'][-1]['loss']:.6f}; test PSNR "
        f"{res_stage['test_psnr']}")
    gt0 = torch.from_numpy(test0.image).to(device)[None]

    def psnr_of(o):
        return float(losses.psnr(torch.clamp(o.color, 0, 1)[None], gt0)[0])

    psnr, twin_psnr = psnr_of(out), psnr_of(twin_out)
    fine_eval = summary["stages"][-1]["test_psnr"][-1][1]
    view0 = last_eval["psnr_per_view"][0]
    drops = {"renderer": render_drops(out, renderer.raster_cfg),
             "run's eval": last_eval["render_per_view"][0],
             "renderer at the eval's caps": render_drops(twin_out,
                                                         twin.raster_cfg)}
    log(f"driver: Renderer on the trained snapshot (iteration "
        f"{renderer.iteration}, {int(renderer.alive.sum())} points): test "
        f"view 0 PSNR {psnr:.4f} dB at its probed caps, {twin_psnr:.4f} dB "
        f"at the eval's caps in the run's capacity "
        f"{last_eval['capacity']}; the run's eval of it {view0:.4f} dB "
        f"(mean over the test views {fine_eval:.4f}); CLI {t_train:.2f} s; "
        f"launches {launches}")
    for name, d in drops.items():
        log(f"driver: test view 0, {name}: dropped_pairs "
            f"{d['dropped_pairs']}, dropped_tile {d['dropped_tile']}, "
            f"num_pairs {d['num_pairs']}; tile_cap {d['tile_cap']}, "
            f"bin_pairs_per_chunk {d['bin_pairs_per_chunk']}")

    co, fi = stats["stages"]["coarse"], stats["stages"]["fine"]
    ev = {k: co["events"].get(k, 0) + fi["events"].get(k, 0)
          for k in ("densify", "prune", "reset_opacity", "resize")}
    checks = {
        "three densify calls grew the count":
            co["densify_grew"] + fi["densify_grew"] >= 3,
        "a prune": ev["prune"] >= 1,
        "an opacity reset": ev["reset_opacity"] >= 1,
        "a bucket change": ev["resize"] >= 1,
        "the SH ramp": fi["active_sh"] >= 1,
        "test evaluations": bool(co["test_psnr"]) and bool(fi["test_psnr"]),
        "the loss fell": fi["loss_last"] < co["loss_first"],
        "a snapshot": (model / "point_cloud" / f"iteration_{fine}").is_dir(),
        "a checkpoint": (model / f"chkpnt_fine_{ckpt_it}.npz").exists(),
        "the resume ran to the end":
            res_stage["start"] == ckpt_it
            and res_stage["history"][-1]["iter"] == fine,
        "the render matches the run's eval":
            abs(twin_psnr - view0) <= RENDER_PSNR_TOL,
        "every iteration replayed a captured step":
            co["graphs"]["replays"] == co["iterations"]
            and fi["graphs"]["replays"] == fi["iterations"],
    }
    gauss, flat, _ = checkpoint.load_snapshot(
        str(model / "point_cloud" / f"iteration_{fine}"))
    checks["no NaN parameter"] = all(
        np.isfinite(v).all() for v in list(gauss.values())
        + list(flat.values()))
    for kernel in ("blend_fwd", "blend_bwd_slots", "scatter_add_rows",
                   "scatter_set_scalars", "binner", "gather_rows"):
        checks[f"{kernel} launched"] = launches[kernel] > 0
    failed = [k for k, ok in checks.items() if not ok]
    log(f"driver checks: {len(checks) - len(failed)}/{len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"driver phase: {failed}")
    stats.update(render_psnr=psnr, render_psnr_at_eval_caps=twin_psnr,
                 eval_psnr_view0=view0, test_view0_drops=drops,
                 raster_cfg=summary["stages"][-1]["raster_cfg"],
                 capacity=last_eval["capacity"],
                 eval_programs=summary["eval_programs"],
                 evals={st["stage"]: st["evals"]
                        for st in summary["stages"]})
    return launches, stats


# ---------------------------------------------------------------------------
# phase 10 (after phase 7): the render and metrics CLIs on phase 7's model
# ---------------------------------------------------------------------------

def phase_eval(torch, device, work: Path, fine: int, in_loop_psnr: float):
    """tools/render.py on phase 7's trained model (its train, test and
    video splits, each frame a replay of the captured frame), then
    tools/metrics.py on the renders, with the kernels' runs read around
    both. Returns the launch counts and what it measured."""
    from fourdgs_tpu_torch.ops import lpips
    from fourdgs_tpu_torch.tools import metrics as metrics_cli
    from fourdgs_tpu_torch.tools import render as render_cli
    from fourdgs_tpu_torch.train import graphs

    scene, model = work / "scene", work / "driver"
    for split in ("train", "test", "video"):
        shutil.rmtree(model / split, ignore_errors=True)

    # ---- the main path, with the launch counts read around it ----
    torch.cuda.synchronize()
    graphs.zero_counts()
    printed = {"render": io.StringIO(), "metrics": io.StringIO()}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed["render"]):
        rendered = render_cli.main([
            "-m", str(model), "-s", str(scene), "--image_size",
            str(DRIVER_SIZE), str(DRIVER_SIZE), "--device", device.type])
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed["metrics"]):
        (results,) = metrics_cli.main(["-m", str(model), "--device",
                                       device.type]).values()
    t_metrics = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = kernel_runs()
    printed = {k: v.getvalue() for k, v in printed.items()}
    print(printed["render"] + printed["metrics"], end="", flush=True)

    splits = rendered["splits"]
    method = f"ours_{fine}"
    views = {"train": DRIVER_VIEWS[0], "test": DRIVER_VIEWS[1],
             "video": splits["video"]["views"]}
    for name, res in splits.items():
        log(f"eval: {name}: {res['views']} views at {DRIVER_SIZE}x"
            f"{DRIVER_SIZE}, {res['passes']} passes ({res['renders']} "
            f"renders), the last {res['seconds']:.3f} s, {res['fps']:.2f} "
            f"FPS; max dropped_pairs {res['max_dropped_pairs']}, max "
            f"dropped_tile {res['max_dropped_tile']} "
            f"({res['views_dropping']} views)")
    renders = (rendered["probe_renders"] + graphs.WARMUP
               * rendered["captures"] + rendered["replays"])
    gathers = HEX_GATHERS_PER_LEVEL * 2        # DRIVER_CONFIG's multires
    want = {"blend_fwd": renders, "binner": renders,
            "gather_rows": gathers * renders}
    got = {k: launches[k] for k in want}
    psnr = results[method]["PSNR"]
    weights = [n for n in metrics_cli.LPIPS_NETS
               if lpips.load_weights(n) is not None]
    lpips_keys = sorted(k for k in results[method] if k.startswith("lpips"))
    log(f"eval: render CLI {t_render:.2f} s (iteration "
        f"{rendered['iteration']}, {rendered['probe_renders']} probe renders "
        f"on train view 0, caps tile_cap "
        f"{rendered['raster_cfg']['tile_cap']} bin_pairs_per_chunk "
        f"{rendered['raster_cfg']['bin_pairs_per_chunk']}; "
        f"{rendered['captures']} captures, {rendered['replays']} replays); "
        f"kernel runs {got} over {renders} renders; metrics CLI "
        f"{t_metrics:.2f} s: {results[method]}; post-hoc test PSNR "
        f"{psnr:.4f} dB against phase 7's last in-loop eval "
        f"{in_loop_psnr:.4f} (tol {RENDER_PSNR_TOL})")

    def pngs(split, sub):
        d = model / split / method / sub
        return len([f for f in os.listdir(d) if f.endswith(".png")])

    checks = {
        "every split rendered": sorted(splits) == ["test", "train", "video"]
        and rendered["iteration"] == fine,
        "the PNG counts": all(
            pngs(sp, "renders") == n and pngs(sp, "gt") == (
                0 if sp == "video" else n) for sp, n in views.items()),
        "every frame a replay": rendered["captures"] >= 1
        and rendered["replays"] == sum(r["renders"] for r in splits.values()),
        "the kernels ran every render": got == want,
        "an FPS printed for each split": all(
            r["fps"] > 0 and f"{sp}: {r['views']} views, FPS: "
            in printed["render"] for sp, r in splits.items()),
        "results.json": (model / "results.json").exists()
        and (model / "per_view.json").exists(),
        "finite metrics": all(np.isfinite(results[method][k]) for k in (
            "PSNR", "SSIM", "MS-SSIM", "D-SSIM")),
        "LPIPS as its weights allow": (
            lpips_keys == [f"lpips-{n}" for n in sorted(weights)]
            and (bool(weights) or "LPIPS: skipped" in printed["metrics"])),
        "the post-hoc PSNR matches the run's eval":
            abs(psnr - in_loop_psnr) <= RENDER_PSNR_TOL,
    }
    failed = [k for k, ok in checks.items() if not ok]
    log(f"eval checks: {len(checks) - len(failed)}/{len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"eval phase: {failed}")
    return got, {
        "seconds_render_cli": t_render, "seconds_metrics_cli": t_metrics,
        "splits": splits, "probe_renders": rendered["probe_renders"],
        "replays": rendered["replays"], "results": results[method],
        "in_loop_test_psnr": in_loop_psnr}


# ---------------------------------------------------------------------------
# phase 21 (after phase 10): the captured step's compile schedule
# ---------------------------------------------------------------------------

# the train CLI on phase 7's scene, config and switches with the prewarmer
# on and off in turns; then a pair on phase 17(a)'s run-to-run-equal route,
# where the two settings must train the same model (on phase 7's route two
# runs of one setting part: their test PSNRs differ by up to 0.3 dB)
PREWARM_RUNS = ("on", "off", "off", "on")
PREWARM_EQUAL_RUNS = ("off", "on")
# the kernels of phase 7's path (the per-slot switches set)
PREWARM_PATH = ("blend_fwd", "blend_bwd_slots", "scatter_add_rows",
                "scatter_set_scalars", "binner", "gather_rows")


def prewarm_figures(st: dict) -> dict:
    """One stage of the train CLI's summary: its captures on the training
    thread and what its prewarms did, ms an iteration, the ms between
    steps while a prewarm thread lived and while none did, peak memory,
    the last test PSNR and loss, and the captures at an iteration where
    the SH degree rose (only the densify statistics' stop may capture
    there)."""
    g = st["graphs"]
    n = st["iterations"] - st["start"]
    at = [(st["start"] + c["step"], c["changed"]) for c in g["captures"]]
    return {
        "iterations": n, "ms_per_iteration": 1e3 * st["wall_time"] / n,
        "captures": len(g["captures"]),
        "capture_s": sum(c["seconds"] for c in g["captures"]),
        "capture_keys": [(c["key"], c["step"], c["seconds"], c["changed"])
                         for c in g["captures"]],
        **{k: g[k] for k in ("prewarmed", "prewarms_used",
                             "prewarms_dropped", "prewarms_failed",
                             "prewarms_retried",
                             "prewarms_dropped_for_memory",
                             "prewarm_wait_s", "prewarm_s", "close_wait_s",
                             "step_gaps", "replays")},
        "prewarms": [(p["key"], p["used"], p["dropped"], p["failed"],
                      p["wait"], p["seconds"]) for p in g["prewarms"]],
        "peak_mib": (st["peak_bytes"] or 0) / 2**20,
        "test_psnr": st["test_psnr"][-1][1],
        "loss_last": st["history"][-1]["loss"],
        "events": [(e["iter"], e["kind"], e["points"]) for e in st["events"]],
        "active_sh": st["active_sh"],
        "captured_at_ramps": [(it, ch) for it, ch in at if it % 1000 == 0],
        "ramp_captures": [(it, ch) for it, ch in at if it % 1000 == 0
                          and ch != ["track_stats"]]}


def prewarm_runs(train_cli, settings, name: str, configs: dict, common):
    """The train CLI once a setting of `settings`, each run's figures."""
    runs = []
    for i, setting in enumerate(settings):
        t0 = time.perf_counter()
        summary = train_cli.main(common + [
            "--configs", str(configs[setting]),
            "-m", str(configs["work"] / f"prewarm_{name}_{i}_{setting}")])
        runs.append({"prewarm": setting, "route": name,
                     "seconds_train_cli": time.perf_counter() - t0,
                     "stages": {st["stage"]: prewarm_figures(st)
                                for st in summary["stages"]}})
    return runs


def phase_prewarm(torch, device, work: Path, coarse: int, fine: int,
                  seed: int):
    """The train CLI through both stages on phase 7's scene, config and
    switches, with the prewarmer on and off in turns (PREWARM_RUNS), the
    kernels' runs read around the four; then once off and once on
    (PREWARM_EQUAL_RUNS) on phase 17(a)'s run-to-run-equal route. Fails on
    a failed prewarm, a run with it on that used no prewarmed program, a
    capture at an SH ramp (at the ramp only the densify statistics' stop
    of phase 7's schedule may capture, and with the prewarmer on
    nothing), an iteration that did not replay, and, on the equal route,
    test PSNRs of the two settings apart by more than RENDER_PSNR_TOL.
    Returns the launch counts and what it measured."""
    from fourdgs_tpu_torch.tools import train as train_cli
    from fourdgs_tpu_torch.tools.bench import card_limit
    from fourdgs_tpu_torch.tools.quality_run import environment
    from fourdgs_tpu_torch.train import graphs

    base = DRIVER_CONFIG.format(coarse=coarse, fine=fine)
    off = base.replace("RasterParams = dict(min_bucket=1024)",
                       "RasterParams = dict(min_bucket=1024, prewarm=False)")
    if off == base:
        raise AssertionError("phase 21: DRIVER_CONFIG's RasterParams moved")
    configs = {"on": work / "prewarm_on.py", "off": work / "prewarm_off.py",
               "work": work}
    configs["on"].write_text(base)
    configs["off"].write_text(off)
    common = ["-s", str(work / "scene"), "--quiet", "--seed", str(seed),
              "--device", device.type, "--test_iterations", str(coarse),
              str(fine)]
    t_phase = time.perf_counter()
    with switches_set(graphs.SWITCHES_ON):
        torch.cuda.synchronize()
        graphs.zero_counts()
        runs = prewarm_runs(train_cli, PREWARM_RUNS, "timed", configs,
                            common)
        torch.cuda.synchronize()
        launches = kernel_runs()
    with environment(EQUAL_ROUTE_SWITCHES), deterministic_mode(torch), \
            sorted_hex_backward(torch):
        equal = prewarm_runs(train_cli, PREWARM_EQUAL_RUNS, "equal",
                             configs, common)
    for run in runs + equal:
        for stage, f in run["stages"].items():
            gaps = f["step_gaps"]
            log(f"prewarm {run['route']} ({run['prewarm']}) {stage}: "
                f"{f['ms_per_iteration']:.3f} ms/iteration; captures on the "
                f"training thread {f['captures']} ({f['capture_s']:.3f} s); "
                f"prewarmed {f['prewarmed']}, used {f['prewarms_used']}, "
                f"dropped {f['prewarms_dropped']}, failed "
                f"{f['prewarms_failed']}, built again "
                f"{f['prewarms_retried']}, dropped for memory "
                f"{f['prewarms_dropped_for_memory']}, wait "
                f"{f['prewarm_wait_s']:.3f} s, "
                f"background {f['prewarm_s']:.3f} s, close "
                f"{f['close_wait_s']:.3f} s; ms between steps while "
                f"prewarming {gaps['prewarming']}, else {gaps['quiet']}; "
                f"peak {f['peak_mib']:.1f} MiB; test PSNR "
                f"{f['test_psnr']:.4f}; SH degree {f['active_sh']}, "
                f"captures at a ramp {f['captured_at_ramps']}")
            for key, step, sec, changed in f["capture_keys"]:
                log(f"prewarm {run['route']} {stage}:   captured {key} at "
                    f"step {step} ({changed}): {sec:.3f} s")
            for key, used, dropped, failed, wait, sec in f["prewarms"]:
                log(f"prewarm {run['route']} {stage}:   prewarm {key}: "
                    + ("used" if used else "dropped" if dropped else
                       "failed" if failed else "held")
                    + f", wait {wait:.3f} s, built in {sec:.3f} s")
    psnr = {s: [r["stages"]["fine"]["test_psnr"] for r in runs
                if r["prewarm"] == s] for s in ("on", "off")}
    pair = {r["prewarm"]: r["stages"]["fine"] for r in equal}
    same = {k: pair["on"][k] == pair["off"][k]
            for k in ("test_psnr", "loss_last", "events")}
    on_runs = [r for r in runs + equal if r["prewarm"] == "on"]
    every = [f for r in runs + equal for f in r["stages"].values()]
    checks = {
        "no prewarm failed": all(f["prewarms_failed"] == 0 for f in every),
        "each run with the prewarmer on used a prewarmed program": all(
            sum(f["prewarms_used"] for f in r["stages"].values()) >= 1
            for r in on_runs),
        "none with it off prewarmed": all(
            not f["prewarms"] for r in runs + equal if r["prewarm"] == "off"
            for f in r["stages"].values()),
        "no capture at an SH ramp": all(not f["ramp_captures"]
                                        for f in every),
        "with the prewarmer on, nothing captured at a ramp": all(
            not f["captured_at_ramps"] for r in on_runs
            for f in r["stages"].values()),
        "the SH ramp": all(r["stages"]["fine"]["active_sh"] >= 1
                           for r in runs + equal),
        "every iteration replayed a captured step": all(
            f["replays"] == f["iterations"] for f in every),
        "on the equal route the two settings' test PSNRs agree":
            abs(pair["on"]["test_psnr"] - pair["off"]["test_psnr"])
            <= RENDER_PSNR_TOL,
        **{f"{k} launched": launches[k] > 0 for k in PREWARM_PATH},
    }
    seconds = time.perf_counter() - t_phase
    failed = [k for k, ok in checks.items() if not ok]
    log(f"prewarm: phase 21 in {seconds:.2f} s ({card_limit(device)}); "
        f"timed runs' test PSNR on {psnr['on']}, off {psnr['off']}; equal "
        f"route off / on {pair['off']['test_psnr']:.4f} / "
        f"{pair['on']['test_psnr']:.4f} (tol {RENDER_PSNR_TOL}), equal bit "
        f"for bit: {same}; launches {launches}; checks "
        f"{len(checks) - len(failed)}/{len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"prewarm phase: {failed}")
    return launches, {"runs": runs, "equal_route": equal, "psnr": psnr,
                      "equal_route_same": same, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 22 (after phase 21): train -> render -> metrics with the JAX
# package out of reach
# ---------------------------------------------------------------------------

def phase_standalone(torch, work: Path, seed: int):
    """The train, render and metrics CLIs on phase 7's scene in a fresh
    interpreter under utils/standalone.py's guard, from an include of the
    port's configs/dnerf/bouncingballs.py, with no switch set. Returns the
    kernels' runs in that interpreter and what it measured."""
    from fourdgs_tpu_torch.tools.bench import card_limit
    from fourdgs_tpu_torch.train import config as config_mod
    from fourdgs_tpu_torch.train import graphs
    from fourdgs_tpu_torch.utils import standalone

    coarse, fine = STANDALONE_ITERS
    scene, model = work / "scene", work / "standalone"
    shutil.rmtree(model, ignore_errors=True)
    config = work / "standalone_smoke.py"
    config.write_text(STANDALONE_CONFIG.format(
        base=str(CONFIG_DIR / "dnerf" / "bouncingballs.py"), coarse=coarse,
        fine=fine))
    cfg = config_mod.apply_config_file(config_mod.Config(), str(config))
    steps = [
        ("fourdgs_tpu_torch.tools.train", [
            "-s", scene, "-m", model, "--configs", config, "--quiet",
            "--seed", seed, "--test_iterations", coarse, fine,
            "--save_iterations", fine]),
        ("fourdgs_tpu_torch.tools.render", ["-m", model, "-s", scene,
                                            "--skip_train"]),
        ("fourdgs_tpu_torch.tools.metrics", ["-m", model])]
    env = {k: v for k, v in os.environ.items() if k not in graphs.SWITCHES}
    t0 = time.perf_counter()
    proc = subprocess.run(standalone.command(ROOT, steps), cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=STANDALONE_TIMEOUT)
    seconds = time.perf_counter() - t0
    (work / "standalone.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        print(proc.stdout[-4000:] + proc.stderr[-8000:], flush=True)
        raise AssertionError(f"standalone phase: the guarded run exited "
                             f"{proc.returncode}")
    rec = standalone.parse(proc.stdout)
    fig = rec["figures"]
    runs = {name: rec["kernel_runs"][wrapper]
            for name, wrapper in REPORTED.items()}
    h = cfg.hidden
    step_s = [(s["module"], round(s["seconds"], 3)) for s in rec["steps"]]
    log(f"standalone: {seconds:.2f} s ({card_limit(torch.device('cuda'))}); "
        f"steps {step_s}; "
        f"refused {rec['refused']} {rec['events']}; config {config.name} on "
        f"bouncingballs.py: kplanes {h.kplanes_config['resolution']} x "
        f"{h.kplanes_config['output_coordinate_dim']}, multires "
        f"{h.multires}, net_width {h.net_width}, defor_depth "
        f"{h.defor_depth}; ms/iteration {fig['ms_per_iteration']}; test "
        f"PSNR in loop {fig['in_loop_test_psnr']:.4f} (SH degree "
        f"{fig['active_sh']}), post hoc {fig['post_hoc_test_psnr']:.4f} "
        f"(iteration {fig['iteration']}, tol {RENDER_PSNR_TOL}); render CLI "
        f"FPS {fig['fps']}; kernel runs {runs}")
    checks = {
        "no refused open or import": rec["refused"] == 0,
        "train, render and metrics ended":
            [s["module"] for s in rec["steps"]] == list(standalone.CHAIN),
        "bouncingballs.py's widths":
            h.kplanes_config["resolution"] == [64, 64, 64, 75]
            and h.kplanes_config["output_coordinate_dim"] == 32
            and (h.multires, h.net_width, h.defor_depth) == ([1, 2], 64, 0),
        "the last iteration rendered": fig["iteration"] == fine,
        # the deformation leaves the SH rest bands alone: the run's degree
        # and the render's (the model's) render alike
        "the SH degrees render alike": fig["active_sh"]
            == cfg.model.sh_degree or h.no_dshs,
        "the post-hoc PSNR matches the run's eval":
            abs(fig["post_hoc_test_psnr"] - fig["in_loop_test_psnr"])
            <= RENDER_PSNR_TOL,
        **{f"{k} ran": runs[k] > 0 for k in PATH_KERNELS},
        "the default route (K3-K5 did not run)":
            runs["blend_bwd_slots"] == runs["scatter_add_rows"]
            == runs["scatter_set_scalars"] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    log(f"standalone checks: {len(checks) - len(failed)}/{len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"standalone phase: {failed}")
    return runs, {**fig, "seconds": seconds, "steps": rec["steps"],
                  "refused": rec["refused"]}


# ---------------------------------------------------------------------------
# phases 11-15 (after phase 10): the nerfies (HyperNeRF), DyNeRF,
# MultipleView, PanopticSports and Colmap layouts
# ---------------------------------------------------------------------------

# the scenes: the ball scene (tools/make_synthetic_scene.py:ball_scene)
# seen through the layouts' cameras at their datasets' sizes
NERFIES_SIZE = (536, 960)      # rgb/2x (W, H): a HyperNeRF vrig view
NERFIES_TIMES = 40             # timestamps, each seen by both cameras
DYNERF_SIZE = (1352, 1014)     # data/dynerf.py IMG_WH
DYNERF_CAMS = 4                # cam00 is the test camera
DYNERF_FRAMES = 24             # frames a camera, at t = index / 300
SCENE_FOVX = 0.9               # radians, at each layout's width
SCENE_POINTS = 2000            # the initial cloud, as synth_mv's
# a DyNeRF rig faces its scene from near the origin, as LLFF captures do,
# so the ball scene is moved in front of it
DYNERF_OFFSET = (0.0, 0.0, -4.0)
DYNERF_RIG = ((0.0, 0.0, 0.0), (-0.5, 0.1, 0.1), (0.5, 0.1, 0.1),
              (0.0, -0.35, 0.05))
BANK_STEPS = 20                # phase 12: captured steps a bank mode
DECODE_VIEWS = 8               # phase 12: views decoded on one thread
# phases 13-15: JPEG layouts, written with data/jpeg.py's encoder
JPEG_QUALITY = 95              # 4:2:0
MULTIVIEW_SIZE = (960, 540)
MULTIVIEW_FRAMES = 20          # frames a camera; DYNERF_RIG's four cameras
PANOPTIC_SIZE = (640, 360)
PANOPTIC_TIMES = 20
# the Panoptic dome: (angle, height) of each camera on a circle of radius
# 4 around the scene, the last the test camera, and each one's principal
# point moved off centre by these fractions of the width and the height
PANOPTIC_CAMS = ((-0.7, 0.4), (-0.25, -0.3), (0.25, 0.5), (0.7, -0.2),
                 (0.05, 0.1))
PANOPTIC_SHIFT = ((0.06, -0.04), (-0.05, 0.06), (0.03, 0.05),
                  (-0.06, -0.03), (0.045, -0.06))
COLMAP_SIZE = (1008, 756)      # LLFF's images_4
COLMAP_VIEWS = 24
COLMAP_FY = 1.04               # fy / fx of the PINHOLE camera
LAYOUT_VIEWS = 4               # phases 11-15: views decoded on one thread
# the layouts' config files; the overlay cuts only the schedule to the
# run's length: iterations, densify and prune every `every` iterations
# until `until`, prune above 1,000 live points, buckets from 1,024 (so
# that the few thousand points cross one)
LAYOUTS = {
    "nerfies": dict(config="hypernerf/default.py", size=NERFIES_SIZE,
                    views=dict(n_times=NERFIES_TIMES),
                    coarse=200, fine=400, every=50, until=300),
    "dynerf": dict(config="dynerf/default.py", size=DYNERF_SIZE,
                   views=dict(n_frames=DYNERF_FRAMES),
                   coarse=100, fine=200, every=25, until=150),
    "multipleview": dict(config="multipleview/default.py",
                         size=MULTIVIEW_SIZE,
                         views=dict(n_frames=MULTIVIEW_FRAMES),
                         coarse=100, fine=200, every=25, until=150),
    # Colmap and PanopticSports have no config file: the config defaults
    "panoptic": dict(config=None, size=PANOPTIC_SIZE,
                     views=dict(n_times=PANOPTIC_TIMES),
                     coarse=100, fine=200, every=25, until=150),
    "colmap": dict(config=None, size=COLMAP_SIZE,
                   views=dict(n_views=COLMAP_VIEWS),
                   coarse=100, fine=100, every=25, until=75),
}
LAYOUT_CONFIG = """\
{base}OptimizationParams = dict(
    coarse_iterations={coarse},
    iterations={fine},
    densify_from_iter={every},
    densification_interval={every},
    pruning_from_iter={every},
    pruning_interval={every},
    densify_until_iter={until},
    prune_min_points=1000,
)
RasterParams = dict(min_bucket=1024)
"""


def look_at(pos, target=(0.0, 0.0, 0.0)):
    """The rows right, down, forward (OpenCV axes) of a camera at `pos`
    looking at `target`, world up +y."""
    fwd = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd])


def render_ball(torch, camera, t: float, size, device,
                offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The ball scene at time t through `camera`, over white, as (H, W, 3)
    uint8 (truncated, as tools/make_synthetic_scene.py writes it)."""
    from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig, rasterize
    from fourdgs_tpu_torch.tools.make_synthetic_scene import ball_scene

    m, s, q, o, c = ball_scene(t)
    m = m + np.asarray(offset, np.float32)
    cfg = RasterConfig(img_width=size[0], img_height=size[1], tile_size=16,
                       tile_cap=1024, chunk=32)
    with torch.no_grad():
        img = rasterize(*(torch.from_numpy(x).to(device)
                          for x in (m, s, q, o, c)),
                        camera, torch.ones(3, device=device), cfg).color
    return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def write_cloud(path: Path, seed: int, offset=(0.0, 0.0, 0.0)) -> None:
    """SCENE_POINTS random points around the ball scene, random colours
    (the layouts' points3D_downsample2.ply)."""
    from fourdgs_tpu_torch.data import ply
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.3, 1.3, (SCENE_POINTS, 3)) + np.asarray(offset)
    rgb = rng.uniform(0.0, 255.0, (SCENE_POINTS, 3))
    cols = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    cols.update({n: np.zeros(SCENE_POINTS) for n in ("nx", "ny", "nz")})
    cols.update(red=rgb[:, 0], green=rgb[:, 1], blue=rgb[:, 2])
    ply._write_ply(str(path), {k: v.astype(np.float32)
                               for k, v in cols.items()})


def write_nerfies_scene(torch, root: Path, device, size=NERFIES_SIZE,
                        n_times: int = NERFIES_TIMES, seed: int = 0) -> None:
    """A vrig-like HyperNeRF capture: a pair of cameras 0.3 apart sweeping
    one radian around the scene over n_times timestamps, the left camera's
    views the train split and the right's the val split; rgb/2x images of
    `size` (the camera JSONs' image_size twice it), covisible masks for
    the val views, and the initial cloud. Each image is rendered through
    the camera that data/hyper.py reads for it, at its time."""
    import concurrent.futures

    from fourdgs_tpu_torch.data.hyper import HyperScene
    from fourdgs_tpu_torch.data.png import write_png
    from fourdgs_tpu_torch.data.scene import camera_from_info

    w, h = size
    focal = 2 * w / (2 * np.tan(SCENE_FOVX / 2))
    for d in ("camera", "rgb/2x", "covisible/2x/val"):
        (root / d).mkdir(parents=True, exist_ok=True)
    ids, meta, split = [], {}, {"left": [], "right": []}
    for i in range(n_times):
        theta = -0.5 + i / max(n_times - 1, 1)
        rig = 4.0 * np.array([np.sin(theta) * np.cos(0.3), np.sin(0.3),
                              np.cos(theta) * np.cos(0.3)])
        right = look_at(rig)[0]
        for cam_id, side in enumerate(("left", "right")):
            pos = rig + (cam_id - 0.5) * 0.3 * right
            iid = f"{side}_{i:05d}"
            with open(root / "camera" / f"{iid}.json", "w") as f:
                json.dump({"orientation": look_at(pos).tolist(),
                           "position": pos.tolist(), "focal_length": focal,
                           "principal_point": [w, h],
                           "image_size": [2 * w, 2 * h], "skew": 0.0,
                           "pixel_aspect_ratio": 1.0,
                           "radial_distortion": [0.0, 0.0, 0.0],
                           "tangential_distortion": [0.0, 0.0]}, f)
            ids.append(iid)
            split[side].append(iid)
            meta[iid] = {"camera_id": cam_id, "warp_id": i,
                         "appearance_id": i}
    for name, body in (
            ("metadata.json", meta),
            ("dataset.json", {"count": len(ids), "num_exemplars": n_times,
                              "ids": ids, "train_ids": split["left"],
                              "val_ids": split["right"]}),
            ("scene.json", {"scale": 1.0, "center": [0.0, 0.0, 0.0],
                            "near": 0.1, "far": 10.0})):
        with open(root / name, "w") as f:
            json.dump(body, f)
    write_cloud(root / "points3D_downsample2.ply", seed)
    mask = np.full((h, w), 255, np.uint8)
    mask[:, : w // 8] = 0                 # a band the left camera misses
    hs = HyperScene(str(root))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futures = []
        for idx, iid in enumerate(hs.all_img_ids):
            info = hs.camera_info(idx, image_sized=False)
            img = render_ball(torch, camera_from_info(info, device),
                              info.time, size, device)
            futures.append(pool.submit(write_png, hs.all_img[idx], img))
            if iid in split["right"]:
                futures.append(pool.submit(
                    write_png, str(root / "covisible/2x/val" / f"{iid}.png"),
                    mask))
        for f in futures:
            f.result()


def write_dynerf_scene(torch, root: Path, device, size=DYNERF_SIZE,
                       n_frames: int = DYNERF_FRAMES, seed: int = 0) -> None:
    """A DyNeRF (Neu3D) capture: poses_bounds.npy for DYNERF_RIG's cameras
    (cam00 the test camera), each looking at the ball scene moved to
    DYNERF_OFFSET, an empty camNN.mp4 placeholder each, n_frames frames a
    camera under camNN/images/%04d.png at `size`, rendered at t = index /
    300 through the camera that data/dynerf.py reads, and the initial
    cloud. The frames have Paeth rows, as PIL writes the frames that a
    DyNeRF preprocessing extracts, so that they decode at the rate real
    frames do. The field of view is SCENE_FOVX across the width."""
    import concurrent.futures

    from fourdgs_tpu_torch.data import dynerf
    from fourdgs_tpu_torch.data.llff_poses import c2w_to_rt
    from fourdgs_tpu_torch.data.png import write_png
    from fourdgs_tpu_torch.data.scene import camera_from_info
    from fourdgs_tpu_torch.data.scene_info import CameraInfo
    from fourdgs_tpu_torch.ops.transforms import focal2fov

    root.mkdir(parents=True, exist_ok=True)
    hwf = [2028.0, 2704.0, 2704.0 / (2 * np.tan(SCENE_FOVX / 2))]
    rows = []
    for pos in DYNERF_RIG:
        right, down, fwd = look_at(pos, DYNERF_OFFSET)
        # LLFF's columns: down, right, back, position; then h, w, focal
        llff = np.stack([down, right, -fwd, np.asarray(pos), hwf], 1)
        rows.append(np.concatenate([llff.ravel(), [2.5, 5.5]]))
    np.save(root / "poses_bounds.npy", np.stack(rows))
    for i in range(len(DYNERF_RIG)):
        (root / f"cam{i:02d}.mp4").touch()
        (root / f"cam{i:02d}" / "images").mkdir(parents=True, exist_ok=True)
    write_cloud(root / "points3D_downsample2.ply", seed, DYNERF_OFFSET)
    poses, _, focal = dynerf.camera_poses(str(root), size)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futures = []
        for i in range(len(DYNERF_RIG)):
            R, T = c2w_to_rt(poses[i])
            for idx in range(n_frames):
                info = CameraInfo(
                    uid=idx, R=R, T=T, fovx=focal2fov(focal, size[0]),
                    fovy=focal2fov(focal, size[1]), image=None,
                    image_path=None, image_name=None, width=size[0],
                    height=size[1], time=idx / dynerf.N_FRAMES)
                img = render_ball(torch, camera_from_info(info, device),
                                  info.time, size, device, DYNERF_OFFSET)
                futures.append(pool.submit(
                    write_png, str(root / f"cam{i:02d}" / "images"
                                   / f"{idx:04d}.png"), img, 4))
        for f in futures:
            f.result()


def write_views(torch, infos, device, size, offset=(0.0, 0.0, 0.0)) -> None:
    """Render each view's image through the Camera the port's reader gives
    it, at its time, and write it to its path as a JPEG (JPEG_QUALITY,
    4:2:0; 8 threads)."""
    import concurrent.futures

    from fourdgs_tpu_torch.data.jpeg import write_jpeg
    from fourdgs_tpu_torch.data.scene import camera_from_info

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futures = []
        for info in infos:
            img = render_ball(torch, camera_from_info(info, device),
                              info.time, size, device, offset)
            os.makedirs(os.path.dirname(info.image_path), exist_ok=True)
            futures.append(pool.submit(write_jpeg, info.image_path, img,
                                       JPEG_QUALITY))
        for f in futures:
            f.result()


def colmap_pose(pos, target=(0.0, 0.0, 0.0)):
    """COLMAP's (qvec, tvec) of a camera at `pos` looking at `target`."""
    from fourdgs_tpu_torch.data.colmap import rotmat2qvec
    r = look_at(pos, target)
    return rotmat2qvec(r), -r @ np.asarray(pos, np.float64)


def write_multipleview_scene(torch, root: Path, device, size=MULTIVIEW_SIZE,
                             n_frames: int = MULTIVIEW_FRAMES,
                             seed: int = 0) -> None:
    """A MultipleView rig: DYNERF_RIG's cameras looking at the ball scene
    moved to DYNERF_OFFSET, in sparse_/ (camera 1 a SIMPLE_PINHOLE of
    SCENE_FOVX across the width; image frameNN.jpg is camNN), the same
    poses in poses_bounds_multipleview.npy for the spiral, the initial
    cloud, and n_frames frames a camera, camNN/frame_00001.jpg, ..., at
    `size`, rendered at time index / n_frames through the cameras that
    data/multiview.py reads."""
    from fourdgs_tpu_torch.data import colmap, multiview

    w, h = size
    focal = w / (2 * np.tan(SCENE_FOVX / 2))
    (root / "sparse_").mkdir(parents=True, exist_ok=True)
    colmap.write_cameras_binary({1: colmap.ColmapCamera(
        id=1, model="SIMPLE_PINHOLE", width=w, height=h,
        params=np.array([focal, w / 2, h / 2]))},
        str(root / "sparse_" / "cameras.bin"))
    images, rows = {}, []
    for c, pos in enumerate(DYNERF_RIG):
        q, t = colmap_pose(pos, DYNERF_OFFSET)
        images[c + 1] = colmap.ColmapImage(
            id=c + 1, qvec=q, tvec=t, camera_id=1,
            name=f"frame{c + 1:02d}.jpg", xys=np.zeros((0, 2)),
            point3D_ids=np.zeros(0, np.int64))
        right, down, fwd = look_at(pos, DYNERF_OFFSET)
        llff = np.stack([down, right, -fwd, np.asarray(pos), [h, w, focal]],
                        1)
        rows.append(np.concatenate([llff.ravel(), [2.5, 5.5]]))
        # the reader counts cam01's files: the frames' names come first
        d = root / f"cam{c + 1:02d}"
        d.mkdir(exist_ok=True)
        for i in range(n_frames):
            (d / f"frame_{i + 1:05d}.jpg").touch()
    colmap.write_images_binary(images, str(root / "sparse_" / "images.bin"))
    np.save(root / "poses_bounds_multipleview.npy", np.stack(rows))
    write_cloud(root / "points3D_multipleview.ply", seed, DYNERF_OFFSET)
    info = multiview.read_multipleview_scene(str(root))
    write_views(torch, info.train_cameras, device, size, DYNERF_OFFSET)


def write_panoptic_scene(torch, root: Path, device, size=PANOPTIC_SIZE,
                         n_times: int = PANOPTIC_TIMES,
                         seed: int = 0) -> None:
    """A PanopticSports sequence: PANOPTIC_CAMS on a dome of radius 4
    around the ball scene (the last one the test split), each with K's
    focal of SCENE_FOVX across the width and its principal point moved off
    centre by PANOPTIC_SHIFT; train_meta.json and test_meta.json for
    n_times timesteps, init_pt_cld.npz of SCENE_POINTS points, and
    ims/<camera>/<t>.jpg at `size`, rendered at time t / n_times through
    the K-built cameras that data/panoptic.py reads."""
    from fourdgs_tpu_torch.data import panoptic

    w, h = size
    focal = w / (2 * np.tan(SCENE_FOVX / 2))
    ks, w2cs = [], []
    for (theta, height), (dx, dy) in zip(PANOPTIC_CAMS, PANOPTIC_SHIFT):
        pos = np.array([4 * np.sin(theta), height, 4 * np.cos(theta)])
        w2c = np.eye(4)
        w2c[:3, :3] = look_at(pos)
        w2c[:3, 3] = -w2c[:3, :3] @ pos
        ks.append([[focal, 0.0, w / 2 + dx * w], [0.0, focal, h / 2 + dy * h],
                   [0.0, 0.0, 1.0]])
        w2cs.append(w2c.tolist())
    n_train = len(PANOPTIC_CAMS) - 1
    root.mkdir(parents=True, exist_ok=True)
    for name, cams in (("train_meta.json", range(n_train)),
                       ("test_meta.json", [n_train])):
        meta = {"w": w, "h": h,
                "fn": [[f"{c}/{t}.jpg" for c in cams] for t in range(n_times)],
                "k": [[ks[c] for c in cams] for _ in range(n_times)],
                "w2c": [[w2cs[c] for c in cams] for _ in range(n_times)],
                "cam_id": [list(cams) for _ in range(n_times)]}
        with open(root / name, "w") as f:
            json.dump(meta, f)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.3, 1.3, (SCENE_POINTS, 3))
    np.savez(root / "init_pt_cld.npz", data=np.concatenate(
        [xyz, rng.uniform(0, 1, (SCENE_POINTS, 3)),
         np.ones((SCENE_POINTS, 1))], 1))
    info = panoptic.read_panoptic_scene(str(root))
    write_views(torch, info.train_cameras + info.test_cameras, device, size)


def write_colmap_scene(torch, root: Path, device, size=COLMAP_SIZE,
                       n_views: int = COLMAP_VIEWS, seed: int = 0) -> None:
    """A monocular COLMAP capture: n_views poses orbiting the ball scene
    (1.6 radians at radius 4, rising), a PINHOLE camera with fy = COLMAP_FY
    fx, in sparse/0/ as binary files with SCENE_POINTS points in
    points3D.bin, and images/00000.jpg, ... at `size`, each rendered at
    time index / n_views through the camera that data/colmap_scene.py
    reads. The points' PLY is left for the first load to write."""
    from fourdgs_tpu_torch.data import colmap, colmap_scene

    w, h = size
    fx = w / (2 * np.tan(SCENE_FOVX / 2))
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    colmap.write_cameras_binary({1: colmap.ColmapCamera(
        id=1, model="PINHOLE", width=w, height=h,
        params=np.array([fx, COLMAP_FY * fx, w / 2, h / 2]))},
        str(sparse / "cameras.bin"))
    images = {}
    for i in range(n_views):
        theta = -0.8 + 1.6 * i / max(n_views - 1, 1)
        pos = [4 * np.sin(theta), -0.3 + 0.6 * i / max(n_views - 1, 1),
               4 * np.cos(theta)]
        q, t = colmap_pose(pos)
        images[i + 1] = colmap.ColmapImage(
            id=i + 1, qvec=q, tvec=t, camera_id=1, name=f"{i:05d}.jpg",
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64))
    colmap.write_images_binary(images, str(sparse / "images.bin"))
    rng = np.random.default_rng(seed)
    colmap.write_points3d_binary(rng.uniform(-1.3, 1.3, (SCENE_POINTS, 3)),
                                 rng.uniform(0, 255, (SCENE_POINTS, 3)),
                                 str(sparse / "points3D.bin"))
    (root / "images").mkdir(exist_ok=True)
    info = colmap_scene.read_colmap_scene(str(root), None, True)
    os.remove(info.ply_path)
    write_views(torch, info.train_cameras + info.test_cameras, device, size)


WRITERS = {"nerfies": write_nerfies_scene, "dynerf": write_dynerf_scene,
           "multipleview": write_multipleview_scene,
           "panoptic": write_panoptic_scene, "colmap": write_colmap_scene}


@contextlib.contextmanager
def dot_free_dir(path: Path):
    """`path`, or where its absolute path has a dot (which the DyNeRF
    reader's `video_path.split(".")[0]` cuts at) a fresh temporary
    directory, removed after the block."""
    import tempfile
    if "." not in str(path.resolve()):
        yield path
        return
    tmp = Path(tempfile.mkdtemp(prefix="fourdgs_"))
    if "." in str(tmp):
        raise RuntimeError(f"neither {path} nor {tmp} is free of dots")
    try:
        yield tmp / path.name
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def step_checks(torch, kind: str, state, cams, gts, bg, sh, rc,
                cfg) -> dict:
    """One eager step of the trained state on a batch: its gradients with
    K2 against the plain backward's (every leaf within GRAD_TOL
    normalised), and its HexPlane forward gathers, which must be
    HEX_GATHERS_PER_LEVEL a level a view and as wide as the config's
    planes (16, or 32 at the defaults), against index_select
    (check_gathers)."""
    from fourdgs_tpu_torch.train import loop

    reg = (cfg.hidden.time_smoothness_weight, cfg.hidden.l1_time_planes,
           cfg.hidden.plane_tv_weight)
    kw = dict(stage="fine", raster_cfg=rc, lambda_dssim=cfg.opt.lambda_dssim,
              reg_weights=reg)

    def grads():
        sg = loop.step_gradients(state, cams, gts, bg, sh, **kw)
        return [x for x in sg.grads + [sg.ndc_grad] if x is not None]

    with recorded_gathers([]) as gathers:
        with_k2 = grads()
    with plain_version("blend_backward"):
        plain = grads()
    errs = [grads_agree(a, b) for a, b in zip(with_k2, plain, strict=True)]
    want = HEX_GATHERS_PER_LEVEL * len(cfg.hidden.multires) * len(cams)
    widths = sorted({t.shape[1] for t, _ in gathers})
    log(f"{kind}: one step of batch {len(cams)} at {rc.img_width}x"
        f"{rc.img_height}: gradients with K2 against the plain backward, "
        f"{len(plain)} leaves, normalised max abs err {max(errs):.3g} (tol "
        f"{GRAD_TOL:g}); {len(gathers)} HexPlane gathers (want {want}), "
        f"widths {widths}")
    if not max(errs) <= GRAD_TOL:
        raise AssertionError(f"{kind}: K2 step gradients off by {max(errs)}"
                             f" in leaf {int(np.argmax(errs))}")
    width = cfg.hidden.kplanes_config["output_coordinate_dim"]
    if len(gathers) != want or widths != [width]:
        raise AssertionError(f"{kind}: {len(gathers)} gathers of widths "
                             f"{widths}, not {want} of {width}")
    return {"grad_err": max(errs),
            "gather_rows": check_gathers(torch, f"{kind} step", gathers)}


def bank_check(torch, device, scene: str, state, cfg, rc, bg, sh, extent,
               seed: int) -> dict:
    """The DyNeRF train split in each bank mode (stack_cameras with the
    budgets that pick it): every view equal bit for bit across the three;
    then BANK_STEPS captured steps of run_stage from one state with the
    device bank and with a lazy bank and its prefetch, both with the
    prewarmer off (they time the banks), and once more with the device
    bank and the prewarmer on, which builds the next bucket's step beside
    them at this dataset's size; the losses of the three must agree within
    STEP_LOSS_RTOL, and no prewarm may fail. Prints each run's ms a step
    (the loss read after every step) and peak memory, what the prewarms
    did, one view's decode ms on one thread, and the lazy bank's
    prefetched batches and wait a step."""
    from fourdgs_tpu_torch.data.scene import (DECODE_WORKERS, _load_u8,
                                              load_scene_info, stack_cameras)
    from fourdgs_tpu_torch.train import loop, optim

    infos = load_scene_info(scene)[0].train_cameras
    budgets = {"device": {}, "host": {"device_budget": 0},
               "lazy": {"device_budget": 0, "host_budget": 0}}
    t0 = time.perf_counter()
    splits = {m: stack_cameras(infos, device, **b) for m, b in budgets.items()}
    t_stack = time.perf_counter() - t0
    banks = {m: s.images for m, s in splits.items()}
    if [b.mode for b in banks.values()] != list(budgets):
        raise AssertionError(f"bank modes {[b.mode for b in banks.values()]}")
    n, batch = len(infos), cfg.opt.batch_size
    differ = []
    for start in range(0, n, batch):
        idxs = np.arange(start, min(n, start + batch))
        ref = banks["device"][idxs]
        differ += [(m, start) for m in ("host", "lazy")
                   if not torch.equal(banks[m][idxs], ref)]
    banks["host"].close()
    banks["lazy"].close()
    # one view's decode on one thread (the frames have Paeth rows)
    t0 = time.perf_counter()
    for info in infos[:DECODE_VIEWS]:
        _load_u8(info)
    decode_ms = 1e3 * (time.perf_counter() - t0) / DECODE_VIEWS
    log(f"dynerf banks: {n} train views at {splits['device'].width}x"
        f"{splits['device'].height} in device, host and lazy modes "
        f"({t_stack:.2f} s to stack the three); equal bit for bit over "
        f"every view: {not differ}; one view decodes on one thread in "
        f"{decode_ms:.3f} ms")
    if differ:
        raise AssertionError(f"bank batches differ: {differ[:5]}")

    quiet = copy.deepcopy(cfg)
    quiet.opt.densify_until_iter = 0       # no surgery: steps only
    quiet.raster.prewarm = False           # nothing built beside the timed
    cams = splits["device"].cameras
    warm = copy.deepcopy(quiet)
    warm.raster.prewarm = True
    runs = {}
    for name, mode, run_cfg in (("device", "device", quiet),
                                ("lazy", "lazy", quiet),
                                ("device_prewarm", "device", warm)):
        bank = (banks["device"] if mode == "device" else stack_cameras(
            infos, device, with_images=True, **budgets["lazy"]).images)
        stamps = []
        st = state.to(device)
        tx = optim.build_optimizer(run_cfg.opt, extent)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        res = loop.run_stage(
            run_cfg, st, "fine", BANK_STEPS, cams, bank, tx, rc,
            rng=np.random.default_rng(seed), log_every=1,
            cameras_extent=extent, initial_active_sh=sh,
            on_iteration=lambda it, s, a: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        g = res.graphs
        # each step ends with its loss read; the first two capture
        ms = 1e3 * float(np.median(np.diff(stamps[2:])))
        runs[name] = {
            "ms_per_step": ms, "losses": [r["loss"] for r in res.history],
            "replays": g["replays"], "capacity": st.capacity,
            "peak_allocated_mib": torch.cuda.max_memory_allocated(device)
            / 2**20,
            "peak_reserved_mib": torch.cuda.max_memory_reserved(device)
            / 2**20,
            "prewarms": [(p["key"], p["used"], p["dropped"], p["failed"],
                          p["retried"], p["seconds"]) for p in g["prewarms"]],
            **{k: g[k] for k in ("prewarmed", "prewarms_failed",
                                 "prewarms_retried",
                                 "prewarms_dropped_for_memory")},
            "stats": dict(bank.stats) if mode == "lazy" else None}
        if mode == "lazy":
            bank.close()
        del st, res
    banks["device"].close()
    le = np.array(runs["device"]["losses"])
    ll = np.array(runs["lazy"]["losses"])
    loss_err = float(np.max(np.abs(ll - le) / np.abs(le)))
    lw = np.array(runs["device_prewarm"]["losses"])
    warm_err = float(np.max(np.abs(lw - le) / np.abs(le)))
    s = runs["lazy"]["stats"]
    waits = 1e3 * np.array(s.pop("waits"))
    wait_ms = float(np.median(waits))
    ratio = runs["lazy"]["ms_per_step"] / runs["device"]["ms_per_step"]
    log(f"dynerf banks: {BANK_STEPS} captured steps of batch {batch} from "
        f"one state: device bank {runs['device']['ms_per_step']:.3f} "
        f"ms/step, lazy bank {runs['lazy']['ms_per_step']:.3f} ms/step "
        f"(median, each step's loss read; lazy / device {ratio:.2f}); "
        f"lazy: {s['decoded']} views "
        f"decoded by {DECODE_WORKERS} threads, "
        f"{s['prefetched']} of {s['batches']} batches prefetched, the "
        f"training thread waited {wait_ms:.3f} ms a step (median; mean "
        f"{waits.mean():.3f}, the first {waits[0]:.3f}); losses within "
        f"{loss_err:.3g} relative (tol {STEP_LOSS_RTOL:g})")
    w = runs["device_prewarm"]
    for name, r in runs.items():
        log(f"dynerf banks: {name}: capacity {r['capacity']}, peak "
            f"{r['peak_allocated_mib']:.1f} MiB allocated, "
            f"{r['peak_reserved_mib']:.1f} MiB reserved; prewarmed "
            f"{r['prewarmed']}, failed {r['prewarms_failed']}, built again "
            f"after running out of memory {r['prewarms_retried']}, dropped "
            f"for a capture's memory {r['prewarms_dropped_for_memory']}")
    for key, used, dropped, failed, retried, sec in w["prewarms"]:
        log(f"dynerf banks: device_prewarm: prewarm {key}: "
            + ("used" if used else "failed" if failed else "dropped"
               if dropped else "held")
            + f", built again {retried}, built in {sec:.3f} s")
    log(f"dynerf banks: device bank with the prewarmer on "
        f"{w['ms_per_step']:.3f} ms/step (median), losses within "
        f"{warm_err:.3g} relative of the device bank's with it off")
    if not all(r["replays"] == BANK_STEPS for r in runs.values()):
        raise AssertionError(f"bank steps replayed {runs}")
    if not loss_err <= STEP_LOSS_RTOL:
        raise AssertionError(f"lazy-bank losses off by {loss_err}")
    if not warm_err <= STEP_LOSS_RTOL:
        raise AssertionError(f"prewarm-on losses off by {warm_err}")
    if w["prewarms_failed"] or not w["prewarmed"]:
        raise AssertionError(f"bank prewarms: {w['prewarms']}")
    return {"views": n, "equal": True, "loss_err": loss_err,
            "prewarm_loss_err": warm_err,
            "prewarm_run": {k: w[k] for k in (
                "ms_per_step", "prewarmed", "prewarms_failed",
                "prewarms_retried", "prewarms_dropped_for_memory",
                "prewarms")},
            **{f"{m}_peak_mib": (r["peak_allocated_mib"],
                                 r["peak_reserved_mib"])
               for m, r in runs.items()},
            "decode_ms_per_view": decode_ms, "wait_ms_per_step": wait_ms,
            "lazy_over_device": ratio, "stack_s": t_stack,
            "wait_ms_per_step_mean": float(waits.mean()),
            **{f"{m}_ms_per_step": r["ms_per_step"] for m, r in runs.items()},
            "lazy_stats": s}


def phase_layout(torch, device, work: Path, kind: str, seed: int):
    """The train CLI on a synthetic scene in the `kind` layout at its
    config's widths and batch, its schedule cut (LAYOUTS), then the render
    and metrics CLIs, with the kernels' runs read around each; then K1 on
    a test frame and one step's K2 gradients and gathers against their
    plain versions at the layout's size, and for dynerf the bank check.
    Returns the launch counts (training and evaluation summed) and what
    it measured."""
    from fourdgs_tpu_torch.data.scene import Scene, _load_u8
    from fourdgs_tpu_torch.ops import losses
    from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
    from fourdgs_tpu_torch.render.serve import Renderer
    from fourdgs_tpu_torch.tools import metrics as metrics_cli
    from fourdgs_tpu_torch.tools import render as render_cli
    from fourdgs_tpu_torch.tools import train as train_cli
    from fourdgs_tpu_torch.train import checkpoint, graphs
    from fourdgs_tpu_torch.train import config as config_mod

    spec = LAYOUTS[kind]
    w, h = spec["size"]
    t_phase = time.perf_counter()
    with dot_free_dir(work / kind) as scene:
        shutil.rmtree(scene, ignore_errors=True)
        model = work / f"{kind}_model"
        shutil.rmtree(model, ignore_errors=True)
        t0 = time.perf_counter()
        WRITERS[kind](torch, scene, device, size=spec["size"], seed=seed,
                      **spec["views"])
        torch.cuda.synchronize()
        t_write = time.perf_counter() - t0
        config = work / f"{kind}_smoke.py"
        base = ""
        if spec["config"]:
            path = CONFIG_DIR / spec["config"]
            base = f"_base_ = {str(path)!r}\n"
        config.write_text(LAYOUT_CONFIG.format(
            base=base,
            **{k: spec[k] for k in ("coarse", "fine", "every", "until")}))
        cfg = config_mod.apply_config_file(config_mod.Config(), str(config))
        batch, levels = cfg.opt.batch_size, len(cfg.hidden.multires)
        log(f"{kind}: scene written in {t_write:.2f} s at {w}x{h}; config "
            f"{spec['config'] or 'defaults'}: batch {batch}, multires "
            f"{cfg.hidden.multires}, kplanes {cfg.hidden.kplanes_config}, "
            f"net_width {cfg.hidden.net_width}, defor_depth "
            f"{cfg.hidden.defor_depth}")

        # ---- the main path: the train CLI, then the render and metrics
        # CLIs, with the launch counts read around each ----
        torch.cuda.synchronize()
        graphs.zero_counts()
        t0 = time.perf_counter()
        summary = train_cli.main([
            "-s", str(scene), "-m", str(model), "--configs", str(config),
            "--quiet", "--seed", str(seed), "--device", device.type,
            "--test_iterations", str(spec["coarse"]), str(spec["fine"]),
            "--save_iterations", str(spec["fine"]),
            "--checkpoint_iterations", str(spec["fine"])])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        train_runs = kernel_runs()
        graphs.zero_counts()
        t0 = time.perf_counter()
        rendered = render_cli.main(["-m", str(model), "-s", str(scene),
                                    "--device", device.type])
        t_render = time.perf_counter() - t0
        (results,) = metrics_cli.main(["-m", str(model), "--device",
                                       device.type]).values()
        torch.cuda.synchronize()
        eval_runs = kernel_runs()

        # ---- what the runs report ----
        stages = {}
        for st in summary["stages"]:
            n_it = st["iterations"] - st["start"]
            g, kinds = st["graphs"], [e["kind"] for e in st["events"]]
            stages[st["stage"]] = {
                "iterations": n_it,
                "ms_per_iteration": 1e3 * st["wall_time"] / n_it,
                "loss_first": st["history"][0]["loss"],
                "loss_last": st["history"][-1]["loss"],
                "points_last": st["history"][-1]["points"],
                "capacity_last": st["history"][-1]["capacity"],
                "test_psnr": st["test_psnr"],
                "events": {k: kinds.count(k) for k in sorted(set(kinds))},
                "captures": len(g["captures"]), "replays": g["replays"],
                "capture_s": sum(c["seconds"] for c in g["captures"]),
                "prewarmed": g["prewarmed"], "prewarms_used":
                g["prewarms_used"], "prewarms_failed": g["prewarms_failed"],
                "prewarms_retried": g["prewarms_retried"],
                "peak_mib": (st["peak_bytes"] or 0) / 2**20}
            r = stages[st["stage"]]
            log(f"{kind} {st['stage']}: {n_it} iterations, "
                f"{r['ms_per_iteration']:.3f} ms/iteration; loss "
                f"{r['loss_first']:.6f} -> {r['loss_last']:.6f}; test PSNR "
                f"{r['test_psnr']}; points {r['points_last']} in "
                f"{r['capacity_last']}; events {r['events']}; "
                f"{r['captures']} captures ({r['capture_s']:.2f} s), "
                f"{r['prewarmed']} prewarmed ({r['prewarms_used']} used, "
                f"{r['prewarms_retried']} built again after running out of "
                f"memory), "
                f"{r['replays']} replays; peak {r['peak_mib']:.1f} MiB")
        splits = rendered["splits"]
        method = f"ours_{spec['fine']}"
        in_loop = summary["stages"][-1]["test_psnr"][-1][1]
        psnr = results[method]["PSNR"]
        for name, res in splits.items():
            log(f"{kind} eval: {name}: {res['views']} views at {w}x{h}, "
                f"{res['passes']} passes, {res['fps']:.2f} FPS; max "
                f"dropped_pairs {res['max_dropped_pairs']}, max dropped_tile "
                f"{res['max_dropped_tile']}")
        log(f"{kind} eval: metrics {results[method]}; post-hoc test PSNR "
            f"{psnr:.4f} dB against the last in-loop eval {in_loop:.4f} "
            f"(tol {RENDER_PSNR_TOL}); train CLI {t_train:.2f} s, render "
            f"CLI {t_render:.2f} s; kernel runs: training {train_runs}, "
            f"evaluation {eval_runs}")

        # ---- the test split evaluated as the run's eval does, at the SH
        # degree the render CLI renders (the model's): a cut schedule ends
        # below it, and where the deformation moves the SH rest bands
        # (no_dshs False, the dynerf configs) the two degrees differ ----
        t0 = time.perf_counter()
        sc = Scene.load(str(scene), device=device)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        for info in sc.info.train_cameras[:LAYOUT_VIEWS]:
            _load_u8(info)
        decode_ms = 1e3 * (time.perf_counter() - t0) / LAYOUT_VIEWS
        log(f"{kind} data: Scene.load {t_load:.3f} s (the train CLI's "
            f"{summary['scene_load_s']:.3f} s), {len(sc.train)} train and "
            f"{len(sc.test)} test views, banks {sc.train.images.mode}/"
            f"{sc.test.images.mode}; one view decodes on one thread in "
            f"{decode_ms:.3f} ms")
        state, _, _, sh = checkpoint.load_checkpoint(
            str(model / f"chkpnt_fine_{spec['fine']}.npz"),
            config_mod.deform_config_from(cfg), device)
        rc = RasterConfig(**summary["stages"][-1]["raster_cfg"])
        bg = torch.ones(3, device=device) if cfg.model.white_background \
            else torch.zeros(3, device=device)
        degree = cfg.model.sh_degree
        at_degree = float(np.mean([float(losses.psnr(torch.clamp(
            train_cli.eval_render(state, cam, bg, "fine", degree, rc)[0], 0,
            1)[None], sc.test.images[[i]])[0])
            for i, cam in enumerate(sc.test.cameras)]))
        log(f"{kind} eval: the run ended at SH degree {sh} of {degree} "
            f"(no_dshs {cfg.hidden.no_dshs}); its state's test PSNR at "
            f"degree {degree}, as the run's eval renders: {at_degree:.4f} dB "
            f"(the post-hoc {psnr:.4f}, the in-loop eval at degree {sh} "
            f"{in_loop:.4f})")

        # ---- the kernels' runs and the run's checks ----
        co, fi = stages["coarse"], stages["fine"]
        # each capture, on this thread or a prewarm's, warms up eagerly
        stepped = {s: r["replays"] + graphs.WARMUP * (r["captures"]
                                                      + r["prewarmed"])
                   for s, r in stages.items()}
        gathers = HEX_GATHERS_PER_LEVEL * levels
        renders = (rendered["probe_renders"] + graphs.WARMUP
                   * rendered["captures"] + rendered["replays"])
        ev = {k: co["events"].get(k, 0) + fi["events"].get(k, 0)
              for k in ("densify", "prune", "resize")}

        def pngs(split, sub):
            d = model / split / method / sub
            return len([f for f in os.listdir(d) if f.endswith(".png")])

        views = {sp: r["views"] for sp, r in splits.items()}
        checks = {
            "every iteration replayed a captured step":
                co["replays"] == co["iterations"]
                and fi["replays"] == fi["iterations"],
            "a densify, a prune and a bucket change":
                min(ev.values()) >= 1,
            "test evaluations": bool(co["test_psnr"])
                and bool(fi["test_psnr"]),
            "no prewarm failed": co["prewarms_failed"] == 0
                == fi["prewarms_failed"],
            "K2 ran batch times every step": train_runs["blend_bwd"]
                == batch * sum(stepped.values()),
            "K1 and the binner ran every render":
                train_runs["blend_fwd"] == train_runs["binner"]
                > train_runs["blend_bwd"],
            "D1 ran every fine render": train_runs["gather_rows"] % gathers
                == 0 and train_runs["gather_rows"]
                >= gathers * batch * stepped["fine"],
            "the evaluation's kernels ran every render":
                eval_runs["blend_fwd"] == eval_runs["binner"] == renders
                and eval_runs["gather_rows"] == gathers * renders
                and eval_runs["blend_bwd"] == 0,
            "the PNG counts": sorted(splits) == ["test", "train", "video"]
                and all(pngs(sp, "renders") == n and pngs(sp, "gt") == (
                    0 if sp == "video" else n) for sp, n in views.items()),
            "finite metrics": all(np.isfinite(results[method][k]) for k in (
                "PSNR", "SSIM", "MS-SSIM", "D-SSIM")),
            "the post-hoc PSNR matches an eval at the render's degree":
                abs(psnr - at_degree) <= RENDER_PSNR_TOL,
        }
        if sh == degree or cfg.hidden.no_dshs:
            # the rest bands are the run's: the degrees render alike
            checks["the post-hoc PSNR matches the run's eval"] = \
                abs(psnr - in_loop) <= RENDER_PSNR_TOL
        failed = [k for k, ok in checks.items() if not ok]
        log(f"{kind} checks: {len(checks) - len(failed)}/{len(checks)} hold"
            + (f"; FAILED: {failed}" if failed else ""))
        if failed:
            raise AssertionError(f"{kind} phase: {failed}")

        # ---- the kernels against their plain versions at this size ----
        renderer = Renderer.from_snapshot(
            str(model), device=device, width=sc.train.width,
            height=sc.train.height, probe_camera=sc.train.cameras[0])
        k1, frame = phase_kernels(torch, renderer, sc.test.cameras[0])
        idxs = np.arange(batch)
        step = step_checks(torch, kind, state, [sc.train.cameras[i]
                                                for i in idxs],
                           sc.train.images[idxs], bg, sh, rc, cfg)
        out = {"size": [w, h], "batch": batch, "multires":
               cfg.hidden.multires, "seconds_write": t_write,
               "seconds_train_cli": t_train, "seconds_render_cli": t_render,
               "stages": stages, "splits": splits,
               "results": results[method], "in_loop_test_psnr": in_loop,
               "test_psnr_at_render_degree": at_degree,
               "sh_degree_at_end": sh, "seconds_scene_load": t_load,
               "seconds_scene_load_train_cli": summary["scene_load_s"],
               "decode_ms_per_view": decode_ms,
               "k1": {k: k1[k] for k in ("ms", "device_ms", "host_ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "max_abs_err")},
               "binner_frame": frame["binner"], "gathers_frame":
               frame["gather_rows"], **step}
        if kind == "dynerf":
            out["banks"] = bank_check(
                torch, device, str(scene), state, cfg, rc, bg, sh,
                sc.cameras_extent, seed)
        out["tools"] = layout_tools(torch, kind, scene, work)
        del sc, renderer, state
    out["seconds"] = time.perf_counter() - t_phase
    log(f"{kind}: phase {out['seconds']:.2f} s")
    runs = {k: train_runs[k] + eval_runs[k] for k in train_runs}
    return runs, out


# ---------------------------------------------------------------------------
# phase 8: K3, K4 and K5 against their plain versions
# ---------------------------------------------------------------------------

def scatter_rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def host_ms(fn, n: int = 200) -> float:
    """The host's ms per call to enqueue fn: n calls on the host clock
    with no synchronize inside, after one call and a drain."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def device_ms(fn, n: int = 20) -> dict:
    """Device ms per call of fn, fills and copies included, summed over
    the kernels torch.profiler sees, with the breakdown by name; the
    records the profiler kept of those the host launched over n calls
    (`records`; where it kept fewer, each kernel's time is the mean of
    the records it kept times its launches a call, and the reading is
    flagged in the log); and the host's ms per call to enqueue it, what
    events time when it is the larger. Where the profiler kept no record
    in any window, the time is `held_stream_ms`'s, flagged in the log and
    under `records["held_stream"]`."""
    try:
        records, launched = kernel_records(fn, n)
    except NoKernelRecords as e:
        held = held_stream_ms(fn, n)
        log(f"device_ms: {e}; timed instead by {HELD_STREAM}: {held:.4f} "
            f"ms a call")
        return {"ms": held, "host_ms": host_ms(fn),
                "kernels": {HELD_STREAM: round(held, 5)},
                "records": {"kept": {}, "launched": e.launched,
                            "held_stream": True}}
    kernels = per_call_ms(records, n)
    kept = {k: len(v) for k, v in records.items()}
    if sum(kept.values()) != launched:
        log(f"device_ms: the profiler kept {sum(kept.values())} records "
            f"{kept} of the {launched} the host launched over {n} calls; "
            f"those kernels' times are estimated from the kept records")
    return {"ms": sum(kernels.values()), "host_ms": host_ms(fn),
            "kernels": {k: round(v, 5) for k, v in kernels.items()},
            "records": {"kept": kept, "launched": launched}}


def k3_counts(torch, args, got, occupied, k2: dict, modelled: int) -> dict:
    """What K3's counting build tallies on `args`: its table must be the
    timed build's `got` bit for bit on the rows it writes (`occupied`), its
    float2 stores five a row of those, and its reduced warp batches those
    of K2's counting build (`k2`, phase 6's entry; the same replay). It
    also counts the chunks its blocks walk, which the coupled exit holds
    at or above K2's; `modelled` is blend_work's walk of them."""
    from fourdgs_tpu_torch.ops import blend
    tally = torch.zeros(3, dtype=torch.int64, device=got.device)
    counted = blend.blend_backward_slots(*args, tally=tally)
    torch.cuda.synchronize()
    stored, batches, chunks = tally.tolist()
    written = int(occupied.sum())
    log(f"blend_bwd_slots: counted by the kernel: {stored} float2 stores "
        f"(5 x {written} rows), {batches} batches reduced (K2's "
        f"{k2['reduced_batches']}), {chunks} chunks walked by its blocks "
        f"against K2's {k2['block_chunks']} (the coupled exit: "
        f"{chunks / k2['block_chunks'] - 1:.2%} more; blend_work's walk: "
        f"{modelled})")
    if not torch.equal(counted[occupied], got[occupied]):
        raise AssertionError("K3's counting build's table differs")
    if (batches != k2["reduced_batches"] or stored != 5 * written
            or chunks < k2["block_chunks"]):
        raise AssertionError(
            f"K3 counted {stored} stores, {batches} batches and {chunks} "
            f"block chunks, not {5 * written}, {k2['reduced_batches']} and "
            f"at least {k2['block_chunks']}")
    return {"float2_stores": stored, "reduced_batches": batches,
            "block_chunks": chunks}


def occupied_rows(torch, counts, rc):
    """(num_tiles, tile_cap) mask of the rows of each tile's occupied
    chunks, the rows K3 writes."""
    ends = (counts.long() + rc.chunk - 1) // rc.chunk * rc.chunk
    return (torch.arange(rc.tile_cap, device=counts.device)[None]
            < ends[:, None])


def phase_kernels_slots(torch, args, work_k2, state, rc, bg, sh, cam, gt,
                        launches: dict, k2: dict) -> list:
    """K3 on phase 6's step input, K4 at the reduction's and a HexPlane
    plane's shapes, K5 at the binner's, and one step's gradients through
    K3 + K4 against K2's (`k2`: phase 6's entry, with its counts)."""
    from fourdgs_tpu_torch.models import hexplane
    from fourdgs_tpu_torch.ops import blend, rasterize_tiled, scatter
    from fourdgs_tpu_torch.ops.rasterize_tiled import prepare_blend
    from fourdgs_tpu_torch.render.render import splats_at
    from fourdgs_tpu_torch.train import loop

    gidx, counts, table = args[0], args[1], args[2]
    n = table.shape[0] - 1
    # ---- K3 ----
    got = blend.blend_backward_slots(*args)
    ref = blend.blend_backward_slots_plain(*args)
    torch.cuda.synchronize()
    used = gidx >= 0
    g, r = got[used], ref[used]
    scale = r.abs().amax(dim=0).clamp(min=1e-30)
    col_err = ((g - r).abs() / scale).amax(dim=0).tolist()
    log("kernel blend_bwd_slots vs plain over the slots with gidx >= 0: "
        "normalised max abs err per column " +
        ", ".join(f"{c} {e:.3g}" for c, e in zip(GRAD_COLUMNS, col_err)) +
        f" (tol {GRAD_TOL:g})")
    if not max(col_err) <= GRAD_TOL:
        raise AssertionError(f"blend_bwd_slots disagrees: {col_err}")
    # the rows it writes: each slot of the tiles' occupied chunks, zero
    # past the count, and the same twice (no atomics)
    occupied = occupied_rows(torch, counts, rc)
    again = blend.blend_backward_slots(*args)
    torch.cuda.synchronize()
    if bool(got[occupied & ~used].any()):
        raise AssertionError("K3 wrote a nonzero row past a tile's count")
    if not torch.equal(again[occupied], got[occupied]):
        raise AssertionError("K3 gave two tables on one input")

    def kernel():
        return blend.blend_backward_slots(*args)

    ms3, plain3 = time_pair(kernel,
                            lambda: blend.blend_backward_slots_plain(*args),
                            launches=20)
    dev3 = device_ms(kernel)
    instr = (sum(BLEND_BWD_FP32_INSTR[k] * work_k2[k]
                 for k in BLEND_BWD_FP32_INSTR) + 10 * work_k2["used"])
    mufu = work_k2["exp"] + 2 * work_k2["used"]
    n_rows = int(torch.unique(gidx[used]).numel())
    pixels = rc.num_tiles * rc.pixels_per_tile
    written = int(occupied.sum())
    nbytes = (4 * rc.num_tiles + 4 * int(counts.sum()) + 48 * n_rows
              + 10 * 4 * pixels + 4 * blend.GRAD_W * written)
    bounds = {"hbm bytes": nbytes / HBM_BYTES_S,
              "fp32 issue": instr / FP32_ISSUE_S,
              "mufu (expf, 2 rcp)": mufu / MUFU_OP_S}
    res3 = max(bounds, key=bounds.get)
    log(f"blend_bwd_slots: {ms3:.4f} ms/launch, device {dev3['ms']:.4f} ms "
        f"{dev3['kernels']}, host {dev3['host_ms']:.4f} ms, plain "
        f"{plain3:.4f} ms; table {tuple(got.shape)}, {written} rows "
        f"written; {instr} FP32 instructions, {nbytes} bytes; bounds " +
        ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in bounds.items()) +
        f"; bound by {res3}")
    # the coupled exit: a tile's cluster walks a chunk while any of its
    # sub-tiles has a live pixel, K2's sub-tile block while one of its own
    subs = (rc.tile_size // 16) * (rc.tile_size // 8)
    modelled = subs * work_k2["block_chunks"]["tile"]
    k3 = {"name": "blend_bwd_slots", "route": "cuda",
          "source": "fourdgs_tpu_torch/csrc/blend_bwd.cu",
          "replaces": "fourdgs_tpu/ops/pallas/blend.py:115",
          "tpu_kernel": "fourdgs_tpu/ops/pallas/blend.py:_bwd_kernel",
          "launches": launches["blend_bwd_slots"],
          "max_abs_err": float((g - r).abs().max()),
          "max_normalised_err": max(col_err), "ms": ms3,
          "device_ms": dev3["ms"], "device_kernels": dev3["kernels"],
          "device_records": dev3["records"],
          "host_ms": dev3["host_ms"], "plain_ms": plain3,
          "bound_ms": bounds[res3] * 1e3,
          "bound_by": "bytes" if res3 == "hbm bytes" else "operations",
          "bound_resource": res3, "library_ms": None,
          **k3_counts(torch, args, got, occupied, k2, modelled), "ok": True}

    # ---- K4: the reduction's shapes and a HexPlane plane's ----
    flat = gidx.reshape(-1)
    red_idx = torch.where(flat >= 0, flat, n).to(torch.int32)
    red_rows = got.reshape(-1, blend.GRAD_W)
    gauss = state.params["gauss"]
    plane = state.params["deform"].grid.planes["l1_p0"]     # x-y, level 1
    h, w, c = plane.shape
    pts = hexplane.normalize_aabb(gauss.xyz.detach(), state.aabb)
    x0, _ = hexplane._axis_coord(pts[:, 0], w)
    y0, _ = hexplane._axis_coord(pts[:, 1], h)
    hex_idx = (y0 * w + x0).to(torch.int32)
    gen = torch.Generator(device=table.device).manual_seed(7)
    hex_rows = torch.randn((hex_idx.shape[0], c), generator=gen,
                           device=table.device)
    # the blend reduction's sacrificial row n takes the rows past each
    # tile's occupied chunks, which K3 leaves unwritten: it is compared on
    # its first n rows, as the reduction keeps them
    k4_cases = {"blend reduction": (red_idx, red_rows, n + 1, n),
                "hexplane l1_p0": (hex_idx, hex_rows, h * w, h * w)}
    k4_rec = {}
    for label, (idx, rows, n_out, keep) in k4_cases.items():
        a = scatter.scatter_add_rows(idx, rows, n_out=n_out)[:keep]
        b = scatter.scatter_add_rows_plain(idx, rows, n_out=n_out)[:keep]
        torch.cuda.synchronize()
        err = scatter_rel_err(a, b)
        ms, plain_ms = time_pair(
            lambda: scatter.scatter_add_rows(idx, rows, n_out=n_out),
            lambda: scatter.scatter_add_rows_plain(idx, rows, n_out=n_out))
        def library():
            return torch.zeros((n_out, rows.shape[1]),
                               device=rows.device).index_add_(0, idx.long(),
                                                              rows)

        lib_ms = time_call(library)
        dev = device_ms(lambda: scatter.scatter_add_rows(idx, rows,
                                                         n_out=n_out))
        lib_dev = device_ms(library)
        nbytes = 4 * idx.numel() + 4 * rows.numel() + 4 * n_out * rows.shape[1]
        bound = nbytes / HBM_BYTES_S * 1e3
        log(f"kernel scatter_add_rows ({label}): idx {tuple(idx.shape)}, rows "
            f"{tuple(rows.shape)} -> ({n_out}, {rows.shape[1]}); max |a-b| / "
            f"max |b| {err:.3g} (tol {SCATTER_TOL:g}); {ms:.4f} ms/launch, "
            f"device {dev['ms']:.4f} ms {dev['kernels']}, host "
            f"{dev['host_ms']:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
            f"{lib_ms:.4f} ms (device {lib_dev['ms']:.4f} ms "
            f"{lib_dev['kernels']}, host {lib_dev['host_ms']:.4f} ms); "
            f"{nbytes} bytes, "
            f"bound {bound:.4f} ms (hbm bytes)")
        if not err <= SCATTER_TOL:
            raise AssertionError(f"scatter_add_rows ({label}) disagrees: "
                                 f"{err}")
        k4_rec[label] = {"max_rel_err": err,
                         "max_abs_err": float((a - b).abs().max()),
                         "ms": ms, "device_ms": dev["ms"],
                         "device_kernels": dev["kernels"],
                         "device_records": dev["records"],
                         "host_ms": dev["host_ms"],
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "library_device_ms": lib_dev["ms"],
                         "library_device_kernels": lib_dev["kernels"],
                         "library_device_records": lib_dev["records"],
                         "library_host_ms": lib_dev["host_ms"],
                         "bound_ms": bound,
                         "shape": [int(idx.numel()), int(rows.shape[1]),
                                   int(n_out)]}
    main4 = k4_rec["blend reduction"]
    k4 = {"name": "scatter_add_rows", "route": "cuda",
          "source": "fourdgs_tpu_torch/csrc/scatter.cu",
          "replaces": "fourdgs_tpu/ops/pallas/scatter.py:26",
          "tpu_kernel": "fourdgs_tpu/ops/pallas/scatter.py:scatter_add_rows",
          "launches": launches["scatter_add_rows"],
          "max_abs_err": max(v["max_abs_err"] for v in k4_rec.values()),
          "max_rel_err": max(v["max_rel_err"] for v in k4_rec.values()),
          "ms": main4["ms"], "device_ms": main4["device_ms"],
          "host_ms": main4["host_ms"], "plain_ms": main4["plain_ms"],
          "bound_ms": main4["bound_ms"], "bound_by": "bytes",
          "library_ms": main4["library_ms"], "cases": k4_rec, "ok": True}

    # ---- K5: the binner's pairs on the step's frame ----
    captured = {}
    real = rasterize_tiled.scatter_set_scalars

    def capture(idx, val, *, n_out):
        captured.update(idx=idx.clone(), val=val.clone(), n_out=n_out)
        return real(idx, val, n_out=n_out)

    rasterize_tiled.scatter_set_scalars = capture
    try:
        with switches_set({"FOURDGS_BIN_SCATTER": "pallas"}), \
                torch.no_grad():
            splats = splats_at(gauss, state.params["deform"], cam, state.aabb,
                               sh)
            _, binned, _ = prepare_blend(*splats, cam, rc, state.alive)
    finally:
        rasterize_tiled.scatter_set_scalars = real
    idx, val, n_out = captured["idx"], captured["val"], captured["n_out"]
    if not torch.equal(binned.gidx.reshape(-1), gidx.reshape(-1)):
        raise AssertionError("the binner's gidx through K5 differs from the "
                             "default binner's")
    a = scatter.scatter_set_scalars(idx, val, n_out=n_out)
    b = scatter.scatter_set_scalars_plain(idx, val, n_out=n_out)
    torch.cuda.synchronize()
    equal = bool(torch.equal(a, b))
    ms5, plain5 = time_pair(
        lambda: scatter.scatter_set_scalars(idx, val, n_out=n_out),
        lambda: scatter.scatter_set_scalars_plain(idx, val, n_out=n_out))
    safe = torch.clamp(idx, max=n_out).long()

    def library():
        buf = torch.full((n_out + 1,), -1, dtype=torch.int32,
                         device=idx.device)
        buf[safe] = val
        return buf

    lib5 = time_call(library)
    dev5 = device_ms(lambda: scatter.scatter_set_scalars(idx, val,
                                                         n_out=n_out))
    lib_dev5 = device_ms(library)
    # the pieces of a call's host path: the launch function alone (fill
    # and scatter into a made buffer), the two ways to name the stream,
    # the two allocations
    from fourdgs_tpu_torch.ops._build import load_library
    lib, out = load_library(), idx.new_empty(n_out)
    stream = torch._C._cuda_getCurrentRawStream(idx.get_device())
    pieces = {
        "launch function": lambda: lib.scatter_set_scalars_launch(
            idx.data_ptr(), val.data_ptr(), idx.numel(), n_out,
            out.data_ptr(), stream),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "_cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(idx.get_device()),
        "torch.empty": lambda: torch.empty((n_out,), dtype=torch.int32,
                                           device=idx.device),
        "new_empty": lambda: idx.new_empty(n_out),
        "torch.full": lambda: torch.full((n_out + 1,), -1,
                                         dtype=torch.int32,
                                         device=idx.device)}
    host5 = {k: host_ms(f) for k, f in pieces.items()}
    log("host ms a call of the pieces of K5's path: " + ", ".join(
        f"{k} {v:.4f}" for k, v in host5.items()))
    nbytes5 = 8 * idx.numel() + 4 * n_out
    bound5 = nbytes5 / HBM_BYTES_S * 1e3
    log(f"kernel scatter_set_scalars (binner): {idx.numel()} pairs -> "
        f"{n_out} slots, {int((idx >= n_out).sum())} past tile_cap; equal "
        f"{equal}; {ms5:.4f} ms/launch, device {dev5['ms']:.4f} ms "
        f"{dev5['kernels']}, host {dev5['host_ms']:.4f} ms, plain "
        f"{plain5:.4f} ms, indexed assignment {lib5:.4f} ms (device "
        f"{lib_dev5['ms']:.4f} ms {lib_dev5['kernels']}, host "
        f"{lib_dev5['host_ms']:.4f} ms); {nbytes5} bytes, bound "
        f"{bound5:.4f} ms "
        f"(hbm bytes)")
    if not equal:
        raise AssertionError("scatter_set_scalars disagrees with plain")
    k5 = {"name": "scatter_set_scalars", "route": "cuda",
          "source": "fourdgs_tpu_torch/csrc/scatter.cu",
          "replaces": "fourdgs_tpu/ops/pallas/scatter.py:73",
          "tpu_kernel":
              "fourdgs_tpu/ops/pallas/scatter.py:scatter_set_scalars",
          "launches": launches["scatter_set_scalars"], "max_abs_err": 0.0,
          "ms": ms5, "device_ms": dev5["ms"],
          "device_kernels": dev5["kernels"],
          "device_records": dev5["records"], "host_ms": dev5["host_ms"],
          "plain_ms": plain5,
          "bound_ms": bound5, "bound_by": "bytes", "library_ms": lib5,
          "library_device_ms": lib_dev5["ms"],
          "library_device_kernels": lib_dev5["kernels"],
          "library_device_records": lib_dev5["records"],
          "library_host_ms": lib_dev5["host_ms"], "host_pieces_ms": host5,
          "ok": True}

    # ---- one step's gradients, K3 + K4 against K2 ----
    kw = dict(stage="fine", raster_cfg=rc, lambda_dssim=0.0,
              reg_weights=(0.01, 0.0001, 0.0001))

    def grads():
        sg = loop.step_gradients(state, [cam], gt[None], bg, sh, **kw)
        return [x for x in sg.grads + [sg.ndc_grad] if x is not None]

    with_k2 = grads()
    before = kernel_runs()
    with switches_set({"FOURDGS_PALLAS_NO_FUSED_BWD": "1",
                       "FOURDGS_PALLAS_GRAD_SCATTER": "1"}):
        with_k3 = grads()
    torch.cuda.synchronize()
    after = kernel_runs()
    if (after["blend_bwd_slots"] - before["blend_bwd_slots"] != 1
            or after["blend_bwd"] != before["blend_bwd"]):
        raise AssertionError(f"the switched step ran {before} -> {after}")
    err = max(grads_agree(x, y) for x, y in zip(with_k3, with_k2))
    log(f"step gradients through K3 + K4 vs K2: {len(with_k2)} leaves, "
        f"normalised max abs err {err:.3g} (tol {GRAD_TOL:g})")
    if not err <= GRAD_TOL:
        raise AssertionError(f"K3 + K4 step gradients disagree: {err}")
    k3["step_grad_err_vs_k2"] = err
    k3["reassociation"] = check_reassociation(
        torch, args, got, gauss, state, rc, sh, cam, grads, with_k2)
    return [k3, k4, k5]


def check_reassociation(torch, args, got, gauss, state, rc, sh, cam, grads,
                        with_k2) -> dict:
    """The per-slot backward's reduction without FOURDGS_PALLAS_GRAD_SCATTER
    (ops/rasterize_tiled.py:reassociate_pair_grads over the binner's
    BlendSlots, the JAX package's default) on phase 6's step input: K3's
    table `got` reduced against `index_add_`'s sums (SCATTER_TOL), two
    runs of K3 and the reduction bit for bit, sums finite over a table
    that was NaN before K3's launch, one step's gradients through it
    against K2's (`with_k2`, GRAD_TOL), and the reduction's, `index_add_`'s
    and K4's time on the table by CUDA events."""
    from fourdgs_tpu_torch.ops import blend, scatter
    from fourdgs_tpu_torch.ops.rasterize_tiled import prepare_blend
    from fourdgs_tpu_torch.render.render import splats_at

    gidx = args[0]
    n = args[2].shape[0] - 1
    with torch.no_grad():
        splats = splats_at(gauss, state.params["deform"], cam, state.aabb, sh)
        _, binned, _ = prepare_blend(*splats, cam, rc, state.alive,
                                     slots=True)
    if not torch.equal(binned.gidx, gidx):
        raise AssertionError("the binning with slots gave other lists")
    slots = binned.slots
    with switches_set({"FOURDGS_PALLAS_NO_FUSED_BWD": "1"}):
        if os.environ.get("FOURDGS_PALLAS_GRAD_SCATTER"):
            raise AssertionError("FOURDGS_PALLAS_GRAD_SCATTER is set")
        red = blend.reduce_slots(gidx, got, n, slots)
        ref = blend.reduce_slots(gidx, got, n)
        again = blend.reduce_slots(
            gidx, blend.blend_backward_slots(*args), n, slots)
        poisoned = torch.full_like(got, float("nan"))
        blend.blend_backward_slots(*args, out=poisoned)
        nan_in = blend.reduce_slots(gidx, poisoned, n, slots)
        torch.cuda.synchronize()
        err = scatter_rel_err(red, ref)
        stable = bool(torch.equal(red, again))
        finite = bool(torch.isfinite(nan_in).all())
        unwritten = int(torch.isnan(poisoned).any(-1).sum())
        before = kernel_runs()
        with_re = grads()
        torch.cuda.synchronize()
        after = kernel_runs()
    ran = {k: after[k] - before[k] for k in after}
    grad_err = max(grads_agree(x, y) for x, y in zip(with_re, with_k2))
    flat = gidx.reshape(-1)
    idx = torch.where(flat >= 0, flat, n).to(torch.int32)
    rows = got.reshape(-1, blend.GRAD_W)
    times = {
        "reassociation": time_call(
            lambda: blend.reduce_slots(gidx, got, n, slots)),
        "index_add_": time_call(lambda: blend.reduce_slots(gidx, got, n)),
        "K4 (fill included)": time_call(
            lambda: scatter.scatter_add_rows(idx, rows, n_out=n + 1))}
    log(f"reassociation on K3's table ({tuple(got.shape)}, {unwritten} "
        f"rows left unwritten by K3; budget {tuple(slots.dest.shape)}): "
        f"max |a - b| / max |b| against index_add_ {err:.3g} (tol "
        f"{SCATTER_TOL:g}); two runs bit for bit {stable}; finite over a "
        f"NaN table {finite}; step gradients through K3 + reassociation vs "
        f"K2 {grad_err:.3g} (tol {GRAD_TOL:g}), launches {ran}; ms by "
        f"events: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    if not (err <= SCATTER_TOL and stable and finite
            and grad_err <= GRAD_TOL and unwritten > 0):
        raise AssertionError(f"reassociation: err {err}, stable {stable}, "
                             f"finite {finite}, grad_err {grad_err}, "
                             f"unwritten rows {unwritten}")
    if (ran["blend_bwd_slots"] != 1 or ran["blend_bwd"]
            or ran["scatter_add_rows"] or ran["scatter_set_scalars"] != 1):
        raise AssertionError(f"the reassociated step ran {ran}")
    return {"max_rel_err_vs_index_add": err, "bit_stable": stable,
            "finite_over_nan": finite, "unwritten_rows": unwritten,
            "step_grad_err_vs_k2": grad_err, "ms": times, "ok": True}


# ---------------------------------------------------------------------------
# phase 16 (after phase 15): the viewer bridge, the triptychs, the per-frame
# export, the merge tool and the empty-voxel grid
# ---------------------------------------------------------------------------

VIEWER_FRAMES = ((30, (800, 800)), (10, (1280, 720)))   # phase 16(a)
VIEWER_FOV = 0.9                # radians, across the width
GUI_ITERS = (50, 150)           # phase 16(b): coarse, fine
GUI_STILL_FRAMES = 20           # frames served before training goes on
EXPORT_FRAMES = 4
MERGE_FRAMES = 12
MERGE_OFFSET = 0.6
VOXEL_ITERS = (50, 100)         # phase 16(e)
EXPORT_TOL = 1e-6


def viewer_request(torch, w: int, h: int, theta: float, train=False,
                   keep_alive=False) -> bytes:
    """A viewer's request for the look-at camera at `theta`, at w x h."""
    from fourdgs_tpu_torch.data.camera import look_at_camera
    from fourdgs_tpu_torch.viewer import network_gui
    cam = look_at_camera(theta=theta, fov=VIEWER_FOV, device="cpu")
    view, proj = network_gui.client_matrices(cam)
    fov_y = 2 * np.arctan(np.tan(VIEWER_FOV / 2) * h / w)
    return network_gui.request_bytes(w, h, VIEWER_FOV, fov_y, view, proj,
                                     train=train, keep_alive=keep_alive)


def viewer_client(torch, port: int, requests, replies: list, errors: list):
    """A client thread's body: connect to the bridge on `port` (retrying
    while it starts), send each request of `requests` (an iterable of
    (w, h, bytes)) after the previous reply, and keep (frame bytes,
    verify string, seconds from the request to its reply's end) in
    `replies`; stop when the requests or the bridge end."""
    import socket

    from fourdgs_tpu_torch.viewer import network_gui
    try:
        for _ in range(1200):
            try:
                sock = socket.create_connection(("127.0.0.1", port), 5)
                break
            except OSError:
                time.sleep(0.05)
        else:
            raise ConnectionError(f"no bridge on port {port}")
        sock.settimeout(300)
        with sock:
            for w, h, data in requests:
                t0 = time.perf_counter()
                try:
                    sock.sendall(data)
                    frame, verify = network_gui.recv_reply(sock, w, h)
                except ConnectionError:         # the run ended
                    return
                replies.append((frame, verify, time.perf_counter() - t0))
    except Exception as e:          # raised again by the phase
        errors.append(e)


def start_client(torch, port, requests):
    import threading
    replies, errors = [], []
    thread = threading.Thread(target=viewer_client, daemon=True,
                              args=(torch, port, requests, replies, errors))
    thread.start()
    return thread, replies, errors


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ms_stats(seconds: list) -> dict:
    ms = np.asarray(seconds, np.float64) * 1e3
    return {"frames": int(ms.size), "ms_median": float(np.median(ms)),
            "ms_mean": float(ms.mean()), "ms_min": float(ms.min()),
            "ms_max": float(ms.max())}


def tools_viewer(torch, device, renderer) -> dict:
    """16(a): the bridge serving phase 3's snapshot through its Renderer
    (each size a captured frame), a client thread asking for
    VIEWER_FRAMES; every reply's size, one 800x800 reply against the
    Renderer's frame, the bridge's ms a frame at each size."""
    from fourdgs_tpu_torch.train import graphs
    from fourdgs_tpu_torch.viewer.network_gui import NetworkGui, frame_bytes

    gui = NetworkGui(device)
    gui.init("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    requests, sizes = [], []
    for count, (w, h) in VIEWER_FRAMES:
        for i in range(count):
            requests.append((w, h, viewer_request(
                torch, w, h, 2 * np.pi * i / count)))
            sizes.append((w, h))
    thread, replies, errors = start_client(torch, port, requests)
    seen = []

    def frame(camera, w, h, sm):
        seen.append((camera, w, h))
        return renderer.gui_frame(camera, w, h, sm)

    torch.cuda.synchronize()
    graphs.zero_counts()
    t0 = time.perf_counter()
    while thread.is_alive() and time.perf_counter() - t0 < 120:
        gui.poll(frame, "chip_smoke", time=0.5)
    thread.join(10)
    gui.close()
    runs = kernel_runs()
    if thread.is_alive():
        raise AssertionError("the viewer client did not finish")
    if errors:
        raise errors[0]
    if len(replies) != len(requests):
        raise AssertionError(f"the viewer got {len(replies)} of "
                             f"{len(requests)} replies")
    for (data, verify, _), (w, h) in zip(replies, sizes):
        if len(data) != w * h * 3 or verify != "chip_smoke":
            raise AssertionError(f"a {w}x{h} reply of {len(data)} bytes, "
                                 f"verify {verify!r}")
    # one 800x800 reply against the Renderer's frame at the camera the
    # bridge decoded
    k = VIEWER_FRAMES[0][0] - 1
    camera, w, h = seen[k]
    want = frame_bytes(renderer.gui_frame(camera, w, h))
    equal = replies[k][0] == want
    out, start = {}, 0
    for count, (w, h) in VIEWER_FRAMES:
        # the first two frames of a size capture and warm its frame
        out[f"{w}x{h}"] = ms_stats([r[2] for r in
                                    replies[start + 2:start + count]])
        start += count
    for size, st in out.items():
        log(f"tools (a) viewer: {size}: {st['frames']} frames, bridge "
            f"{st['ms_median']:.3f} ms a frame median ({st['ms_min']:.3f}"
            f"-{st['ms_max']:.3f}), {1e3 / st['ms_median']:.1f} FPS")
    log(f"tools (a) viewer: {len(replies)} replies; the 800x800 reply "
        f"equal to the Renderer's frame {equal}; kernel runs {runs}; "
        f"renderer captured {renderer.captured}, replayed "
        f"{renderer.replayed}")
    if not equal:
        raise AssertionError("the bridge's bytes differ from the "
                             "Renderer's frame")
    if min(runs[k] for k in PATH_KERNELS if k != "blend_bwd") < len(requests):
        raise AssertionError(f"the served frames ran {runs}")
    return {"sizes": out, "replies": len(replies), "kernel_runs": runs}


def tools_gui_training(torch, device, work: Path, seed: int,
                       phase7_fine_ms: float) -> dict:
    """16(b): the train CLI with --gui and render_process on phase 7's
    scene: a client asks for GUI_STILL_FRAMES frames without `train`,
    then one an iteration with `train` and `keep_alive` until the run
    ends; the run's end, the triptychs, the served frames' ms."""
    from fourdgs_tpu_torch.data.jpeg import read_jpeg
    from fourdgs_tpu_torch.tools import train as train_cli
    from fourdgs_tpu_torch.train import graphs

    coarse, fine = GUI_ITERS
    model = work / "gui"
    shutil.rmtree(model, ignore_errors=True)
    config = work / "dnerf_gui.py"
    config.write_text(DRIVER_CONFIG.format(coarse=coarse, fine=fine)
                      + "ModelParams = dict(render_process=True)\n")
    port = free_port()
    w, h = DRIVER_SIZE, DRIVER_SIZE

    def requests():
        for i in range(100_000):
            train = i >= GUI_STILL_FRAMES
            yield w, h, viewer_request(torch, w, h, 0.05 * i, train, train)

    thread, replies, errors = start_client(torch, port, requests())
    torch.cuda.synchronize()
    graphs.zero_counts()
    t0 = time.perf_counter()
    summary = train_cli.main([
        "-s", str(work / "scene"), "-m", str(model), "--configs",
        str(config), "--quiet", "--seed", str(seed), "--device",
        device.type, "--gui", "--port", str(port), "--test_iterations",
        str(coarse), str(fine), "--save_iterations", str(fine)])
    seconds = time.perf_counter() - t0
    thread.join(30)
    runs = kernel_runs()
    if thread.is_alive():
        raise AssertionError("the viewer client did not finish")
    if errors:
        raise errors[0]
    stages = {st["stage"]: st for st in summary["stages"]}
    ms_it = {k: 1e3 * st["wall_time"] / (st["iterations"] - st["start"])
             for k, st in stages.items()}
    still = ms_stats([r[2] for r in replies[2:GUI_STILL_FRAMES]])
    per_it = ms_stats([r[2] for r in replies[GUI_STILL_FRAMES:]])
    trips = {}
    for stage, it in (("coarse", coarse), ("fine", fine)):
        path = model / "train_render" / f"{stage}test" / f"{it:05d}.jpg"
        trips[str(path.relative_to(work))] = (
            read_jpeg(str(path)).shape if path.exists() else None)
    checks = {
        "the run reached its last iteration":
            stages["fine"]["history"][-1]["iter"] == fine,
        "a frame each iteration after the still ones":
            len(replies) >= GUI_STILL_FRAMES + coarse + fine - 1,
        "every reply a frame": all(len(r[0]) == w * h * 3
                                   for r in replies),
        "the triptychs": all(s == (h, 3 * w, 3) for s in trips.values()),
        "K2 ran each step": runs["blend_bwd"] >= coarse + fine,
    }
    failed = [k for k, ok in checks.items() if not ok]
    log(f"tools (b) viewer in training: {len(replies)} frames served "
        f"({GUI_STILL_FRAMES} without train: {still['ms_median']:.3f} ms "
        f"median, {still['ms_min']:.3f}-{still['ms_max']:.3f}; one an "
        f"iteration: {per_it['ms_median']:.3f} ms median from request to "
        f"reply, a step included); coarse {ms_it['coarse']:.3f}, fine "
        f"{ms_it['fine']:.3f} ms an iteration, the bridge left out "
        f"(phase 7's fine {phase7_fine_ms:.3f}); CLI {seconds:.2f} s; "
        f"triptychs {trips}; kernel runs {runs}; checks "
        f"{len(checks) - len(failed)}/{len(checks)}")
    if failed:
        raise AssertionError(f"phase 16(b): {failed}")
    return {"still_frames": still, "per_iteration_frames": per_it,
            "ms_per_iteration": ms_it, "phase7_fine_ms": phase7_fine_ms,
            "seconds": seconds, "triptychs": {k: list(v) for k, v
                                              in trips.items()},
            "kernel_runs": runs}


def tools_export(torch, device, work: Path) -> dict:
    """16(c): tools/export_perframe.py on phase 3's snapshot at
    EXPORT_FRAMES timestamps; one PLY read back against
    get_state_at_time on the card (EXPORT_TOL)."""
    from fourdgs_tpu_torch.data import ply
    from fourdgs_tpu_torch.render.state_at_time import get_state_at_time
    from fourdgs_tpu_torch.tools import export_perframe
    from fourdgs_tpu_torch.train import checkpoint

    model = work / "model"
    t0 = time.perf_counter()
    paths = export_perframe.main(["-m", str(model), "--n_frames",
                                  str(EXPORT_FRAMES), "--device",
                                  device.type])
    seconds = time.perf_counter() - t0
    sizes = [os.path.getsize(p) for p in paths]
    k = 1
    _, gauss, alive, deform, aabb, _ = checkpoint.load_model(
        str(model), -1, device)
    t = float(np.linspace(0, 1, EXPORT_FRAMES)[k])
    keep = alive.cpu().numpy()
    want = dict(zip(("xyz", "scaling", "rotation", "opacity", "shs"), (
        x.cpu().numpy()[keep]
        for x in get_state_at_time(gauss, deform, aabb, t))))
    want["features_dc"] = want["shs"][:, :1]
    want["features_rest"] = want.pop("shs")[:, 1:]
    got = ply.load_gaussians(paths[k], 3)
    err = max(float(np.abs(got[f] - want[f]).max()) for f in want)
    shutil.rmtree(model / "gaussian_pertimestamp")
    log(f"tools (c) export: {len(paths)} frames of {int(keep.sum())} "
        f"gaussians, {np.mean(sizes) / 1e6:.2f} MB each, "
        f"{seconds / len(paths):.3f} s a frame (the model's load "
        f"included); frame {k} read back against get_state_at_time on the "
        f"card: max abs err {err:.3g} (tol {EXPORT_TOL:g})")
    if len(paths) != EXPORT_FRAMES or not err <= EXPORT_TOL:
        raise AssertionError(f"export: {len(paths)} frames, err {err}")
    return {"frames": len(paths), "mb_per_frame": float(np.mean(sizes)) / 1e6,
            "s_per_frame": seconds / len(paths), "max_abs_err": err}


def tools_merge(torch, device, work: Path) -> dict:
    """16(d): tools/merge_many.py on phase 3's snapshot twice (offsets
    +-MERGE_OFFSET in x) over MERGE_FRAMES of phase 7's video cameras;
    frame 0 through K1 against the plain blend on the card (TOL), its PNG
    against the kernel's frame, ms a frame and the drops."""
    from fourdgs_tpu_torch.data.blender import (
        generate_spherical_video_cameras, read_timeline)
    from fourdgs_tpu_torch.data.png import read_png
    from fourdgs_tpu_torch.data.scene import camera_from_info
    from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig, rasterize
    from fourdgs_tpu_torch.tools import merge_many
    from fourdgs_tpu_torch.tools import render as render_cli
    from fourdgs_tpu_torch.train import checkpoint, graphs

    model, out = str(work / "model"), work / "merged"
    shutil.rmtree(out, ignore_errors=True)
    offsets = (f"{MERGE_OFFSET},0,0", f"{-MERGE_OFFSET},0,0")
    torch.cuda.synchronize()
    graphs.zero_counts()
    t0 = time.perf_counter()
    summary = merge_many.main(["-m", model, model, "-s", str(work / "scene"),
                               "--offsets", *offsets, "--out", str(out),
                               "--n_frames", str(MERGE_FRAMES),
                               "--device", device.type])
    seconds = time.perf_counter() - t0
    runs = kernel_runs()
    # frame 0 again, through K1 and through the plain blend
    models = []
    for off in offsets:
        _, gauss, alive, deform, aabb, _ = checkpoint.load_model(
            model, -1, device)
        models.append((gauss, torch.nonzero(alive)[:, 0], deform, aabb,
                       torch.tensor([float(x) for x in off.split(",")],
                                    device=device), 1.0))
    # the scene's first video camera, as Scene.load makes it, without
    # decoding the scene's images again
    _, max_time = read_timeline(str(work / "scene"))
    info = generate_spherical_video_cameras(
        str(work / "scene"), "transforms_train.json", max_time,
        resolution=(DRIVER_SIZE, DRIVER_SIZE))[0]
    cam = camera_from_info(info, device)
    rc = RasterConfig(img_width=info.width, img_height=info.height)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        splats = merge_many.merged_splats(models, cam, float(info.time))
        a = rasterize(*splats, cam, bg, rc)
        with plain_version("blend_forward"):
            b = rasterize(*splats, cam, bg, rc)
    torch.cuda.synchronize()
    errs = {"color": float((a.color - b.color).abs().max()),
            "depth": float((a.depth - b.depth).abs().max()),
            "t": float((a.alpha - b.alpha).abs().max())}
    png_equal = bool(np.array_equal(read_png(str(out / "00000.png")),
                                    render_cli.quantise(a.color)))
    frames = ms_stats(summary["seconds"][1:])
    log(f"tools (d) merge: {summary['gaussians']} gaussians, "
        f"{summary['frames']} frames at {rc.img_width}x{rc.img_height}, "
        f"{frames['ms_median']:.3f} ms a frame median "
        f"({frames['ms_min']:.3f}-{frames['ms_max']:.3f}; the first "
        f"{1e3 * summary['seconds'][0]:.3f}), CLI {seconds:.2f} s; drops "
        f"{summary['drops']}; frame 0 K1 vs plain {errs} (tol {TOL}); its "
        f"PNG equal to the kernel's frame {png_equal}; kernel runs {runs}")
    if not (all(errs[k] <= TOL[k] for k in TOL) and png_equal):
        raise AssertionError(f"merge: frame 0 errs {errs}, PNG {png_equal}")
    if min(runs[k] for k in ("blend_fwd", "binner", "gather_rows")) == 0:
        raise AssertionError(f"the merge ran {runs}")
    shutil.rmtree(out)
    return {"gaussians": summary["gaussians"], "frames": frames,
            "first_frame_ms": 1e3 * summary["seconds"][0],
            "drops": summary["drops"], "frame0_err": errs,
            "kernel_runs": runs}


def tools_empty_voxel(torch, device, work: Path, seed: int) -> dict:
    """16(e): the train CLI with empty_voxel on phase 7's scene; finite
    losses, and the empty_voxel leaf in the snapshot, read back equal."""
    from fourdgs_tpu_torch.tools import train as train_cli
    from fourdgs_tpu_torch.train import checkpoint
    from fourdgs_tpu_torch.train import config as config_mod

    coarse, fine = VOXEL_ITERS
    model = work / "voxel"
    shutil.rmtree(model, ignore_errors=True)
    config = work / "dnerf_voxel.py"
    config.write_text(DRIVER_CONFIG.format(coarse=coarse, fine=fine).replace(
        "ModelHiddenParams = dict(\n",
        "ModelHiddenParams = dict(\n    empty_voxel=True,\n"))
    t0 = time.perf_counter()
    summary = train_cli.main([
        "-s", str(work / "scene"), "-m", str(model), "--configs",
        str(config), "--quiet", "--seed", str(seed), "--device",
        device.type, "--test_iterations", str(fine), "--save_iterations",
        str(fine)])
    seconds = time.perf_counter() - t0
    losses = [r["loss"] for st in summary["stages"] for r in st["history"]]
    snap = model / "point_cloud" / f"iteration_{fine}"
    _, flat, _ = checkpoint.load_snapshot(str(snap))
    cfg = config_mod.load_cfg(str(model / "cfg_args.json"))
    leaf = flat.get("empty_voxel")
    back = checkpoint.deform_params_from_flat(
        flat, config_mod.deform_config_from(cfg), device)
    checks = {
        "finite losses": bool(np.isfinite(losses).all()),
        "the leaf in the snapshot": leaf is not None
        and leaf.shape == (64, 64, 64, 1),
        "the leaf trained": leaf is not None and bool(np.abs(leaf).max() > 0),
        "read back equal": leaf is not None and np.array_equal(
            back.empty_voxel.detach().cpu().numpy(), leaf),
        "the fine stage ran": summary["stages"][-1]["history"][-1]["iter"]
        == fine,
    }
    failed = [k for k, ok in checks.items() if not ok]
    log(f"tools (e) empty_voxel: {coarse} + {fine} iterations in "
        f"{seconds:.2f} s, loss first {losses[0]:.6f} last "
        f"{losses[-1]:.6f}, fine test PSNR "
        f"{summary['stages'][-1]['test_psnr']}; leaf |max| "
        f"{float(np.abs(leaf).max()) if leaf is not None else None}; checks "
        f"{len(checks) - len(failed)}/{len(checks)}")
    if failed:
        raise AssertionError(f"phase 16(e): {failed}")
    return {"seconds": seconds, "loss_first": losses[0],
            "loss_last": losses[-1],
            "test_psnr": summary["stages"][-1]["test_psnr"]}


def phase_tools(torch, device, work: Path, renderer, seed: int,
                phase7_fine_ms: float) -> dict:
    """Phase 16: the viewer bridge on the served snapshot and inside
    training, the triptychs, the per-frame export, the merge and the
    empty-voxel grid, each timed."""
    t0 = time.perf_counter()
    out = {}
    for name, fn in (
            ("viewer", lambda: tools_viewer(torch, device, renderer)),
            ("gui_training", lambda: tools_gui_training(
                torch, device, work, seed, phase7_fine_ms)),
            ("export", lambda: tools_export(torch, device, work)),
            ("merge", lambda: tools_merge(torch, device, work)),
            ("empty_voxel", lambda: tools_empty_voxel(torch, device, work,
                                                      seed))):
        t1 = time.perf_counter()
        out[name] = fn()
        out[name]["phase_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    log(f"tools: phase 16 in {out['seconds']:.2f} s (" + ", ".join(
        f"{k} {v['phase_s']:.2f}" for k, v in out.items()
        if isinstance(v, dict)) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 17: the mesh (fourdgs_tpu_torch/parallel)
# ---------------------------------------------------------------------------

MESH_TILE = 16                 # 50 x 50 tiles at 800x800: two bands of 25 rows
MESH_TIMES = (0.25, 0.75)      # the global batch of (b): two cameras
MESH_SHAPES = ((1, 2), (2, 1))
MESH_DSSIM = 0.2               # the SSIM term's gather over "tile" runs
MESH_TIMED_STEPS = 3
# (b)'s step against the single-card step: tests/test_parallel.py's
# tolerances (the loss, the PSNR, the parameters, the statistics); the
# parameters where |g| > 1e-3 max|g| of the leaf, since Adam moves a
# parameter by about lr * sign(g) whatever g's size, and a gradient that
# is round-off (K2 sums with atomics) may take either sign
MESH_LOSS_RTOL, MESH_PSNR_RTOL = 1e-4, 1e-3
MESH_PARAM_ATOL, MESH_ACCUM_ATOL = 5e-5, 1e-5
MESH_CLI_ITERS = (20, 40)      # (c): coarse, fine; one eval, at the end
MESH_RANKS_TIMEOUT = 300       # seconds (b)'s ranks may take
# the CLIs' progress lines whose arrival (c) logs
MESH_CLI_MARKS = ("Loading scene", "extent=", "stage done", "Evaluating",
                  "Saved snapshot", "ranks' final", "rendering snapshot",
                  "views, FPS")
MESH_PATH = {"blend_fwd": "blend_forward", "blend_bwd": "blend_backward",
             "binner": "bin_tiles", "gather_rows": "gather_rows"}
# (a)'s captured programs: steps a mode from one state, the profiled
# replays a mode, and the target of the captured one-rank mesh step over
# the single-card captured step at the same inputs (reported, not a check)
MESH_CAPTURED_STEPS = 30
MESH_PROFILED_STEPS = 4
MESH_CAPTURE_TARGET = 1.15
# (d)'s target: the captured --mesh 1,1 CLI's fine iteration over phase 7's
MESH_CLI_TARGET = 1.25
# (e): tools/bench_scaling.py's arguments (a CPU rehearsal cuts the point)
SCALING_ARGS: tuple = ()


def mesh_sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_inputs(torch, scene, seed: int, device):
    """Phase 17's step inputs, built alike in every process from the seed:
    phase 5's gaussians in their 131,072-slot buffer at tile 16, two
    cameras, targets rendered before seeded noise moved the colors and
    opacities (phase 5's rule), and caps probed drop-free on the first
    camera with the tile cap then doubled, since a band's binning keeps
    the pairs the whole grid's corner cull drops. Returns (cfg, state,
    raster config, bg, SH degree, cameras, targets)."""
    from fourdgs_tpu_torch.data.camera import look_at_camera
    from fourdgs_tpu_torch.render.serve import overflows
    from fourdgs_tpu_torch.train import config as config_mod
    from fourdgs_tpu_torch.train import loop

    if scene is None:
        scene = make_scene(torch, seed, device)
    cfg, state = make_train_state(torch, scene, device)
    cfg.raster = dataclasses.replace(cfg.raster, tile_size=MESH_TILE)
    rc = config_mod.raster_config_from(cfg, SIZE, SIZE)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=device)
    sh = cfg.model.sh_degree
    cams = [look_at_camera(theta=0.3 + 0.4 * i, time=t, device=device)
            for i, t in enumerate(MESH_TIMES)]
    for _ in range(4):
        out = loop.eval_step(state, cams[0], bg, stage="fine", active_sh=sh,
                             raster_cfg=rc)
        pairs, tile = overflows(int(out.dropped_pairs),
                                int(out.dropped_tile), int(out.num_pairs))
        if not (pairs or tile):
            break
        rc = dataclasses.replace(
            rc, tile_cap=rc.tile_cap * (2 if tile else 1),
            bin_pairs_per_chunk=rc.bin_pairs_per_chunk * (2 if pairs else 1))
    rc = dataclasses.replace(rc, tile_cap=2 * rc.tile_cap)
    gts = torch.stack([loop.eval_step(state, c, bg, stage="fine",
                                      active_sh=sh, raster_cfg=rc).color
                       for c in cams])
    rng = np.random.default_rng(seed + 1)
    g = state.params["gauss"]
    with torch.no_grad():
        g.features_dc[:N_GAUSS] += torch.from_numpy(rng.normal(
            0.0, NOISE_DC, (N_GAUSS, 1, 3)).astype(np.float32)).to(device)
        g.opacity[:N_GAUSS] += torch.from_numpy(rng.normal(
            0.0, NOISE_OPACITY, (N_GAUSS, 1)).astype(np.float32)).to(device)
    return cfg, state, rc, bg, sh, cams, gts


def mesh_reg(cfg) -> tuple:
    return (cfg.hidden.time_smoothness_weight, cfg.hidden.l1_time_planes,
            cfg.hidden.plane_tv_weight)


def mesh_state_leaves(state) -> list:
    from fourdgs_tpu_torch.train import optim
    return optim.param_leaves(state.params) + [
        state.alive, state.denom, state.xyz_gradient_accum,
        state.max_radii2d]


def mesh_vs_single(torch, state, loss, aux, single, saux) -> dict:
    """A sharded step's state against the single-card step's from the same
    state (MESH_* tolerances): the loss, the PSNR, every gaussian field
    where its gradient is not round-off, every Adam first moment (the
    step's gradient) normalised, denom and max_radii2d exact,
    xyz_gradient_accum."""
    from fourdgs_tpu_torch.models.gaussians import FIELDS
    from fourdgs_tpu_torch.train import optim

    param_err, grad_err = 0.0, 0.0
    for f in FIELDS:
        a = getattr(state.params["gauss"], f).detach()
        b = getattr(single.params["gauss"], f).detach()
        g = getattr(single.opt_state.mu["gauss"], f)
        real = g.abs() > 1e-3 * g.abs().max()
        param_err = max(param_err, float((a - b)[real].abs().max())
                        if bool(real.any()) else 0.0)
    for a, b in zip(optim.moment_leaves(state.opt_state.mu),
                    optim.moment_leaves(single.opt_state.mu)):
        grad_err = max(grad_err, grads_agree(a, b))
    rec = {"loss": float(loss), "single_loss": float(saux.loss),
           "psnr": float(aux.psnr), "single_psnr": float(saux.psnr),
           "param_err": param_err, "grad_err": grad_err,
           "accum_err": float((state.xyz_gradient_accum
                               - single.xyz_gradient_accum).abs().max()),
           "denom_equal": bool(torch.equal(state.denom, single.denom)),
           "radii_equal": bool(torch.equal(state.max_radii2d,
                                           single.max_radii2d)),
           "dropped": [int(aux.dropped_pairs), int(aux.dropped_tile)]}
    rec["ok"] = (abs(rec["loss"] - rec["single_loss"])
                 <= MESH_LOSS_RTOL * abs(rec["single_loss"])
                 and abs(rec["psnr"] - rec["single_psnr"])
                 <= MESH_PSNR_RTOL * abs(rec["single_psnr"])
                 and param_err <= MESH_PARAM_ATOL and grad_err <= GRAD_TOL
                 and rec["accum_err"] <= MESH_ACCUM_ATOL
                 and rec["denom_equal"] and rec["radii_equal"]
                 and rec["dropped"] == [0, 0])
    return rec


def mesh_step_check(torch, mesh, inputs, device, timed: bool) -> dict:
    """One sharded step of the mesh from the inputs' state, the kernels'
    runs counted around it (the main path), MESH_TIMED_STEPS more timed,
    the ranks' states compared by digest; on rank 0 the single-card
    train_step from the same state, and the comparison."""
    from fourdgs_tpu_torch.parallel.multihost import (host_batch_slice,
                                                      ranks_agree)
    from fourdgs_tpu_torch.parallel.sharded import sharded_train_step
    from fourdgs_tpu_torch.train import graphs, loop, optim

    cfg, start, rc, bg, sh, cams, gts = inputs
    sl = host_batch_slice(len(cams), mesh)
    kw = dict(mesh=mesh, stage="fine", raster_cfg=rc,
              reg_weights=mesh_reg(cfg), lambda_dssim=MESH_DSSIM)

    def step(state):
        return sharded_train_step(
            state, cams[sl], gts[sl], bg, sh,
            tx=optim.build_optimizer(cfg.opt, SPATIAL_LR_SCALE), **kw)

    state = start.to(device)
    mesh_sync(torch, device)
    graphs.zero_counts()
    state, loss, aux = step(state)
    mesh_sync(torch, device)
    runs = graphs.kernel_runs()
    rec = {"runs": {k: runs[w] for k, w in MESH_PATH.items()},
           "ranks_equal": ranks_agree(mesh_state_leaves(state),
                                      mesh.group)[0]}
    if timed:
        again = start.to(device)
        for i in range(MESH_TIMED_STEPS + 1):
            if i == 1:
                mesh_sync(torch, device)
                t0 = time.perf_counter()
            step(again)
        mesh_sync(torch, device)
        rec["ms_per_step"] = 1e3 * (time.perf_counter() - t0) \
            / MESH_TIMED_STEPS
        del again
    if mesh.rank == 0:
        single = start.to(device)
        _, saux = loop.train_step(
            single, cams, gts, bg, sh, stage="fine", raster_cfg=rc,
            tx=optim.build_optimizer(cfg.opt, SPATIAL_LR_SCALE),
            lambda_dssim=MESH_DSSIM, reg_weights=mesh_reg(cfg))
        rec["vs_single"] = mesh_vs_single(torch, state, loss, aux, single,
                                          saux)
    return rec


def kernel_ms_by_name(torch, fn, n: int) -> dict:
    """Device time a call by kernel (and copy or fill) name, over n calls
    of `fn` under torch.profiler (which may drop some records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / n / 1e3
    return out


# the run-to-run-equal route of phase 17(a): the blend backward through
# K3's cluster, its table reduced by the reassociation over the binner's
# BlendSlots (FOURDGS_PALLAS_NO_FUSED_BWD alone), and the HexPlane
# backward's rows summed in one order
EQUAL_ROUTE_SWITCHES = {"FOURDGS_PALLAS_NO_FUSED_BWD": "1"}


def sorted_rows_sum(torch, idx, g, n_rows: int):
    """g's rows summed by idx in one order from run to run, in plain
    torch: the indices sorted stably, each row's run summed by
    torch.segment_reduce (a thread a run and column, serially)."""
    order = torch.argsort(idx, stable=True)
    bounds = torch.searchsorted(idx[order], torch.arange(
        n_rows + 1, device=idx.device, dtype=idx.dtype))
    return torch.segment_reduce(g[order], "sum", lengths=bounds.diff(),
                                unsafe=True, initial=0.0)


@contextlib.contextmanager
def deterministic_mode(torch):
    """torch.use_deterministic_algorithms (warn_only: an op without a
    deterministic implementation warns, and its warnings are kept in the
    yielded list), cuDNN's deterministic algorithms, and uninitialised
    memory left unfilled, as on the default route."""
    import warnings

    import torch.utils.deterministic as tud
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             tud.fill_uninitialized_memory,
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    tud.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        tud.fill_uninitialized_memory = saved[2]
        torch.backends.cudnn.deterministic = saved[3]


@contextlib.contextmanager
def sorted_hex_backward(torch):
    """The HexPlane gathers' backward (models/hexplane.py:_GatherRows)
    through `sorted_rows_sum` instead of index_add_."""
    from fourdgs_tpu_torch.models import hexplane
    saved = hexplane._GatherRows.backward

    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return sorted_rows_sum(torch, idx, g.contiguous(), ctx.n_rows), None

    hexplane._GatherRows.backward = staticmethod(backward)
    try:
        yield
    finally:
        hexplane._GatherRows.backward = saved


def equal_route_check(torch, mesh, inputs, device, eager_losses) -> dict:
    """Phase 17(a)'s eager pair again from one state on the
    run-to-run-equal route (EQUAL_ROUTE_SWITCHES, deterministic_mode, and
    the HexPlane backward by `sorted_hex_backward`), the two runs in
    lockstep with every leaf compared after each step (the first step and
    leaf where they part, if they do); where the pair's losses agree
    within STEP_LOSS_RTOL at every step, the captured mesh step on that
    route from the same state, held to the route's eager run at every
    step."""
    from fourdgs_tpu_torch.models.gaussians import FIELDS
    from fourdgs_tpu_torch.parallel import sharded
    from fourdgs_tpu_torch.tools.quality_run import environment
    from fourdgs_tpu_torch.train import graphs, optim

    cfg, start, rc, bg, sh, cams, gts = inputs
    names = list(FIELDS) + [n for n, _ in
                            start.params["deform"].named_parameters()]

    def leaves(st):
        return optim.param_leaves(st.params) + [
            st.xyz_gradient_accum, st.denom, st.max_radii2d]

    names += ["xyz_gradient_accum", "denom", "max_radii2d"]
    t0 = time.perf_counter()
    with environment(EQUAL_ROUTE_SWITCHES), deterministic_mode(torch) as \
            caught, sorted_hex_backward(torch):
        tx = optim.build_optimizer(cfg.opt, SPATIAL_LR_SCALE)
        key = graphs.StepKey("fine", start.capacity, rc, True, len(cams),
                             MESH_DSSIM, mesh_reg(cfg), graphs.switches(),
                             sharded.mesh_key(mesh, rc), sh)
        step = sharded.step_of_key(tx, mesh)(key)
        a, b = start.to(device), start.to(device)
        losses, parted = {"eager": [], "eager again": []}, None
        for i in range(MESH_CAPTURED_STEPS):
            losses["eager"].append(float(step(a, cams, gts, bg, sh).loss))
            losses["eager again"].append(float(step(b, cams, gts, bg,
                                                    sh).loss))
            if parted is None:
                for n, x, y in zip(names, leaves(a), leaves(b), strict=True):
                    if not torch.equal(x.detach(), y.detach()):
                        parted = {"step": i, "leaf": n, "max_abs": float(
                            (x.detach() - y.detach()).abs().max())}
                        break
        del a, b
        eager = np.array(losses["eager"])
        pair = np.abs(np.array(losses["eager again"]) - eager) / np.abs(eager)
        agree = bool((pair <= STEP_LOSS_RTOL).all())
        captured = None
        if agree:
            programs = graphs.StepPrograms(sharded.step_of_key(tx, mesh))
            st = start.to(device)
            losses["captured"] = [float(programs.run(key, st, cams, gts,
                                                     bg, sh).loss)
                                  for _ in range(MESH_CAPTURED_STEPS)]
            captured = np.abs(np.array(losses["captured"]) - eager) \
                / np.abs(eager)
            del programs, st
        mesh_sync(torch, device)
        warned = sorted({str(w.message)[:120] for w in caught})
    default = np.array(eager_losses)
    rec = {"switches": EQUAL_ROUTE_SWITCHES,
           "seconds": time.perf_counter() - t0,
           "eager_pair_by_step": pair.tolist(), "eager_pair_max":
           float(pair.max()), "eager_pair_agree": agree, "parted": parted,
           "captured_by_step": None if captured is None
           else captured.tolist(),
           "captured_max": None if captured is None
           else float(captured.max()),
           "vs_default_route_max": float(np.max(np.abs(eager - default)
                                                / np.abs(default))),
           "warnings": warned, "loss_first_last": {
               m: [v[0], v[-1]] for m, v in losses.items()}}
    rec["ok"] = not agree or rec["captured_max"] <= STEP_LOSS_RTOL
    log(f"mesh (a) run-to-run-equal route ({EQUAL_ROUTE_SWITCHES}, "
        f"deterministic algorithms, the HexPlane backward by the sorted "
        f"reduction), {MESH_CAPTURED_STEPS} steps from one state in "
        f"{rec['seconds']:.2f} s: two eager runs differ by at most "
        f"{rec['eager_pair_max']:.3g} a step (every step within "
        f"{STEP_LOSS_RTOL}: {agree}); they part "
        + ("nowhere, bit for bit at every leaf" if parted is None else
           f"at step {parted['step']}, leaf {parted['leaf']} (max abs "
           f"{parted['max_abs']:.3g})")
        + ("; the captured mesh step against that eager run: largest "
           f"step {rec['captured_max']:.3g} (tol {STEP_LOSS_RTOL})"
           if captured is not None else "; the captured step not held")
        + f"; the route's losses against the default route's: largest "
        f"step {rec['vs_default_route_max']:.3g}"
        + (f"; warnings {warned}" if warned else ""))
    return rec


def mesh_capture_check(torch, mesh, inputs, device) -> dict:
    """Phase 17(a)'s captured programs on the one-rank NCCL mesh, at the
    inputs' batch of two cameras: the single-card step captured, the
    sharded step captured and the sharded step eagerly,
    MESH_CAPTURED_STEPS each from one state (the captured sharded run's
    leaves after one step within GRAD_TOL of the eager run's, its losses
    within STEP_LOSS_RTOL on average over the steps: two eager runs from
    one state differ by more than that at their largest step, 1.6e-3 on
    the H100, K2's and index_add_'s float atomics carried on by Adam), the
    kernels' runs counted over each run; the
    two captured steps timed again in the other order and profiled
    (device time by kernel name, and where the difference goes); and the
    captured sharded frame of each camera against the eager one (equal).
    """
    import gc

    from fourdgs_tpu_torch.parallel import sharded
    from fourdgs_tpu_torch.render.serve import Renderer
    from fourdgs_tpu_torch.tools.render import MeshRenderer
    from fourdgs_tpu_torch.train import graphs, loop, optim

    cfg, start, rc, bg, sh, cams, gts = inputs
    tx = optim.build_optimizer(cfg.opt, SPATIAL_LR_SCALE)
    single_key = graphs.StepKey("fine", start.capacity, rc, True,
                                len(cams), MESH_DSSIM, mesh_reg(cfg),
                                graphs.switches())
    # the mesh's step is static in the SH degree, the single card's reads
    # it from a buffer (as run_stage passes them)
    key = single_key._replace(mesh=sharded.mesh_key(mesh, rc), active_sh=sh)
    sh_t = torch.full((), sh, dtype=torch.int32, device=device)
    mesh_fn = sharded.step_of_key(tx, mesh)
    programs = {"mesh": graphs.StepPrograms(mesh_fn),
                "single": graphs.StepPrograms(loop.step_of_key(tx))}
    run = {"single captured": lambda st: programs["single"].run(
               single_key, st, cams, gts, bg, sh_t),
           "mesh captured": lambda st: programs["mesh"].run(
               key, st, cams, gts, bg, sh),
           "mesh eager": lambda st: mesh_fn(key)(st, cams, gts, bg, sh),
           "mesh eager again": lambda st: mesh_fn(key)(st, cams, gts, bg,
                                                       sh)}
    states, losses, ms, after_one, runs = {}, {}, {}, {}, {}

    def timed(mode, record):
        st = states[mode]
        out = []
        for i in range(MESH_CAPTURED_STEPS):
            if i == UNTIMED_STEPS:
                mesh_sync(torch, device)
                t0 = time.perf_counter()
            out.append(run[mode](st).loss)
            if record and i == 0:
                after_one[mode] = st.to(device)
        mesh_sync(torch, device)
        ms.setdefault(mode, []).append(1e3 * (time.perf_counter() - t0)
                                       / (MESH_CAPTURED_STEPS
                                          - UNTIMED_STEPS))
        return [float(x) for x in out]

    for mode in run:
        states[mode] = start.to(device)
        mesh_sync(torch, device)
        graphs.zero_counts()
        losses[mode] = timed(mode, True)
        ran = graphs.kernel_runs()
        runs[mode] = {k: ran[w] for k, w in MESH_PATH.items()}
    for mode in ("mesh captured", "single captured"):   # the other order
        timed(mode, False)
    def leaves(st):
        return (optim.param_leaves(st.params)
                + optim.moment_leaves(st.opt_state.mu)
                + optim.moment_leaves(st.opt_state.nu)
                + [st.xyz_gradient_accum, st.denom, st.max_radii2d])
    one_step = max(grads_agree(a.detach(), b.detach()) for a, b in zip(
        leaves(after_one["mesh captured"]), leaves(after_one["mesh eager"]),
        strict=True))
    del after_one

    def rel(a, b, reduce=np.max):
        a, b = np.array(losses[a]), np.array(losses[b])
        return float(reduce(np.abs(a - b) / np.abs(b)))

    prof = {mode: kernel_ms_by_name(
        torch, lambda m=mode: run[m](states[m]), MESH_PROFILED_STEPS)
        for mode in ("single captured", "mesh captured")}
    diff = {name: prof["mesh captured"].get(name, 0.0)
            - prof["single captured"].get(name, 0.0)
            for name in set(prof["mesh captured"]) | set(prof["single "
                                                             "captured"])}
    nccl_ms = sum(v for k, v in prof["mesh captured"].items()
                  if "nccl" in k.lower())
    gathers = HEX_GATHERS_PER_LEVEL * len(cfg.hidden.multires)
    a_step = {"blend_fwd": 1, "blend_bwd": 1, "binner": 1,
              "gather_rows": gathers}
    live = programs["mesh"].live.program
    st = states["mesh captured"]
    renderer = Renderer(gauss=st.params["gauss"], alive=st.alive,
                        deform=st.params["deform"], aabb=st.aabb, bg=bg,
                        raster_cfg=rc, sh_degree=sh, device=device)
    frames = MeshRenderer(renderer, mesh)
    frame_equal = frames.captures
    for cam in cams:
        got, want = frames.render(cam), frames.render_eager(cam)
        frame_equal = frame_equal and all(
            torch.equal(getattr(got, f), getattr(want, f))
            for f in ("color", "depth", "alpha", "dropped_pairs",
                      "dropped_tile", "num_pairs"))
    mean = {mode: float(np.mean(v)) for mode, v in ms.items()}
    rec = {"ms_per_step": ms, "ratio": mean["mesh captured"]
           / mean["single captured"],
           "eager_over_captured": mean["mesh eager"]
           / mean["mesh captured"],
           "one_step_leaves": one_step,
           "losses": rel("mesh captured", "mesh eager"),
           "losses_mean": rel("mesh captured", "mesh eager", np.mean),
           "losses_vs_single": rel("mesh captured", "single captured"),
           "losses_eager_vs_eager": rel("mesh eager again", "mesh eager"),
           "loss_rel_by_step": {
               m: (np.abs(np.array(losses[m]) - np.array(losses[
                   "mesh eager"])) / np.abs(np.array(losses["mesh eager"]))
                   ).tolist() for m in ("mesh captured", "single captured",
                                        "mesh eager again")},
           "loss_first_last": {m: [v[0], v[-1]] for m, v in losses.items()},
           "runs": runs, "program_launches": live.launches,
           "replays": live.replays,
           "capture_s": {m: p.captures[0]["seconds"]
                         for m, p in programs.items()},
           "kernel_ms": {m: sum(p.values()) for m, p in prof.items()},
           "nccl_ms": nccl_ms,
           "kernel_diff_top": sorted(
               ((k[:80], v) for k, v in diff.items()),
               key=lambda kv: -abs(kv[1]))[:10],
           "frame_equal": frame_equal,
           "frames": [renderer.captured, renderer.replayed]}
    rec["equal_route"] = equal_route_check(torch, mesh, inputs, device,
                                           losses["mesh eager"])
    rec["ok"] = {
        "leaves": one_step <= GRAD_TOL,
        "losses": rec["losses_mean"] <= STEP_LOSS_RTOL,
        "losses on the run-to-run-equal route": rec["equal_route"]["ok"],
        "launches": live.launches == {REPORTED[k]: len(cams) * v
                                      for k, v in a_step.items()},
        "ran": all(runs["mesh captured"][k] > 0 for k in MESH_PATH),
        "frame": frame_equal and rec["frames"] == [1, len(cams)]}
    del states, programs, frames, renderer, st, run
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_band_kernels(torch, inputs, mesh) -> dict:
    """K1, K2, K3 and the binner on this rank's band of the first camera
    (its rects clipped to the band, the cull off, `tile0` its first
    tile), each against its plain version at the same offset (TOL,
    GRAD_TOL, equal), K3's table reduced over the band's BlendSlots
    against K2's rows, each kernel and plain version timed by CUDA
    events."""
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops import rasterize_tiled as rt
    from fourdgs_tpu_torch.ops.projection import project_gaussians
    from fourdgs_tpu_torch.render.render import splats_at

    cfg, state, rc, bg, sh, cams, gts = inputs
    rows = rc.grid_y // mesh.n_tile
    nt, tile0 = rows * rc.grid_x, mesh.tile * rows * rc.grid_x
    with torch.no_grad():
        xyz, scales, quats, opac, colors = splats_at(
            state.params["gauss"], state.params["deform"], cams[0],
            state.aabb, sh, "fine")
        proj = project_gaussians(xyz, scales, quats, cams[0], rc.img_width,
                                 rc.img_height, rc.tile_size,
                                 alive=state.alive, opacities=opac)
        band = rt.clip_proj_to_tile_rows(proj, mesh.tile * rows, rows)
        binned = rt.bin_gaussians_count(band, rc, True, num_tiles=nt)
        want = rt.bin_gaussians_count_plain(band, rc, True, num_tiles=nt)
        binner_equal = all(
            torch.equal(getattr(binned, f), getattr(want, f))
            for f in ("gidx", "counts", "overflow", "num_pairs",
                      "dropped_pairs", "dropped_tile")) and all(
            torch.equal(a, b) for a, b in zip(binned.slots, want.slots))
        table = blend.pack_attr_table(proj.pix, proj.conic, colors, opac,
                                      proj.depth)
        gidx, counts = binned.gidx, binned.counts
        fwd = (gidx, counts, table, rc)
        out = blend.blend_forward(*fwd, tile0=tile0)
        ref = blend.blend_forward_plain(*fwd, tile0=tile0)
        k1_err = {n: float((a - b).abs().max())
                  for n, a, b in zip(("color", "depth", "t"), out, ref)}
        gen = torch.Generator().manual_seed(7)
        p = rc.pixels_per_tile
        cot = [torch.randn(s, generator=gen).to(table.device)
               for s in ((nt, p, 3), (nt, p), (nt, p))]
        bwd = (*fwd[:3], *out, *cot, rc)
        g = blend.blend_backward(*bwd, tile0=tile0)
        gref = blend.blend_backward_plain(*bwd, tile0=tile0)
        k2_err = max(grads_agree(g[:, c], gref[:, c])
                     for c in range(blend.GRAD_W))
        s = blend.blend_backward_slots(*bwd, tile0=tile0)
        sref = blend.blend_backward_slots_plain(*bwd, tile0=tile0)
        used = gidx >= 0
        k3_err = max(grads_agree(s[..., c][used], sref[..., c][used])
                     for c in range(blend.GRAD_W))
        reduced = blend.reduce_slots(gidx, s, table.shape[0] - 1,
                                     binned.slots)
        k3_reduced_err = max(grads_agree(reduced[:, c], g[:, c])
                             for c in range(blend.GRAD_W))
        times = {}
        for name, kernel, plain in (
                ("binner", lambda: rt.bin_gaussians_count(
                    band, rc, num_tiles=nt),
                 lambda: rt.bin_gaussians_count_plain(band, rc,
                                                      num_tiles=nt)),
                ("blend_fwd", lambda: blend.blend_forward(*fwd, tile0=tile0),
                 lambda: blend.blend_forward_plain(*fwd, tile0=tile0)),
                ("blend_bwd", lambda: blend.blend_backward(*bwd,
                                                           tile0=tile0),
                 lambda: blend.blend_backward_plain(*bwd, tile0=tile0)),
                ("blend_bwd_slots",
                 lambda: blend.blend_backward_slots(*bwd, tile0=tile0),
                 lambda: blend.blend_backward_slots_plain(*bwd,
                                                          tile0=tile0))):
            dev = table.device.type
            times[name] = {"ms": time_call(kernel, 20, dev),
                           "plain_ms": time_call(plain, 2, dev)}
    ok = {"binner": binner_equal,
          "blend_fwd": all(k1_err[n] <= TOL[n] for n in TOL),
          "blend_bwd": k2_err <= GRAD_TOL,
          "blend_bwd_slots": k3_err <= GRAD_TOL
          and k3_reduced_err <= GRAD_TOL}
    errs = {"binner": 0.0, "blend_fwd": max(k1_err.values()),
            "blend_bwd": k2_err, "blend_bwd_slots": k3_err}
    return {"tile0": tile0, "tiles": nt,
            "pairs": int(band.tiles_touched.sum()),
            "k1_err": k1_err, "k3_reduced_err": k3_reduced_err,
            **{name: {**times[name], "max_abs_err": errs[name],
                      "ok": ok[name]} for name in times}}


def mesh_rank(rank: int, world: int, port: int, seed: int, out_dir: str,
              settings: dict) -> None:
    """Phase 17(b)'s rank process: two of them share cuda:0 over gloo.
    Each builds phase 17's inputs from the seed, takes one sharded step
    at each of MESH_SHAPES (rank 0 also the single-card step), renders
    the first camera tile-sharded at (1, 2), and rank 1 (tile 1 of
    (1, 2)) checks the kernels at its band offset. Writes
    <out_dir>/rank<r>.json. `settings` holds the device ("cuda") and any
    of this module's sizes to set in the rank (a CPU rehearsal cuts
    them)."""
    import torch
    import torch.distributed as dist

    settings = dict(settings)
    device_type = settings.pop("device")
    globals().update(settings)
    from fourdgs_tpu_torch.parallel import multihost
    from fourdgs_tpu_torch.parallel.mesh import make_mesh
    from fourdgs_tpu_torch.parallel.sharded import sharded_eval_render
    from fourdgs_tpu_torch.train import loop

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert multihost.initialize_distributed(device=device_type,
                                            backend="gloo")
    try:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if device_type == "cuda" else torch.device(device_type))
        inputs = mesh_inputs(torch, None, seed, device)
        out = {"rank": rank, "steps": {}}
        for shape in MESH_SHAPES:
            out["steps"]["x".join(map(str, shape))] = mesh_step_check(
                torch, make_mesh(*shape), inputs, device, timed=True)
        mesh = make_mesh(1, 2)
        cfg, state, rc, bg, sh, cams, _ = inputs
        color, _, _ = sharded_eval_render(state, cams[0], bg, mesh=mesh,
                                          raster_cfg=rc, stage="fine",
                                          active_sh=sh)
        if rank == 0:
            ref = loop.eval_step(state, cams[0], bg, stage="fine",
                                 active_sh=sh, raster_cfg=rc).color
            err = (color - ref).abs()
            out["eval"] = {"max_abs_err": float(err.max()),
                           "mean_abs_err": float(err.mean()),
                           "pixels_over_tol": int((err.amax(-1)
                                                   > TOL["color"]).sum())}
        dist.barrier()      # rank 1 times its kernels on an idle card
        if rank == 1:
            out["band_kernels"] = mesh_band_kernels(torch, inputs, mesh)
        dist.barrier()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_env():
    """torchrun's environment for one rank (a free port), for a block."""
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)


def mesh_nccl(torch, scene, seed: int, device) -> dict:
    """Phase 17(a): one rank over NCCL in this process, a (1, 1) mesh whose
    groups are NCCL groups of one rank: its sharded step against the
    single-card step, and its captured programs (`mesh_capture_check`)."""
    import torch.distributed as dist

    from fourdgs_tpu_torch.parallel import multihost
    from fourdgs_tpu_torch.parallel.mesh import make_mesh

    with one_rank_env():
        assert multihost.initialize_distributed(device=device.type)
        try:
            mesh = make_mesh(1, 1)
            inputs = mesh_inputs(torch, scene, seed, device)
            rec = mesh_step_check(torch, mesh, inputs, device, timed=False)
            rec["backend"] = mesh.backend
            rec["capture"] = mesh_capture_check(torch, mesh, inputs, device)
        finally:
            dist.destroy_process_group()
    return rec


def mesh_cli(torch, device, work: Path, seed: int) -> dict:
    """Phase 17(c): the train CLI under torch.distributed.run, two ranks
    sharing the card over gloo at --mesh 1,2, on phase 7's scene at tile
    16, its schedule cut; then the render CLI at --mesh 1,2 on the test
    split, and its PNGs' PSNR against the last in-loop eval."""
    from fourdgs_tpu_torch.data.png import read_png

    scene, model = work / "scene", work / "mesh_driver"
    shutil.rmtree(model, ignore_errors=True)
    coarse, fine = MESH_CLI_ITERS
    config = work / "mesh_smoke.py"
    config.write_text(DRIVER_CONFIG.format(coarse=coarse, fine=fine).replace(
        "RasterParams = dict(min_bucket=1024)",
        f"RasterParams = dict(min_bucket=1024, tile_size={MESH_TILE})"))
    env = {**os.environ, "FOURDGS_DIST_BACKEND": "gloo"}

    def torchrun(module, *args):
        """Run `module` on two ranks; returns its stdout and seconds, and
        logs when each of its progress lines came (where the time goes)."""
        t0 = time.perf_counter()
        with subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "2", "-m", module,
                 *map(str, args)], cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT) as proc:
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if any(k in line for k in MESH_CLI_MARKS):
                    log(f"mesh (c) +{time.perf_counter() - t0:6.2f} s: "
                        f"{line.strip()[:120]}")
            rc = proc.wait(timeout=600)
        printed = "".join(lines)
        if rc != 0:
            raise AssertionError(f"{module} over the mesh failed ({rc}):\n"
                                 f"{printed[-6000:]}")
        return printed, time.perf_counter() - t0

    size = ["--image_size", DRIVER_SIZE, DRIVER_SIZE, "--device",
            device.type]
    printed, t_train = torchrun(
        "fourdgs_tpu_torch.tools.train", "-s", scene, "-m", model, *size,
        "--configs", config, "--quiet", "--seed", seed,
        "--test_iterations", fine, "--save_iterations", fine,
        "--distributed", "--mesh", "1,2")
    with open(model / "train_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    mesh = records[-1]["mesh"]
    ms = {r["stage"]: 1e3 * r["elapsed"] / r["iter"] for r in records
          if "elapsed" in r}
    evals = [r for r in records if r.get("eval") == "test"]
    in_loop = evals[-1]["psnr"]
    rendered, t_render = torchrun(
        "fourdgs_tpu_torch.tools.render", "-m", model, "-s", scene, *size,
        "--mesh", "1,2", "--skip_train", "--skip_video")
    split = model / "test" / f"ours_{fine}"
    psnrs = []
    for f in sorted((split / "renders").glob("*.png")):
        a = read_png(f).astype(np.float64) / 255.0
        b = read_png(split / "gt" / f.name).astype(np.float64) / 255.0
        psnrs.append(-10.0 * np.log10(((a - b) ** 2).mean()))
    post_hoc = float(np.mean(psnrs))
    return {"ms_per_iteration": ms, "seconds_train_cli": t_train,
            "seconds_render_cli": t_render, "in_loop_psnr": in_loop,
            "post_hoc_psnr": post_hoc, "test_views": len(psnrs),
            "ranks_equal": mesh["ranks_equal"],
            "kernel_runs": [{k: r[w] for k, w in MESH_PATH.items()}
                            for r in mesh["kernel_runs"]],
            "printed_mesh_line": "training on mesh data=1 tile=2" in printed,
            "printed_render_mesh": "rendering on mesh data=1 tile=2"
            in rendered}


def mesh_cli_nccl(torch, device, work: Path, seed: int, coarse: int,
                  fine: int) -> dict:
    """Phase 17(d): the train CLI at --distributed --mesh 1,1 over a
    one-rank NCCL group, in this process as phase 7 runs it, on phase 7's
    scene, config, schedule and switches (every step a replay of the
    captured sharded step, every sharded eval a replay of a captured
    sharded frame), with the kernels' runs read around it; then the
    render CLI at --mesh 1,1 on the test split (captured sharded frames)
    and its PNGs' PSNR against the last in-loop eval."""
    from fourdgs_tpu_torch.data.png import read_png
    from fourdgs_tpu_torch.tools import render as render_cli
    from fourdgs_tpu_torch.tools import train as train_cli
    from fourdgs_tpu_torch.train import graphs

    scene, model = work / "scene", work / "mesh_nccl_driver"
    shutil.rmtree(model, ignore_errors=True)
    config = work / "dnerf_smoke.py"
    config.write_text(DRIVER_CONFIG.format(coarse=coarse, fine=fine))
    size = ["--image_size", str(DRIVER_SIZE), str(DRIVER_SIZE), "--device",
            device.type]
    with switches_set(graphs.SWITCHES_ON), one_rank_env():
        mesh_sync(torch, device)
        graphs.zero_counts()
        t0 = time.perf_counter()
        summary = train_cli.main([
            "-s", str(scene), "-m", str(model), "--configs", str(config),
            "--quiet", "--seed", str(seed), *size, "--test_iterations",
            str(coarse), str(fine), "--save_iterations", str(fine),
            "--distributed", "--mesh", "1,1"])
        mesh_sync(torch, device)
        t_train = time.perf_counter() - t0
        runs = kernel_runs()
    printed = io.StringIO()
    with one_rank_env(), contextlib.redirect_stdout(printed):
        t0 = time.perf_counter()
        rendered = render_cli.main(["-m", str(model), "-s", str(scene),
                                    *size, "--mesh", "1,1", "--skip_train",
                                    "--skip_video"])
        t_render = time.perf_counter() - t0
    printed = printed.getvalue()
    print(printed, end="", flush=True)
    split = model / "test" / f"ours_{fine}"
    psnrs = []
    for f in sorted((split / "renders").glob("*.png")):
        a = read_png(f).astype(np.float64) / 255.0
        b = read_png(split / "gt" / f.name).astype(np.float64) / 255.0
        psnrs.append(-10.0 * np.log10(((a - b) ** 2).mean()))
    stages = {st["stage"]: {
        "ms_per_iteration": 1e3 * st["wall_time"]
        / (st["iterations"] - st["start"]),
        "iterations": st["iterations"] - st["start"],
        "captures": len(st["graphs"]["captures"]),
        "capture_s": sum(c["seconds"] for c in st["graphs"]["captures"]),
        "replays": st["graphs"]["replays"], "rebinds": st["graphs"]["rebinds"],
        "test_psnr": st["test_psnr"]} for st in summary["stages"]}
    return {"stages": stages, "seconds_train_cli": t_train,
            "seconds_render_cli": t_render,
            "in_loop_psnr": summary["stages"][-1]["test_psnr"][-1][1],
            "post_hoc_psnr": float(np.mean(psnrs)), "test_views": len(psnrs),
            "eval_frames": summary["mesh"]["eval_frames"],
            "ranks_equal": summary["mesh"]["ranks_equal"], "runs": runs,
            "render": {k: rendered[k] for k in ("captures", "replays")},
            "render_renders": sum(r["renders"]
                                  for r in rendered["splits"].values()),
            "render_fps": rendered["splits"]["test"]["fps"],
            "printed_captured": "rendering on mesh data=1 tile=1 (captured "
            "frames)" in printed}


def mesh_scaling(device) -> dict:
    """Phase 17(e): tools/bench_scaling.py over every card of the machine,
    as a user runs it; its lines."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "fourdgs_tpu_torch.tools.bench_scaling",
         *SCALING_ARGS], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    if done.returncode != 0:
        raise AssertionError(f"bench_scaling failed ({done.returncode}):\n"
                             f"{(done.stdout + done.stderr)[-6000:]}")
    lines = [json.loads(x) for x in done.stdout.splitlines()
             if x.startswith('{"mesh"')]
    return {"lines": lines, "seconds": time.perf_counter() - t0}


def phase_mesh(torch, device, work: Path, scene, seed: int,
               coarse: int, fine: int, driver_fine_ms: float,
               rank_settings: dict | None = None) -> dict:
    """Phase 17: (a) one NCCL rank, (b) two gloo ranks on the card, spawned
    after phase 2's build, (c) the train and render CLIs over a 1 x 2
    mesh. Raises when a check fails; returns what it measured, with each
    path's kernel runs at a nonzero band and gaussian offset (rank 1's)."""
    import torch.multiprocessing as mp

    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
        if device.type == "cuda" else device.type)
    t0 = time.perf_counter()
    nccl = mesh_nccl(torch, scene, seed, device)
    t_a = time.perf_counter() - t0
    cap = nccl["capture"]
    log(f"mesh (a): one NCCL rank ({nccl['backend']}), a 1x1 sharded step "
        f"against train_step: {nccl['vs_single']}; runs {nccl['runs']}")
    log(f"mesh (a) captured ({card}): {SIZE}x{SIZE}, tile {MESH_TILE}, "
        f"batch {len(MESH_TIMES)}, {N_GAUSS} gaussians, ms/step over "
        f"{MESH_CAPTURED_STEPS - UNTIMED_STEPS} steps a round: "
        + "; ".join(f"{m} " + ", ".join(f"{v:.3f}" for v in ms)
                    for m, ms in cap["ms_per_step"].items())
        + f"; the captured mesh step over the single-card one "
        f"{cap['ratio']:.4f} (target {MESH_CAPTURE_TARGET}), the eager mesh "
        f"step over the captured {cap['eager_over_captured']:.2f}; captured "
        f"against eager: every leaf after one step within "
        f"{cap['one_step_leaves']:.3g} (tol {GRAD_TOL:g}), losses within "
        f"{cap['losses_mean']:.3g} on average (tol {STEP_LOSS_RTOL:g}), "
        f"{cap['losses']:.3g} at the largest step (the two eager runs "
        f"{cap['losses_eager_vs_eager']:.3g}, the single-card captured run "
        f"{cap['losses_vs_single']:.3g}); "
        f"captures {cap['capture_s']} s; the program's launches "
        f"{cap['program_launches']}, {cap['replays']} replays; runs "
        f"{cap['runs']}; sharded frames captured and replayed "
        f"{cap['frames']}, equal to eager {cap['frame_equal']}")
    log(f"mesh (a) profile of the replays ({MESH_PROFILED_STEPS} a mode): "
        f"device ms a step by kernel, single "
        f"{cap['kernel_ms']['single captured']:.3f}, mesh "
        f"{cap['kernel_ms']['mesh captured']:.3f} (NCCL "
        f"{cap['nccl_ms']:.4f}); the largest differences (mesh - single): "
        + ", ".join(f"{k} {v:+.4f}" for k, v in cap["kernel_diff_top"])
        + f"; {t_a:.2f} s")
    out_dir = work / "mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t1 = time.perf_counter()
    ctx = mp.start_processes(
        mesh_rank, args=(2, free_port(), seed, str(out_dir),
                         rank_settings or {"device": "cuda"}),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.perf_counter() + MESH_RANKS_TIMEOUT
    while not ctx.join(max(deadline - time.perf_counter(), 0.0)):
        if time.perf_counter() >= deadline:    # a rank hung: stop both
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"phase 17(b)'s ranks still running after "
                                 f"{MESH_RANKS_TIMEOUT} s")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(2)]
    t_b = time.perf_counter() - t1
    two = {k: {"ms_per_step": [r["steps"][k]["ms_per_step"] for r in ranks],
               "vs_single": ranks[0]["steps"][k]["vs_single"],
               "runs_rank1": ranks[1]["steps"][k]["runs"],
               "ranks_equal": ranks[0]["steps"][k]["ranks_equal"]}
           for k in ranks[0]["steps"]}
    band = ranks[1]["band_kernels"]
    for k, v in two.items():
        log(f"mesh (b) {k}: two ranks sharing one card ({card}; not a "
            f"scaling figure): {v['ms_per_step'][0]:.3f} ms/step eager at "
            f"{SIZE}x{SIZE}, tile {MESH_TILE}, batch {len(MESH_TIMES)}; "
            f"against train_step {v['vs_single']}; rank 1's runs "
            f"{v['runs_rank1']}; ranks equal {v['ranks_equal']}")
    log(f"mesh (b): sharded_eval_render against the single-card frame "
        f"{ranks[0]['eval']}; rank 1's band (tile0 {band['tile0']}, "
        f"{band['tiles']} tiles, {band['pairs']} pairs): " + ", ".join(
            f"{k} {band[k]['ms']:.4f} ms (plain {band[k]['plain_ms']:.3f}, "
            f"err {band[k]['max_abs_err']:.3g}, ok {band[k]['ok']})"
            for k in ("binner", "blend_fwd", "blend_bwd",
                      "blend_bwd_slots")) + f"; {t_b:.2f} s")
    t2 = time.perf_counter()
    cli = mesh_cli(torch, device, work, seed)
    t_c = time.perf_counter() - t2
    log(f"mesh (c): train CLI over --mesh 1,2, two ranks sharing one card "
        f"({card}; not a scaling figure): "
        + ", ".join(f"{s} {v:.2f} ms/iteration"
                    for s, v in cli["ms_per_iteration"].items())
        + f"; ranks equal {cli['ranks_equal']}; in-loop test PSNR "
        f"{cli['in_loop_psnr']:.4f}, post hoc {cli['post_hoc_psnr']:.4f} "
        f"over {cli['test_views']} views (tol {RENDER_PSNR_TOL}); rank 1's "
        f"runs {cli['kernel_runs'][1]}; train {cli['seconds_train_cli']:.2f} "
        f"s, render {cli['seconds_render_cli']:.2f} s")
    t3 = time.perf_counter()
    cli_nccl = mesh_cli_nccl(torch, device, work, seed, coarse, fine)
    t_d = time.perf_counter() - t3
    st = cli_nccl["stages"]
    log(f"mesh (d): train CLI at --distributed --mesh 1,1 over one NCCL "
        f"rank, captured ({card}), phase 7's scene, schedule and switches: "
        + ", ".join(f"{s} {v['ms_per_iteration']:.3f} ms/iteration "
                    f"({v['captures']} captures, {v['capture_s']:.2f} s; "
                    f"{v['replays']} replays)" for s, v in st.items())
        + f"; phase 7's fine {driver_fine_ms:.3f} (ratio "
        f"{st['fine']['ms_per_iteration'] / driver_fine_ms:.4f}, target "
        f"{MESH_CLI_TARGET}); eval frames {cli_nccl['eval_frames']}; in-loop "
        f"test PSNR {cli_nccl['in_loop_psnr']:.4f}, render CLI post hoc "
        f"{cli_nccl['post_hoc_psnr']:.4f} over {cli_nccl['test_views']} views "
        f"(tol {RENDER_PSNR_TOL}), {cli_nccl['render']} frames, "
        f"{cli_nccl['render_fps']:.2f} FPS; runs {cli_nccl['runs']}; train "
        f"{cli_nccl['seconds_train_cli']:.2f} s, render "
        f"{cli_nccl['seconds_render_cli']:.2f} s")
    t4 = time.perf_counter()
    scaling = mesh_scaling(device)
    t_e = time.perf_counter() - t4
    for line in scaling["lines"]:
        log(f"mesh (e) bench_scaling: {json.dumps(line)}")
    seconds = time.perf_counter() - t0
    log(f"mesh: phase 17 in {seconds:.2f} s (a {t_a:.2f}, b {t_b:.2f}, "
        f"c {t_c:.2f}, d {t_d:.2f}, e {t_e:.2f})")
    cards = torch.cuda.device_count() if device.type == "cuda" else 2
    checks = {
        "(a) NCCL": nccl["backend"] == ("nccl" if device.type == "cuda"
                                        else "gloo"),
        "(a) 1x1 against train_step": nccl["vs_single"]["ok"],
        "(a) ran the path": all(nccl["runs"][k] > 0 for k in MESH_PATH),
        **{f"(a) captured: {k}": v for k, v in cap["ok"].items()},
        **{f"(b) {k} against train_step": v["vs_single"]["ok"]
           for k, v in two.items()},
        **{f"(b) {k} ranks equal": v["ranks_equal"] for k, v in two.items()},
        **{f"(b) {k} rank 1 ran the path": all(
            v["runs_rank1"][n] > 0 for n in MESH_PATH)
           for k, v in two.items()},
        "(b) eval render": ranks[0]["eval"]["max_abs_err"] <= TOL["color"],
        **{f"(b) {k} at the band offset": band[k]["ok"]
           for k in ("binner", "blend_fwd", "blend_bwd",
                     "blend_bwd_slots")},
        "(c) ranks equal": cli["ranks_equal"],
        "(c) rank 1 ran the path": all(cli["kernel_runs"][1][n] > 0
                                       for n in MESH_PATH),
        "(c) the mesh lines": cli["printed_mesh_line"]
        and cli["printed_render_mesh"],
        "(c) post hoc within tol": abs(cli["post_hoc_psnr"]
                                       - cli["in_loop_psnr"])
        <= RENDER_PSNR_TOL,
        "(d) every iteration replayed a captured step": all(
            v["replays"] == v["iterations"] for v in st.values()),
        "(d) the evals replayed captured sharded frames":
            cli_nccl["eval_frames"]["captured"]
            and cli_nccl["eval_frames"]["captures"] >= 1
            and cli_nccl["eval_frames"]["replays"] > 0,
        "(d) ranks equal": cli_nccl["ranks_equal"],
        "(d) the kernels ran": all(cli_nccl["runs"][k] > 0 for k in (
            "blend_fwd", "blend_bwd_slots", "scatter_add_rows",
            "scatter_set_scalars", "binner", "gather_rows")),
        "(d) the render CLI replayed captured frames":
            cli_nccl["printed_captured"]
            and cli_nccl["render"]["captures"] >= 1
            and cli_nccl["render"]["replays"] == cli_nccl["render_renders"],
        "(d) post hoc within tol": abs(cli_nccl["post_hoc_psnr"]
                                       - cli_nccl["in_loop_psnr"])
        <= RENDER_PSNR_TOL,
        "(e) a line a mesh": [x["mesh"] for x in scaling["lines"]]
        == ["x".join(map(str, m)) for m in mesh_shapes_of(cards)],
        "(e) captured on the cards": all(
            x["captured"] == (device.type == "cuda") and x["rays_per_s"] > 0
            for x in scaling["lines"])}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 17 failed: {failed}")
    # rank 1 of a 1 x 2 mesh blends its band from tile0 > 0, bins only
    # its band and deforms the second half of the gaussians
    offset_runs = {n: {"b": two["1x2"]["runs_rank1"][n],
                       "c": cli["kernel_runs"][1][n]} for n in MESH_PATH}
    return {"nccl": nccl, "two_ranks": two, "eval": ranks[0]["eval"],
            "band_kernels": band, "cli": cli, "offset_runs": offset_runs,
            "cli_nccl": cli_nccl, "scaling": scaling, "seconds": seconds,
            "seconds_abcde": [t_a, t_b, t_c, t_d, t_e]}


def mesh_shapes_of(cards: int) -> list:
    """tools/bench_scaling.py's meshes at its operating point's tiles."""
    from fourdgs_tpu_torch.tools import bench_scaling
    size = (int(SCALING_ARGS[SCALING_ARGS.index("--size") + 1])
            if "--size" in SCALING_ARGS else 800)
    return bench_scaling.mesh_shapes(cards, bench_scaling._num_tiles(size))


# ---------------------------------------------------------------------------
# phase 18 (after phase 2): the host library
# ---------------------------------------------------------------------------

HOST_PNG = (1352, 1014)          # (W, H): a DyNeRF frame with Paeth rows
HOST_JPEG = (1008, 756)          # a COLMAP view, quality 95, 4:2:0
HOST_RESIZE = ((2704, 2028), (1352, 1014))   # LANCZOS, in and out (W, H)
HOST_POINTS = 1_000_000          # points3D.bin, tracks of 2-8 pairs
HOST_TRACKS = (2, 8)
HOST_POOL_VIEWS = 16             # DyNeRF frames decoded by each pool
HOST_POOL_BATCH = 4              # a DyNeRF batch
HOST_REPEATS = 3                 # native timings: the best of these
PROGRESSIVE_FIXTURES = ROOT / "tests" / "jpeg_fixtures"


def photo_like(shape, seed: int) -> np.ndarray:
    """A seeded (H, W, C) uint8 image like a photograph to the codecs:
    smooth gradients plus Gaussian noise of sigma 6."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(x / 97 + k) * np.cos(y / 73 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0.0, 6.0, base.shape), 0,
                   255).astype(np.uint8)


def write_points3d(path: Path, xyz, rgb, err, track_lens, seed: int) -> None:
    """points3D.bin (COLMAP's binary model) of the points in order, point
    i with track_lens[i] random (image id, point2D index) pairs; each run
    of equal track lengths is written as one record array."""
    rng = np.random.default_rng(seed)
    track_lens = np.asarray(track_lens, np.int64)
    cuts = np.flatnonzero(np.diff(track_lens)) + 1
    with open(path, "wb") as f:
        f.write(np.uint64(len(xyz)).tobytes())
        for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(xyz)]):
            t = int(track_lens[lo]) if hi > lo else 0
            rec = np.zeros(hi - lo, np.dtype([
                ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                ("err", "<f8"), ("n", "<u8"), ("track", "<i4", (2 * t,))]))
            rec["id"] = np.arange(lo, hi)
            rec["xyz"], rec["rgb"], rec["err"] = xyz[lo:hi], rgb[lo:hi], \
                err[lo:hi]
            rec["n"] = t
            rec["track"] = rng.integers(0, 1 << 20, (hi - lo, 2 * t))
            f.write(rec.tobytes())


@contextlib.contextmanager
def plain_host_route():
    """The data layer's plain versions (numpy, Python) in place of the
    host library's calls, for the length of the block."""
    from fourdgs_tpu_torch.data import colmap, jpeg, png, resample
    routed = [(png, "unfilter"), (jpeg, "decode_jpeg"),
              (resample, "resample"), (colmap, "read_points3d_binary")]
    saved = [getattr(m, n) for m, n in routed]
    try:
        for m, n in routed:
            setattr(m, n, getattr(m, f"{n}_plain"))
        yield
    finally:
        for (m, n), fn in zip(routed, saved):
            setattr(m, n, fn)


def native_and_plain(label: str, fn, unit: str = "ms") -> dict:
    """fn() through the host library (the best of HOST_REPEATS calls) and
    through the plain versions (one call); raises unless both give equal
    arrays. Returns both times in `unit` and the native result."""
    scale = 1e3 if unit == "ms" else 1.0
    best = None
    for _ in range(HOST_REPEATS):
        t0 = time.perf_counter()
        got = fn()
        t = time.perf_counter() - t0
        best = t if best is None else min(best, t)
    with plain_host_route():
        t0 = time.perf_counter()
        want = fn()
        plain = time.perf_counter() - t0
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    equal = all(a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b) for a, b in zip(got_t, want_t))
    log(f"host: {label}: native {best * scale:.3f} {unit}, plain "
        f"{plain * scale:.3f} {unit} ({plain / best:.1f}x), equal bit for "
        f"bit: {equal}")
    if not equal:
        raise AssertionError(f"host: {label}: native and plain differ")
    return {f"native_{unit}": best * scale, f"plain_{unit}": plain * scale,
            "result": got}


def host_pools(work: Path, seed: int) -> dict:
    """HOST_POOL_VIEWS DyNeRF-size Paeth frames decoded (data/images.py
    `load_u8`, the lazy bank's and the stacking pool's call) in batches of
    HOST_POOL_BATCH by DECODE_WORKERS threads and by DECODE_WORKERS
    spawned processes (the pool before the host library), after one
    untimed pass: ms a batch (median) and a view over a timed pass, and
    each pool's start (its workers' first calls)."""
    import concurrent.futures
    import multiprocessing

    from fourdgs_tpu_torch.data import png
    from fourdgs_tpu_torch.data.images import load_u8
    from fourdgs_tpu_torch.data.scene import DECODE_WORKERS
    w, h = HOST_PNG
    img = photo_like((h, w, 3), seed + 1)
    paths = [str(work / f"pool_{i:02d}.png") for i in range(HOST_POOL_VIEWS)]
    png.write_png(paths[0], img, row_filter=4)
    for path in paths[1:]:
        shutil.copyfile(paths[0], path)
    out = {}
    for kind in ("threads", "processes"):
        t0 = time.perf_counter()
        if kind == "threads":
            pool = concurrent.futures.ThreadPoolExecutor(DECODE_WORKERS)
        else:
            pool = concurrent.futures.ProcessPoolExecutor(
                DECODE_WORKERS, mp_context=multiprocessing.get_context(
                    "spawn"))
        try:
            # every worker started, the library loaded in each
            list(pool.map(load_u8, [None] * DECODE_WORKERS,
                          paths[:DECODE_WORKERS], [HOST_PNG] * DECODE_WORKERS))
            start = time.perf_counter() - t0
            # one untimed pass: the allocator's steady state, as a lazy
            # bank's after its first batches
            list(pool.map(load_u8, [None] * HOST_POOL_VIEWS, paths,
                          [HOST_PNG] * HOST_POOL_VIEWS))
            batches = []
            t_all = time.perf_counter()
            for b in range(0, HOST_POOL_VIEWS, HOST_POOL_BATCH):
                t1 = time.perf_counter()
                got = list(pool.map(load_u8, [None] * HOST_POOL_BATCH,
                                    paths[b:b + HOST_POOL_BATCH],
                                    [HOST_PNG] * HOST_POOL_BATCH))
                batches.append(time.perf_counter() - t1)
            total = time.perf_counter() - t_all
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        if not all(np.array_equal(g, img) for g in got):
            raise AssertionError(f"host pools: {kind} decoded other pixels")
        out[kind] = {"start_s": start,
                     "ms_per_batch": 1e3 * float(np.median(batches)),
                     "ms_per_view": 1e3 * total / HOST_POOL_VIEWS}
        log(f"host: {DECODE_WORKERS} {kind}: {HOST_POOL_VIEWS} views of "
            f"{w}x{h} (Paeth) in batches of {HOST_POOL_BATCH}: "
            f"{out[kind]['ms_per_batch']:.3f} ms a batch (median), "
            f"{out[kind]['ms_per_view']:.3f} ms a view over the pass; "
            f"started in {start:.3f} s")
    return out


def phase_host(work: Path, seed: int) -> dict:
    """Phase 18: the host library (csrc/host, native/build.py) built, then
    each of its routes against its plain version on this run's inputs,
    equal bit for bit, with both times: a photograph-like Paeth PNG, a
    quality-95 4:2:0 JPEG from data/jpeg.py's encoder, the progressive
    fixtures of tests/jpeg_fixtures (whose Pillow pixels' sha256 sits in
    pillow_pixels.json), LANCZOS on a 2x DyNeRF frame, a million-point
    points3D.bin; then the decode pools (host_pools)."""
    import hashlib

    from fourdgs_tpu_torch import native
    from fourdgs_tpu_torch.data import colmap, images, jpeg, png, resample
    from fourdgs_tpu_torch.native import build
    t_phase = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    native.load_library()
    info = build.build_info
    log(f"host: library {time.perf_counter() - t0:.2f} s (compile "
        f"{info['seconds']:.2f} s, cached={info['cached']}, "
        f"{build.compiler()}) -> {Path(info['path']).relative_to(ROOT)}")
    out = {"build_s": info["seconds"], "cached": info["cached"]}

    w, h = HOST_PNG
    path = str(work / "paeth.png")
    img = photo_like((h, w, 3), seed)
    png.write_png(path, img, row_filter=4)
    r = native_and_plain(f"PNG {w}x{h}, Paeth rows", lambda: png.read_png(path))
    if not np.array_equal(r.pop("result"), img):
        raise AssertionError("host: the PNG decodes to other pixels")
    out["png"] = r

    w, h = HOST_JPEG
    path = str(work / "q95.jpg")
    jpeg.write_jpeg(path, photo_like((h, w, 3), seed + 2), 95, "4:2:0")
    r = native_and_plain(f"JPEG {w}x{h}, quality 95, 4:2:0, baseline",
                         lambda: images.read_rgb(path))
    r.pop("result")
    out["jpeg"] = r

    manifest = json.loads((PROGRESSIVE_FIXTURES
                           / "pillow_pixels.json").read_text())
    out["progressive"] = {}
    for name, want in sorted(manifest.items()):
        p = str(PROGRESSIVE_FIXTURES / name)
        r = native_and_plain(f"progressive {name}", lambda: jpeg.read_jpeg(p))
        got = r.pop("result")
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        if list(got.shape) != want["shape"] or digest != want["sha256"]:
            raise AssertionError(f"host: {name} differs from Pillow's "
                                 f"pixels")
        out["progressive"][name] = r
    log(f"host: {len(manifest)} progressive fixtures equal to Pillow's "
        f"pixels (sha256)")

    (wi, hi), (wo, ho) = HOST_RESIZE
    big = photo_like((hi, wi, 3), seed + 3)
    r = native_and_plain(f"LANCZOS {wi}x{hi} -> {wo}x{ho}",
                         lambda: resample.resize(big, (wo, ho), "lanczos"))
    r.pop("result")
    out["lanczos"] = r

    rng = np.random.default_rng(seed + 4)
    path = str(work / "points3D.bin")
    tracks = np.sort(rng.integers(HOST_TRACKS[0], HOST_TRACKS[1] + 1,
                                  HOST_POINTS))
    xyz = rng.normal(size=(HOST_POINTS, 3))
    rgb = rng.integers(0, 256, (HOST_POINTS, 3), dtype=np.uint8)
    err = rng.uniform(0.0, 2.0, HOST_POINTS)
    write_points3d(Path(path), xyz, rgb, err, tracks, seed)
    r = native_and_plain(f"points3D.bin, {HOST_POINTS} points, tracks "
                         f"{HOST_TRACKS[0]}-{HOST_TRACKS[1]}",
                         lambda: colmap.read_points3d_binary(path), unit="s")
    got = r.pop("result")
    if not (np.array_equal(got[0], xyz) and np.array_equal(got[1], rgb)
            and np.array_equal(got[2], err)):
        raise AssertionError("host: points3D.bin read other points")
    out["points3d"] = r

    out["pools"] = host_pools(work, seed)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"host: phase {out['seconds']:.2f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: the dev tools' kernels (D1-D6) at the scripts' shapes
# ---------------------------------------------------------------------------

def dev_entry(kid: str, name: str, source: str, replaces: str,
              tpu_kernel: str, launches: int, err: float, rec: dict,
              library_ms=None, **extra) -> dict:
    """A kernels-line entry of a dev tool's kernel from its tool's record
    (ms, plain_ms, bound_ms, bound_by, bound_resource)."""
    return {"name": f"{kid} {name}", "route": "cuda",
            "source": f"fourdgs_tpu_torch/csrc/{source}",
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": launches, "max_abs_err": err, "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "bound_resource": rec["bound_resource"],
            "library_ms": library_ms, "ok": True, **extra}


def device_share(fn, rec: dict) -> dict:
    """A dev kernel's device time a call (`device_ms`: by kernel, the
    records kept, the host's enqueue time), the same time taken without
    the profiler (`held_stream_ms`, what `device_ms` falls back on), and
    its bound's share of the events time (rec's ms) and of the device
    time."""
    dev = device_ms(fn)
    return {"device_ms": dev["ms"], "device_kernels": dev["kernels"],
            "device_records": dev["records"], "host_ms": dev["host_ms"],
            "held_stream_ms": held_stream_ms(fn),
            "bound_share_events": rec["bound_ms"] / rec["ms"],
            "bound_share_device": rec["bound_ms"] / dev["ms"]}


def phase_dev_kernels(torch, device, seed: int) -> list:
    """Each tool of fourdgs_tpu_torch/tools that ports a Pallas prototype
    of scripts/ runs through its `main` at its script's shapes, with the
    launch counts read around the six; then each kernel against its plain
    version on the tool's inputs."""
    from fourdgs_tpu_torch.ops import (binner_proto, blend, blend_variants,
                                       gather, scatter, serial)
    from fourdgs_tpu_torch.tools import (exp_binner_proto, exp_gather,
                                         exp_scatter, exp_serial,
                                         profile_blend_split,
                                         profile_kernel_variants)
    from fourdgs_tpu_torch.utils.timing import bound

    bodies = [getattr(blend_variants, b) for b in blend_variants.BODIES]
    wrappers = [gather.gather_rows, binner_proto.expand_rank,
                scatter.scatter_add_rows, serial.scalar_store,
                serial.tile_counter_store, blend.blend_forward, *bodies]
    tools = {"D1": exp_gather, "D2": exp_binner_proto, "D3": exp_scatter,
             "D4": exp_serial, "D5": profile_blend_split,
             "D6": profile_kernel_variants}
    argv = ["--seed", str(seed), "--device", device.type]

    # ---- the main path, with the launch counts read around it ----
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    res = {kid: tool.main(argv) for kid, tool in tools.items()}
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"dev tools: {time.perf_counter() - t0:.2f} s; launches {launches}")

    # ---- each kernel against its plain version on its tool's inputs ----
    out = []
    table, idx = res["D1"]["inputs"]["table"], res["D1"]["inputs"]["idx"]
    ref = gather.gather_rows_plain(table, idx)
    equal = bool(torch.equal(gather.gather_rows(table, idx), ref))
    log(f"kernel gather_rows vs plain: equal {equal}")
    if not equal:
        raise AssertionError("gather_rows disagrees with plain")
    out.append(dev_entry(
        "D1", "gather_rows", "gather.cu", "scripts/exp_pallas_gather.py:50",
        "scripts/exp_pallas_gather.py:50, :75, :102, :125 (gather1-4)",
        launches["gather_rows"], 0.0, res["D1"],
        library_ms=res["D1"]["library_ms"], nbytes=res["D1"]["nbytes"]))

    rec = res["D2"]
    kw = dict(pc=exp_binner_proto.PC, n_tiles=exp_binner_proto.NT,
              grid_x=exp_binner_proto.GRID_X,
              tile_cap=exp_binner_proto.TILE_CAP)
    inp = list(rec["inputs"].values())
    equal = bool(torch.equal(binner_proto.expand_rank(*inp, **kw),
                             binner_proto.expand_rank_plain(*inp, **kw)))
    log(f"kernel expand_rank vs plain: equal {equal}")
    if not equal:
        raise AssertionError("expand_rank disagrees with plain")
    out.append(dev_entry(
        "D2", "expand_rank", "binner_proto.cu",
        "scripts/exp_pallas_binner_proto.py:78",
        "scripts/exp_pallas_binner_proto.py:29 (kernel)",
        launches["expand_rank"], 0.0, rec, pairs=rec["pairs"],
        pairs_per_s=rec["pairs_per_s"], pairs_past_pc=rec["pairs_past_pc"],
        pairs_past_tile_cap=rec["pairs_past_tile_cap"],
        passes_ms=rec["passes_ms"], device_ms=rec["device_ms"]))

    cases = {}
    for case, rec in res["D3"].items():
        i = rec["inputs"]
        a = scatter.scatter_add_rows(i["idx"], i["rows"], n_out=i["n_out"])
        b = scatter.scatter_add_rows_plain(i["idx"], i["rows"],
                                           n_out=i["n_out"])
        err = scatter_rel_err(a, b)
        log(f"kernel scatter_add_rows ({case}, {rec['shape']}) vs plain: max "
            f"|a-b| / max |b| {err:.3g} (tol {SCATTER_TOL:g})")
        if not err <= SCATTER_TOL:
            raise AssertionError(f"scatter_add_rows ({case}) disagrees: "
                                 f"{err}")
        cases[case] = {k: v for k, v in rec.items() if k != "inputs"}
        cases[case].update(max_rel_err=err,
                           max_abs_err=float((a - b).abs().max()))
    main3 = cases["hexplane"]
    out.append(dev_entry(
        "D3", "scatter_add_rows", "scatter.cu",
        "scripts/exp_pallas_scatter.py:66",
        "scripts/exp_pallas_scatter.py:48 (make_scatter_add's kernel)",
        launches["scatter_add_rows"],
        max(c["max_abs_err"] for c in cases.values()), main3,
        library_ms=main3["library_ms"], cases=cases))

    i = res["D4"]["inputs"]
    store = serial.scalar_store(i["idx"], i["val"], n_out=exp_serial.TABLE)
    kw = dict(n_tiles=exp_serial.NT, tile_cap=exp_serial.TILE_CAP,
              n_out=exp_serial.TABLE)
    counter = serial.tile_counter_store(i["tid"], i["val"], **kw)
    equal = {"scalar_store": bool(torch.equal(store, serial.scalar_store_plain(
        i["idx"], i["val"], n_out=exp_serial.TABLE))),
        "tile_counter_store": all(
            torch.equal(a, b) for a, b in zip(
                counter, serial.tile_counter_store_plain(i["tid"], i["val"],
                                                         **kw)))}
    log(f"kernels scalar_store, tile_counter_store vs plain ("
        f"{res['D4']['repeats']} repeated indices): equal {equal}")
    if not all(equal.values()):
        raise AssertionError(f"serial stores disagree with plain: {equal}")
    calls = {"D4a": lambda: serial.scalar_store(i["idx"], i["val"],
                                                n_out=exp_serial.TABLE),
             "D4b": lambda: serial.tile_counter_store(i["tid"], i["val"],
                                                      **kw)}
    for kid, name, line, body in (("D4a", "scalar_store", 70, "store_kernel"
                                   " :31"),
                                  ("D4b", "tile_counter_store", 77,
                                   "counter_kernel :43")):
        rec = res["D4"]["store" if kid == "D4a" else "counter"]
        out.append(dev_entry(
            kid, name, "serial.cu", f"scripts/exp_pallas_serial.py:{line}",
            f"scripts/exp_pallas_serial.py:{body}", launches[name], 0.0,
            rec, pairs_per_s=rec["pairs_per_s"], passes_ms=rec["passes_ms"],
            **device_share(calls[kid], rec),
            library_note="no single PyTorch call: indexed assignment leaves "
                         "the winner among repeated indices undefined"))

    rec = res["D5"]
    i = rec["inputs"]
    args = (i["gidx"], i["counts"], i["table"], i["cfg"])
    got, ref = blend.blend_forward(*args), blend.blend_forward_plain(*args)
    err = {k: float((a - b).abs().max())
           for k, a, b in zip(("color", "depth", "t"), got, ref)}
    log("kernel blend_fwd (tile 16) vs plain: max abs err " + ", ".join(
        f"{k} {v:.3g} (tol {TOL[k]:g})" for k, v in err.items()))
    if not all(v <= TOL[k] for k, v in err.items()):
        raise AssertionError(f"blend_fwd (tile 16) disagrees: {err}")
    cfg = i["cfg"]
    work = blend_work(*args)
    n_rows = int(torch.unique(i["gidx"][i["gidx"] >= 0]).numel())
    nbytes = (4 * cfg.num_tiles + 4 * int(i["counts"].sum()) + 48 * n_rows
              + 5 * 4 * cfg.num_tiles * cfg.pixels_per_tile)
    rec5 = {**rec, **bound(nbytes, sum(BLEND_FP32_INSTR[k] * work[k]
                                       for k in BLEND_FP32_INSTR),
                           work["exp"])}
    log(f"blend_fwd (tile 16): {rec['ms']:.4f} ms, bound "
        f"{rec5['bound_ms']:.4f} ms ({rec5['bound_resource']}); "
        f"evaluations {work}")
    out.append(dev_entry(
        "D5", "blend_fwd (tile 16)", "blend_fwd.cu",
        "scripts/profile_pallas_split.py:83",
        "scripts/profile_pallas_split.py:83 (_raw_fwd around K1's "
        "_fwd_kernel)", launches["blend_forward"], err["color"], rec5,
        max_abs_err_depth=err["depth"], max_abs_err_t=err["t"],
        pack_ms=rec["pack_ms"], pack_and_blend_ms=rec["pack_and_blend_ms"],
        evaluations=work))

    i = res["D6"]["inputs"]
    for fn, line in zip(bodies, (66, 77, 91, 108)):
        name = fn.__name__
        a, b = fn(i["attrs"], i["px"]), getattr(
            blend_variants, name + "_plain")(i["attrs"], i["px"])
        err = scatter_rel_err(a, b)
        log(f"kernel {name} vs plain: max |a-b| / max |b| {err:.3g} (tol "
            f"{DEV_TOL:g})")
        if not err <= DEV_TOL:
            raise AssertionError(f"{name} disagrees with plain: {err}")
        rec = res["D6"][name]
        out.append(dev_entry(
            "D6", f"blend_variants.{name}", "blend_variants.cu",
            "scripts/profile_kernel_variants.py:50",
            f"scripts/profile_kernel_variants.py:{line} (k_{name})",
            launches[name], float((a - b).abs().max()), rec,
            max_rel_err=err, clocks=rec.get("clocks"),
            sass_loop=res["D6"].get("sass_loop", {}).get(name),
            **device_share(lambda: fn(i["attrs"], i["px"]), rec)))
    for e in out:
        log(f"{e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
            f"library {e['library_ms']}, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_resource']}); launches {e['launches']}" + (
                f"; device {e['device_ms']:.4f} ms (held stream "
                f"{e['held_stream_ms']:.4f} ms), bound share "
                f"{e['bound_share_events']:.1%} by events, "
                f"{e['bound_share_device']:.1%} on the device"
                if "bound_share_device" in e else ""))
    return out


# ---------------------------------------------------------------------------
# phase 20 (after phase 15): the test evaluation as captured programs, and
# the preparation, point and report tools
# ---------------------------------------------------------------------------

EVAL_PROBE_VIEWS = 5           # tools/train.py on_test's train probe views
EVAL_RUNS = ("eager", "captured", "captured again", "eager again")
TOOL_BUDGET = 40_000           # downsample_point's default
# the evaluation programs' memory, measured also at the capacity every
# config of the repo caps a run at (RasterParams.capacity) with the
# largest deformation of its configs (HyperNeRF banana: time resolution
# 250, multires [1, 2, 4], net_width 128)
EVAL_MEMORY_CAPACITY = 400_000
EVAL_MEMORY_CONFIG = "hypernerf/banana.py"


def run_tool(name: str, argv: list, **kw) -> dict:
    """A tool of fourdgs_tpu_torch/tools through its `main`, in this
    process: its printed lines (echoed here), its seconds and what it
    returns."""
    import importlib
    mod = importlib.import_module(f"fourdgs_tpu_torch.tools.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(argv, **kw)
    seconds = time.perf_counter() - t0
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"tools {name}: {line}")
    return {"seconds": seconds, "printed": printed, "returned": ret}


def same_colmap_records(a, b) -> bool:
    """Two read_model results hold equal cameras, images and points."""
    def rec_equal(x, y):
        return all(np.array_equal(np.asarray(u), np.asarray(v))
                   for u, v in zip(x, y, strict=True))
    return all(sorted(p) == sorted(q) and all(rec_equal(p[k], q[k])
                                              for k in p)
               for p, q in zip(a, b, strict=True))


def layout_tools(torch, kind: str, scene: Path, work: Path) -> dict:
    """Phase 20(b)'s tools that read a layout's files, run inside the
    layout's phase while its scene exists (a checkout whose path has a
    dot keeps a DyNeRF scene in a temporary directory): poses2colmap on
    the nerfies capture (phase 11), preprocess_dynerf on the DyNeRF layout
    (phase 12: its frames exist; then a video without frames, in a
    subprocess with OpenCV hidden, must exit nonzero with the named
    ImportError) and colmap_converter from .bin to .txt and back on the
    COLMAP model (phase 15), the records equal."""
    import importlib.util

    from fourdgs_tpu_torch.data import colmap

    if kind not in ("nerfies", "dynerf", "colmap"):
        return {}
    out, checks = {}, {}
    if kind == "nerfies":
        shutil.rmtree(scene / "sparse_", ignore_errors=True)
        shutil.rmtree(scene / "image_colmap", ignore_errors=True)
        out["poses2colmap"] = run_tool("poses2colmap", [str(scene)])
        cams = colmap.read_cameras_text(str(scene / "sparse_" /
                                            "cameras.txt"))
        images = colmap.read_images_text(str(scene / "sparse_" /
                                             "images.txt"))
        n = len(os.listdir(scene / "camera")) // 2
        checks["poses2colmap (nerfies)"] = (
            len(cams) == len(images) == n
            and len(os.listdir(scene / "image_colmap")) == n
            and out["poses2colmap"]["printed"].startswith(f"wrote {n} "))
    elif kind == "dynerf":
        rec = run_tool("preprocess_dynerf", ["--datadir", str(scene)])
        lines = rec["printed"].splitlines()
        checks["preprocess_dynerf lists the frames"] = (
            len(lines) == DYNERF_CAMS and all(
                line.endswith(f"({DYNERF_FRAMES} frames)") for line in lines))
        # a video without frames, on a machine without OpenCV: where this
        # machine has it, a `cv2` package that raises ImportError comes
        # first on the subprocess's path
        missing = scene / "no_frames"
        hidden = missing / "no_opencv" / "cv2"
        hidden.mkdir(parents=True, exist_ok=True)
        (hidden / "__init__.py").write_text(
            "raise ImportError('OpenCV hidden')\n")
        (missing / "cam00.mp4").write_bytes(b"")
        r = subprocess.run(
            [sys.executable, "-m", "fourdgs_tpu_torch.tools.preprocess_dynerf",
             "--datadir", str(missing)], cwd=ROOT, capture_output=True,
            text=True, timeout=300, env=dict(
                os.environ, PYTHONPATH=os.pathsep.join(
                    [str(hidden.parent), str(ROOT)])))
        opencv = importlib.util.find_spec("cv2") is not None
        rec["no_frames"] = {"returncode": r.returncode,
                            "opencv_installed": opencv,
                            "error": r.stderr.strip().splitlines()[-1:]}
        log(f"tools preprocess_dynerf: a video without frames, OpenCV "
            f"hidden (this machine {'has' if opencv else 'has no'} OpenCV):"
            f" exit {r.returncode}, {rec['no_frames']['error']}")
        checks["preprocess_dynerf refuses a video without frames"] = (
            r.returncode != 0 and "ImportError" in r.stderr
            and "cam00.mp4" in r.stderr and "OpenCV" in r.stderr
            and not (missing / "cam00").exists())
        shutil.rmtree(missing)
        out["preprocess_dynerf"] = rec
    elif kind == "colmap":
        src = scene / "sparse" / "0"
        txt, back = work / "colmap_tool_txt", work / "colmap_tool_bin"
        for d in (txt, back):
            shutil.rmtree(d, ignore_errors=True)
        rec = run_tool("colmap_converter", [
            "--input_model", str(src), "--input_format", ".bin",
            "--output_model", str(txt), "--output_format", ".txt"])
        rec["back"] = run_tool("colmap_converter", [
            "--input_model", str(txt), "--output_model", str(back),
            "--output_format", ".bin"])
        checks["colmap_converter .bin -> .txt -> .bin keeps the records"] = (
            same_colmap_records(colmap.read_model(str(src), ".bin"),
                                colmap.read_model(str(back), ".bin"))
            and same_colmap_records(colmap.read_model(str(src), ".bin"),
                                    colmap.read_model(str(txt), ".txt"))
            and rec["printed"] == rec["back"]["printed"])
        out["colmap_converter"] = rec
    failed = [k for k, ok in checks.items() if not ok]
    log(f"{kind} tools: {len(checks) - len(failed)}/{len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"{kind} tools: {failed}")
    return {k: {"seconds": v["seconds"], **({"no_frames": v["no_frames"]}
                                            if "no_frames" in v else {})}
            for k, v in out.items()}


def evaluation(torch, state, scene, bg, sh, rc, programs):
    """One test evaluation as the train CLI's (tools/train.py on_test):
    the state loaded into `programs` (None: eager), every test view and
    EVAL_PROBE_VIEWS train views through `eval_output` (its cap growth,
    one drop read a render) and their PSNR read at the end. Returns the
    seconds, the PSNRs and each view's output and drops."""
    from fourdgs_tpu_torch.ops import losses
    from fourdgs_tpu_torch.tools import train as train_cli

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if programs is not None:
        programs.load(state, bg)
    psnrs, outs = [], []
    for split, n in ((scene.test, len(scene.test)),
                     (scene.train, EVAL_PROBE_VIEWS)):
        for i in range(min(n, len(split))):
            out, drops = train_cli.eval_output(
                state, split.cameras[i], bg, "fine", sh, rc,
                programs=programs)
            psnrs.append(losses.psnr(torch.clamp(out.color, 0, 1),
                                     split.images[[i]][0])[0])
            outs.append((out, drops))
    psnrs = torch.stack(psnrs).cpu().tolist()
    return time.perf_counter() - t0, psnrs, outs


def eval_programs_memory(torch, state, cams, bg, sh, rc) -> dict:
    """The device memory an EvalPrograms holds after one evaluation of
    `cams` at `rc`: its copies of `state` (the allocation `load` adds)
    and all it holds (what torch reserves more, the frames' graph pools
    with the copies), from the allocator's counts before it was made,
    after the evaluation and after it was freed, in MiB."""
    import gc

    from fourdgs_tpu_torch.train import graphs

    def counts():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return (torch.cuda.memory_allocated() / 2**20,
                torch.cuda.memory_reserved() / 2**20)

    a0, r0 = counts()
    programs = graphs.EvalPrograms()
    programs.load(state, bg)
    a1, _ = counts()
    for cam in cams:
        programs.render(cam, stage="fine", active_sh=sh, raster_cfg=rc)
    _, r2 = counts()
    frames = len(programs.renderer.frames)
    del programs
    _, r3 = counts()
    return {"capacity": int(state.alive.shape[0]), "copies_mib": a1 - a0,
            "held_mib": r2 - r0, "pools_mib": (r2 - r0) - (a1 - a0),
            "frames": frames, "freed_mib": r2 - r3,
            "copies_bytes_per_slot": (a1 - a0) * 2**20
            / int(state.alive.shape[0])}


def largest_eval_memory(torch, state, cams, bg, sh, rc,
                        capacity: int) -> dict:
    """`eval_programs_memory` of `state`'s gaussians in `capacity` slots
    (the rest dead) with EVAL_MEMORY_CONFIG's deformation, random from a
    seed, and that deformation's MiB of parameters."""
    from types import SimpleNamespace

    from fourdgs_tpu_torch.models.deformation import Deformation
    from fourdgs_tpu_torch.train import config as config_mod

    cfg = config_mod.apply_config_file(
        config_mod.Config(),
        str(CONFIG_DIR / EVAL_MEMORY_CONFIG))
    deform = Deformation(config_mod.deform_config_from(cfg),
                         generator=torch.Generator().manual_seed(5))
    gauss, alive = padded(torch, state.params["gauss"], state.alive,
                          capacity)
    big = SimpleNamespace(params={"gauss": gauss, "deform": deform.to(
        state.alive.device).eval()}, alive=alive, aabb=state.aabb)
    out = eval_programs_memory(torch, big, cams, bg, sh, rc)
    out["deform_mib"] = sum(p.numel() * p.element_size()
                            for p in deform.parameters()) / 2**20
    out["config"] = EVAL_MEMORY_CONFIG
    return out


def phase_eval_programs(torch, device, work: Path, driver: dict):
    """Phase 20(a): on phase 7's final state (its snapshot in the run's
    capacity, the run's final raster config and SH degree) and its test
    views, an evaluation as the train CLI makes it, eagerly, through the
    evaluation programs twice (graphs.EvalPrograms: the second captures
    nothing) and eagerly again, each timed; every view's replay equal to
    the eager render bit for bit; the first test view's replay against the
    frame through the plain blend, binner and gather (TOL, counters
    equal), and K1, the binner and D1 against their plain versions at that
    view's shapes (phase 4's checks); the kernels' runs counted over the
    two captured evaluations. Returns the runs and what it measured."""
    from types import SimpleNamespace

    from fourdgs_tpu_torch.data.scene import Scene
    from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig
    from fourdgs_tpu_torch.render.serve import Renderer
    from fourdgs_tpu_torch.tools.bench import card_limit
    from fourdgs_tpu_torch.train import checkpoint, graphs, loop

    t_phase = time.perf_counter()
    name = card_limit(device)
    cfg, gauss, alive, deform, aabb, it = checkpoint.load_model(
        str(work / "driver"), -1, device)
    gauss, alive = padded(torch, gauss, alive, driver["capacity"])
    state = SimpleNamespace(params={"gauss": gauss, "deform": deform},
                            alive=alive, aabb=aabb)
    rc = RasterConfig(**driver["raster_cfg"])
    sh = driver["stages"]["fine"]["active_sh"]
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=device)
    scene = Scene.load(str(work / "scene"), device=device,
                       white_background=cfg.model.white_background,
                       eval_split=cfg.model.eval,
                       resolution=(DRIVER_SIZE, DRIVER_SIZE))
    programs = graphs.EvalPrograms()
    runs, seconds, psnrs, outs, captures = {}, {}, {}, {}, {}
    replays = {}
    for mode in EVAL_RUNS:
        captured = mode.startswith("captured")
        before = len(programs.captures)
        if mode == "captured":
            torch.cuda.synchronize()
            graphs.zero_counts()
        seconds[mode], psnrs[mode], outs[mode] = evaluation(
            torch, state, scene, bg, sh, rc, programs if captured else None)
        if mode == "captured again":
            torch.cuda.synchronize()
            ran = kernel_runs()
            runs = {k: ran[k] for k in ("blend_fwd", "binner",
                                        "gather_rows")}
        replays[mode] = programs.replays
        new = programs.captures[before:]
        captures[mode] = {"captures": len(new),
                          "capture_s": sum(c["seconds"] for c in new)}
    rep = programs.report()
    views = len(outs["eager"])
    equal = all(
        d == de and all(torch.equal(getattr(o, f), getattr(oe, f))
                        for f in ("color", "depth", "alpha", "num_pairs",
                                  "dropped_pairs", "dropped_tile"))
        for mode in ("captured", "captured again")
        for (o, d), (oe, de) in zip(outs[mode], outs["eager"], strict=True))
    renders = rep["replays"]
    gathers = HEX_GATHERS_PER_LEVEL * len(cfg.hidden.multires)
    warm = graphs.WARMUP * captures["captured"]["captures"]
    want = {"blend_fwd": renders + warm, "binner": renders + warm,
            "gather_rows": gathers * (renders + warm)}
    mean_test = float(np.mean(psnrs["captured"][:len(scene.test)]))
    in_loop = driver["stages"]["fine"]["test_psnr"][-1][1]
    for mode in EVAL_RUNS:
        c = captures[mode]
        log(f"eval programs: evaluation {mode}: {seconds[mode]:.4f} s "
            f"({views} views: {len(scene.test)} test, "
            f"{views - len(scene.test)} train probe), {c['captures']} "
            f"captures in "
            f"{c['capture_s']:.3f} s; {name}")
    ev = driver["eval_programs"]
    log(f"eval programs: phase 7's train CLI: {len(ev['captures'])} "
        f"captures ({sum(c['seconds'] for c in ev['captures']):.3f} s), "
        f"{ev['loads']} loads, {ev['replays']} replays; its evaluations "
        + ", ".join(f"{s} {e['iter']}: {e['seconds']:.3f} s ({e['captures']}"
                    f" captures, {e['capture_s']:.3f} s)"
                    for s, es in driver["evals"].items() for e in es)
        + f"; {name}")
    log(f"eval programs: {rep['loads']} loads, {renders} replays, "
        f"captures {[c['key'] for c in rep['captures']]}; kernel runs over "
        f"the two captured evaluations {runs} (want {want}); every view's "
        f"replay equal to the eager render bit for bit: {equal}; mean test "
        f"PSNR {mean_test:.4f} dB against phase 7's last in-loop eval "
        f"{in_loop:.4f}")

    # ---- the first test view: the replay against the plain frame, and
    # the kernels against their plain versions at its shapes ----
    first, drops = outs["captured"][0]
    rc0 = dataclasses.replace(rc, tile_cap=drops["tile_cap"],
                              bin_pairs_per_chunk=drops[
                                  "bin_pairs_per_chunk"])
    cam0 = scene.test.cameras[0]
    with plain_path():
        ref = loop.eval_step(state, cam0, bg, stage="fine", active_sh=sh,
                             raster_cfg=rc0)
    plain = {k: float((getattr(first, k) - getattr(ref, k)).abs().max())
             for k in ("color", "depth")}
    counters = {k: (int(getattr(first, k)), int(getattr(ref, k)))
                for k in ("num_pairs", "dropped_pairs", "dropped_tile")}
    log(f"eval programs: test view 0's replay against the plain blend, "
        f"binner and gather: max abs err " + ", ".join(
            f"{k} {v:.3g} (tol {TOL[k]:g})" for k, v in plain.items())
        + f"; counters (replay, plain) {counters}")
    renderer = Renderer(gauss=gauss, alive=alive, deform=deform, aabb=aabb,
                        bg=bg, raster_cfg=rc0, sh_degree=sh, device=device)
    k1, checks = phase_kernels(torch, renderer, cam0, "eval_programs")
    checks["blend_fwd"] = {k: k1[k] for k in (
        "max_abs_err", "max_abs_err_depth", "max_abs_err_t", "ms",
        "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by")}
    ok = {
        "the second evaluation captured nothing":
            captures["captured"]["captures"] >= 1
            and captures["captured again"]["captures"] == 0,
        "every render a replay": replays["captured"] >= views
        and renders == 2 * replays["captured"] and rep["loads"] == 2,
        "every view equal to the eager render": equal,
        "the PSNRs equal the eager ones": psnrs["captured"]
        == psnrs["eager"] == psnrs["captured again"],
        "the kernels ran every render": runs == want,
        "the replay matches the plain frame": all(
            v <= TOL[k] for k, v in plain.items())
        and all(a == b for a, b in counters.values()),
        "the PSNR matches phase 7's eval":
            abs(mean_test - in_loop) <= RENDER_PSNR_TOL,
        "phase 7's evaluations replayed": len(ev["captures"]) >= 1
            and ev["replays"] > 0 and ev["loads"] == sum(
                len(es) for es in driver["evals"].values()),
    }
    failed = [k for k, v in ok.items() if not v]
    log(f"eval programs checks: {len(ok) - len(failed)}/{len(ok)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"eval programs phase: {failed}")
    # ---- the memory the programs hold: at phase 7's capacity, and at
    # EVAL_MEMORY_CAPACITY slots with EVAL_MEMORY_CONFIG's deformation ----
    cams = [scene.test.cameras[i] for i in range(len(scene.test))]
    memory = {"run": eval_programs_memory(torch, state, cams, bg, sh, rc),
              "largest": largest_eval_memory(torch, state, cams, bg, sh, rc,
                                             EVAL_MEMORY_CAPACITY)}
    for k, m in memory.items():
        log(f"eval programs memory ({k}: {m['capacity']} slots"
            + (f", {EVAL_MEMORY_CONFIG}'s deformation "
               f"{m['deform_mib']:.2f} MiB" if k == "largest" else "")
            + f"): the state's copies {m['copies_mib']:.2f} MiB "
            f"({m['copies_bytes_per_slot']:.1f} bytes a slot), held in "
            f"all {m['held_mib']:.2f} MiB with {m['frames']} frame(s) "
            f"(pools {m['pools_mib']:.2f} MiB), freed with the programs "
            f"{m['freed_mib']:.2f} MiB; {name}")
    del scene, programs, renderer, state
    out = {"seconds": time.perf_counter() - t_phase, "card": name,
           "memory": memory,
           "evaluation_s": seconds, "captures": captures,
           "programs": rep, "views": views, "runs": runs,
           "plain_frame": {"max_abs_err": plain, "counters": counters},
           "checks": checks, "train_cli": {"programs": ev,
                                           "evals": driver["evals"]}}
    log(f"eval programs: phase {out['seconds']:.2f} s; {name}")
    return runs, out


def phase_prep_tools(torch, device, work: Path, layouts: dict) -> dict:
    """Phase 20(b): the tools that port the JAX package's preparation,
    point and report scripts, on files that earlier phases wrote, each
    through its `main`: poses2colmap on phase 7's Blender scene (the
    nerfies capture's, preprocess_dynerf's and colmap_converter's runs
    came with phases 11, 12 and 15: `layout_tools`); downsample_point on
    phase 18's million points (written as a PLY) down to 40,000;
    grow_point on the card on that result and on the million points
    (the k-NN and the draw timed); merge_point on the two grown clouds;
    cal_modelsize, visualize_hexplane (its PNGs read back through
    data/png.py) and diag_checkpoint on phase 7's model and checkpoint.
    A tool that fails fails the phase."""
    from fourdgs_tpu_torch.data import colmap, ply
    from fourdgs_tpu_torch.data.png import read_png
    from fourdgs_tpu_torch.tools.bench import card_limit
    from fourdgs_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    name = card_limit(device)
    out_dir = work / "tools_prep"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    model = work / "driver"
    rec, checks = {}, {}

    r = rec["poses2colmap"] = run_tool("poses2colmap", [
        str(work / "scene" / "transforms_train.json"),
        str(out_dir / "blender_sparse"), "--width", str(DRIVER_SIZE),
        "--height", str(DRIVER_SIZE)])
    images = colmap.read_images_text(str(out_dir / "blender_sparse" /
                                         "images.txt"))
    checks["poses2colmap (blender)"] = (
        len(images) == DRIVER_VIEWS[0]
        and r["printed"].startswith(f"wrote {DRIVER_VIEWS[0]} poses"))

    xyz, rgb, _ = colmap.read_points3d_binary(str(work / "host" /
                                                  "points3D.bin"))
    dense = out_dir / "million.ply"
    ply.store_point_cloud(str(dense), xyz.astype(np.float32),
                          rgb.astype(np.float32))
    down = out_dir / "down.ply"
    r = rec["downsample_point"] = run_tool("downsample_point",
                                           [str(dense), str(down)])
    n_down = len(ply.fetch_point_cloud(str(down))[0])
    checks["downsample_point to the budget"] = (
        TOOL_BUDGET * 0.5 < n_down <= TOOL_BUDGET
        and r["printed"] == f"{len(xyz)} -> {n_down} points\n")

    grown = {}
    for label, src in (("40k", down), ("million", dense)):
        dst = out_dir / f"grown_{label}.ply"
        r = rec[f"grow_point {label}"] = run_tool(
            "grow_point", [str(src), str(dst), "--device", device.type])
        got = r["returned"]
        n = len(ply.fetch_point_cloud(str(dst))[0])
        grown[label] = (dst, n)
        log(f"tools grow_point {label}: {got['points']} points, "
            f"{got['grown']} grown, the k-NN and the draw "
            f"{got['seconds']:.3f} s on {got['device']}; {name}")
        checks[f"grow_point {label}"] = (
            got["device"].startswith("cuda") and n == got["points"]
            + got["grown"] and 0 < got["grown"] < got["points"])
    r = rec["merge_point"] = run_tool("merge_point", [
        str(grown["40k"][0]), str(grown["million"][0]), "-o",
        str(out_dir / "merged.ply")])
    n_merged = len(ply.fetch_point_cloud(str(out_dir / "merged.ply"))[0])
    checks["merge_point"] = (n_merged == grown["40k"][1]
                             + grown["million"][1])

    snap, it = checkpoint.find_latest_snapshot(str(model))
    size = sum(os.path.getsize(os.path.join(snap, f))
               for f in ("point_cloud.ply", "deformation.npz"))
    r = rec["cal_modelsize"] = run_tool("cal_modelsize", [str(model)])
    checks["cal_modelsize"] = r["returned"] == [size / 1e6]

    vis = out_dir / "hexplane"
    r = rec["visualize_hexplane"] = run_tool(
        "visualize_hexplane", ["-m", str(model), "--out", str(vis)])
    _, flat, _ = checkpoint.load_snapshot(snap)
    planes = {k.split("/")[-1]: v.shape[:-1] for k, v in flat.items()
              if k.startswith("grid/")}
    pngs = {p.name.rsplit("_", 1)[0]: read_png(str(p))
            for p in vis.iterdir()}
    checks["visualize_hexplane"] = (
        sorted(pngs) == sorted(planes) and all(
            img.shape == planes[k] and img.dtype == np.uint8
            and img.min() == 0 and img.max() in (0, 255)
            for k, img in pngs.items()))

    ckpts = sorted(model.glob("chkpnt_fine_*.npz"))
    r = rec["diag_checkpoint"] = run_tool(
        "diag_checkpoint", [str(ckpts[-1]), "--device", device.type])
    with np.load(ckpts[-1]) as z:
        n_alive = int(z["alive"].sum())
        cap = z["alive"].shape[0]
    lines = r["printed"].splitlines()
    checks["diag_checkpoint"] = (
        lines[-1] == f"alive: {n_alive} / {cap}"
        and sum(" alive-stats: " in line for line in lines) == 4)

    failed = [k for k, ok in checks.items() if not ok]
    seconds = {k: v["seconds"] for k, v in rec.items()}
    for kind in ("nerfies", "dynerf", "colmap"):
        for tool, v in layouts[kind]["tools"].items():
            seconds[f"{tool} ({kind})"] = v["seconds"]
    out = {"seconds": time.perf_counter() - t_phase, "card": name,
           "tool_seconds": seconds, "grow_point": {
               k: rec[f"grow_point {k}"]["returned"] for k in grown},
           "downsampled": n_down}
    log(f"prep tools: seconds {json.dumps(seconds)}; {name}")
    log(f"prep tools checks: {len(checks) - len(failed)}/{len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"prep tools phase: {failed}")
    log(f"prep tools: phase {out['seconds']:.2f} s; {name}")
    return out


def path_entries(serve: dict, step: dict, serve_runs: dict,
                 step_runs: dict, eval_runs: dict, layout_runs: dict,
                 layouts: dict) -> list:
    """The kernels-line entries of the binner kernel and of D1 as the
    HexPlane's forward gather: their runs on the serve and step paths
    (phases 3 and 5), the render CLI's (phase 10) and the layouts'
    (phases 11-12), and the checks on phase 4's frame and phase 6's step
    input, the step's at the top level (the layouts' under their
    names)."""
    out = []
    for name, source, replaces, tpu_kernel in (
            ("binner", "binner.cu", "scripts/exp_pallas_binner_proto.py:78",
             "scripts/exp_pallas_binner_proto.py:29 (kernel), at "
             "fourdgs_tpu/ops/rasterize_tiled.py:178 bin_gaussians_count's "
             "contract"),
            ("gather_rows", "gather.cu", "scripts/exp_pallas_gather.py:50",
             "scripts/exp_pallas_gather.py:50, :75, :102, :125 (gather1-4), "
             "as fourdgs_tpu/models/hexplane.py:71 _gather_rows")):
        top = step[name]
        out.append({
            "name": f"{name} (main path)", "route": "cuda",
            "source": f"fourdgs_tpu_torch/csrc/{source}",
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": serve_runs[name] + step_runs[name],
            "launches_serve": serve_runs[name],
            "launches_step": step_runs[name],
            "launches_eval": eval_runs[name],
            **{f"launches_{kind}": runs[name]
               for kind, runs in layout_runs.items()},
            **{kind: {"step_gathers" if name == "gather_rows" else "frame":
                      rec["gather_rows"] if name == "gather_rows"
                      else rec["binner_frame"]}
               for kind, rec in layouts.items()},
            "max_abs_err": 0.0,
            "ms": top["ms"], "device_ms": top["device_ms"],
            "host_ms": top["host_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "bound_resource": "hbm bytes",
            "library_ms": top.get("library_ms"),
            "step": step[name], "serve": serve[name], "ok": True})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--coarse", type=int, default=300,
                        help="coarse iterations of the driver phase")
    parser.add_argument("--fine", type=int, default=1200,
                        help="fine iterations of the driver phase (the SH "
                        "ramp needs 1000)")
    args = parser.parse_args(argv)
    if args.steps <= UNTIMED_STEPS + 5:
        parser.error(f"--steps must exceed {UNTIMED_STEPS + 5}")

    import torch
    phase_device(torch)
    from fourdgs_tpu_torch.train import graphs
    # Full float32 everywhere: the deformation MLP heads must not run in
    # TF32 (three decimal digits) for parity with the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    phase_build()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    phase_host(work / "host", args.seed)
    t0 = time.perf_counter()
    scene = make_scene(torch, args.seed, device)
    log(f"scene: {N_GAUSS} gaussians, seed {args.seed}, "
        f"{time.perf_counter() - t0:.2f} s")
    renderer, cams, launches, renders, serve = phase_slice(
        torch, scene, device, args.frames, work)
    bench = phase_bench_fps(torch, serve)
    cam = cams[round(KERNEL_CHECK_FRAME * args.frames)]
    k1, serve_checks = phase_kernels(torch, renderer, cam)
    k1["launches"] = launches["blend_fwd"]
    k1["launches_per_frame"] = launches["blend_fwd"] / renders
    k1["serve"] = serve
    k1["bench_fps"] = {k: bench[k] for k in ("replays", "line",
                                             "replay_profile", "capture_s",
                                             "plain_frame", "seconds")}
    state, rc, bg, sh, check_cam, gt, train_launches, train = phase_train(
        torch, scene, renderer, device, args.steps, args.seed)
    k1["launches_train"] = train_launches["blend_fwd"]
    k2, step_args, work_k2, step_checks = phase_kernels_bwd(
        torch, state, rc, bg, sh, check_cam, gt)
    k2["launches"] = train_launches["blend_bwd"]
    k2["launches_per_step"] = train_launches["blend_bwd"] / (
        2 * args.steps + graphs.WARMUP)
    k2["train"] = train
    driver_launches, driver = phase_driver(torch, device, work, args.coarse,
                                           args.fine, args.seed)
    k1["launches_driver"] = driver_launches["blend_fwd"]
    eval_launches, evaluation = phase_eval(
        torch, device, work, args.fine,
        driver["stages"]["fine"]["test_psnr"][-1][1])
    k1["launches_eval"] = eval_launches["blend_fwd"]
    k1["eval"] = evaluation
    prewarm_runs, prewarm = phase_prewarm(torch, device, work, args.coarse,
                                          args.fine, args.seed)
    standalone_runs, standalone = phase_standalone(torch, work, args.seed)
    layouts, layout_runs = {}, {}
    for kind in LAYOUTS:
        layout_runs[kind], layouts[kind] = phase_layout(torch, device, work,
                                                        kind, args.seed)
        for entry, kernel in ((k1, "blend_fwd"), (k2, "blend_bwd")):
            entry[f"launches_{kind}"] = layout_runs[kind][kernel]
        k1[kind] = layouts[kind]
    eval_program_runs, evals = phase_eval_programs(torch, device, work,
                                                   driver)
    k1["launches_eval_programs"] = eval_program_runs["blend_fwd"]
    k1["eval_programs"] = evals
    k1["prep_tools"] = phase_prep_tools(torch, device, work, layouts)
    k1["tools"] = phase_tools(
        torch, device, work, renderer, args.seed,
        driver["stages"]["fine"]["ms_per_iteration"])
    mesh = phase_mesh(torch, device, work, scene, args.seed, args.coarse,
                      args.fine, driver["stages"]["fine"]["ms_per_iteration"])
    kernels = [k1, k2] + phase_kernels_slots(
        torch, step_args, work_k2, state, rc, bg, sh, check_cam, gt,
        driver_launches, k2)
    kernels[2]["driver"] = driver
    kernels += path_entries(serve_checks, step_checks, launches,
                            train_launches, eval_launches, layout_runs,
                            layouts)
    kernels += phase_dev_kernels(torch, device, args.seed)
    # phase 17: the band offset's check and times (K1, K2, K3, the
    # binner) and the runs at a nonzero offset on the mesh's paths
    band = mesh["band_kernels"]
    for k in kernels:
        name = k["name"].split(" (main path)")[0]
        if name in band:
            k["band_offset"] = {**band[name], "tile0": band["tile0"],
                                "tiles": band["tiles"]}
        if name in MESH_PATH:
            k["launches_mesh_offset"] = mesh["offset_runs"][name]
        if name in bench["runs"]:
            k["launches_bench_fps"] = bench["runs"][name]
            k.setdefault("bench_fps", {})["frame"] = bench["checks"][name]
        if name in eval_program_runs:
            k["launches_eval_programs"] = eval_program_runs[name]
            k.setdefault("eval_programs", {})["frame"] = \
                evals["checks"][name]
    # phase 21: the runs of phase 7's path with the prewarmer on and off
    for k in kernels:
        name = k["name"].split(" (main path)")[0]
        if name in PREWARM_PATH:
            k["launches_prewarm"] = prewarm_runs[name]
    # phase 22: the runs of the guarded train -> render -> metrics run
    for k in kernels:
        name = k["name"].split(" (main path)")[0]
        if name in PATH_KERNELS:
            k["launches_standalone"] = standalone_runs[name]
    k1["prewarm"] = prewarm
    k1["standalone"] = standalone
    k1["mesh"] = {key: mesh[key] for key in ("nccl", "two_ranks", "eval",
                                             "cli", "cli_nccl", "scaling",
                                             "seconds", "seconds_abcde")}
    for k in kernels:
        if k["launches"] == 0 or any(k.get(f"launches_{path}", 1) == 0
                                     for path in ("serve", "step", "eval",
                                                  "bench_fps",
                                                  "eval_programs", "prewarm",
                                                  "standalone", *LAYOUTS)):
            raise AssertionError(f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
