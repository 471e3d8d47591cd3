"""Scene facade: dataset-type detection, loading and image residency
(counterpart: fourdgs_tpu/data/scene.py).

All six layouts are read: Blender (D-NeRF), Colmap, dynerf (DyNeRF /
Neu3D), nerfies (HyperNeRF), PanopticSports and MultipleView. A split's
images live in an `ImageBank` whose mode the decoded split's size picks,
with the JAX package's budgets: on the device as float32, in host memory
as uint8, or on disk, decoded on demand.

One difference from the JAX package: its `load_scene_info` asks the
readers to decode every image at read time, which for a DyNeRF scene's
train split is some 94 GB of float32 before any budget applies. Here the
readers other than Blender's keep each view's path and size, and the bank
decodes what its mode holds; every number it serves is the same. A device
or host split whose files hold more than STACK_POOL_PIXELS pixels is
decoded by DECODE_WORKERS processes (the decoders are Python and numpy),
started at the first such split and kept for the process.
"""
from __future__ import annotations

import atexit
import collections
import concurrent.futures
import multiprocessing
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import Camera, make_camera
from fourdgs_tpu_torch.data.images import load_image, load_u8
from fourdgs_tpu_torch.data.panoptic import (PanopticCameraInfo,
                                             camera_from_k_w2c)
from fourdgs_tpu_torch.data.scene_info import CameraInfo, SceneInfo
from fourdgs_tpu_torch.utils.device import resolve_device

# a split whose images take more than this as float32 stays off the device
DEVICE_IMAGE_BUDGET = 4 << 30
# a split whose images take more than this as uint8 stays on disk
HOST_IMAGE_BUDGET = 16 << 30
# decoded views a lazy bank keeps, and prefetched batches it holds
LAZY_CACHE = 64
PENDING = 4
# processes that decode a lazy bank's views, or a large split's when it is
# stacked; the numbers served do not depend on it
DECODE_WORKERS = 4
# a device or host split whose files hold more pixels than this is decoded
# by the stacking pool's processes (below it, on the calling thread)
STACK_POOL_PIXELS = 1 << 23
_stack_pool = None


def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "Blender"
    if os.path.exists(os.path.join(path, "poses_bounds.npy")):
        return "dynerf"
    if os.path.exists(os.path.join(path, "dataset.json")):
        return "nerfies"
    if os.path.exists(os.path.join(path, "train_meta.json")):
        return "PanopticSports"
    if os.path.exists(os.path.join(path, "points3D_multipleview.ply")):
        return "MultipleView"
    raise ValueError(f"could not recognize scene type for {path}")


def load_scene_info(path: str, *, white_background: bool = True,
                    eval_split: bool = True, extension: str = ".png",
                    images: str | None = None, llffhold: int = 8,
                    resolution=None,
                    rng: np.random.Generator | None = None
                    ) -> tuple[SceneInfo, str]:
    """The scene's info and its type. `resolution` (None: the Blender
    reader's RESOLUTION) is the size Blender images are resized to;
    `images` (None: "images") is the Colmap layout's image directory and
    `llffhold` its test-view stride. The readers other than Blender's keep
    each view's path for the image bank to decode (the Blender reader
    decodes every image)."""
    kind = detect_scene_type(path)
    if kind == "Blender":
        from fourdgs_tpu_torch.data.blender import (RESOLUTION,
                                                    read_blender_scene)
        info = read_blender_scene(path, white_background, eval_split,
                                  extension,
                                  resolution=resolution or RESOLUTION,
                                  rng=rng)
    elif kind == "dynerf":
        from fourdgs_tpu_torch.data.dynerf import read_dynerf_scene
        info = read_dynerf_scene(path)
    elif kind == "nerfies":
        from fourdgs_tpu_torch.data.hyper import read_hyper_scene
        info = read_hyper_scene(path)
    elif kind == "Colmap":
        from fourdgs_tpu_torch.data.colmap_scene import read_colmap_scene
        info = read_colmap_scene(path, images, eval_split, llffhold)
    elif kind == "PanopticSports":
        from fourdgs_tpu_torch.data.panoptic import read_panoptic_scene
        info = read_panoptic_scene(path)
    else:
        from fourdgs_tpu_torch.data.multiview import read_multipleview_scene
        info = read_multipleview_scene(path)
    return info, kind


def camera_from_info(info, device) -> Camera:
    """The view's Camera on `device`: from (R, T) and the fields of view,
    or for a PanopticSports view from its K and w2c."""
    if isinstance(info, PanopticCameraInfo):
        return camera_from_k_w2c(info.k, info.w2c, info.width, info.height,
                                 time=info.time, device=device)
    return make_camera(info.R, info.T, info.fovx, info.fovy, time=info.time,
                       device=device)


def _load_image(info: CameraInfo, downscale: int = 1) -> np.ndarray:
    """The view's float32 image at `downscale` (data/images.py)."""
    return load_image(info.image, info.image_path, (info.width, info.height),
                      downscale)


def _load_u8(info: CameraInfo, downscale: int = 1) -> np.ndarray:
    """The view's uint8 image at `downscale`, as a host or lazy bank holds
    it (data/images.py)."""
    return load_u8(info.image, info.image_path, (info.width, info.height),
                   downscale)


def _key(idxs) -> tuple:
    return tuple(int(i) for i in np.ravel(idxs))


def _done(value) -> concurrent.futures.Future:
    f: concurrent.futures.Future = concurrent.futures.Future()
    f.set_result(value)
    return f


class ImageBank:
    """A split's images in one of three modes (the JAX package's
    ImageBank):

      * "device": one (n, H, W, 3) float32 tensor on the device;
        `bank[idxs]` is a device gather;
      * "host": one (n, H, W, 3) uint8 array in host memory;
      * "lazy": the views' files, decoded on demand by DECODE_WORKERS
        worker processes (the decoder is Python and numpy, which threads
        would run one at a time), the last LAZY_CACHE views used kept.

    A host or lazy bank's `bank[idxs]` takes the views' bytes on the host,
    copies them to the device (through two pinned buffers on the card, on
    the caller's stream) and converts them there, x / 255 as a true
    division, so that a batch equals the device mode's bit for bit where
    the images are 8-bit. `prefetch(idxs)` starts a batch's bytes (a
    thread takes a host bank's slice; the processes decode a lazy bank's
    views): no CUDA call leaves the caller's thread, so a CUDA graph
    capture there is safe. A later `bank[idxs]` of the same views takes
    them. `stats` counts the batches served, those a prefetch had started
    and the views sent to be decoded, and lists the seconds the caller
    waited in each `bank[idxs]`. `close()` stops the workers. They start
    by the spawn method, which imports the main module again: a script
    that trains from a lazy bank keeps its work under
    `if __name__ == "__main__"`.
    """

    def __init__(self, mode: str, device, *, images=None, infos=None,
                 downscale: int = 1, n: int = 0, height: int = 0,
                 width: int = 0):
        self.mode = mode
        self.device = torch.device(device)
        self._images = images       # the device tensor or the host array
        self._infos = infos
        self._downscale = downscale
        self._n = n
        self._hw = (height, width)
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_size = LAZY_CACHE
        self._pool = None
        self._pending: dict[tuple, list] = {}
        self._staging: dict[tuple, list] = {}
        self._turn = 0
        self._divisor = None
        self.stats = {"batches": 0, "prefetched": 0, "waits": [],
                      "decoded": 0}

    @property
    def shape(self):
        if self.mode == "lazy":
            return (self._n, self._hw[0], self._hw[1], 3)
        return tuple(self._images.shape)

    def __len__(self):
        return int(self.shape[0])

    def close(self) -> None:
        """Stop the bank's thread or worker processes."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._pending.clear()

    def _submit(self, idxs: np.ndarray) -> list:
        """Futures of a batch's bytes: one slice of the host array, or one
        a view (a cached view's is done)."""
        if self.mode == "host":
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="imagebank")
            return [self._pool.submit(np.take, self._images, idxs, 0)]
        if self._pool is None:
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=DECODE_WORKERS,
                mp_context=multiprocessing.get_context("spawn"))
        futures = []
        for i in map(int, idxs):
            if i in self._cache:
                futures.append(_done(self._cache[i]))
                continue
            info = self._infos[i]
            futures.append(self._pool.submit(
                load_u8, info.image, info.image_path,
                (info.width, info.height), self._downscale))
            self.stats["decoded"] += 1
        return futures

    def _remember(self, idxs: np.ndarray, parts: list) -> None:
        """Put a lazy batch's views in the cache, the last used last."""
        for i, img in zip(map(int, idxs), parts):
            self._cache[i] = img
            self._cache.move_to_end(i)
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)

    def prefetch(self, idxs) -> None:
        """Start the bytes of a future batch `bank[idxs]` (nothing for a
        device bank). At most PENDING batches wait; the oldest is dropped
        (a reshuffled epoch orphans some)."""
        if self.mode == "device":
            return
        key = _key(idxs)
        if key in self._pending:
            return
        while len(self._pending) >= PENDING:
            self._pending.pop(next(iter(self._pending)))
        self._pending[key] = self._submit(np.asarray(idxs).ravel())

    def batch(self, idxs, next_idxs=None) -> torch.Tensor:
        """A training batch `bank[idxs]`, with the next batch's bytes
        started (`next_idxs`, where it is known). A device bank gathers
        view by view: an index array from the host would be copied over
        with a sync."""
        if self.mode == "device":
            return torch.stack([self._images[int(i)] for i in idxs])
        if next_idxs is not None:
            self.prefetch(next_idxs)
        return self[idxs]

    def _upload(self, batch: np.ndarray) -> torch.Tensor:
        """The uint8 batch on the device as float32 / 255."""
        if self._divisor is None:
            self._divisor = torch.tensor(255.0, device=self.device)
        if self.device.type == "cuda":
            ring = self._staging.get(batch.shape)
            if ring is None:
                ring = [(torch.empty(batch.shape, dtype=torch.uint8,
                                     pin_memory=True), torch.cuda.Event())
                        for _ in range(2)]
                self._staging[batch.shape] = ring
            buf, done = ring[self._turn]
            self._turn ^= 1
            done.synchronize()       # the copy that last read buf is over
            np.copyto(buf.numpy(), batch)
            out = buf.to(self.device, non_blocking=True)
            done.record()
        else:
            out = torch.from_numpy(batch)
        return out.to(torch.float32) / self._divisor

    def __getitem__(self, idxs):
        if self.mode == "device":
            if isinstance(idxs, (np.ndarray, list)):
                idxs = torch.as_tensor(np.array(idxs), dtype=torch.long,
                                       device=self._images.device)
            return self._images[idxs]
        if np.ndim(idxs) == 0:
            return self[np.asarray([idxs])][0]
        t0 = time.perf_counter()
        idxs = np.asarray(idxs).ravel()
        futures = self._pending.pop(_key(idxs), None)
        self.stats["batches"] += 1
        if futures is None:
            futures = self._submit(idxs)
        else:
            self.stats["prefetched"] += 1
        parts = [f.result() for f in futures]
        if self.mode == "host":
            batch = parts[0]
        else:
            self._remember(idxs, parts)
            batch = np.stack(parts)
        out = self._upload(batch)
        self.stats["waits"].append(time.perf_counter() - t0)
        return out


@dataclass
class StackedCameras:
    """One split: a Camera per view (on the device), its image bank and
    its timestamps."""
    cameras: list
    images: ImageBank | None
    times: np.ndarray
    width: int
    height: int

    def __len__(self):
        return int(np.asarray(self.times).shape[0])


def _info_dims(info, downscale: int) -> tuple[int, int]:
    w, h = info.width, info.height
    if downscale > 1:
        w, h = w // downscale, h // downscale
    return int(w), int(h)


def close_stack_pool() -> None:
    """Stop the stacking pool's processes (at exit, or sooner)."""
    global _stack_pool
    if _stack_pool is not None:
        _stack_pool.shutdown(wait=True, cancel_futures=True)
        _stack_pool = None


def _pooled_u8(infos: list, downscale: int):
    """Every view's uint8 image decoded by the stacking pool's processes
    where every view is a file and together they hold more than
    STACK_POOL_PIXELS pixels, else None. For a file, `_load_image` is this
    divided by 255 (load_u8's 8-bit round trip), so the split's numbers do
    not depend on the route."""
    global _stack_pool
    if not all(i.image is None and i.image_path for i in infos) or sum(
            i.width * i.height for i in infos) <= STACK_POOL_PIXELS:
        return None
    if _stack_pool is None:
        _stack_pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=DECODE_WORKERS,
            mp_context=multiprocessing.get_context("spawn"))
        atexit.register(close_stack_pool)
    futures = [_stack_pool.submit(load_u8, None, i.image_path,
                                  (i.width, i.height), downscale)
               for i in infos]
    return [f.result() for f in futures]


def stack_cameras(infos: list, device, with_images: bool = True,
                  downscale: int = 1,
                  device_budget: int = DEVICE_IMAGE_BUDGET,
                  host_budget: int = HOST_IMAGE_BUDGET) -> StackedCameras:
    """The split's cameras on `device` and its image bank, whose mode the
    split's decoded size picks against the budgets as the JAX package's
    does: device while float32 fits device_budget, else host while uint8
    fits host_budget (or a view has no file), else lazy. A device or host
    split of many pixels decodes in the stacking pool (_pooled_u8).
    `downscale` divides the image sizes (the fields of view stay)."""
    cams = [camera_from_info(i, device) for i in infos]
    w, h = _info_dims(infos[0], downscale)
    times = np.array([i.time for i in infos], np.float32)
    images = None
    if with_images:
        n = len(infos)
        f32_bytes = n * h * w * 3 * 4
        u8_bytes = n * h * w * 3
        can_lazy = all(i.image is not None or i.image_path for i in infos)
        if f32_bytes <= device_budget:
            pooled = _pooled_u8(infos, downscale)
            host = (np.stack(pooled).astype(np.float32) / 255.0
                    if pooled is not None else
                    np.stack([_load_image(i, downscale) for i in infos]))
            images = ImageBank("device", device,
                               images=torch.from_numpy(host).to(device))
        elif u8_bytes <= host_budget or not can_lazy:
            pooled = _pooled_u8(infos, downscale)
            images = ImageBank("host", device, images=np.stack(
                pooled if pooled is not None else
                [_load_u8(i, downscale) for i in infos]))
        else:
            images = ImageBank("lazy", device, infos=infos,
                               downscale=downscale, n=n, height=h, width=w)
    return StackedCameras(cameras=cams, images=images, times=times,
                          width=w, height=h)


@dataclass
class Scene:
    """A loaded scene ready for training."""
    info: SceneInfo
    dataset_type: str
    train: StackedCameras
    test: StackedCameras
    video: StackedCameras
    cameras_extent: float
    aabb: np.ndarray          # (2, 3) rows (max, min) for the deform field
    maxtime: float

    @classmethod
    def load(cls, path: str, downscale: int = 1,
             device: str | torch.device | None = None,
             load_images: bool = True, **kwargs) -> "Scene":
        """The scene's splits on `device` (None: cuda, which raises without
        a card). `downscale` divides the image resolution (the `-r` flag);
        `load_images=False` stacks the cameras only, with no image bank
        (the export and merge tools); `kwargs` go to `load_scene_info`."""
        dev = resolve_device(device)
        info, kind = load_scene_info(path, **kwargs)
        train = stack_cameras(info.train_cameras, dev,
                              with_images=load_images, downscale=downscale)
        test = (stack_cameras(info.test_cameras, dev,
                              with_images=load_images, downscale=downscale)
                if info.test_cameras else train)
        video = (stack_cameras(info.video_cameras, dev, with_images=False,
                               downscale=downscale)
                 if info.video_cameras else test)
        pts = info.point_cloud.points
        aabb = np.stack([pts.max(0), pts.min(0)]).astype(np.float32)
        return cls(info=info, dataset_type=kind, train=train, test=test,
                   video=video,
                   cameras_extent=float(info.nerf_normalization["radius"]),
                   aabb=aabb, maxtime=info.maxtime)

    def zerostamp_mask(self) -> np.ndarray:
        """Views at the first timestamp (the coarse stage's zerostamp
        init)."""
        t = self.train.times
        return t == t.min()
