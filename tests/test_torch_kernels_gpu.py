"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and takes the `cuda` fixture, which skips
it when no CUDA device is present. The decision is made when the test
runs, never at import, so every pytest-xdist worker collects the same
tests. Run them on a machine with an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Tolerances are those the blend is held to everywhere: color 1e-5, depth
1e-4, transmittance 1e-5. The kernel and the plain version take the same
gate decisions and differ only in the order of the color and depth sums.
"""
import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.data.camera import look_at_camera, make_camera
from fourdgs_tpu_torch.models.deformation import DeformConfig, Deformation
from fourdgs_tpu_torch.models.gaussians import GaussianParams
from fourdgs_tpu_torch.ops import blend
from fourdgs_tpu_torch.ops.rasterize_tiled import RasterConfig, prepare_blend
from fourdgs_tpu_torch.render.render import splats_at

TOL = {"color": 1e-5, "depth": 1e-4, "t": 1e-5}
W, H = 96, 80


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                          rng.uniform(2.0, 6.0, n)], -1)
        scales = np.exp(rng.uniform(-3.0, -1.0, (n, 3)))
        opac = rng.uniform(0.05, 0.99, n)
    else:  # a deep stack of near-opaque splats: every pixel saturates
        means = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                          np.linspace(2.0, 6.0, n)], -1)
        scales = np.full((n, 3), 2.0)
        opac = rng.uniform(0.9, 0.99, n)
    quats = rng.normal(size=(n, 4))
    colors = rng.uniform(0.0, 1.0, (n, 3))
    return [np.asarray(x, np.float32)
            for x in (means, scales, quats, opac, colors)]


def _inputs(dev, kind, ts, tile_cap=128, chunk=8, n=400, seed=0):
    cfg = RasterConfig(img_width=W, img_height=H, tile_size=ts,
                       tile_cap=tile_cap, chunk=chunk)
    means, scales, quats, opac, colors = (
        torch.from_numpy(x).to(dev) for x in _scene(kind, n, seed))
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.85, device=dev)
    _, binned, table = prepare_blend(means, scales, quats, opac, colors, cam,
                                     cfg)
    return binned, table, cfg


def _assert_close(out, ref):
    for name, a, b in zip(("color", "depth", "t"), out, ref):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= TOL[name], f"{name}: max abs err {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_blend_kernel_matches_plain(cuda, kind, ts):
    binned, table, cfg = _inputs(cuda, kind, ts)
    assert int(binned.counts.max()) > cfg.chunk     # several chunks
    before = blend.blend_forward.launches
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    torch.cuda.synchronize()
    assert blend.blend_forward.launches == before + 1
    _assert_close(out, blend.blend_forward_plain(binned.gidx, binned.counts,
                                                 table, cfg))
    if kind == "saturating":
        assert float(out[2].max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("tile_cap,chunk", [(16, 8), (64, 32), (96, 32)])
def test_blend_kernel_caps_and_chunks(cuda, tile_cap, chunk):
    """Full tiles (tile overflow), and counts that end inside a chunk."""
    binned, table, cfg = _inputs(cuda, "random", 16, tile_cap, chunk, n=900,
                                 seed=1)
    if tile_cap == 16:
        assert int(binned.overflow.sum()) > 0
    out = blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    _assert_close(out, blend.blend_forward_plain(binned.gidx, binned.counts,
                                                 table, cfg))


@pytest.mark.gpu
def test_blend_kernel_refuses_what_it_cannot_take(cuda):
    before = blend.blend_forward.launches
    binned, table, cfg = _inputs(cuda, "random", 8)
    with pytest.raises(ValueError, match="tile_size 16 or 32"):
        blend.blend_forward(binned.gidx, binned.counts, table, cfg)
    binned, table, cfg = _inputs(cuda, "random", 16)
    with pytest.raises(ValueError, match="device"):
        blend.blend_forward(binned.gidx, binned.counts.cpu(), table, cfg)
    assert blend.blend_forward.launches == before


@pytest.mark.gpu
def test_fine_splats_wait_on_no_host_sync(cuda):
    """The deformation at the camera's timestamp, the HexPlane constant-t
    sampler included, and the SH colors never read the device to the
    host, so they leave the launch queue running."""
    rng = np.random.default_rng(2)
    n = 512
    gauss = GaussianParams(**{
        k: torch.from_numpy(rng.normal(0, 0.3, shape).astype(np.float32)).to(
            cuda)
        for k, shape in (("xyz", (n, 3)), ("features_dc", (n, 1, 3)),
                         ("features_rest", (n, 15, 3)), ("scaling", (n, 3)),
                         ("rotation", (n, 4)), ("opacity", (n, 1)))})
    deform = Deformation(DeformConfig(),
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    aabb = torch.tensor([[1.5] * 3, [-1.5] * 3], device=cuda)
    cam = look_at_camera(time=0.4, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = splats_at(gauss, deform, cam, aabb, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(x).all()) for x in out)
