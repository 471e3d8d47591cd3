"""Port parity for the image banks (data/scene.py `ImageBank`,
`stack_cameras`): the device, host and lazy modes against each other and
against the JAX package's bank of the same mode, the lazy cache, prefetch,
and `run_stage` fed by a host or lazy bank (the counterparts of
tests/test_image_bank.py's four tests).

Batches of a mode equal JAX's of that mode bit for bit. Across modes they
are equal for 8-bit sources (a nerfies scene) and within the uint8
requantisation, 1/510, for alpha-composited Blender images.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from fourdgs_tpu.data import blender as jblender
from fourdgs_tpu.data import hyper as jhyper
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu_torch.data import blender as tblender
from fourdgs_tpu_torch.data import hyper as thyper
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.train import config as tconfig
from fourdgs_tpu_torch.train import loop, optim
from fourdgs_tpu_torch.train.state import create_state
from tests.test_data import write_blender_fixture

torch.set_num_threads(1)

CPU = torch.device("cpu")
BUDGETS = {"device": {}, "host": {"device_budget": 0},
           "lazy": {"device_budget": 0, "host_budget": 0}}


@pytest.fixture(scope="module")
def blender_infos(tmp_path_factory):
    root = tmp_path_factory.mktemp("bankdata")
    write_blender_fixture(root, n_frames=6, size=32)
    kw = dict(white_background=True, eval_split=True, resolution=(32, 32))
    return (jblender.read_blender_scene(str(root), **kw).train_cameras,
            tblender.read_blender_scene(str(root), **kw).train_cameras)


@pytest.fixture(scope="module")
def nerfies_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("nerfies")
    chip_smoke.write_nerfies_scene(torch, root, CPU, size=(24, 32),
                                   n_times=6)
    return root


_OPEN = []


@pytest.fixture(autouse=True)
def _close_banks():
    """Stop every bank's decode workers after each test."""
    yield
    while _OPEN:
        _OPEN.pop().close()


def _stack(infos, **kw):
    split = tscene.stack_cameras(infos, CPU, **kw)
    _OPEN.append(split.images)
    return split


def _banks(infos, **kw):
    return {m: _stack(infos, **b, **kw).images for m, b in BUDGETS.items()}


def _jax_banks(infos):
    return {m: jscene.stack_cameras(infos, **b).images
            for m, b in BUDGETS.items()}


def test_modes_agree(blender_infos):
    jinfos, infos = blender_infos
    banks, jbanks = _banks(infos), _jax_banks(jinfos)
    assert [b.mode for b in banks.values()] == list(BUDGETS)
    idxs = np.array([0, 3, 5])
    for m, bank in banks.items():
        assert bank.shape == (6, 32, 32, 3) and len(bank) == 6
        got = bank[idxs]
        assert got.dtype == torch.float32 and got.device == CPU
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jbanks[m][idxs]))
        # alpha-composited images are not 8-bit exact: the host and lazy
        # modes' uint8 requantisation moves a value by at most 1/510
        np.testing.assert_allclose(got.numpy(), banks["device"][idxs].numpy(),
                                   atol=0.002)
        # scalar indexing (the eval path)
        np.testing.assert_array_equal(bank[3].numpy(), got[1].numpy())


def test_eight_bit_modes_equal(nerfies_root):
    """A nerfies split whose views are still on disk: every mode's batch
    equal bit for bit to the others and to JAX's of the same mode (whose
    reader decoded the images)."""
    infos = thyper.read_hyper_scene(str(nerfies_root)).train_cameras
    jinfos = jhyper.read_hyper_scene(str(nerfies_root),
                                     load_images=True).train_cameras
    assert all(i.image is None for i in infos)
    banks, jbanks = _banks(infos), _jax_banks(jinfos)
    idxs = np.arange(6)[::-1]
    want = banks["device"][idxs].numpy()
    for m, bank in banks.items():
        np.testing.assert_array_equal(bank[idxs].numpy(), want)
        np.testing.assert_array_equal(np.asarray(jbanks[m][idxs]), want)
    lazy = _stack(infos, downscale=2, **BUDGETS["lazy"]).images
    jlazy = jscene.stack_cameras(jinfos, downscale=2,
                                 **BUDGETS["lazy"]).images
    assert lazy.shape == (6, 16, 12, 3)
    np.testing.assert_array_equal(lazy[idxs].numpy(),
                                  np.asarray(jlazy[idxs]))


def test_lazy_cache_bounded(blender_infos):
    bank = _banks(blender_infos[1])["lazy"]
    bank._cache_size = 2
    for i in range(6):
        bank[np.array([i])]
    assert len(bank._cache) <= 2
    assert list(bank._cache) == [4, 5]
    bank[np.array([4])]                    # a hit refreshes the view
    bank[np.array([0])]
    assert list(bank._cache) == [4, 0]
    assert bank.stats["decoded"] == 7


def test_prefetch_agrees_and_drains(blender_infos):
    """prefetch(idxs) -> bank[idxs] returns the prefetched batch (equal to
    a cold read) and drains the pending table; unconsumed prefetches stay
    bounded; a device bank ignores prefetch."""
    banks = _banks(blender_infos[1])
    for mode in ("host", "lazy"):
        bank = banks[mode]
        idxs = np.array([1, 4])
        cold = bank[idxs].numpy()
        bank.prefetch(idxs)
        assert len(bank._pending) == 1
        warm = bank[idxs].numpy()
        np.testing.assert_array_equal(cold, warm)
        assert len(bank._pending) == 0
        assert (bank.stats["batches"], bank.stats["prefetched"]) == (2, 1)
        for i in range(10):
            bank.prefetch(np.array([i % 6]))
        assert len(bank._pending) <= tscene.PENDING
    banks["device"].prefetch(np.array([1, 4]))


def _tiny_cfg():
    cfg = tconfig.Config()
    cfg.model.sh_degree = 1
    cfg.raster = tconfig.RasterParams(capacity=512, tile_size=16,
                                      tile_cap=64, chunk=8, min_bucket=256)
    cfg.opt.batch_size = 2
    cfg.hidden.kplanes_config = {"grid_dimensions": 2,
                                 "input_coordinate_dim": 4,
                                 "output_coordinate_dim": 8,
                                 "resolution": [8, 8, 8, 4]}
    cfg.hidden.multires = [1, 2]
    cfg.hidden.net_width = 16
    return cfg


def _run(cfg, split, bank, stage, iters, seed=1):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (128, 3)).astype(np.float32)
    st = create_state(cfg, pts, cols, 1.0,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    st = loop.compact_and_resize(st, 512)
    tx = optim.build_optimizer(cfg.opt, 1.0)
    st.opt_state = tx.init(st.params)
    rcfg = tconfig.raster_config_from(cfg, split.width, split.height)
    return loop.run_stage(cfg, st, stage, iters, split.cameras, bank, tx,
                          rcfg, rng=np.random.default_rng(seed),
                          log_every=1)


def test_train_step_with_host_bank(blender_infos):
    """run_stage takes a host bank as it takes the device one."""
    infos = blender_infos[1]
    host = _stack(infos, **BUDGETS["host"])
    res = _run(_tiny_cfg(), host, host.images, "coarse", 6)
    assert np.isfinite(res.history[-1]["loss"])
    assert host.images.stats["batches"] == 6
    # three batches an epoch of six views: each epoch's first is not
    # prefetched (the step before it cannot draw the next permutation)
    assert host.images.stats["prefetched"] == 4


def test_run_stage_lazy_equals_device(nerfies_root):
    """A short fine stage on a PNG-layout scene: the lazy bank with its
    prefetch gives the device bank's losses and state exactly."""
    infos = thyper.read_hyper_scene(str(nerfies_root)).train_cameras
    cfg = _tiny_cfg()
    runs = {}
    for mode in ("device", "lazy"):
        split = _stack(infos, **BUDGETS[mode])
        assert split.images.mode == mode
        runs[mode] = _run(cfg, split, split.images, "fine", 8)
    assert [h["loss"] for h in runs["lazy"].history] == \
        [h["loss"] for h in runs["device"].history]
    for a, b in zip(optim.param_leaves(runs["lazy"].state.params),
                    optim.param_leaves(runs["device"].state.params)):
        assert torch.equal(a, b)
