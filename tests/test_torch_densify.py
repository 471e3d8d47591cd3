"""Port parity for adaptive density control (train/densify.py) and the
capacity buckets (train/loop.py `pick_bucket`, `compact_and_resize`).

Both packages start from one JAX-built state (`convert.train_state_from_numpy`)
whose densify statistics, moments and alive mask are numpy noise, so that
clones, splits, prunes and free-slot reuse all happen. The JAX package's
random draws are computed here from its key and injected into the port, so
the two states are compared slot by slot: alive masks equal, parameters and
moments to 1e-6 (the split's rotation product rounds differently in the
two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import transforms as jtransforms
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu.train import densify as jdensify
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu_torch import convert
from fourdgs_tpu_torch.models.gaussians import FIELDS
from fourdgs_tpu_torch.train import densify as tdensify
from fourdgs_tpu_torch.train import loop as tloop
from tests.test_torch_train import _noisy_jax_state, _port_state
from tests.test_train import tiny_config

torch.set_num_threads(1)

TOL = 1e-6
CAP = 256


def _stats_state(seed=0):
    """A JAX state with 96 gaussians among 256 slots, a few of them dead
    (free slots interleave with live ones), random densify statistics and
    random moments of the gaussian fields."""
    cfg = tiny_config(cap=CAP)
    st = _noisy_jax_state(cfg, seed)
    rng = np.random.default_rng(seed + 10)
    alive = np.asarray(st.alive).copy()
    alive[::7] = False
    denom = rng.integers(0, 4, CAP).astype(np.float32)
    accum = (rng.uniform(0, 8e-4, CAP) * denom).astype(np.float32)

    def noisy(tree, scale):
        return tree._replace(**{
            f: jnp.asarray(rng.normal(0, scale, np.shape(getattr(tree, f))),
                           jnp.float32) for f in tree._fields})
    opt = st.opt_state
    mu = {**opt.mu, "gauss": noisy(opt.mu["gauss"], 0.1)}
    nu = {**opt.nu, "gauss": jax.tree.map(jnp.abs,
                                          noisy(opt.nu["gauss"], 0.01))}
    return cfg, st._replace(
        alive=jnp.asarray(alive), denom=jnp.asarray(denom),
        xyz_gradient_accum=jnp.asarray(accum),
        max_radii2d=jnp.asarray(rng.uniform(0, 40, CAP), jnp.float32),
        opt_state=opt._replace(mu=mu, nu=nu))


def _extent(st):
    """An extent that puts the percent_dense line at the median gaussian,
    so that half the candidates clone and half split."""
    scales = np.asarray(jtransforms.safe_exp_scales(
        st.params["gauss"].scaling)).max(axis=1)
    return float(np.median(scales[np.asarray(st.alive)])) / 0.01


def _assert_same(port, jst, what):
    """Every per-slot leaf of the two states, slot by slot."""
    flat_j = jckpt._flatten(jst._asdict())
    flat_t = convert.train_state_to_numpy(port)
    assert sorted(flat_t) == sorted(flat_j)
    np.testing.assert_array_equal(flat_t["alive"], flat_j["alive"],
                                  err_msg=what)
    for k, v in flat_t.items():
        if k == "alive":
            continue
        np.testing.assert_allclose(v, flat_j[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {k}")


def _split_noise(key):
    """The JAX package's two split draws (densify.py:104-106)."""
    return (np.array(jax.random.normal(key, (CAP, 3))),
            np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                       (CAP, 3))))


@pytest.mark.parametrize("budget", ["unbounded", "tight"])
def test_densify_matches_jax(budget):
    """Clone and split from one state; a tight budget (max_points = alive
    + the clones + 3) lets every clone through and only three splits."""
    cfg, st = _stats_state()
    port = _port_state(st, cfg)
    extent = _extent(st)
    key = jax.random.key(3)
    max_points = 360_000
    if budget == "tight":
        _, free = jdensify.densify(st, key, 2e-4, 0.01, extent, max_points)
        max_points = (int(np.asarray(st.alive).sum()) + int(free.n_cloned)
                      + 3)
    jst, jstats = jdensify.densify(st, key, 2e-4, 0.01, extent, max_points)
    noise = tuple(torch.from_numpy(x) for x in _split_noise(key))
    port, tstats = tdensify.densify(port, 2e-4, 0.01, extent, max_points,
                                    noise=noise)
    for f in ("n_cloned", "n_split", "n_dropped"):
        assert int(getattr(tstats, f)) == int(getattr(jstats, f)), f
    assert int(jstats.n_cloned) > 0 and int(jstats.n_split) > 0
    if budget == "tight":
        assert int(jstats.n_split) == 3 and int(jstats.n_dropped) > 0
    _assert_same(port, jst, "densify")
    # the moments of the written slots are zero, the others untouched
    written = np.asarray(jst.alive) & ~np.asarray(st.alive)
    assert written.any()
    assert float(port.opt_state.mu["gauss"].xyz[written].abs().max()) == 0
    assert all(getattr(port.params["gauss"], f).requires_grad
               for f in FIELDS)


@pytest.mark.parametrize("max_screen_size,min_points",
                         [(None, 10), (20, 10), (20, 10_000)])
def test_prune_matches_jax(max_screen_size, min_points):
    cfg, st = _stats_state(1)
    port = _port_state(st, cfg)
    extent = _extent(st)
    jst = jdensify.prune(st, 0.4, extent, max_screen_size, min_points)
    port = tdensify.prune(port, 0.4, extent, max_screen_size, min_points)
    _assert_same(port, jst, "prune")
    removed = int(np.asarray(st.alive).sum() - np.asarray(jst.alive).sum())
    assert (removed > 0) == (min_points < 100)


def test_grow_matches_jax():
    """Density-based growing with the JAX package's normal draw injected."""
    cfg, st = _stats_state(2)
    port = _port_state(st, cfg)
    key = jax.random.key(5)
    n_alive = int(np.asarray(st.alive).sum())
    jst, jn = jdensify.grow(st, key, max_points=n_alive + 12)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (CAP, 3))))
    port, tn = tdensify.grow(port, max_points=n_alive + 12, noise=noise)
    assert int(tn) == int(jn) == 12
    _assert_same(port, jst, "grow")


def test_reset_opacity_matches_jax():
    cfg, st = _stats_state(3)
    port = _port_state(st, cfg)
    jst = jdensify.reset_opacity(st)
    port = tdensify.reset_opacity(port)
    _assert_same(port, jst, "reset_opacity")
    assert float(port.opt_state.nu["gauss"].opacity.abs().max()) == 0


@pytest.mark.parametrize("n_alive,max_cap,min_bucket,headroom,want", [
    (0, 400_000, 4096, 1.5, 4096),
    (2000, 400_000, 4096, 1.5, 4096),
    (2732, 400_000, 4096, 1.5, 8192),
    (30_000, 400_000, 4096, 2.0, 65536),
    (43_690, 400_000, 4096, 1.5, 65536),
    (43_692, 400_000, 4096, 1.5, 131072),
    (131_072, 400_000, 4096, 1.5, 196608),
    (250_000, 400_000, 4096, 1.5, 393_216),
    (270_000, 400_000, 4096, 1.5, 400_000),
    (100, 1024, 4096, 1.5, 1024),
    (100, 400_000, 256, 1.5, 256),
])
def test_pick_bucket_table(n_alive, max_cap, min_bucket, headroom, want):
    """Powers of two up to 64k, multiples of 64k above, clamped to the
    capacity; the same as the JAX package's."""
    got = tloop.pick_bucket(n_alive, max_cap, min_bucket, headroom)
    assert got == want
    assert got == jloop.pick_bucket(n_alive, max_cap, min_bucket, headroom)


@pytest.mark.parametrize("new_cap", [512, 128, CAP])
def test_compact_and_resize_matches_jax(new_cap):
    """After a densify (live and free slots interleaved): the stable
    compaction, the w = 1 rotations of padded parameter slots and zero
    padded moments, at a larger, a smaller and the same capacity."""
    cfg, st = _stats_state(4)
    port = _port_state(st, cfg)
    key = jax.random.key(7)
    extent = _extent(st)
    st, _ = jdensify.densify(st, key, 2e-4, 0.01, extent, 360_000)
    noise = tuple(torch.from_numpy(x) for x in _split_noise(key))
    port, _ = tdensify.densify(port, 2e-4, 0.01, extent, 360_000,
                               noise=noise)
    jst = jloop.compact_and_resize(st, new_cap)
    port = tloop.compact_and_resize(port, new_cap)
    assert port.capacity == new_cap
    _assert_same(port, jst, f"resize {new_cap}")
    n = int(port.alive.sum())
    assert bool(port.alive[:n].all()) and not bool(port.alive[n:].any())
    if new_cap > CAP:
        # the slots past the old capacity: w = 1 parameters, zero moments
        rot = port.params["gauss"].rotation.detach()
        assert bool((rot[CAP:, 0] == 1.0).all())
        assert float(port.opt_state.mu["gauss"].rotation[CAP:].abs().max()) \
            == 0
    assert all(getattr(port.params["gauss"], f).requires_grad
               for f in FIELDS)


def test_compact_and_resize_refuses_a_small_capacity():
    cfg, st = _stats_state(5)
    port = _port_state(st, cfg)
    with pytest.raises(ValueError, match="do not fit"):
        tloop.compact_and_resize(port, 64)
