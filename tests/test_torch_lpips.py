"""Port parity for LPIPS (ops/lpips.py): the VGG16 and AlexNet networks
with the same random weights in the npz layout (tests/test_lpips.py's
`random_params`) against the JAX package's `lpips`, to 1e-5 relative, and
the weight search of `make_lpips_fn` (None without a file,
$FOURDGS_LPIPS_WEIGHTS first, the sha256 sidecar checked)."""
import hashlib

import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import lpips as jlpips
from fourdgs_tpu_torch.ops import lpips as tlpips
from tests.test_lpips import random_params

torch.set_num_threads(1)

SIZE = 64
RTOL = 1e-5


def _images(seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    return x, y


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_matches_jax(net):
    params = random_params(np.random.default_rng(0), net)
    x, y = _images(1)
    want = np.asarray(jlpips.lpips({k: np.asarray(v) for k, v in
                                    params.items()}, x, y, net=net))
    model = tlpips.LPIPS(params, net).eval()
    with torch.no_grad():
        got = model(_nchw(x), _nchw(y)).numpy()
        same = model(_nchw(x), _nchw(x)).numpy()
    assert got.shape == (2,) and np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_array_equal(same, 0.0)
    taps = model.features(_nchw(x))
    assert [t.shape[1] for t in taps] == list(
        tlpips.VGG_CHANNELS if net == "vgg" else tlpips.ALEX_CHANNELS)


def _write_npz(path, params):
    np.savez(path, **params)
    return path


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_make_lpips_fn_follows_the_search_order(net, tmp_path, monkeypatch):
    monkeypatch.delenv("FOURDGS_LPIPS_WEIGHTS", raising=False)
    assert tlpips.default_weights_path(net) == \
        jlpips.default_weights_path(net)
    missing = str(tmp_path / "none.npz")
    assert tlpips.make_lpips_fn(net, missing, device="cpu") is None
    assert tlpips.load_weights(net, missing) is None

    params = random_params(np.random.default_rng(2), net)
    path = _write_npz(str(tmp_path / f"lpips_{net}.npz"), params)
    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS", path)
    assert tlpips.default_weights_path(net) == path == \
        jlpips.default_weights_path(net)
    fn = tlpips.make_lpips_fn(net, device="cpu")
    jfn = jlpips.make_lpips_fn(net)
    x, y = _images(3, batch=1)
    np.testing.assert_allclose(fn(x[0], y[0]), jfn(x[0], y[0]), rtol=RTOL)

    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS", missing)
    assert tlpips.make_lpips_fn(net, device="cpu") is None


def test_load_weights_checks_the_sidecar(tmp_path):
    params = random_params(np.random.default_rng(4), "alex")
    path = _write_npz(str(tmp_path / "w.npz"), params)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with open(path + ".sha256", "w") as f:
        f.write(f"{digest}  w.npz\n")
    loaded = tlpips.load_weights("alex", path)
    assert sorted(loaded) == sorted(params)
    with open(path + ".sha256", "w") as f:
        f.write("0" * 64 + "\n")
    with pytest.raises(ValueError, match="checksum mismatch"):
        tlpips.load_weights("alex", path)


def test_make_lpips_fn_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = _write_npz(str(tmp_path / "w.npz"),
                      random_params(np.random.default_rng(5), "alex"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tlpips.make_lpips_fn("alex", path)
