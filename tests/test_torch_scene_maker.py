"""Port parity for the synthetic scene's protocols
(tools/make_synthetic_scene.py) against scripts/make_synthetic_scene.py
at 32px: the multiview rig (3 cameras, 2 timestamps, camera 0 held out)
and the monocular pool with every third view held out. The transforms
files must list the same frames (paths equal, times and matrices to
1e-6), and every image must be within one level of 255 of the JAX
script's (the two rasterizers' float sums round apart)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.data.png import read_png
from fourdgs_tpu_torch.tools import make_synthetic_scene as tmake

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX scripts in a subprocess on the CPU, as tests/test_cli.py runs them
ENV = dict(os.environ, JAX_PLATFORMS="cpu", FOURDGS_PLATFORM="cpu",
           PYTHONPATH="",
           XLA_FLAGS="--xla_force_host_platform_device_count=1")
PROTOCOLS = {
    "multiview": ["--protocol", "multiview", "--n_cams", "3",
                  "--n_times", "2"],
    "holdout": ["--holdout_every", "3", "--n_train", "4", "--n_test", "2"],
}
SPLITS = {"multiview": (4, 2), "holdout": (4, 2)}   # train, test views


def _frames(root, split):
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_protocol_matches_the_jax_script(protocol, tmp_path):
    args = ["--size", "32"] + PROTOCOLS[protocol]
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    r = subprocess.run([sys.executable, "scripts/make_synthetic_scene.py",
                        jroot] + args, cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    tmake.main([troot, "--device", "cpu"] + args)
    assert sorted(os.listdir(troot)) == sorted(os.listdir(jroot))
    assert not os.path.exists(os.path.join(troot, "transforms_pool.json"))
    for split, n in zip(("train", "test"), SPLITS[protocol]):
        want, got = _frames(jroot, split), _frames(troot, split)
        assert got["camera_angle_x"] == want["camera_angle_x"]
        assert len(got["frames"]) == len(want["frames"]) == n
        for a, b in zip(got["frames"], want["frames"]):
            assert a["file_path"] == b["file_path"]
            np.testing.assert_allclose(a["time"], b["time"], atol=1e-6)
            np.testing.assert_allclose(a["transform_matrix"],
                                       b["transform_matrix"], atol=1e-6)
            path = a["file_path"][2:] + ".png"
            img_t = read_png(os.path.join(troot, path)).astype(np.int16)
            img_j = read_png(os.path.join(jroot, path)).astype(np.int16)
            assert img_t.shape == img_j.shape == (32, 32, 4)
            assert np.abs(img_t - img_j).max() <= 1, path
    if protocol == "multiview":
        # camera 0 is the test split, every camera sees both times
        test = _frames(troot, "test")["frames"]
        assert {f["file_path"][:len("./test/cam00")] for f in test} == \
            {"./test/cam00"}
        assert sorted(f["time"] for f in test) == [0.0, 1.0]
    else:
        # every third view of one pool is held out, the images under pool/
        paths = [f["file_path"] for s in ("train", "test")
                 for f in _frames(troot, s)["frames"]]
        assert all(p.startswith("./pool/") for p in paths)
        assert sorted(p for p in (f["file_path"] for f in
                                  _frames(troot, "test")["frames"])) == \
            ["./pool/r_0", "./pool/r_3"]
