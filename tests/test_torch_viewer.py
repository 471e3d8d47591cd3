"""Port parity for the live viewer bridge (viewer/network_gui.py) against
fourdgs_tpu/viewer/network_gui.py, over `socket.socketpair()`:

  * `receive` on the same request bytes: the camera's matrices within
    1e-7, every other field equal (a zero-size request included);
  * `send_image`'s bytes equal to JAX's, for a frame given as a tensor
    and as an array, values outside [0, 1] included;
  * a scripted `poll` session (a zero-size request, frames with and
    without `train`, `keep_alive` once training is done, a disconnect):
    the same frames served and the same return in both packages;
  * a poll with no client connected returns without rendering;
  * `tools/train.py --gui` on a tiny CPU scene with a client thread
    trains to its end, and the client gets every frame's bytes; with
    `render_process` the test evaluation writes its triptych.
"""
import itertools
import math
import socket
import threading

import numpy as np
import pytest
import torch

from fourdgs_tpu.viewer import network_gui as jgui
from fourdgs_tpu_torch.data.camera import look_at_camera
from fourdgs_tpu_torch.data.jpeg import read_jpeg
from fourdgs_tpu_torch.tools import train as ttrain
from fourdgs_tpu_torch.tools.make_synthetic_scene import write_split
from fourdgs_tpu_torch.viewer import network_gui as tgui
from tests.test_torch_stage import CLI_CONFIG

torch.set_num_threads(1)

FOV = 0.9


def _request(w, h, train=False, keep_alive=False, theta=0.3, sm=1.0):
    cam = look_at_camera(theta=theta, fov=FOV, device="cpu")
    view, proj = tgui.client_matrices(cam)
    return tgui.request_bytes(w, h, FOV, FOV * h / max(w, 1), view, proj,
                              train=train, keep_alive=keep_alive,
                              scaling_modifier=sm)


def _pair_gui(gui):
    server, client = socket.socketpair()
    gui.conn = server
    return client


@pytest.mark.parametrize("size", [(40, 24), (0, 0)])
def test_receive_matches_jax(size):
    data = _request(*size, train=True, keep_alive=True, theta=1.1, sm=0.5)
    reqs = []
    for gui in (jgui.NetworkGui(), tgui.NetworkGui("cpu")):
        client = _pair_gui(gui)
        client.sendall(data)
        reqs.append(gui.receive(time=0.375))
        client.close()
        gui.disconnect()
    want, got = reqs
    for f in tgui.GuiRequest._fields:
        if f != "camera":
            assert getattr(got, f) == getattr(want, f), f
    if size == (0, 0):
        assert got.camera is None and want.camera is None
        return
    for f in ("world_view", "full_proj", "cam_center", "tanfovx", "tanfovy",
              "time"):
        a = getattr(got.camera, f)
        assert a.dtype == torch.float32 and a.device.type == "cpu", f
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(
            want.camera, f)), rtol=1e-7, atol=1e-7, err_msg=f)
    # the client's matrices decode to the camera they were made from
    cam = look_at_camera(theta=1.1, fov=FOV, device="cpu")
    np.testing.assert_allclose(got.camera.world_view.numpy(),
                               cam.world_view.numpy(), atol=1e-6)


def _sent(gui, image, verify="scene"):
    client = _pair_gui(gui)
    gui.send_image(image, verify)
    gui.disconnect()
    out = b""
    while chunk := client.recv(1 << 16):
        out += chunk
    client.close()
    return out


def test_send_image_bytes_match_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, (17, 23, 3)).astype(np.float32)
    want = _sent(jgui.NetworkGui(), img)
    assert len(want) == 17 * 23 * 3 + 4 + len("scene")
    for frame in (torch.from_numpy(img), img):
        assert _sent(tgui.NetworkGui("cpu"), frame) == want
    assert _sent(tgui.NetworkGui("cpu"), None) == _sent(jgui.NetworkGui(),
                                                         None)
    assert tgui.frame_bytes(torch.from_numpy(img)) == want[:17 * 23 * 3]


def _frame(world_view, w, h, sm):
    """A frame that depends on the request: its camera, size and scale."""
    y, x = np.mgrid[0:h, 0:w]
    base = (world_view[0, 0] + 0.01 * x + 0.02 * y) * sm
    return np.stack([base, 1 - base, np.full_like(base, 0.5)],
                    -1).astype(np.float32) % 1.0


SESSION = [   # (requests of one poll, training_done)
    ([(0, 0, False, False), (24, 16, False, False), (24, 16, True, False)],
     False),
    ([(20, 12, True, True), (20, 12, False, True), (20, 12, True, False)],
     True),
]


def _session(gui, render_fn):
    """The scripted polls; returns (frames served, each poll's return,
    the client's replies)."""
    client = _pair_gui(gui)
    served, returns, replies = [], [], []

    def render(camera, w, h, sm):
        served.append((w, h, sm))
        return render_fn(camera, w, h, sm)

    for i, (reqs, done) in enumerate(SESSION):
        for w, h, train, keep in reqs:
            client.sendall(_request(w, h, train, keep, theta=0.2 * i,
                                    sm=1.0 + i))
        returns.append(gui.poll(render, "src", time=0.5, training_done=done))
        for w, h, _, _ in reqs:
            replies.append(tgui.recv_reply(client, w, h))
    client.close()                          # the viewer goes away
    returns.append(gui.poll(render, "src", time=0.5))
    assert gui.conn is None
    return served, returns, replies


def test_scripted_poll_session_matches_jax():
    want = _session(jgui.NetworkGui(), lambda c, w, h, sm: _frame(
        np.asarray(c.world_view), w, h, sm))
    got = _session(tgui.NetworkGui("cpu"), lambda c, w, h, sm: (
        torch.from_numpy(_frame(c.world_view.numpy(), w, h, sm))))
    assert got[0] == want[0] and len(want[0]) == 5
    assert got[1] == want[1] == [True, True, True]
    assert got[2] == want[2]
    assert [len(f) for f, _ in got[2]] == [0, 24 * 16 * 3, 24 * 16 * 3,
                                           20 * 12 * 3, 20 * 12 * 3,
                                           20 * 12 * 3]
    assert all(v == "src" for _, v in got[2])


def test_poll_without_client_does_not_render():
    gui = tgui.NetworkGui("cpu")
    gui.init("127.0.0.1", 0)
    try:
        def refuse(*a):
            raise AssertionError("rendered without a client")

        for _ in range(3):
            assert gui.poll(refuse, "src") is True
        assert gui.conn is None
    finally:
        gui.close()
    held = socket.socket()
    held.bind(("127.0.0.1", 0))
    held.listen()
    try:
        taken = tgui.NetworkGui("cpu")
        with pytest.raises(OSError):        # a failed bind raises
            taken.init("127.0.0.1", held.getsockname()[1])
        taken.close()
    finally:
        held.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_gui_serves_a_client(tmp_path):
    """The train CLI with --gui: a client that asks for 4 frames without
    `train` (one poll serves them all before training goes on), then one
    frame an iteration with `train` and `keep_alive` until the run ends
    and the bridge closes, gets every reply, and the run reaches its last
    iteration."""
    scene = tmp_path / "scene"
    write_split(str(scene), "train", 4, 0.0, 32, "cpu")
    write_split(str(scene), "test", 2, 0.13, 32, "cpu")
    (scene / "cli.py").write_text(
        CLI_CONFIG + "ModelParams = dict(render_process=True)\n")
    port = _free_port()
    got, errors = [], []

    def client():
        try:
            for _ in range(600):
                try:
                    sock = socket.create_connection(("127.0.0.1", port), 5)
                    break
                except OSError:
                    threading.Event().wait(0.05)
            sock.settimeout(120)
            for i in itertools.count():
                train = i >= 4
                try:
                    sock.sendall(_request(32, 24, train=train,
                                          keep_alive=train, theta=0.1 * i))
                    got.append(tgui.recv_reply(sock, 32, 24))
                except ConnectionError:     # the run ended
                    break
            sock.close()
        except Exception as e:          # reported by the main thread
            errors.append(e)

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    summary = ttrain.main([
        "-s", str(scene), "-m", str(tmp_path / "model"), "--configs",
        str(scene / "cli.py"), "--device", "cpu", "--image_size", "32", "32",
        "--quiet", "--gui", "--ip", "127.0.0.1", "--port", str(port),
        "--test_iterations", "16"])
    thread.join(60)
    assert not thread.is_alive()
    assert not errors, errors
    assert [s["stage"] for s in summary["stages"]] == ["coarse", "fine"]
    assert summary["stages"][-1]["history"][-1]["iter"] == 16
    assert len(got) > 4 + 8      # served in both stages
    assert all(len(f) == 32 * 24 * 3 and v == str(scene) for f, v in got)
    assert any(len(set(f)) > 1 for f, _ in got)
    trip = read_jpeg(str(tmp_path / "model" / "train_render" / "finetest"
                         / "00016.jpg"))
    assert trip.shape == (32, 96, 3)
    assert math.isfinite(summary["stages"][-1]["history"][-1]["loss"])
