"""The SIBR remote-viewer TCP bridge
(counterpart: fourdgs_tpu/viewer/network_gui.py).

Speaks the 3DGS network-GUI wire protocol, so that any SIBR-protocol
client can watch a model while it trains or is served: a request is a
4-byte little-endian length and then JSON (resolution, fields of view,
near/far, the row-major view and view-projection matrices with their Y
and Z columns flipped, and the train / keep_alive / scaling_modifier
fields); the reply is the frame's H * W * 3 bytes, (clip(x, 0, 1) * 255)
truncated to uint8, then the length-prefixed verify string.

The caller's render function draws the frame on the device; this module
owns the sockets and the camera decoding. The camera is a data.camera.
Camera on the bridge's device, and a frame that comes back as a tensor is
turned into bytes on its device, so that only the bytes cross to the
host. With no client connected, a poll is one non-blocking `accept`: it
touches no tensor.
"""
from __future__ import annotations

import json
import socket
import traceback
from typing import NamedTuple

import numpy as np
import torch

from fourdgs_tpu_torch.data.camera import Camera, f32_tensor
from fourdgs_tpu_torch.utils.device import resolve_device


class GuiRequest(NamedTuple):
    camera: Camera | None
    width: int
    height: int
    do_training: bool
    do_shs_python: bool
    do_rot_scale_python: bool
    keep_alive: bool
    scaling_modifier: float


def frame_bytes(image) -> bytes:
    """An (H, W, 3) float frame in [0, 1] as the reply's bytes:
    (clip(x, 0, 1) * 255) truncated to uint8, row-major. A tensor is
    converted on its device and only the bytes are copied to the host."""
    if isinstance(image, torch.Tensor):
        u8 = (torch.clamp(image.detach(), 0, 1) * 255).to(torch.uint8)
        return u8.cpu().numpy().tobytes()
    return (np.clip(np.asarray(image), 0, 1) * 255).astype(
        np.uint8).tobytes()


class NetworkGui:
    def __init__(self, device: str | torch.device | None = None):
        """`device` (None: cuda) is where the requests' cameras live."""
        self.device = resolve_device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.conn = None
        self.addr = None

    def init(self, host: str = "127.0.0.1", port: int = 6009):
        """Bind and listen (a failed bind raises)."""
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)

    def close(self):
        self.disconnect()
        self.listener.close()

    def try_connect(self):
        if self.conn is not None:
            return
        try:
            self.conn, self.addr = self.listener.accept()
            print(f"\nConnected by {self.addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self, time: float = 0.0) -> GuiRequest:
        msg = self._read()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return GuiRequest(None, 0, 0, False, False, False, False, 1.0)
        try:
            # the client sends transposed matrices: flip the Y and Z
            # columns and transpose into the column-vector convention
            view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
            view[:, 1] = -view[:, 1]
            view[:, 2] = -view[:, 2]
            full = np.array(msg["view_projection_matrix"],
                            np.float32).reshape(4, 4)
            full[:, 1] = -full[:, 1]
            w2c = view.T
            cam_center = np.linalg.inv(w2c)[:3, 3]
            dev = self.device
            camera = Camera(
                world_view=f32_tensor(w2c, dev),
                full_proj=f32_tensor(full.T, dev),
                cam_center=f32_tensor(cam_center, dev),
                tanfovx=f32_tensor(np.tan(msg["fov_x"] * 0.5), dev),
                tanfovy=f32_tensor(np.tan(msg["fov_y"] * 0.5), dev),
                time=f32_tensor(time, dev))
        except Exception:
            traceback.print_exc()
            raise
        return GuiRequest(
            camera=camera, width=width, height=height,
            do_training=bool(msg["train"]),
            do_shs_python=bool(msg["shs_python"]),
            do_rot_scale_python=bool(msg["rot_scale_python"]),
            keep_alive=bool(msg["keep_alive"]),
            scaling_modifier=float(msg["scaling_modifier"]))

    def send_image(self, image, verify: str):
        """image: an (H, W, 3) float frame in [0, 1] (a tensor or an
        array), or None."""
        if image is not None:
            self.conn.sendall(frame_bytes(image))
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self):
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        self.conn = None

    def poll(self, render_fn, source_path: str, time: float = 0.0,
             training_done: bool = False) -> bool:
        """One training-loop poll: serve as many frames as the client asks
        for, `render_fn(camera, width, height, scaling_modifier)` drawing
        each; a request with `train` set ends the poll unless training is
        done and the client keeps it alive. Returns True to go on
        training."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                req = self.receive(time=time)
                img = None
                if req.camera is not None:
                    img = render_fn(req.camera, req.width, req.height,
                                    req.scaling_modifier)
                self.send_image(img, source_path)
                if req.do_training and (not training_done
                                        or not req.keep_alive):
                    break
            except Exception as e:
                print(e)
                self.disconnect()
        return True


def request_bytes(width: int, height: int, fov_x: float, fov_y: float,
                  view_matrix, view_projection_matrix, train: bool = False,
                  keep_alive: bool = False, scaling_modifier: float = 1.0,
                  znear: float = 0.01, zfar: float = 100.0) -> bytes:
    """One request as a client sends it: the 4-byte little-endian length
    and the JSON, the matrices row-major as given (16 floats each)."""
    msg = json.dumps({
        "resolution_x": int(width), "resolution_y": int(height),
        "train": bool(train), "fov_y": float(fov_y), "fov_x": float(fov_x),
        "z_near": float(znear), "z_far": float(zfar),
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": bool(keep_alive),
        "scaling_modifier": float(scaling_modifier),
        "view_matrix": [float(x) for x in np.ravel(view_matrix)],
        "view_projection_matrix": [float(x) for x in
                                   np.ravel(view_projection_matrix)]})
    data = msg.encode("utf-8")
    return len(data).to_bytes(4, "little") + data


def client_matrices(camera: Camera) -> tuple[np.ndarray, np.ndarray]:
    """The (view, view-projection) matrices a client sends for `camera`,
    so that `NetworkGui.receive` decodes the same camera: the inverse of
    its transpose and column flips."""
    w2c = camera.world_view.detach().cpu().numpy().astype(np.float32)
    full = camera.full_proj.detach().cpu().numpy().astype(np.float32)
    view = w2c.T.copy()
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    proj = full.T.copy()
    proj[:, 1] = -proj[:, 1]
    return view, proj


def recv_reply(sock: socket.socket, width: int, height: int) -> tuple:
    """Read one reply on a client socket: (the frame's bytes, or b"" for a
    zero-size request, the verify string)."""
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("bridge closed")
            buf += chunk
        return buf

    frame = exact(width * height * 3) if width and height else b""
    n = int.from_bytes(exact(4), "little")
    return frame, exact(n).decode("ascii")
