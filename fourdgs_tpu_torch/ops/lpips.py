"""LPIPS v0.1, the learned perceptual image patch similarity
(counterpart: fourdgs_tpu/ops/lpips.py).

The inputs are z-scored with LPIPS's shift and scale, run through the
VGG16 or AlexNet convolution stack, each tapped activation is normalised
to unit length over its channels, the squared differences are weighted by
the learned 1x1 "lin" weights, and averaged over space; the score is the
sum over the tapped levels.

The network is an `nn.Module` on NCHW images. Its weights come from a
plain npz with the JAX package's keys (`conv{i}/w` in OIHW, `conv{i}/b`,
`lin{l}/w`), which scripts/export_lpips_weights.py writes; the search
order is $FOURDGS_LPIPS_WEIGHTS, then <repo>/weights/lpips_{net}.npz.
The files are not in the repository (weights/README.md), and nothing
here fetches them. The convolutions run in full float32: cuDNN's default
TF32 keeps about three decimal digits, and a reported metric must not
depend on the card's default precision.
"""
from __future__ import annotations

import hashlib
import os
from collections.abc import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fourdgs_tpu_torch.utils.device import resolve_device

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision's .features children: the convolutions, the ReLUs whose
# outputs are tapped (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), the
# max pools before the last tap
VGG_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG_TAPS = (3, 8, 15, 22, 29)
VGG_POOLS = (4, 9, 16, 23)
VGG_CHANNELS = (64, 128, 256, 512, 512)

ALEX_CHANNELS = (64, 192, 384, 256, 256)
# AlexNet's five convolutions, each tapped after its ReLU (torchvision
# children 1, 4, 7, 9, 11): (stride, padding), and whether a 3x3 stride-2
# max pool precedes it
_ALEX_CONVS = ((4, 2, False), (1, 2, True), (1, 1, True), (1, 1, False),
               (1, 1, False))


def default_weights_path(net: str = "vgg") -> str:
    env = os.environ.get("FOURDGS_LPIPS_WEIGHTS")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "weights", f"lpips_{net}.npz")


def load_weights(net: str = "vgg", path: str | None = None
                 ) -> dict[str, np.ndarray] | None:
    """The npz's arrays, or None when there is no weight file. A
    `<path>.sha256` sidecar, where present, must match the file."""
    path = path or default_weights_path(net)
    if not os.path.exists(path):
        return None
    side = path + ".sha256"
    if os.path.exists(side):
        with open(side) as f:
            want = f.read().split()[0].strip()
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise ValueError(
                f"LPIPS weights checksum mismatch for {path}: expected "
                f"{want[:16]}..., got {got[:16]}...; re-export with "
                f"scripts/export_lpips_weights.py")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _unit(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit length over the channels (dim 1)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS distance per batch item between two (B, 3, H, W) images in
    [0, 1] (the range the reference's metrics feed it)."""

    def __init__(self, params: Mapping[str, np.ndarray], net: str = "vgg"):
        super().__init__()
        if net not in ("vgg", "alex"):
            raise ValueError(f"unknown LPIPS network {net!r}")
        self.net = net
        n_convs = len(VGG_CONVS) if net == "vgg" else len(_ALEX_CONVS)
        channels = VGG_CHANNELS if net == "vgg" else ALEX_CHANNELS

        def tensor(key):
            return torch.from_numpy(np.array(params[key], np.float32))

        self.weights = nn.ParameterList(
            nn.Parameter(tensor(f"conv{i}/w"), requires_grad=False)
            for i in range(n_convs))
        self.biases = nn.ParameterList(
            nn.Parameter(tensor(f"conv{i}/b"), requires_grad=False)
            for i in range(n_convs))
        self.lins = nn.ParameterList(
            nn.Parameter(tensor(f"lin{lvl}/w").reshape(-1),
                         requires_grad=False)
            for lvl in range(len(channels)))
        self.register_buffer("shift",
                             torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale",
                             torch.tensor(_SCALE).reshape(1, 3, 1, 1))

    def _conv(self, x, i, stride=1, padding=1):
        return F.relu(F.conv2d(x, self.weights[i], self.biases[i],
                               stride=stride, padding=padding))

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The unit-normalised activations at the taps."""
        feats = []
        if self.net == "vgg":
            child = 0                   # torchvision child index
            for i in range(len(VGG_CONVS)):
                if child in VGG_POOLS:
                    x = F.max_pool2d(x, 2, 2)
                    child += 1
                x = self._conv(x, i)
                child += 2              # the conv and its ReLU
                if child - 1 in VGG_TAPS:
                    feats.append(_unit(x))
            return feats
        for i, (stride, padding, pool) in enumerate(_ALEX_CONVS):
            if pool:
                x = F.max_pool2d(x, 3, 2)
            x = self._conv(x, i, stride, padding)
            feats.append(_unit(x))
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            fx = self.features((x - self.shift) / self.scale)
            fy = self.features((y - self.shift) / self.scale)
        score = x.new_zeros(x.shape[0])
        for lin, a, b in zip(self.lins, fx, fy):
            d = (a - b) ** 2                              # (B, C, H, W)
            score = score + torch.einsum("bchw,c->b", d, lin) / (
                d.shape[2] * d.shape[3])
        return score


def make_lpips_fn(net: str = "vgg", path: str | None = None,
                  device: str | torch.device | None = None
                  ) -> Callable[[np.ndarray, np.ndarray], float] | None:
    """A function of two (H, W, 3) images in [0, 1] (numpy) -> the LPIPS
    distance as a float, on `device` (None: cuda), or None when the
    weights are absent."""
    params = load_weights(net, path)
    if params is None:
        return None
    dev = resolve_device(device)
    model = LPIPS(params, net).to(dev).eval()

    def nchw(im):
        return torch.from_numpy(np.asarray(im, np.float32)).to(dev).permute(
            2, 0, 1)[None]

    @torch.no_grad()
    def run(r, g):
        return float(model(nchw(r), nchw(g))[0])
    return run
