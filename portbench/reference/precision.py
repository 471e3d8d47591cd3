"""Matrix products of the reference in its two precisions.

"fp32": float32 products with TF32 off, the precision the port states
(fourdgs_tpu_torch/render/serve.py:_full_float32 turns TF32 off).
"tf32": the control, the next precision below: each operand of every
product that PyTorch routes through a GEMM rounded to TF32 (8 exponent
bits, 10 mantissa bits, round to nearest even), accumulated in float32,
which is what a tensor core does with `allow_tf32`. The backward's
products round the same way. The rounding is done here, so the control
reads the same on the CPU and on the card.
"""
from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -8192).view(torch.float32)


class _Tf32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g.contiguous())
        ga = g @ tf32_round(b).transpose(-1, -2)
        gb = tf32_round(a).transpose(-1, -2) @ g
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in `precision`."""
    if precision == "fp32":
        return a @ b
    if precision == "tf32":
        return _Tf32MatMul.apply(a, b)
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           precision: str) -> torch.Tensor:
    """x @ weight.T + bias, weight stored (out, in) as nn.Linear's."""
    return matmul(x, weight.t(), precision) + bias


def full_float32() -> None:
    """TF32 off for every product PyTorch runs in the process, as the port
    sets it for serving (and as PyTorch's default leaves matrix products);
    run.py sets it before a cell starts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
