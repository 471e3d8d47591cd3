"""Learning-rate schedules (counterpart: fourdgs_tpu/ops/schedule.py).

Log-linear exponential decay with an optional sine delay ramp, computed
in float32 tensor ops in the JAX package's order, so that a schedule
evaluated at a step held on the device needs no host sync.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> torch.Tensor:
    """The lr at `step` (a tensor or a Python number), as float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    # float32 logs made on the host as Python numbers: a tensor made on
    # the host and copied to the card would cost a sync per step
    log_init = float(np.log(np.float32(lr_init)))
    log_final = float(np.log(np.float32(lr_final)))
    log_lerp = torch.exp(log_init * (1 - t) + log_final * t)
    return torch.where(step < 0, torch.zeros_like(step),
                       delay_rate * log_lerp)


def make_expon_lr(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                  max_steps=1000000):
    def fn(step):
        return expon_lr(step, lr_init, lr_final, lr_delay_steps,
                        lr_delay_mult, max_steps)
    return fn
