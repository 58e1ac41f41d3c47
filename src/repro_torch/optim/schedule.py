"""LR schedules.  WSD (warmup-stable-decay) is the minicpm-2b paper's
schedule [arXiv:2404.06395]: linear warmup, long stable plateau, short
(~10%) exponential/linear decay.

Counterpart of ``repro/optim/schedule.py``.  Each schedule maps a step (an
int or an integer tensor) to a 0-dim fp32 tensor, computed in fp32 as the
reference computes it, on the step's device.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def linear_schedule(peak_lr: float, warmup: int, total: int):
    def lr(step):
        s = _step(step)
        warm = s / max(warmup, 1)
        decay = torch.clamp((total - s) / max(total - warmup, 1), min=0.0)
        return peak_lr * torch.where(s < warmup, warm, decay)
    return lr


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    def lr(step):
        s = _step(step)
        warm = s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return peak_lr * torch.where(s < warmup, warm, cos)
    return lr


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_fraction: float = 0.1, min_ratio: float = 0.01):
    """Warmup -> Stable (peak) -> Decay (last decay_fraction of steps)."""
    decay_start = int(total * (1.0 - decay_fraction))
    # the reference takes this log in fp32 (jnp.log of a Python float)
    log_min = torch.log(torch.tensor(max(min_ratio, 1e-6),
                                     dtype=torch.float32))

    def lr(step):
        s = _step(step)
        warm = s / max(warmup, 1)
        t = torch.clamp((s - decay_start) / max(total - decay_start, 1),
                        0.0, 1.0)
        decay = torch.exp(log_min.to(s.device) * t)
        val = torch.where(s < warmup, warm,
                          torch.where(s < decay_start, 1.0, decay))
        return peak_lr * val
    return lr


def for_arch(arch_name: str, peak_lr: float, warmup: int, total: int):
    """minicpm trains with WSD (its paper's contribution); others cosine."""
    if "minicpm" in arch_name:
        return wsd_schedule(peak_lr, warmup, total)
    return cosine_schedule(peak_lr, warmup, total)
