"""LR schedules (pure functions of the step counter).

The counterpart of the JAX package's ``optim/schedule.py``: float32
tensors, computed as the reference computes them (``jnp.minimum``,
``jnp.clip``, ``jnp.cos`` of ``jnp.pi * t`` in float32). A tensor step keeps
its device; an int step gives a CPU tensor.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_with_warmup", "constant"]


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_with_warmup(step, *, peak: float, warmup: int, total: int, floor: float = 0.1):
    step = _f32(step)
    warm = peak * torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    pi = torch.tensor(math.pi, dtype=torch.float32)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(pi * t)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, peak: float, **_):
    return torch.tensor(peak, dtype=torch.float32,
                        device=step.device if isinstance(step, torch.Tensor) else None)
