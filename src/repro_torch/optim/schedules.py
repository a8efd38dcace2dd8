"""Learning-rate schedules: pure functions of the step counter (a 0-dim
integer tensor) that return a 0-dim f32 tensor on the step's device,
in the reference's f32 arithmetic."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=F32,
                                     device=torch.as_tensor(step).device)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        s = torch.as_tensor(step).to(F32)
        return lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return f


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       final_ratio: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).to(F32)
        warm = lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (s - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        # the f32 argument's cosine rounded once to f32 (PyTorch's f32
        # cosine can miss by an ulp)
        c = torch.cos((math.pi * prog).to(torch.float64)).to(F32)
        cos = final_ratio + (1 - final_ratio) * 0.5 * (1 + c)
        return torch.where(s < warmup_steps, warm, lr * cos)
    return f
