"""Device selection for the port's entry points.

Every entry point (``STDService``, ``EngineFactory``, ``DetectionModel``)
takes ``device="cuda"`` by default and runs on the card; a caller that
wants the CPU passes ``device="cpu"``.  Asking for the card on a machine
without one raises: nothing falls back silently.

TF32 is switched off here, for matmuls and for cuDNN convolutions alike.
The reference computes true f32 (``preferred_element_type=f32``), and
PyTorch would otherwise run f32 convolutions through TF32 tensor cores,
which keep about three decimal digits.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
