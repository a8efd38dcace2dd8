"""Device meshes for the execution plans, and the card's datasheet rates.

A :class:`Mesh` is an ndarray of ``torch.device`` slots with one name per
axis (``("data", "model")`` for the serving plans).  One process drives
every slot: the executor (``runtime/executor.py``) splits a batch over
the "data" axis and image rows over the "model" axis and moves tensors
between slots with ``.to(device)``, so nothing here needs
``torch.distributed``.

:func:`make_mesh` takes the visible CUDA devices and raises when there
are fewer than the shape needs.  :func:`make_host_mesh` repeats one
device in every slot, the counterpart of a forced host device count: the
CPU tests run 2- and 4-band plans on ``"cpu"`` and a one-card machine on
``"cuda:0"``.  Slots that share a device run one after another on it;
their halo copies are plain copies.

The rates below are one NVIDIA H100 SXM's datasheet figures (dense, no
sparsity, at the full power limit of 700 W); a card set to a lower
``power.limit`` runs slower under load.  They are the defaults of the
cost model (``runtime/planner.CostParams``), which a fit on measured
steps replaces (``runtime/telemetry.fit_cost_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# NVIDIA H100 SXM datasheet, dense rates at a 700 W power limit
PEAK_FLOPS_BF16 = 989e12        # FLOP/s on the tensor cores
HBM_BW = 3.35e12                # B/s, 80 GB of HBM3
NVLINK_BW = 900e9               # B/s to the other cards of the host, all
                                # to all (450 GB/s each way)


def canonical_device(device) -> torch.device:
    """``device`` as a torch.device with its CUDA index filled in, so
    that ``"cuda"`` and ``"cuda:0"`` compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object ndarray of ``torch.device``, one dimension
    per axis name.  Two meshes of the same devices in the same layout are
    equal and hash alike: the plans that hold a mesh key the engine LRU."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")

    def _key(self):
        return (self.devices.shape, self.axis_names,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_at(self, **index: int) -> torch.device:
        """The device of the slot at ``index`` (axis name -> position;
        axes left out take position 0)."""
        unknown = set(index) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh {self.axis_names} has no axes "
                             f"{sorted(unknown)}")
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]


def _build(shape, axes, devices: Sequence) -> Mesh:
    shape = tuple(int(s) for s in shape)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [canonical_device(d) for d in devices]
    return Mesh(arr.reshape(shape), tuple(axes))


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over distinct CUDA devices: ``devices`` or the
    first ``prod(shape)`` visible cards.  Raises when there are fewer
    cards than slots."""
    need = int(np.prod(shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise RuntimeError(
                f"mesh {tuple(shape)} needs {need} CUDA devices, "
                f"{have} visible; use make_host_mesh to put several slots "
                f"on one device")
        devices = [torch.device("cuda", i) for i in range(need)]
    if len(devices) != need:
        raise ValueError(f"mesh {tuple(shape)} needs {need} devices, got "
                         f"{len(devices)}")
    return _build(shape, axes, devices)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), *,
                   device) -> Mesh:
    """A mesh of ``shape`` with ``device`` in every slot (``"cpu"`` in the
    tests, ``"cuda:0"`` on one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           f"torch.cuda.is_available() is False")
    return _build(shape, axes, [dev] * int(np.prod(shape)))
