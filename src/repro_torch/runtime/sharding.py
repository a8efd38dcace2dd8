"""Which tensor dims of the FCN serving activations split over which mesh
axis.

NHWC image planes and the quarter-resolution maps derived from them
(score, links, labels) share one layout decision: the batch dim over
``batch_axis`` (data-parallel plans, the paper's batch level) and/or the
row dim over ``rows_axis`` (row-band plans, paper §IV.B); the 2-D
GridPlan sets both.  :func:`fcn_activation_specs` states it per tensor
as a tuple with one entry per dim, an axis name or None (the dim stays
whole), the counterpart of a JAX PartitionSpec; the executor
(``runtime/executor.py``) splits and gathers by it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

Spec = Tuple[Optional[str], ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return mesh.axis_sizes()


def fcn_batch_axis(mesh, batch: int, axis: str = "data") -> Optional[str]:
    """The mesh axis an FCN batch can split over, or None (whole)."""
    n = mesh_axis_sizes(mesh).get(axis, 1)
    return axis if n > 1 and batch % n == 0 else None


def fcn_activation_specs(batch_axis: Optional[str] = None,
                         rows_axis: Optional[str] = None
                         ) -> Dict[str, Spec]:
    """Per tensor, the mesh axis each dim splits over.  Keys: "image"
    (N, H, W, C), "score" (N, h, w), "links" (N, h, w, 8), "labels"
    (N, h, w)."""
    return {
        "image": (batch_axis, rows_axis, None, None),
        "score": (batch_axis, rows_axis, None),
        "links": (batch_axis, rows_axis, None, None),
        "labels": (batch_axis, rows_axis, None),
    }


def split_dims(spec: Spec, axis: str) -> Tuple[int, ...]:
    """The dims of a tensor with ``spec`` that split over ``axis``."""
    return tuple(d for d, a in enumerate(spec) if a == axis)
