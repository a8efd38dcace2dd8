"""What the timed path produced, kept for the check that decides
``correct``.

The program hands a served request back as boxes only.  To judge the
forward pass and the CC labelling as well, :class:`Tap` wraps two public
callables of the objects the harness was handed, for the run's life:
each engine model's ``apply`` (images in, the head's maps out) and the
engine factory's ``label_tail`` (maps in, label maps out).  Both run in
the engine call the window times, one after the other on one thread.
For a seeded reservoir sample of the window's engine calls the tap keeps
references to the tensors that call produced (logits, score, links,
labels, convergence flags, the valid sizes) and a strided sample of its
input images, by which each batch slot is matched to its pool image once
the window has closed.  Nothing crosses to the host or waits in the
window: a kept call costs one small strided copy on the device.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

STRIDE = 16            # pixels between the sampled points of an image


def fingerprint(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> (N, H/STRIDE, W/STRIDE, 3): the values at a grid."""
    return images[:, ::STRIDE, ::STRIDE, :].clone()


class Tap:
    """Keeps up to ``k`` of the armed window's engine calls, chosen by
    reservoir sampling with ``seed``."""

    def __init__(self, factory, models, k: int, seed: int):
        self.k = int(k)
        self._rng = np.random.default_rng(np.random.SeedSequence(
            [int(seed), 4]))
        self._lock = threading.Lock()
        self._local = threading.local()
        self.armed = False
        self.calls = 0
        self.kept: Dict[int, Dict[str, torch.Tensor]] = {}
        tail = factory.label_tail

        def label_tail(score, links, valid_q):
            out = tail(score, links, valid_q)
            rec = getattr(self._local, "pending", None)
            if rec is not None and rec["score"] is score:
                self._local.pending = None
                rec.update(valid_q=valid_q, labels=out[0], converged=out[1])
                with self._lock:
                    self.kept[rec.pop("slot")] = rec
            return out

        factory.label_tail = label_tail
        for model in models:
            self._wrap(model)

    def _wrap(self, model) -> None:
        apply = model.apply

        def tapped(params, images, **kw):
            out = apply(params, images, **kw)
            slot = self._choose()
            if slot is not None:
                self._local.pending = {
                    "slot": slot, "fp": fingerprint(images),
                    "logits": out["logits"], "score": out["score"],
                    "links": out["links"]}
            return out

        model.apply = tapped

    def _choose(self) -> Optional[int]:
        with self._lock:
            if not self.armed:
                return None
            n = self.calls
            self.calls += 1
            if n < self.k:
                return n
            j = int(self._rng.integers(0, n + 1))
            return j if j < self.k else None

    def arm(self) -> None:
        with self._lock:
            self.armed = True

    def disarm(self) -> None:
        with self._lock:
            self.armed = False

    def records(self) -> List[Dict[str, np.ndarray]]:
        """The kept calls, on the host, in slot order."""
        with self._lock:
            kept = [self.kept[s] for s in sorted(self.kept)]
        return [{k: v.detach().cpu().numpy() for k, v in rec.items()}
                for rec in kept]
