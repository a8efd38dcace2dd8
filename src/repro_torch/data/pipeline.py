"""Host data pipeline for LM training.

``TokenDataset`` is a synthetic pretraining stream with two properties a
production loader needs:

  * step-indexed determinism: ``batch(step)`` is a pure function of
    (seed, step, host_id), drawn with NumPy from
    ``SeedSequence([seed, step, host_id])``, so a resumed job reads
    exactly the stream it would have read, and the batches are bit-equal
    to the JAX package's;
  * host sharding: each host draws only its slice of the global batch.

``Prefetcher`` is a double-buffered host-to-device feed: a thread puts the
next batches on the device while the current step runs (the paper's
ping-pong input buffer, C4, at the host boundary).  On a CUDA device each
batch goes from pinned memory to the card on a side stream, and the
consumer's stream waits on that copy's event before it reads the batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.core import tree as tree_lib


class TokenDataset:
    """Synthetic autoregressive data with learnable structure (a noisy
    repeat-copy language), so small models visibly learn."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                 structure: str = "repeat"):       # repeat|uniform
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id
        self.structure = structure

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens", "labels"}`` (local_batch, seq_len) integer
        arrays, of the reference's types; labels are the tokens shifted
        left, -1 at the last position."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.local_batch, self.seq_len, self.vocab
        if self.structure == "uniform":
            toks = rng.integers(0, v, size=(b, s), dtype=np.int32)
        else:
            # repeat-copy: period-p repetition plus 10% noise
            period = rng.integers(3, 8, size=(b, 1))
            base = rng.integers(0, v, size=(b, 8), dtype=np.int32)
            idx = np.arange(s)[None, :] % period
            toks = np.take_along_axis(base, idx, axis=1).astype(np.int32)
            noise = rng.random((b, s)) < 0.1
            toks = np.where(noise, rng.integers(0, v, size=(b, s)), toks)
        labels = np.concatenate(
            [toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Depth-``depth`` prefetch of a stream of trees of arrays, each leaf
    put on ``device`` as a tensor."""

    def __init__(self, it: Iterator[Any], *, depth: int = 2, device="cpu"):
        self._it = it
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda \
            else None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _transfer(self, item):
        """(tree on the device, the copy's event or None)."""
        host = tree_lib.tree_map(lambda a: torch.as_tensor(np.asarray(a)),
                                 item)
        if not self._cuda:
            return tree_lib.tree_map(lambda t: t.to(self._device), host), None
        with torch.cuda.stream(self._stream):
            dev = tree_lib.tree_map(
                lambda t: t.pin_memory().to(self._device, non_blocking=True),
                host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(self._transfer(item))
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        tree, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            # the copies were allocated on the side stream: tell the
            # allocator the consumer's stream uses them too
            for t in tree_lib.leaves(tree):
                t.record_stream(consumer)
        return tree
