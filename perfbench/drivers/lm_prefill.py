"""Drive LM prefill through ``serve_lm``, as a service answering long
prompts does up to the first token.

A closed loop of back-to-back batches of ``batch`` requests through
``repro_torch.launch.serve_lm.prefill`` (K4 for attention, K5 for the
Mamba2 scan): each batch holds prompts of one length, the lengths taken
in turn from the mix's ``lengths`` starting where ``--seed`` put the
cycle (``families/lm.pool``), the cache sized for ``decode_tokens`` more
positions.  A request's latency runs from its batch's send to its first
greedy token on the host.  The window runs whole cycles: it ends with
the cycle during which ``--seconds`` elapse, so that every length is in
it equally often and the median does not hang on where the cycle
started.  Set-up runs one batch at every length.

For the check, :class:`Tap` keeps ``sample_calls`` requests of distinct
batches (a seeded reservoir over the window's batches, one request of
each): the cache slice of that request, its first token and that token's
logits, all on the device.  The slices go into caches made at set-up
for the longest prompt, so that the device memory the run holds does
not depend on which requests were kept.  After the window,
:meth:`Tap.records` decodes ``decode_tokens`` greedy tokens for each
through ``serve_lm.decode`` from that cache and hands the tokens and
their logits to the family's check.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import Window


def _copy_request(dst, src, r: int) -> None:
    """Request ``r`` of a batched cache tree (stacked leaves: the batch
    is dim 1) into the leading part of a batch-1 cache tree ``dst``."""
    if isinstance(src, dict):
        for k, v in src.items():
            _copy_request(dst[k], v, r)
        return
    part = src[:, r:r + 1]
    dst[tuple(slice(0, n) for n in part.shape)].copy_(part)


class Tap:
    """Up to ``k`` requests of distinct batches of the armed window,
    chosen by reservoir sampling with ``seed``."""

    def __init__(self, driver, k: int, seed: int, max_len: int):
        self.driver = driver
        self.k = int(k)
        self._rng = np.random.default_rng(np.random.SeedSequence(
            [int(seed), 5]))
        self.armed = False
        self.batches = 0
        self.kept: Dict[int, Dict[str, object]] = {}
        self.caches = [driver.model.init_cache(1, max_len)
                       for _ in range(self.k)]

    def offer(self, j: int, tok, logits, cache) -> None:
        """Batch at pool index ``j`` has prefilled."""
        if not self.armed:
            return
        n = self.batches
        self.batches += 1
        slot = n if n < self.k else int(self._rng.integers(0, n + 1))
        if slot >= self.k:
            return
        r = int(self._rng.integers(0, tok.shape[0]))
        _copy_request(self.caches[slot], cache, r)
        self.kept[slot] = {"j": j, "r": r, "tok": tok[r:r + 1].clone(),
                           "logits": logits[r, -1].clone(),
                           "cache": self.caches[slot]}

    def records(self) -> List[Dict[str, np.ndarray]]:
        """The kept requests, each decoded on from its cache: prompt,
        ``tokens`` (the first and the decoded ones) and their ``logits``
        (one row per token), on the host, in slot order."""
        d = self.driver
        out = []
        for s in sorted(self.kept):
            rec = self.kept[s]
            prompt = d.pool["prompts"][rec["j"]][rec["r"]]
            toks, lg, _ = d.serve_lm.decode(
                d.model, d.params, rec["tok"], rec["cache"], len(prompt),
                d.decode_tokens)
            out.append({
                "prompt": np.asarray(prompt),
                "tokens": torch.cat([rec["tok"], toks[0]]).cpu().numpy(),
                "logits": torch.cat([rec["logits"][None], lg[0]])
                .float().cpu().numpy()})
        self.kept.clear()
        return out


class Driver:
    def __init__(self, ctx, params, pool):
        from repro_torch.launch import serve_lm
        from repro_torch.models.lm import LMModel

        mix = ctx.traffic
        self.serve_lm = serve_lm
        self.model = LMModel(ctx.family.arch_config(ctx.config), ctx.device)
        self.dev = self.model.device
        self.params = ctx.family.nest(params)
        self.pool = pool
        self.decode_tokens = int(mix["decode_tokens"])
        self.prompts = [torch.from_numpy(p).to(self.dev)
                        for p in pool["prompts"]]
        self.n = len(self.prompts)
        self.start = int(pool["start"])
        self.tap = Tap(self, int(ctx.cell["sample_calls"]), ctx.seed,
                       max(p.shape[1] for p in self.prompts)
                       + self.decode_tokens)
        for j in range(self.n):               # every shape of the cycle
            self._step(j)

    def _step(self, j: int):
        """One batch at pool index ``j``: its first tokens on the host."""
        x = self.prompts[j]
        tok, logits, cache = self.serve_lm.prefill(
            self.model, self.params, x, x.shape[1] + self.decode_tokens)
        self.tap.offer(j, tok, logits, cache)
        del logits, cache
        return tok.cpu().numpy()

    def window(self, seconds: float, tracer) -> Window:
        from repro_torch import kernels

        self.tap.armed = True
        launched = kernels.launch_counts()
        lat: List[float] = []
        served: List = []
        lengths: List[int] = []
        in_slice: List[int] = []
        t0 = time.perf_counter()
        end = t0 + seconds
        tracer.plan(t0, seconds)
        k = 0
        while True:
            now = time.perf_counter()
            if now >= end and k % self.n == 0:
                break
            # every batch ends on the host, so the slice holds whole ones
            tracer.tick(now)
            j = (self.start + k) % self.n
            b, n = self.prompts[j].shape
            if tracer.active:
                in_slice.append(n)
            t = time.perf_counter()
            toks = self._step(j)
            done = time.perf_counter()
            lat.extend([done - t] * b)
            served.extend((j * b + r, int(toks[r])) for r in range(b))
            lengths.append(n)
            k += 1
        t1 = time.perf_counter()
        tracer.finish()
        self.tap.armed = False
        per = {name: (n - launched[name]) / max(k, 1)
               for name, n in kernels.launch_counts().items()}
        return Window(attempted=len(served), failed=0, served=served,
                      seconds=t1 - t0, latencies_s=lat, batches=k,
                      stats={"prefill_lengths": lengths,
                             "slice_lengths": in_slice,
                             "batch": int(self.prompts[0].shape[0])},
                      notes={"prefill": f"{k} batches ({k // self.n} "
                                        f"cycles) in {t1 - t0:.3f} s",
                             "launches per prefill": (
                                 f"K4 {per['flash_attention_padded']}, "
                                 f"K5 {per['ssd_chunk']}")})

    def close(self) -> None:
        del self.model, self.params, self.prompts
        self.tap.kept.clear()
        self.tap.caches.clear()

