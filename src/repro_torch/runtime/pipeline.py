"""Host pipelining: the paper's C4 module-level multithreading on the
host, which ``STDService.serve_pipelined`` runs as preprocess / device
inference / box postprocess stages.  (The JAX package's mesh pipeline,
``pipeline_apply``, is not ported yet.)
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Sequence


class HostPipeline:
    """The paper's C4 module-level multithreading on host: a chain of
    stages connected by bounded queues, one thread per stage, so stage i
    of item n overlaps stage i+1 of item n-1 (serve.py's preprocess /
    device-infer / CC-postprocess chain is the motivating instance).

    ``stages`` are ``fn(item) -> item``; ``run`` preserves input order.
    A stage exception propagates to the caller and stops the pipeline.
    """

    def __init__(self, stages: Sequence[Callable[[Any], Any]],
                 maxsize: int = 4):
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = list(stages)
        self.maxsize = maxsize

    def run(self, items: Sequence[Any]) -> List[Any]:
        n_stages = len(self.stages)
        qs = [queue.Queue(maxsize=self.maxsize) for _ in range(n_stages + 1)]
        results: List[Any] = [None] * len(items)
        errors: List[BaseException] = []
        abort = threading.Event()        # a stage error must unwind EVERY
                                         # thread, not just downstream ones

        def _put(q, item) -> bool:
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def _get(q):
            """Item, or None sentinel, or False once aborted+drained."""
            while True:
                try:
                    return q.get(timeout=0.05)
                except queue.Empty:
                    if abort.is_set():
                        return False

        def feeder():
            for i, item in enumerate(items):
                if not _put(qs[0], (i, item)):
                    return
            _put(qs[0], None)

        def worker(si: int):
            fn = self.stages[si]
            while True:
                got = _get(qs[si])
                if got is False:
                    return
                if got is None:
                    _put(qs[si + 1], None)
                    return
                i, item = got
                try:
                    out = fn(item)
                except Exception as e:
                    errors.append(e)
                    abort.set()
                    return
                if not _put(qs[si + 1], (i, out)):
                    return

        def sink():
            while True:
                got = _get(qs[n_stages])
                if got is False or got is None:
                    return
                i, item = got
                results[i] = item

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [
            threading.Thread(target=worker, args=(si,), daemon=True)
            for si in range(n_stages)
        ]
        threads.append(threading.Thread(target=sink, daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
