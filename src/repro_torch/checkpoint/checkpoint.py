"""Atomic, async checkpoints of parameter and optimizer trees, in the
reference's on-disk layout, so a checkpoint crosses between the two
packages bit for bit.

Layout:  <dir>/step_<N>/
             manifest.json        step, tree structure, each leaf's key,
                                  shape and dtype name, meta
             <leaf-key>.bin       one file of raw bytes per tree leaf

Leaf keys are the reference's (the paths of
``core/tree.flatten_with_paths`` with ``[``, ``]``, ``.`` and ``/`` made
``_``): a BFP moment is two leaves, its
mantissa and exponent.  bf16 leaves are written as their 16-bit
patterns under the dtype name ``bfloat16``.

  * ATOMIC: written to ``step_<N>.tmp-<pid>-<seq>``, fsynced, then
    ``os.rename``d; a crash mid-save never leaves a partial latest
    step, and a manager prunes the staging directories of dead writers
    when it starts.
  * ASYNC: ``save_checkpoint(..., blocking=False)`` copies every leaf to
    host memory before it returns and writes on a worker thread.
  * ELASTIC: ``restore_checkpoint(..., device=)`` puts each leaf on a
    device, or on the matching device of a tree of devices (one per
    mesh slot, ``launch/mesh.py``); without it a leaf lands on the
    device of the tree it is restored into.
  * EXACT: a round trip is bit-identical.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_lib

_STEP_RE = re.compile(r"^step_(\d+)$")
# unique staging suffixes: two writers of one step (an orphaned async
# write racing a post-restart save) never share a directory
_TMP_SEQ = itertools.count()

_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


def _leaf_key(path: str) -> str:
    return (path.replace("[", "_").replace("]", "_").replace("'", "")
            .replace(".", "_").replace("/", "_").strip("_")) or "leaf"


def _flatten_with_keys(tree):
    out = []
    seen: Dict[str, int] = {}
    for path, v in tree_lib.flatten_with_paths(tree):
        k = _leaf_key(path)
        if k in seen:
            seen[k] += 1
            k = f"{k}__{seen[k]}"
        else:
            seen[k] = 0
        out.append((k, v))
    return out


def _describe(tree) -> str:
    """The tree's structure with ``*`` for each leaf (the manifest's
    ``treedef``; restore does not read it)."""
    kids = tree_lib.children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{k}: {_describe(c)}" for k, c in kids)
    return f"{type(tree).__name__}({inner})"


def _to_host(v: torch.Tensor):
    """(numpy array, dtype name): one copy of the leaf in host memory,
    bf16 as its 16-bit patterns."""
    v = torch.as_tensor(v).detach()
    name = _NAMES.get(v.dtype)
    if name is None:
        raise TypeError(f"checkpoint: unsupported dtype {v.dtype}")
    if v.dtype == torch.bfloat16:
        v = v.view(torch.int16)
    return v.to("cpu", copy=True).numpy(), name


def _from_host(raw: bytes, name: str, shape) -> torch.Tensor:
    if name == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
    return torch.from_numpy(arr.copy())


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    blocking: bool = True,
                    extra_meta: Optional[Dict[str, Any]] = None
                    ) -> Optional[threading.Thread]:
    """Write ``tree`` at ``directory/step_<step>`` (atomic); with
    ``blocking=False`` the host copy is taken before returning and a
    worker thread, which is returned, writes it."""
    os.makedirs(directory, exist_ok=True)
    host = [(k, *_to_host(v)) for k, v in _flatten_with_keys(tree)]
    manifest = {
        "step": int(step),
        "treedef": _describe(tree),
        "leaves": [{"key": k, "shape": list(a.shape), "dtype": name}
                   for k, a, name in host],
        "meta": extra_meta or {},
    }
    tmp_suffix = f".tmp-{os.getpid()}-{next(_TMP_SEQ)}"

    def write():
        final = os.path.join(directory, f"step_{step}")
        tmp = final + tmp_suffix
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, a, _ in host:
            with open(os.path.join(tmp, f"{k}.bin"), "wb") as f:
                f.write(np.ascontiguousarray(a).tobytes())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _is_device(x) -> bool:
    return isinstance(x, (str, torch.device))


def _leaf_devices(like, device) -> List[Optional[torch.device]]:
    """One target device per leaf of ``like``: ``device`` itself, or the
    device at the matching node of a tree of devices (a device there
    covers every leaf below it)."""
    if device is None or _is_device(device):
        dev = None if device is None else torch.device(device)
        return [dev] * len(tree_lib.leaves(like))
    kids, dkids = tree_lib.children(like), tree_lib.children(device)
    if kids is None or dkids is None or \
            [k for k, _ in kids] != [k for k, _ in dkids]:
        raise ValueError("restore_checkpoint: the device tree does not "
                         "match the tree being restored")
    return [d for (_, c), (_, dc) in zip(kids, dkids)
            for d in _leaf_devices(c, dc)]


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       device: Any = None) -> Any:
    """The checkpoint at ``step`` in the structure of ``like`` (leaf keys
    and shapes checked).  ``device``: one device for every leaf, or a
    tree of devices matching ``like`` (the elastic restore onto other
    mesh slots); default each leaf's device in ``like``."""
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _flatten_with_keys(like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"model expects {len(leaves)}")
    devices = _leaf_devices(like, device)
    out = []
    for (k, ref), rec, dev in zip(leaves, manifest["leaves"], devices):
        if k != rec["key"]:
            raise ValueError(f"leaf order mismatch: {k} != {rec['key']}")
        with open(os.path.join(d, f"{k}.bin"), "rb") as f:
            t = _from_host(f.read(), rec["dtype"], rec["shape"])
        ref_shape = tuple(torch.as_tensor(ref).shape)
        if tuple(t.shape) != ref_shape:
            raise ValueError(f"{k}: checkpoint shape {tuple(t.shape)} != "
                             f"model {ref_shape}")
        if dev is None:
            dev = torch.as_tensor(ref).device
        out.append(t.to(dev))
    return tree_lib.unflatten(like, out)


class CheckpointManager:
    """Retention (keep the newest ``keep``), latest-step discovery,
    auto-resume and one in-flight async write at a time."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        # reclaim staging directories of crashed writers: their suffixes
        # are never reused (one writer per directory)
        for name in os.listdir(directory):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def save(self, step: int, tree: Any, *, blocking: bool = False,
             extra_meta=None) -> None:
        self.wait()
        self._pending = save_checkpoint(self.directory, step, tree,
                                        blocking=blocking,
                                        extra_meta=extra_meta)
        if blocking:
            self._pending = None
        self._gc()

    def restore_latest(self, like, *, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like,
                                        device=device)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
