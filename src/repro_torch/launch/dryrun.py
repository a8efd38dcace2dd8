"""The dry run: build and run EVERY (architecture x input shape x mesh)
cell's step on the meta device, with stand-ins for every argument, so
that no parameter is ever allocated and no card is needed.

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --mesh 1x1
    python -m repro_torch.launch.dryrun --all --mesh 1x1 2x4

``--mesh`` takes mesh shapes over ("data", "model"), each a host mesh
whose slots are all ``"meta"``; ``--smoke`` runs the archs' smoke
configs, whose records say ``"smoke": true`` and whose tags end in
``__smoke``, so that a full sweep's ``--skip-existing`` never takes one
for a full cell.  The step is ``launch/step_fns.build_step``'s, called with the
arguments placed in pieces per ``arg_shardings`` (a decode step's
``cache_len`` is the deepest, ``seq_len - 1``).  Per cell we record into
``reports/dryrun_torch/<arch>__<shape>__<mesh>[__smoke].json``:

  * ``memory.argument_size_bytes``: bytes per slot of the arguments
    (params, optimizer state, batch, cache), each leaf's bytes over the
    slots its spec splits it across; the counterpart of XLA's
    ``argument_size_in_bytes``, which is what each device of the
    reference's mesh holds (the one controller keeps one copy of a piece
    where the reference replicates it over the axes its spec leaves
    out);
  * ``memory.temp_size_bytes``: the bytes of the tensors autograd saves
    for the backward (``torch.autograd.graph.saved_tensors_hooks``), each
    storage once, the arguments' storages left out, over the data slots
    that compute a share of the batch; the counterpart of
    ``temp_size_in_bytes``.  A serving step saves nothing, so its
    transient activations are not counted;
  * ``memory.output_size_bytes``: the outputs that do not alias an
    argument, per slot: a train step's new params and optimizer state in
    the arguments' pieces (the update builds them beside the old), a
    serving step's logits, tokens and a prefill's new cache on the first
    slot; the counterpart of ``output_size_in_bytes``;
  * ``flops``: the step's matmul FLOPs (``FlopCounterMode``; forward,
    backward and remat's recomputation), the counterpart of
    ``cost_analysis()["flops"]``; ``flops_per_device`` is their even
    share over the mesh's slots;
  * ``aten_op_histogram``: the 15 aten ops the step dispatches most
    (``TorchDispatchMode``) and ``aten_ops``, their total, which
    predicts the step's launch count on the card, the counterpart of
    the reference's ``hlo_op_histogram``;
  * ``n_params`` and ``param_bytes`` of the parameter tree
    (``models.lm.params.count_params`` / ``param_bytes``);
  * ``tensors_off_meta``: tensors the step made anywhere but on the meta
    device (0: nothing was allocated).

A cell that ``configs.shape_applicable`` rules out records the
reference's ``status="skipped"`` and reason; a failing cell records
``status="error"`` with its traceback, and ``main`` then exits 1.

What does not carry over: lowering and compile times (nothing is
compiled), HLO collective bytes (``launch/hlo_analysis.py`` parses XLA's
HLO text, and one controller moves pieces by ``.to()``), bytes accessed,
generated-code and alias sizes, and the reference's ``--unroll``
analysis compile (a Python layer loop is counted layer by layer
already).  ``launch/hlo_analysis.py`` has no counterpart in the port.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig, get_config,
                                 get_smoke_config, shape_applicable)
from repro_torch.core import tree as tree_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.step_fns import build_step
from repro_torch.models.lm import params as params_lib
from repro_torch.runtime import sharding as shd

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")
MESH_AXES = ("data", "model")
TOP_OPS = 15
CARD_BYTES = 80 * 2**30        # one H100's device memory


def parse_mesh(text: str) -> Tuple[int, ...]:
    """``"2x4"`` -> (2, 4)."""
    try:
        shape = tuple(int(n) for n in text.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != len(MESH_AXES) or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: expected DATAxMODEL, as 2x4")
    return shape


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched and the tensors made off meta."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.off_meta = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[func.overloadpacket.__name__] += 1
        for t in tree_lib.leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.off_meta += 1
        return out


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2·b·m·n·k for both overloads of ``aten.bmm``: the library's own
    formula takes the ``out_dtype`` overload's dtype (the card's bf16
    expert matmuls, ``layers.low_precision_matmul``) for an output
    shape."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return s._cdata, s


def _storages(tree) -> Dict[int, Any]:
    """Each distinct storage of the tensors in ``tree``, by address."""
    return dict(_storage(t) for t in tree_lib.leaves(tree)
                if isinstance(t, torch.Tensor))


def account(fn, *args, keep=()) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` (on meta tensors): (its result, what it did):
    its matmul ``flops``, the ``saved_bytes`` autograd keeps for the
    backward (each storage once, the storages of the tensors in ``keep``
    left out), the aten ops it dispatches (``aten_ops``, and the
    ``aten_op_histogram`` of the most frequent) and the
    ``tensors_off_meta`` it makes."""
    kept = _storages(list(keep))
    saved: Dict[int, Any] = {}

    def pack(t):
        key, s = _storage(t)
        if key not in kept:
            saved[key] = s          # holding it keeps its address unique
        return t

    ops = _OpCounter()
    flop_counter = FlopCounterMode(
        display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flop})
    with flop_counter, ops, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*args)
    return out, {
        "flops": flop_counter.get_total_flops(),
        "saved_bytes": sum(s.nbytes() for s in saved.values()),
        "aten_ops": sum(ops.ops.values()),
        "aten_op_histogram": dict(ops.ops.most_common(TOP_OPS)),
        "tensors_off_meta": ops.off_meta}


def _slot_bytes(args, shardings) -> int:
    """Bytes per slot of ``args``: each leaf's bytes over the slots its
    spec splits it across."""
    total = 0
    for leaf, sh in zip(tree_lib.leaves(args), tree_lib.leaves(shardings),
                        strict=True):
        sizes = shd.mesh_axis_sizes(sh.mesh)
        n = math.prod(sizes[a] for a in shd.named_axes(sh.spec))
        b = leaf.numel() * leaf.element_size()
        if b % n:
            raise ValueError(f"a leaf of {tuple(leaf.shape)} does not split "
                             f"over {sh.spec}")
        total += b // n
    return total


def _placed(built, kind: str) -> list:
    """The step's arguments with the parameters (and a train step's
    optimizer moments) in the pieces their shardings give, as a previous
    step returns them; the batch and a cache stay whole, as the step
    takes them."""
    args = list(built.abstract_args)
    args[0] = shd.place_tree(args[0], built.arg_shardings[0])
    if kind == "train":
        opt, sh = args[1], built.arg_shardings[1]
        args[1] = opt._replace(mu=shd.place_tree(opt.mu, sh.mu),
                               nu=shd.place_tree(opt.nu, sh.nu))
    return args


def _mesh_tag(shape: Tuple[int, ...]) -> str:
    return "x".join(str(n) for n in shape)


def _tag(arch: str, shape: str, mesh: Tuple[int, ...], smoke: bool) -> str:
    """A cell's report name: ``<arch>__<shape>__<mesh>[__smoke]``."""
    return f"{arch}__{shape}__{_mesh_tag(mesh)}" + ("__smoke" if smoke
                                                    else "")


def run_cell(arch: str, shape: Union[str, ShapeConfig], *,
             mesh: Union[str, Tuple[int, ...]] = "1x1",
             report_dir: str = REPORT_DIR, verbose: bool = True,
             smoke: bool = False,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             **build_kw) -> Dict[str, Any]:
    """One cell: ``shape`` a name of ``configs.SHAPES`` or a ShapeConfig,
    ``mesh`` a shape over ("data", "model") (``"2x4"`` or (2, 4)).
    Returns the record it writes to ``report_dir``."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_shape = parse_mesh(mesh) if isinstance(mesh, str) else tuple(mesh)
    tag = _tag(arch, shape.name, mesh_shape, smoke)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": _mesh_tag(mesh_shape),
        "n_devices": math.prod(mesh_shape), "smoke": smoke,
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        _write(report_dir, tag, rec)
        if verbose:
            print(f"[dryrun] {tag}: SKIP ({reason})")
        return rec

    t0 = time.time()
    try:
        m = make_host_mesh(mesh_shape, MESH_AXES, device="meta")
        built = build_step(cfg, m, shape, **build_kw)
        args = _placed(built, shape.kind)
        if shape.kind == "decode":
            args[-1] = shape.seq_len - 1          # the deepest cache
        arg_bytes = _slot_bytes(built.abstract_args, built.arg_shardings)
        out, acct = account(built.fn, *args, keep=tree_lib.leaves(args))
        flops, saved_bytes = acct["flops"], acct["saved_bytes"]
        if shape.kind == "train":
            # the new params and optimizer state, in the arguments' pieces
            out_bytes = _slot_bytes(built.abstract_args[:2],
                                    built.arg_shardings[:2])
        else:
            # on the first slot; a decode step's cache is its argument's
            held = _storages(args)
            out_bytes = sum(s.nbytes() for k, s in _storages(out).items()
                            if k not in held)
        params = built.abstract_args[0]
        rec.update(
            status="ok",
            run_s=round(time.time() - t0, 2),
            step_kind=built.meta.get("kind"),
            flops=flops,
            flops_per_device=flops / rec["n_devices"],
            memory={
                "argument_size_bytes": arg_bytes,
                "temp_size_bytes":
                    saved_bytes // built.meta.get("data_slots", 1),
                "output_size_bytes": out_bytes,
            },
            saved_bytes=saved_bytes,
            n_params=params_lib.count_params(params),
            param_bytes=params_lib.param_bytes(params),
            aten_ops=acct["aten_ops"],
            aten_op_histogram=acct["aten_op_histogram"],
            tensors_off_meta=acct["tensors_off_meta"],
        )
        if verbose:
            mem = rec["memory"]
            per_slot = mem["argument_size_bytes"] + mem["temp_size_bytes"]
            print(f"[dryrun] {tag}: OK  flops={flops:.3e}  "
                  f"args/slot={arg_bytes / 2**30:.2f}GiB  "
                  f"saved={saved_bytes / 2**30:.2f}GiB  "
                  f"mem/slot~{per_slot / 2**30:.2f}GiB  "
                  f"ops={rec['aten_ops']}  ({rec['run_s']:.1f}s)")
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug; record it
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[dryrun] {tag}: ERROR {type(e).__name__}: {e}")
    _write(report_dir, tag, rec)
    return rec


def _write(report_dir: str, tag: str, rec: Dict[str, Any]):
    os.makedirs(report_dir, exist_ok=True)
    with open(os.path.join(report_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", nargs="+", default=["1x1"],
                    help="mesh shapes over (data, model), as 1x1 2x4")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [parse_mesh(m) for m in args.mesh]

    n_bad, rows = 0, []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = _tag(arch, shape, mesh, args.smoke)
                path = os.path.join(args.report_dir, f"{tag}.json")
                rec = None
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"[dryrun] {tag}: cached")
                    else:
                        rec = None
                if rec is None:
                    rec = run_cell(arch, shape, mesh=mesh, smoke=args.smoke,
                                   report_dir=args.report_dir)
                if rec["status"] == "error":
                    n_bad += 1
                rows.append(_row(tag, rec))
    print("| cell | status | GiB per slot | fits the card's 80 GiB |")
    print("|---|---|---|---|")
    print("\n".join(rows))
    print(f"[dryrun] done, {n_bad} failed cells")
    raise SystemExit(1 if n_bad else 0)


def _row(tag: str, rec: Dict[str, Any]) -> str:
    """A markdown row: status, bytes per slot (arguments, saved for the
    backward, outputs) and whether they fit one card."""
    if rec["status"] != "ok":
        return f"| {tag} | {rec['status']} | | |"
    per_slot = sum(rec["memory"].values())
    fits = "yes" if per_slot <= CARD_BYTES else "no"
    return f"| {tag} | ok | {per_slot / 2**30:.2f} | {fits} |"


if __name__ == "__main__":
    main()
