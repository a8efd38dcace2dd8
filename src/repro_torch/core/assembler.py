"""Auto-configuration flow, left branch (paper Fig. 4): model description
-> general IR -> microcode program.

The paper's Python parser resolves a model description file layer by layer
into microcode; weights are normalized separately (right branch — see
``core.bfp`` and ``FCNEngine.normalize_weights``).  Here the "model
description" is a list of :class:`LayerSpec` (what the paper calls the
*general model description*), produced by the backbone/fusion spec emitters in
``models/fcn``.

Address allocation (paper §III.B):
  * every layer output is a region in external memory, assigned by a bump
    allocator (the DDR4 data pool);
  * concatenation is expressed by allocating the producers *adjacent* so
    the consumer reads one combined extent — no copy, no concat op;
  * residual connections use the ``res_op`` cache/add register (Fig. 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .microcode import (
    ExtOp,
    Kernel,
    KERNEL_CODES,
    LayerType,
    Microcode,
    ResOp,
)

# storage dtype in the data pool is FP16 (paper §III.E)
STORAGE_BYTES = 2
ADDR_ALIGN = 64          # AXI burst alignment


@dataclasses.dataclass
class LayerSpec:
    """One node of the general model description."""

    name: str
    op: str                              # conv|pool|upsample|sigmoid|add|
                                         # identity|input|ext:<opname>
    inputs: Sequence[str] = ()
    out_ch: int = 0
    kernel: int = 1
    stride: int = 1
    relu: bool = False
    bn: bool = False                     # batch-norm (folded at normalize)
    bias: bool = True
    res: str = "none"                    # none|cache|add
    pool_kind: str = "max"               # max|avg (pool layers)
    upsample_mode: str = "fused"         # fused|nearest (upsample layers)
    table: Optional[Dict[str, Any]] = None   # ext-op hyperparameters
    ext_op: Optional[ExtOp] = None


@dataclasses.dataclass
class Program:
    """Assembled program: microcode words + side tables + bindings."""

    words: List[Microcode]
    tables: List[Dict[str, Any]]
    weight_bindings: Dict[int, str]      # word index -> parameter name
    layer_specs: Dict[int, LayerSpec]    # word index -> originating spec
    input_addr: int
    input_shape_chw: Tuple[int, int, int]    # (C, H, W) of the input plane
    outputs: Dict[str, int]              # output name -> address
    addr_shapes: Dict[int, Tuple[int, int, int]]   # addr -> (H, W, C)
    arena_bytes: int

    def disassemble(self) -> str:
        from .microcode import disassemble

        return disassemble(self.words)


def _align(addr: int) -> int:
    return (addr + ADDR_ALIGN - 1) // ADDR_ALIGN * ADDR_ALIGN


def _region_bytes(h: int, w: int, c: int) -> int:
    return _align(h * w * c * STORAGE_BYTES)


class Assembler:
    """Resolves a LayerSpec graph into a :class:`Program`.

    Shapes are propagated from the input plane so every microcode word
    carries the height/width/channel hyperparameters of Table II.
    """

    def __init__(self, input_shape_hwc: Tuple[int, int, int]):
        self.input_shape = input_shape_hwc

    # -- shape rules ---------------------------------------------------------
    @staticmethod
    def _out_shape(spec: LayerSpec, h: int, w: int, c: int) -> Tuple[int, int, int]:
        if spec.op == "conv":
            s = spec.stride
            return (-(-h // s), -(-w // s), spec.out_ch)
        if spec.op == "pool":
            s = spec.stride
            return (-(-h // s), -(-w // s), c)
        if spec.op == "upsample":
            return (2 * h, 2 * w, spec.out_ch or c)
        if spec.op in ("sigmoid", "identity", "add"):
            return (h, w, spec.out_ch or c)
        raise ValueError(f"unknown FCN op {spec.op!r}")

    def assemble(
        self, specs: Sequence[LayerSpec], outputs: Sequence[str]
    ) -> Program:
        by_name = {s.name: s for s in specs}
        order = list(specs)

        # ---- pass 1: concat groups --------------------------------------
        # a layer consuming >1 input reads them as one extent; producers in
        # the group must be allocated adjacently, in input order.
        group_of: Dict[str, Tuple[str, int]] = {}
        for s in order:
            if s.op == "add":
                continue                       # binary op, not a concat
            if len(s.inputs) > 1:
                for slot, p in enumerate(s.inputs):
                    if p in group_of and group_of[p][0] != s.name:
                        raise ValueError(
                            f"{p} feeds two concat groups; insert an "
                            f"identity copy layer"
                        )
                    group_of[p] = (s.name, slot)

        # ---- pass 2: allocation + emission -------------------------------
        h0, w0, c0 = self.input_shape
        cursor = 0
        input_addr = cursor
        cursor += _region_bytes(h0, w0, c0)
        addr_of: Dict[str, int] = {"input": input_addr}
        shape_of: Dict[str, Tuple[int, int, int]] = {"input": (h0, w0, c0)}
        addr_shapes: Dict[int, Tuple[int, int, int]] = {
            input_addr: (h0, w0, c0)
        }
        # concat groups get a contiguous region allocated when their first
        # producer is emitted:
        group_base: Dict[str, int] = {}

        words: List[Microcode] = []
        tables: List[Dict[str, Any]] = []
        bindings: Dict[int, str] = {}
        spec_of: Dict[int, LayerSpec] = {}

        def alloc_out(spec: LayerSpec, shp) -> int:
            nonlocal cursor
            h, w, c = shp
            if spec.name in group_of:
                gname, slot = group_of[spec.name]
                consumer = by_name[gname]
                if gname not in group_base:
                    # allocate the whole concat extent now, packed tight
                    # (concat is along channels; members share H, W)
                    total = 0
                    for p in consumer.inputs:
                        ph, pw, pc = self._infer_shape(p, by_name, shape_of)
                        total += ph * pw * pc * STORAGE_BYTES
                    base = _align(cursor)
                    group_base[gname] = base
                    cursor = base + _align(total)
                # member offset = sum of earlier members' *unaligned* bytes
                off = 0
                for p in consumer.inputs[:slot]:
                    ph, pw, pc = self._infer_shape(p, by_name, shape_of)
                    off += ph * pw * pc * STORAGE_BYTES
                return group_base[gname] + off
            base = _align(cursor)
            cursor = base + _region_bytes(h, w, c)
            return base

        for spec in order:
            ins = list(spec.inputs) or ["input"]
            ih, iw, ic = shape_of[ins[0]]
            if len(ins) > 1:
                for p in ins[1:]:
                    ph, pw, pc = shape_of[p]
                    if (ph, pw) != (ih, iw):
                        raise ValueError(
                            f"{'add' if spec.op == 'add' else 'concat'} "
                            f"into {spec.name}: H/W mismatch "
                            f"{(ph, pw)} vs {(ih, iw)}"
                        )
                    if spec.op == "add":
                        # binary add reads TWO same-shape operands (the
                        # second via ext_addr2), never a combined extent
                        # — channels must match, not sum
                        if pc != ic:
                            raise ValueError(
                                f"add into {spec.name}: channel mismatch "
                                f"{pc} vs {ic}"
                            )
                    else:          # concat read: channels sum, H/W match
                        ic += pc
            in_addr = addr_of[ins[0]]

            if spec.op.startswith("ext:") or spec.ext_op is not None:
                ext = spec.ext_op or ExtOp[spec.op.split(":", 1)[1].upper()]
                oshape = (ih, iw, spec.out_ch or ic)
            else:
                ext = ExtOp.NONE
                oshape = self._out_shape(spec, ih, iw, ic)
            out_addr = alloc_out(spec, oshape)

            layer_type = {
                "conv": LayerType.CONV,
                "pool": LayerType.POOL,
                "upsample": LayerType.UPSAMPLE,
            }.get(spec.op, LayerType.EXT)
            if layer_type == LayerType.EXT and ext == ExtOp.NONE:
                ext = {
                    "sigmoid": ExtOp.SIGMOID,
                    "add": ExtOp.ADD,
                    "identity": ExtOp.IDENTITY,
                }[spec.op]

            tbl_idx = 0
            if spec.table:
                tables.append(dict(spec.table))
                tbl_idx = len(tables)        # 1-based; 0 = no table

            # pool convention: code 0 -> 2x2, code 1 -> 3x3 (Table II's
            # kernel field only encodes {1,3,7}; the pool unit treats
            # code 0 as its native 2x2 window).  Anything else must
            # fail HERE: an unencodable kernel that silently snapped to
            # a nearby code would assemble fine and compute the wrong
            # thing.
            if spec.op == "pool":
                if spec.kernel not in (2, 3):
                    raise ValueError(
                        f"{spec.name}: pool kernel {spec.kernel} not "
                        f"encodable (the pool unit supports 2x2 and 3x3)"
                    )
                kernel_code = 0 if spec.kernel == 2 else 1
            elif spec.op == "conv" and spec.kernel not in KERNEL_CODES:
                raise ValueError(
                    f"{spec.name}: conv kernel {spec.kernel} not "
                    f"encodable (Table II encodes "
                    f"{sorted(KERNEL_CODES)})"
                )
            else:
                kernel_code = int(KERNEL_CODES.get(spec.kernel, Kernel.K1))

            mc = Microcode(
                layer_type=int(layer_type),
                transpose_relu=(0b01 if spec.relu else 0),
                in_ch=min(ic, (1 << 16) - 1),
                out_ch=min(oshape[2], (1 << 16) - 1),
                height=min(ih, (1 << 20) - 1),
                width=min(iw, (1 << 15) - 1),
                kernel=kernel_code,
                stride=1 if spec.stride == 2 else 0,
                res_op=int(ResOp[spec.res.upper()]),
                in_addr=in_addr,
                out_addr=out_addr,
                ext_opcode=int(ext),
                ext_table_idx=tbl_idx,
                ext_addr2=addr_of[ins[1]] if (spec.op == "add" and len(ins) > 1) else 0,
            ).validate()

            idx = len(words)
            words.append(mc)
            spec_of[idx] = spec
            if (
                spec.op == "conv"
                or (spec.op == "upsample" and spec.upsample_mode == "fused")
                or ext in (ExtOp.EMBED, ExtOp.ATTN, ExtOp.CROSS_ATTN,
                           ExtOp.GLU_MLP, ExtOp.MLP, ExtOp.MOE, ExtOp.SSD,
                           ExtOp.CONV1D, ExtOp.LM_HEAD, ExtOp.RMSNORM,
                           ExtOp.LAYERNORM)
            ):
                bindings[idx] = spec.name

            addr_of[spec.name] = out_addr
            shape_of[spec.name] = oshape
            addr_shapes[out_addr] = oshape

        return Program(
            words=words,
            tables=tables,
            weight_bindings=bindings,
            layer_specs=spec_of,
            input_addr=input_addr,
            input_shape_chw=(c0, h0, w0),
            outputs={o: addr_of[o] for o in outputs},
            addr_shapes=addr_shapes,
            arena_bytes=cursor,
        )

    def _infer_shape(self, name, by_name, shape_of):
        if name in shape_of:
            return shape_of[name]
        # forward-shape inference for not-yet-emitted concat members:
        spec = by_name[name]
        ins = list(spec.inputs) or ["input"]
        h, w, c = self._infer_shape(ins[0], by_name, shape_of)
        if len(ins) > 1 and spec.op != "add":      # add: channels match
            for p in ins[1:]:
                c += self._infer_shape(p, by_name, shape_of)[2]
        return self._out_shape(spec, h, w, c) if not (
            spec.op.startswith("ext:") or spec.ext_op
        ) else (h, w, spec.out_ch or c)
