"""Microcode interpreter: the paper's FCN module (Fig. 5) in torch ops.

The hardware parses one microcode word per layer and drives fixed
datapath units (conv / pool / upsample / post-process) against a DDR4
data pool.  Here the data pool is an *arena* dict keyed by the words'
address fields and the datapath units are chosen by ``mode``:

    mode="reference"  plain convolutions (the oracle)
    mode="optimized"  Winograd F(4x4, 3x3) for stride-1 3x3 convs and the
                      phase-decomposed fused upsample

With ``use_kernels=True`` the optimized datapath runs the CUDA kernels:
every stride-1 3x3 conv through K1 (``kernels/winograd_conv``), and in
BFP precision every 1x1 stride-1 conv through K2 (``kernels/bfp_matmul``).
On CPU tensors those wrappers run their plain torch versions.

The walk is differentiable in the plain datapaths, as the reference's
``apply`` is under ``jax.grad``: training runs ``mode="reference"``.
The kernels have no backward, so their wrappers refuse tensors that
require grad, and the serving layers (``EngineFactory``'s engines,
``drive_bands``, ``STDService``, LM prefill and decode) run under
``torch.no_grad()``.

Row-banded execution (paper §IV.B across mesh slots): :meth:`FCNEngine.
walk` is the interpreter loop as a generator; on one band of a plane it
yields before every spatial layer whose window crosses band edges and
takes back its input extended by the neighbours' rows, so the executor
can drive the bands of a plane in lockstep and exchange rows between
yields.  Unbanded, it never yields.

BFP numerics (paper §III.E): with a :class:`BFPConfig`, conv inputs and
weights go through Algorithm 1 before the MAC, the accumulator stays f32,
and storage between layers is ``storage_dtype`` (FP16 in the paper).

:func:`build_stream_fn` runs the same ISA over the LM datapath modules
(``models/lm``): one microcode word per module, the residual through the
same cache/add register, BFP-stored weights widened at use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import bfp as bfp_lib
from . import fuse, winograd
from .assembler import Program, STORAGE_BYTES
from .microcode import ExtOp, LayerType, Microcode, ResOp
from .rowband import layer_halo


@dataclasses.dataclass(frozen=True)
class BFPConfig:
    block_size: int = bfp_lib.DEFAULT_BLOCK
    mantissa_bits: int = bfp_lib.DEFAULT_MANTISSA
    rounding: str = "trunc"
    wide_accum: bool = True


class FCNEngine:
    """Executes an assembled FCN :class:`Program` on NHWC tensors."""

    def __init__(self, program: Program, mode: str = "reference",
                 bfp: Optional[BFPConfig] = None,
                 storage_dtype=torch.float32, use_kernels: bool = False,
                 memplan=None, plane_bands: int = 1):
        if mode not in ("reference", "optimized"):
            raise ValueError(mode)
        if bfp is not None and not bfp.wide_accum:
            raise NotImplementedError("narrow BFP accumulation is not ported")
        self.program = program
        self.mode = mode
        self.bfp = bfp
        self.storage_dtype = storage_dtype
        self.use_kernels = use_kernels
        # the program runs one of ``plane_bands`` row bands of a plane:
        # K2 picks its K split from the whole plane's image rows, so a
        # band's rows get the bits the full plane gives them
        self.plane_bands = int(plane_bands)
        # memplan: None/False -> keep every buffer; True -> the static plan
        # of core.memplan (fusion facts, dead words, drop at last use)
        if memplan is True:
            from . import memplan as memplan_lib

            memplan = memplan_lib.plan_program(
                program,
                dtype_bytes=torch.tensor([], dtype=storage_dtype)
                .element_size())
        self.memplan = memplan or None

    # -- parameters ----------------------------------------------------------
    def init_params(self, generator: torch.Generator,
                    device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
        """He-normal weights drawn on the CPU from ``generator`` (so every
        device gets the same numbers), zero biases, identity BN."""
        def he(shape, fan_in):
            w = torch.randn(shape, generator=generator) * np.sqrt(2.0 / fan_in)
            return w.to(device)

        def const(v, n):
            return torch.full((n,), v, dtype=torch.float32, device=device)

        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for idx, name in self.program.weight_bindings.items():
            mc = self.program.words[idx]
            spec = self.program.layer_specs[idx]
            if spec.op == "conv":
                k, cin, cout = mc.kernel_size, mc.in_ch, mc.out_ch
                if spec.table and spec.table.get("depthwise"):
                    p = {"w": he((k, k, 1, cout), k * k)}
                else:
                    p = {"w": he((k, k, cin, cout), k * k * cin)}
                if spec.bias:
                    p["b"] = const(0.0, cout)
                if spec.bn:
                    p.update(gamma=const(1.0, cout), beta=const(0.0, cout),
                             mean=const(0.0, cout), var=const(1.0, cout))
                params[name] = p
            elif spec.op == "upsample" and spec.upsample_mode == "fused":
                cin, cout = mc.in_ch, mc.out_ch or mc.in_ch
                params[name] = {"w": he((3, 3, cin, cout), 9 * cin)}
        return params

    def normalize_weights(self, params):
        """Paper Fig. 4 right branch: fold BN, then BFP-normalize weights
        (blocked along Cin)."""
        out = {}
        for idx, name in self.program.weight_bindings.items():
            spec = self.program.layer_specs[idx]
            p = dict(params[name])
            if spec.op == "conv" and spec.bn:
                w, b = fuse.fold_batchnorm(p["w"], p.get("b"), p["gamma"],
                                           p["beta"], p["mean"], p["var"])
                p = {"w": w, "b": b}
            if self.bfp is not None and "w" in p:
                p["w"] = self._bfp_roundtrip(p["w"], axis=-2)
            out[name] = p
        return out

    def _bfp_roundtrip(self, x, axis):
        """The f32 value of ``x`` through BFP: on the card one launch of
        ``kernels/bfp_quantize``, reading ``x`` in its stored type."""
        from repro_torch.kernels.bfp_quantize import roundtrip

        return roundtrip(
            x.contiguous(), block_size=self.bfp.block_size,
            mantissa_bits=self.bfp.mantissa_bits, axis=axis,
            rounding=self.bfp.rounding)

    # -- datapath units -------------------------------------------------------
    def _runs_k2(self, mc: Microcode, spec) -> bool:
        """A 1x1 stride-1 conv in bfp precision with the optimized kernels
        is one K2 matmul."""
        depthwise = bool(spec.table and spec.table.get("depthwise"))
        return (self.bfp is not None and self.use_kernels
                and self.mode == "optimized" and not depthwise
                and mc.kernel_size == 1 and mc.stride_n == 1)

    def k2_shapes(self, batch: int):
        """(binding, M, K, N) of each K2 matmul one forward pass of a
        ``batch`` runs, in program order."""
        prog = self.program
        out = []
        for idx, mc in enumerate(prog.words):
            if (LayerType(mc.layer_type) == LayerType.CONV
                    and self._runs_k2(mc, prog.layer_specs[idx])
                    and (self.memplan is None
                         or idx in self.memplan.schedule)):
                h, w, _ = prog.addr_shapes[mc.out_addr]
                out.append((prog.weight_bindings.get(idx, str(idx)),
                            batch * h * w, mc.in_ch, mc.out_ch))
        return out

    def _runs_k1(self, mc: Microcode, spec) -> bool:
        """A stride-1 3x3 conv with the optimized kernels is one K1
        Winograd launch."""
        depthwise = bool(spec.table and spec.table.get("depthwise"))
        return (self.use_kernels and self.mode == "optimized"
                and not depthwise and mc.kernel_size == 3
                and mc.stride_n == 1)

    def k1_shapes(self, batch: int):
        """(binding, N, H, W, Cin, Cout) of each K1 conv one forward pass
        of a ``batch`` runs, in program order."""
        prog = self.program
        out = []
        for idx, mc in enumerate(prog.words):
            if (LayerType(mc.layer_type) == LayerType.CONV
                    and self._runs_k1(mc, prog.layer_specs[idx])
                    and (self.memplan is None
                         or idx in self.memplan.schedule)):
                h, w, _ = prog.addr_shapes[mc.out_addr]
                out.append((prog.weight_bindings.get(idx, str(idx)), batch,
                            h, w, mc.in_ch, mc.out_ch))
        return out

    def _conv(self, x, p, mc: Microcode, spec, *, transposed: bool = False,
              relu: bool = False):
        w = p["w"]
        b = p.get("b")
        depthwise = bool(spec.table and spec.table.get("depthwise"))
        if self._runs_k2(mc, spec):
            # a 1x1 conv is a matmul (transposing its kernel changes
            # nothing): K2 quantizes both operands along the contraction
            # dim (activations along channels, in their stored type, and
            # weights along Cin, the same blocking as the roundtrip below);
            # the K split is chosen for one image of the whole plane, so
            # every batch size and every band gives an image the same bits
            from repro_torch.kernels.bfp_matmul import bfp_matmul

            n, hh, ww, cin = x.shape
            y = bfp_matmul(
                x.reshape(-1, cin), w.reshape(cin, -1),
                block_size=self.bfp.block_size,
                mantissa_bits=self.bfp.mantissa_bits,
                rounding=self.bfp.rounding,
                split_rows=hh * ww * self.plane_bands,
            ).reshape(n, hh, ww, -1)
            return fuse.conv_epilogue(y, b, relu)
        if self.bfp is not None:
            x = self._bfp_roundtrip(x, axis=-1)
            # weights quantize in-call too (idempotent under trunc); the
            # blocks run along Cin, so they may be transposed after
            w = self._bfp_roundtrip(w, axis=-2)
        if transposed:
            # transposed-image mode: transpose the weight kernels too
            w = w.transpose(0, 1)
        x = x.to(torch.float32)
        w = w.to(torch.float32)
        if depthwise:
            y = fuse.conv2d_nhwc(x, w, mc.stride_n, "SAME", groups=mc.in_ch)
            return fuse.conv_epilogue(y, b, relu)
        if self._runs_k1(mc, spec):
            from repro_torch.kernels.winograd_conv import winograd_conv2d

            # bias + ReLU fused into K1's output-transform epilogue
            return winograd_conv2d(x, w, b, relu=relu)
        if self.mode == "optimized" and mc.kernel_size == 3 \
                and mc.stride_n == 1:
            y = winograd.winograd_conv2d(x, w, padding="SAME")
        else:
            y = fuse.conv2d_nhwc(x, w, mc.stride_n, "SAME")
        return fuse.conv_epilogue(y, b, relu)

    @staticmethod
    def _pool(x, mc: Microcode, spec):
        k = 2 if mc.kernel == 0 else 3
        return fuse.pool_nhwc(x, k, mc.stride_n, spec.pool_kind)

    def _upsample(self, x, p, spec, decomposed: Optional[bool] = None):
        if decomposed is None:
            decomposed = spec.upsample_mode != "nearest"
        if not decomposed:
            return fuse.upsample_nearest_2x(x)
        w = p["w"].to(torch.float32)
        x = x.to(torch.float32)
        if self.mode == "optimized":
            return fuse.upsample2x_conv3x3_fused(x, w)
        return fuse.upsample2x_conv3x3_naive(x, w)

    # -- row-banded spatial execution (paper §IV.B across mesh slots) --------
    @staticmethod
    def _spatial(banded: bool, x, k: int, s: int, op, out_scale: int = 1,
                 align: int = 1):
        """One spatial layer; on a band, first take rows from the other
        bands.  A generator: with ``banded`` and a window that crosses
        band edges it yields ``(x, halo, align)`` and takes back ``(ext,
        j)``: x extended by at least ``halo`` rows on each side, out to
        plane rows at multiples of ``align``
        (``runtime/collectives.halo_exchange``), and ``j``, where this
        band's own rows start in ``ext``.  It applies the op with its
        normal SAME padding and slices this band's output rows back out.
        Its value is the layer's output."""
        halo = layer_halo(k, s)
        if not banded or halo == 0:
            return op(x)
        bh = x.shape[1]
        ext, j = yield x, halo, align
        y = op(ext)
        j0 = j * out_scale // s
        return y[:, j0:j0 + bh * out_scale // s]

    # -- the interpreter loop -------------------------------------------------
    def walk(self, params, x: torch.Tensor, *, transposed: bool = False,
             banded: bool = False, trace=None):
        """The program over ``x`` as a generator whose value is the output
        dict.  Unbanded it never yields.  With ``banded``, ``x`` is one
        horizontal band of a larger plane and the walk yields ``(x,
        halo, align)`` before every spatial layer whose window crosses
        band edges, expecting ``x`` extended by the neighbouring bands'
        rows (zeros beyond the plane) in return (:meth:`_spatial`); a
        3x3 stride-1 conv asks for its extension to reach plane rows at
        multiples of the Winograd tile (4), so its tiles are the full
        plane's wherever the band starts.  The bands
        of one plane walk the program in lockstep: the executor advances
        one walk per band and exchanges rows between yields
        (``runtime/executor.py``).  ``trace(idx, y)``, when given, sees
        each word's stored output (a word walk of band against full
        plane)."""
        prog = self.program
        c0, h0, w0 = prog.input_shape_chw
        want = (w0, h0, c0) if transposed else (h0, w0, c0)
        if tuple(x.shape[1:]) != want:
            raise ValueError(f"input {tuple(x.shape)} != program plane {want}")
        arena: Dict[int, torch.Tensor] = {prog.input_addr: x}
        extents: Dict[int, int] = {prog.input_addr: h0 * w0 * c0 *
                                   STORAGE_BYTES}
        cache: Optional[torch.Tensor] = None

        def read(addr: int, want_ch: int) -> torch.Tensor:
            if addr in arena and arena[addr].shape[-1] == want_ch:
                return arena[addr]
            # concat read: memory-contiguous buffers from addr
            parts, cur, got = [], addr, 0
            while got < want_ch:
                if cur not in arena:
                    raise KeyError(f"read at {cur:#x}: no buffer (concat walk "
                                   f"from {addr:#x}, {got}/{want_ch} ch)")
                parts.append(arena[cur])
                got += arena[cur].shape[-1]
                cur += extents[cur]
            if got != want_ch:
                raise ValueError(f"concat channel mismatch {got}!={want_ch}")
            return torch.cat(parts, dim=-1)

        plan = self.memplan
        indices = plan.schedule if plan is not None else range(len(prog.words))
        for idx in indices:
            mc = prog.words[idx]
            wp = plan.word(idx) if plan is not None else None
            spec = prog.layer_specs[idx]
            xin = read(mc.in_addr, mc.in_ch)
            name = prog.weight_bindings.get(idx)
            p = params.get(name, {}) if name else {}
            lt = LayerType(mc.layer_type)
            fused_relu = False
            if lt == LayerType.CONV:
                eligible = (wp.fuse_relu if wp is not None
                            else fuse.can_fuse_conv_epilogue(mc))
                fused_relu = self.mode == "optimized" and eligible
                tiled = mc.kernel_size == 3 and mc.stride_n == 1
                y = yield from self._spatial(
                    banded, xin, mc.kernel_size, mc.stride_n,
                    lambda xb: self._conv(xb, p, mc, spec,
                                          transposed=transposed,
                                          relu=fused_relu),
                    align=winograd.TILE_OUT if tiled else 1)
            elif lt == LayerType.POOL:
                y = yield from self._spatial(
                    banded, xin, 2 if mc.kernel == 0 else 3, mc.stride_n,
                    lambda xb: self._pool(xb, mc, spec))
            elif lt == LayerType.UPSAMPLE:
                up_conv = (wp.fuse_upsample if wp is not None
                           else spec.upsample_mode != "nearest")
                y = yield from self._spatial(
                    banded, xin, 3 if up_conv else 1, 1,
                    lambda xb: self._upsample(xb, p, spec, up_conv),
                    out_scale=2)
            else:
                op = ExtOp(mc.ext_opcode)
                if op == ExtOp.SIGMOID:
                    y = torch.sigmoid(xin.to(torch.float32))
                elif op == ExtOp.ADD:
                    y = xin.to(torch.float32) + \
                        read(mc.ext_addr2, mc.in_ch).to(torch.float32)
                elif op == ExtOp.IDENTITY:
                    y = xin
                else:
                    raise NotImplementedError(
                        f"FCN engine does not implement {op!r}")
            if mc.res_op == ResOp.CACHE:
                cache = y
            elif mc.res_op == ResOp.ADD:
                assert cache is not None, "res add with empty cache register"
                y = y + cache
            if mc.relu and not fused_relu:
                y = torch.relu(y)
            # write back in storage precision (FP16 in the paper)
            y = y.to(self.storage_dtype)
            if trace is not None:
                trace(idx, y)
            if wp is None or wp.store:
                arena[mc.out_addr] = y
                h, w, c = prog.addr_shapes[mc.out_addr]
                extents[mc.out_addr] = h * w * c * STORAGE_BYTES
            if wp is not None:
                for a in wp.free_after:
                    arena.pop(a, None)
                    extents.pop(a, None)
                if wp.drop_cache:
                    cache = None
        return {k: arena[a] for k, a in prog.outputs.items()}

    def __call__(self, params, x: torch.Tensor, *, transposed: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """x: (N, H, W, C) matching the program's input plane (or its
        transpose with ``transposed=True``, paper §IV.B)."""
        return finish(self.walk(params, x, transposed=transposed))


def finish(walk):
    """The value of a walk that must not yield (an unbanded one)."""
    try:
        request = next(walk)
    except StopIteration as stop:
        return stop.value
    walk.close()
    raise RuntimeError(f"an unbanded walk asked for a halo exchange "
                       f"({request[1]} rows)")


# ---------------------------------------------------------------------------
# LM stream execution: the same ISA driving the transformer datapath
# modules (models/lm/layers.py).
# ---------------------------------------------------------------------------

# module signature: fn(params, x, *, mc, table, ctx) -> y
ModuleFn = Callable[..., torch.Tensor]


def _deq(p, ctx):
    """BFP-stored weights (serving mode) widen to the compute type at
    use; other leaves pass through."""
    if isinstance(p, bfp_lib.BFPTensor):
        return bfp_lib.dequantize(p).to(ctx.get("compute_dtype",
                                                torch.bfloat16))
    if isinstance(p, dict):
        return {k: _deq(v, ctx) for k, v in p.items()}
    return p


def build_stream_fn(words: Sequence[Microcode],
                    tables: Sequence[Dict[str, Any]],
                    registry: Dict[ExtOp, ModuleFn],
                    weight_bindings: Dict[int, str]):
    """Compile a microcode segment into ``fn(params, x, ctx) -> (y, ctx)``.

    ``params`` is a dict keyed by binding name.  The residual cache/add
    register is interpreted exactly as in :class:`FCNEngine`; pre-norm
    residuals are IDENTITY(cache) ... ATTN(add).  A transformer stack
    calls it once per layer with that layer's slice of the stacked
    parameters (models/lm/transformer.py).
    """
    words = list(words)

    def fn(params, x, ctx=None):
        ctx = {} if ctx is None else ctx
        cache = None
        cur = x
        for idx, mc in enumerate(words):
            op = ExtOp(mc.ext_opcode)
            name = weight_bindings.get(idx)
            p = params.get(name) if name else None
            if p is not None:
                p = _deq(p, ctx)
            table = tables[mc.ext_table_idx - 1] if mc.ext_table_idx else {}
            if op == ExtOp.IDENTITY:
                y = cur
            elif op == ExtOp.ADD:
                y = cur + (cache if cache is not None else 0)
            elif op in registry:
                y = registry[op](p, cur, mc=mc, table=table, ctx=ctx)
            else:
                raise NotImplementedError(f"no module registered for {op!r}")
            if mc.res_op == ResOp.CACHE:
                cache = y
            elif mc.res_op == ResOp.ADD and op != ExtOp.ADD:
                assert cache is not None, "res add with empty cache register"
                y = y + cache
            if mc.relu:
                y = torch.relu(y)
            cur = y
        return cur, ctx

    return fn
