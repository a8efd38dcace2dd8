"""256-bit microcode ISA — bit-exact implementation of paper Table II.

The paper configures a fixed FCN datapath with one 256-bit microcode word
per layer (width aligned to the AXI bus).  Field layout (LSB first), from
Table II:

    =============  =====  =========================================
    field          bits   meaning
    =============  =====  =========================================
    layer_type     2      0=conv 1=pool 2=upsample 3=null/extended
    transpose_relu 2      bit0 = relu enable, bit1 = transpose mode
    in_ch          16     input channels
    out_ch         16     output channels
    height         20     feature-map height (rows)
    width          15     feature-map width (<= 4096 in the paper)
    kernel         2      0 -> 1x1, 1 -> 3x3, 2 -> 7x7
    stride         1      0 -> 1,   1 -> 2
    res_op         2      0=none 1=cache result 2=add cached result
    in_addr        34     input buffer address (external memory)
    out_addr       34     output buffer address
    reserved       112    (extension page, below)
    =============  =====  =========================================

Layer interconnection is carried entirely by the address fields: each
layer writes its output at ``out_addr`` and the next layer reads from its
``in_addr``; *concatenation* is expressed by allocating two producers at
adjacent addresses and letting the consumer read the combined extent
(paper SSIII-B).  Residual blocks use ``res_op`` (1 = cache, 2 = add the
cached tensor; Fig. 3).

Extension page
--------------
The paper reserves 112 bits.  We use them — exactly as reserved fields
are meant to be used — to extend the same ISA to transformer / SSM
"datapath modules" so that *every* architecture in this framework is
driven by the one interpreter (the paper's versatility axis):

    =============  =====  =========================================
    ext field      bits   meaning (within the 112 reserved bits)
    =============  =====  =========================================
    ext_opcode     8      ExtOp below; 0 keeps plain Table II meaning
    ext_table_idx  16     index into the program's parameter side-table
                          (for hyperparameters too wide for the fields,
                          e.g. vocab 163840 > 2**16; the paper likewise
                          keeps weights out-of-band in DDR4)
    ext_addr2      34     second input address (binary ops: add/concat/
                          cross-attention memory)
    ext_flags      16     op-specific flags
    (unused)       38     still reserved
    =============  =====  =========================================
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, List, Sequence, Tuple

import numpy as np

MICROCODE_BITS = 256
MICROCODE_BYTES = MICROCODE_BITS // 8

# (name, bitwidth) in LSB-first order — Table II verbatim, reserved split
# into the extension page.
_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("layer_type", 2),
    ("transpose_relu", 2),
    ("in_ch", 16),
    ("out_ch", 16),
    ("height", 20),
    ("width", 15),
    ("kernel", 2),
    ("stride", 1),
    ("res_op", 2),
    ("in_addr", 34),
    ("out_addr", 34),
    # --- 112 reserved bits ---
    ("ext_opcode", 8),
    ("ext_table_idx", 16),
    ("ext_addr2", 34),
    ("ext_flags", 16),
    ("reserved", 38),
)

assert sum(w for _, w in _FIELDS) == MICROCODE_BITS


class LayerType(enum.IntEnum):
    CONV = 0
    POOL = 1
    UPSAMPLE = 2
    EXT = 3          # the paper's "null" type doubles as our escape


class Kernel(enum.IntEnum):
    K1 = 0           # 1x1
    K3 = 1           # 3x3
    K7 = 2           # 7x7


KERNEL_SIZES = {Kernel.K1: 1, Kernel.K3: 3, Kernel.K7: 7}
KERNEL_CODES = {1: Kernel.K1, 3: Kernel.K3, 7: Kernel.K7}


class ResOp(enum.IntEnum):
    NONE = 0
    CACHE = 1        # cache layer result (residual branch entry)
    ADD = 2          # add cached result (residual branch exit)


class ExtOp(enum.IntEnum):
    """Extended datapath modules (reserved-page opcodes)."""

    NONE = 0
    # --- FCN fusion-module extras (paper: sigmoid replaces maxpool) ---
    SIGMOID = 1
    ADD = 2          # explicit elementwise add of in_addr + ext_addr2
    CONCAT = 3       # explicit concat marker (normally implied by addrs)
    IDENTITY = 4
    # --- transformer / LM datapath modules ---
    EMBED = 16       # token embedding lookup
    RMSNORM = 17
    LAYERNORM = 18
    ATTN = 19        # GQA attention with RoPE (self)
    CROSS_ATTN = 20  # cross attention (enc-dec); memory at ext_addr2
    GLU_MLP = 21     # gate/up/down SwiGLU MLP
    MLP = 22         # plain 2-matmul MLP (gelu)
    MOE = 23         # top-k routed mixture of experts
    SSD = 24         # Mamba2 state-space dual block
    CONV1D = 25      # short causal conv (mamba/whisper frontends)
    LM_HEAD = 26     # final projection to vocab
    SOFTMAX = 27
    GELU = 28
    SCALE = 29


@dataclasses.dataclass(frozen=True)
class Microcode:
    """One decoded 256-bit word.  Fields mirror Table II."""

    layer_type: int = int(LayerType.EXT)
    transpose_relu: int = 0
    in_ch: int = 0
    out_ch: int = 0
    height: int = 0
    width: int = 0
    kernel: int = int(Kernel.K1)
    stride: int = 0
    res_op: int = int(ResOp.NONE)
    in_addr: int = 0
    out_addr: int = 0
    ext_opcode: int = int(ExtOp.NONE)
    ext_table_idx: int = 0
    ext_addr2: int = 0
    ext_flags: int = 0
    reserved: int = 0

    # ---- convenience views -------------------------------------------------
    @property
    def relu(self) -> bool:
        return bool(self.transpose_relu & 0b01)

    @property
    def transpose(self) -> bool:
        return bool(self.transpose_relu & 0b10)

    @property
    def kernel_size(self) -> int:
        return KERNEL_SIZES[Kernel(self.kernel)]

    @property
    def stride_n(self) -> int:
        return 2 if self.stride else 1

    def validate(self) -> "Microcode":
        for name, bits in _FIELDS:
            v = getattr(self, name)
            if not (0 <= v < (1 << bits)):
                raise ValueError(
                    f"microcode field {name}={v} does not fit in {bits} bits"
                )
        return self


def pack(mc: Microcode) -> np.ndarray:
    """Pack to 32 little-endian bytes (one AXI-width word)."""
    mc.validate()
    word = 0
    shift = 0
    for name, bits in _FIELDS:
        word |= (getattr(mc, name) & ((1 << bits) - 1)) << shift
        shift += bits
    return np.frombuffer(
        word.to_bytes(MICROCODE_BYTES, "little"), dtype=np.uint8
    ).copy()


def unpack(raw: np.ndarray | bytes) -> Microcode:
    data = bytes(bytearray(raw))
    if len(data) != MICROCODE_BYTES:
        raise ValueError(f"expected {MICROCODE_BYTES} bytes, got {len(data)}")
    word = int.from_bytes(data, "little")
    kwargs = {}
    shift = 0
    for name, bits in _FIELDS:
        kwargs[name] = (word >> shift) & ((1 << bits) - 1)
        shift += bits
    return Microcode(**kwargs)


def pack_program(words: Sequence[Microcode]) -> np.ndarray:
    """Pack a whole program into the shape the config RAM would hold."""
    if not words:
        return np.zeros((0, MICROCODE_BYTES), dtype=np.uint8)
    return np.stack([pack(w) for w in words])


def unpack_program(raw: np.ndarray) -> List[Microcode]:
    return [unpack(row) for row in np.asarray(raw, dtype=np.uint8)]


def disassemble(words: Iterable[Microcode]) -> str:
    """Human-readable listing (debug aid; mirrors Fig. 3's table style)."""
    rows = []
    for i, w in enumerate(words):
        if w.layer_type == LayerType.EXT and w.ext_opcode != ExtOp.NONE:
            op = f"ext.{ExtOp(w.ext_opcode).name.lower()}"
        else:
            op = LayerType(w.layer_type).name.lower()
        rows.append(
            f"{i:4d}  {op:<14s} k{w.kernel_size} s{w.stride_n} "
            f"c{w.in_ch}->{w.out_ch} hw={w.height}x{w.width} "
            f"res={ResOp(w.res_op).name.lower():<5s} "
            f"{'relu ' if w.relu else ''}{'T ' if w.transpose else ''}"
            f"@{w.in_addr:#x}"
            + (f"+{w.ext_addr2:#x}" if w.ext_addr2 else "")
            + f" -> {w.out_addr:#x}"
            + (f" tbl[{w.ext_table_idx}]" if w.ext_table_idx else "")
        )
    return "\n".join(rows)
