"""repro_torch.core: the paper's contributions as torch modules.

C1 microcode ISA/assembler/interpreter, C2 block floating-point,
C3 Winograd F(4x4, 3x3), C6 BN folding + fused upsample, and the static
memory planner.
"""
from . import assembler, bfp, fuse, interpreter, memplan, microcode, winograd
from .assembler import Assembler, LayerSpec, Program
from .device import resolve_device
from .interpreter import BFPConfig, FCNEngine
from .memplan import MemPlan, WordPlan, plan_program
from .microcode import ExtOp, Kernel, LayerType, Microcode, ResOp

__all__ = [
    "assembler", "bfp", "fuse", "interpreter", "memplan", "microcode",
    "winograd", "Assembler", "LayerSpec", "Program", "resolve_device",
    "BFPConfig", "FCNEngine", "MemPlan", "WordPlan", "plan_program",
    "ExtOp", "Kernel", "LayerType", "Microcode", "ResOp",
]
