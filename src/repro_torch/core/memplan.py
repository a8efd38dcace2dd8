"""Static microcode optimizer + data-pool memory planner (paper §III.B/§IV).

The paper's auto-configuration flow plans every layer's ``in_addr`` /
``out_addr`` ahead of time so the DDR4 data pool reuses a region the
moment its last consumer has run.  This module is that pass for our
assembled :class:`~repro_torch.core.assembler.Program`:

* **liveness** — per-address last-use from the same concat-walk read
  discipline the interpreter uses (``in_addr`` extent walks,
  ``ext_addr2`` second operands, and the ``res_op`` cache/add register);
* **elimination** — words whose output is never observable (not read,
  not a program output, not a residual-cache source) are unreachable and
  dropped; residual-cache sources whose *arena* region is never read keep
  executing but skip the store (a *dead store*);
* **fusion facts** — conv+bias+ReLU epilogue fusion and the
  upsample2x+conv3x3 phase decomposition are decided here, once, instead
  of per-call inside the trace loop;
* **arena plan** — an address→slot assignment (best-fit reuse of freed
  slots), the peak live bytes under drop-at-last-use, and per-word
  free-after sets the interpreter uses to release buffers.

Everything is a pure function of the Program — no tracing, no params —
so a plan can be computed once per (bucket, model) and consulted by the
batcher, the engine LRU, and the planner's cost model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

from .assembler import Program, STORAGE_BYTES
from .microcode import ExtOp, LayerType, Microcode, ResOp
from . import fuse

#: end-of-program sentinel for lifetimes (outputs live past the last word)
_END = 1 << 30


@dataclasses.dataclass(frozen=True)
class WordPlan:
    """Per-word plan facts consumed by the interpreter loop."""

    index: int                      # position in the original word list
    store: bool                     # write out_addr into the arena?
    fuse_relu: bool                 # conv epilogue ReLU folds into launch
    fuse_upsample: bool             # upsample word carries a 3x3 conv
                                    # eligible for phase decomposition
    free_after: Tuple[int, ...]     # arena addrs dead once this word ran
    drop_cache: bool                # res register value dead after word


@dataclasses.dataclass(frozen=True)
class MemPlan:
    """The memory plan for one assembled program."""

    n_words: int                    # original word count
    schedule: Tuple[int, ...]       # live word indices, program order
    dead_words: Tuple[int, ...]     # unreachable words (skipped entirely)
    dead_stores: Tuple[int, ...]    # live words that skip the arena write
    dtype_bytes: int                # activation element size used for sizes
    peak_bytes: int                 # max live activation bytes (1 image)
    naive_bytes: int                # input + every word output kept live
    pool_bytes: int                 # sum of arena slot sizes
    slot_of: Dict[int, int]         # stored addr -> slot id
    slot_bytes: Tuple[int, ...]     # slot id -> size in bytes
    words: Dict[int, WordPlan]      # word index -> plan facts

    def word(self, idx: int) -> WordPlan:
        return self.words[idx]

    @property
    def reduction(self) -> float:
        """Fraction of the naive footprint the plan eliminates."""
        if self.naive_bytes <= 0:
            return 0.0
        return 1.0 - self.peak_bytes / self.naive_bytes


def _walk(program: Program, addr: int, want_ch: int) -> List[int]:
    """Static mirror of the interpreter's concat read walk: the list of
    region base addresses one read at ``addr`` for ``want_ch`` channels
    touches.  Extent arithmetic is the assembler's (STORAGE_BYTES), which
    is what the address fields were allocated with."""
    shapes = program.addr_shapes
    if addr in shapes and shapes[addr][2] == want_ch:
        return [addr]
    out, cur, got = [], addr, 0
    while got < want_ch:
        if cur not in shapes:
            raise KeyError(
                f"memplan walk at {cur:#x}: no region (from {addr:#x}, "
                f"have {got}/{want_ch} channels)"
            )
        h, w, c = shapes[cur]
        out.append(cur)
        got += c
        cur += h * w * c * STORAGE_BYTES
    if got != want_ch:
        raise ValueError(
            f"memplan walk from {addr:#x}: channels {got} != {want_ch}"
        )
    return out


def _reads_of(program: Program, idx: int, mc: Microcode) -> List[int]:
    """All arena addresses word ``idx`` reads (in_addr walk + ext_addr2)."""
    addrs = _walk(program, mc.in_addr, mc.in_ch)
    if (
        LayerType(mc.layer_type) == LayerType.EXT
        and ExtOp(mc.ext_opcode) == ExtOp.ADD
    ):
        addrs += _walk(program, mc.ext_addr2, mc.in_ch)
    return addrs


def _region_raw_bytes(program: Program, addr: int, dtype_bytes: int) -> int:
    h, w, c = program.addr_shapes[addr]
    return h * w * c * dtype_bytes


def plan_program(program: Program, *, dtype_bytes: int = 4) -> MemPlan:
    """Compute the :class:`MemPlan` for ``program``.

    ``dtype_bytes`` sizes activations for the byte accounting (4 for f32
    compute, 2 when the engine stores fp16 between layers); addresses and
    extents always use the assembler's STORAGE_BYTES arithmetic.
    """
    words = program.words
    n = len(words)

    # The pass assumes single assignment: every word writes a distinct
    # address (the bump allocator guarantees it).  A program violating
    # that gets a conservative identity plan — everything live, nothing
    # freed — rather than a wrong one.
    out_addrs = [mc.out_addr for mc in words]
    if len(set(out_addrs)) != n:
        return _identity_plan(program, dtype_bytes)

    def_word: Dict[int, int] = {program.input_addr: -1}
    for i, mc in enumerate(words):
        def_word[mc.out_addr] = i

    # nearest preceding res-CACHE word for every res-ADD word
    cache_src: Dict[int, int] = {}
    last_cache = -1
    for i, mc in enumerate(words):
        if mc.res_op == ResOp.CACHE:
            last_cache = i
        elif mc.res_op == ResOp.ADD:
            if last_cache < 0:
                raise ValueError(f"word {i}: res add with empty cache register")
            cache_src[i] = last_cache

    # ---- backward reachability from the program outputs -----------------
    needed: Set[int] = set(program.outputs.values())
    reg_demand: Set[int] = set()        # CACHE word indices a live ADD needs
    live = [False] * n
    for i in range(n - 1, -1, -1):
        mc = words[i]
        if mc.out_addr in needed or i in reg_demand:
            live[i] = True
            needed.update(_reads_of(program, i, mc))
            if mc.res_op == ResOp.ADD:
                reg_demand.add(cache_src[i])

    schedule = tuple(i for i in range(n) if live[i])
    dead_words = tuple(i for i in range(n) if not live[i])

    # ---- forward liveness over the live schedule ------------------------
    arena_use: Dict[int, int] = {}      # addr -> last word index reading it
    reg_use: Dict[int, int] = {}        # CACHE out_addr -> last register use
    for i in schedule:
        mc = words[i]
        for a in _reads_of(program, i, mc):
            arena_use[a] = i
        if mc.res_op == ResOp.ADD:
            src = cache_src[i]
            reg_use[words[src].out_addr] = i

    output_addrs = set(program.outputs.values())
    stored: Set[int] = {program.input_addr}
    dead_stores: List[int] = []
    for i in schedule:
        a = words[i].out_addr
        if a in arena_use or a in output_addrs:
            stored.add(a)
        else:
            # live only through the res register: execute, skip the store
            dead_stores.append(i)

    def lifetime_end(addr: int) -> int:
        if addr in output_addrs:
            return _END
        return max(arena_use.get(addr, def_word[addr]),
                   reg_use.get(addr, -1))

    # per-word free-after sets: stored regions whose last *arena* read is
    # this word (the register may keep the value alive past the drop —
    # it aliases the same array, so dropping the dict entry costs nothing)
    free_after: Dict[int, List[int]] = {i: [] for i in schedule}
    for a in stored:
        if a in output_addrs:
            continue
        last = arena_use.get(a)
        if last is not None:
            free_after[last].append(a)

    # drop_cache: last res-ADD consuming each register value
    drop_at: Set[int] = set()
    for src in set(cache_src.values()):
        uses = [i for i in schedule if cache_src.get(i) == src]
        if uses:
            drop_at.add(max(uses))

    # ---- peak live bytes under drop-at-last-use -------------------------
    frees_at: Dict[int, List[int]] = {}
    tracked = set(stored) | {words[i].out_addr for i in dead_stores}
    for a in tracked:
        frees_at.setdefault(lifetime_end(a), []).append(a)
    running = _region_raw_bytes(program, program.input_addr, dtype_bytes)
    for a in frees_at.get(-1, ()):      # degenerate: input never read
        running -= _region_raw_bytes(program, a, dtype_bytes)
    peak = running
    for i in schedule:
        running += _region_raw_bytes(program, words[i].out_addr, dtype_bytes)
        peak = max(peak, running)
        for a in frees_at.get(i, ()):
            running -= _region_raw_bytes(program, a, dtype_bytes)
    naive = sum(
        _region_raw_bytes(program, a, dtype_bytes)
        for a in [program.input_addr] + out_addrs
    )

    # ---- address -> arena slot assignment (best-fit reuse) --------------
    slot_bytes: List[int] = []
    free_slots: List[int] = []
    slot_of: Dict[int, int] = {}

    def acquire(need: int) -> int:
        fitting = [s for s in free_slots if slot_bytes[s] >= need]
        if fitting:
            s = min(fitting, key=lambda s: slot_bytes[s])
        elif free_slots:
            s = max(free_slots, key=lambda s: slot_bytes[s])
            slot_bytes[s] = need
        else:
            slot_bytes.append(need)
            return len(slot_bytes) - 1
        free_slots.remove(s)
        return s

    slot_of[program.input_addr] = acquire(
        _region_raw_bytes(program, program.input_addr, dtype_bytes)
    )
    slot_release: Dict[int, List[int]] = {}
    for a in stored:
        end = lifetime_end(a)
        if end < _END:
            slot_release.setdefault(end, []).append(a)
    for a in slot_release.get(-1, ()):
        free_slots.append(slot_of[a])
    for i in schedule:
        a = words[i].out_addr
        if a in stored:
            slot_of[a] = acquire(_region_raw_bytes(program, a, dtype_bytes))
        for r in slot_release.get(i, ()):
            free_slots.append(slot_of[r])

    # ---- per-word plan facts --------------------------------------------
    dead_store_set = set(dead_stores)
    plans: Dict[int, WordPlan] = {}
    for i in schedule:
        mc = words[i]
        spec = program.layer_specs[i]
        lt = LayerType(mc.layer_type)
        plans[i] = WordPlan(
            index=i,
            store=i not in dead_store_set,
            fuse_relu=(lt == LayerType.CONV
                       and fuse.can_fuse_conv_epilogue(mc)),
            fuse_upsample=(lt == LayerType.UPSAMPLE
                           and spec.upsample_mode == "fused"),
            free_after=tuple(sorted(free_after[i])),
            drop_cache=i in drop_at,
        )

    return MemPlan(
        n_words=n,
        schedule=schedule,
        dead_words=dead_words,
        dead_stores=tuple(dead_stores),
        dtype_bytes=dtype_bytes,
        peak_bytes=int(peak),
        naive_bytes=int(naive),
        pool_bytes=int(sum(slot_bytes)),
        slot_of=slot_of,
        slot_bytes=tuple(slot_bytes),
        words=plans,
    )


def _identity_plan(program: Program, dtype_bytes: int) -> MemPlan:
    """Conservative fallback: run every word, free nothing."""
    words = program.words
    n = len(words)
    naive = sum(
        _region_raw_bytes(program, a, dtype_bytes)
        for a in [program.input_addr] + [mc.out_addr for mc in words]
    )
    plans = {}
    for i, mc in enumerate(words):
        spec = program.layer_specs[i]
        lt = LayerType(mc.layer_type)
        plans[i] = WordPlan(
            index=i, store=True,
            fuse_relu=(lt == LayerType.CONV
                       and fuse.can_fuse_conv_epilogue(mc)),
            fuse_upsample=(lt == LayerType.UPSAMPLE
                           and spec.upsample_mode == "fused"),
            free_after=(), drop_cache=False,
        )
    return MemPlan(
        n_words=n, schedule=tuple(range(n)), dead_words=(), dead_stores=(),
        dtype_bytes=dtype_bytes, peak_bytes=int(naive), naive_bytes=int(naive),
        pool_bytes=int(naive), slot_of={}, slot_bytes=(), words=plans,
    )


def optimize_program(program: Program) -> Program:
    """Return ``program`` with unreachable words removed (indices in the
    side tables remapped).  Addresses are untouched — the data-pool
    layout, concat adjacency, and addr_shapes all still hold."""
    plan = plan_program(program)
    if not plan.dead_words:
        return program
    remap = {old: new for new, old in enumerate(plan.schedule)}
    return Program(
        words=[program.words[i] for i in plan.schedule],
        tables=list(program.tables),
        weight_bindings={remap[i]: v
                         for i, v in program.weight_bindings.items()
                         if i in remap},
        layer_specs={remap[i]: v
                     for i, v in program.layer_specs.items()
                     if i in remap},
        input_addr=program.input_addr,
        input_shape_chw=program.input_shape_chw,
        outputs=dict(program.outputs),
        addr_shapes=dict(program.addr_shapes),
        arena_bytes=program.arena_bytes,
    )


def admissible_batch(
    peak_bytes_per_image: int,
    budget_bytes: int,
    *,
    multiple: int = 1,
    floor: int = 1,
) -> int:
    """Largest batch whose planned activation footprint fits the budget,
    rounded down to ``multiple`` (a plan's batch multiple) but never
    below ``max(multiple, floor)`` — a bucket that cannot fit even one
    group still has to serve it."""
    multiple = max(1, int(multiple))
    lo = max(int(floor), multiple)
    if peak_bytes_per_image <= 0 or budget_bytes <= 0:
        return lo
    b = int(budget_bytes) // int(peak_bytes_per_image)
    b = (b // multiple) * multiple
    return max(lo, b)


def plan_disassembly(program: Program, *, dtype_bytes: int = 4) -> str:
    """Disassembly of the memplan-optimized program plus the plan
    summary — the golden-snapshot text for one model."""
    plan = plan_program(program, dtype_bytes=dtype_bytes)
    opt = optimize_program(program)
    lines = [
        f"# memplan: words={plan.n_words} live={len(plan.schedule)} "
        f"dead_words={len(plan.dead_words)} "
        f"dead_stores={len(plan.dead_stores)}",
        f"# bytes: peak={plan.peak_bytes} pool={plan.pool_bytes} "
        f"naive={plan.naive_bytes} reduction={plan.reduction:.3f} "
        f"(dtype_bytes={plan.dtype_bytes})",
        f"# slots: n={len(plan.slot_bytes)} "
        f"sizes=[{','.join(str(s) for s in plan.slot_bytes)}]",
    ]
    for i in plan.schedule:
        wp = plan.words[i]
        mc = program.words[i]
        flags = [
            f for f, on in (
                ("fuse_relu", wp.fuse_relu),
                ("fuse_upsample", wp.fuse_upsample),
                ("dead_store", not wp.store),
                ("drop_cache", wp.drop_cache),
            ) if on
        ]
        frees = ",".join(f"{a:#x}" for a in wp.free_after) or "-"
        slot = plan.slot_of.get(mc.out_addr, -1)
        lines.append(
            f"# w{i:03d} out={mc.out_addr:#08x} slot={slot} "
            f"free=[{frees}] flags=[{','.join(flags) or '-'}]"
        )
    return opt.disassemble() + "\n" + "\n".join(lines) + "\n"
