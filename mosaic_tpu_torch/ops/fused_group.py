"""The fused SQL operator group, K14: a hand-written CUDA kernel for Hopper
and its plain PyTorch version, over one encoded group program.

Counterpart of the XLA program ``mosaic_tpu.perf.fusion._build_program``
builds per (fusion group, pow2 row bucket): the row mask of a WHERE, then
the projected columns or the scalar aggregates (countstar, count, integer
sum and avg, min, max, first), with only the group's outputs crossing back
to the host.  The port compiles nothing at run time, so a group is a
:class:`Program`: a typed register program (one instruction per AST node,
each carrying the dtype the fusion pass's type walk gives its node;
``perf/fusion.py`` encodes it) that the fixed kernel
``csrc/fused_group.cu`` interprets a tile of rows at a time, and that
:func:`fused_group_ref` runs over whole columns with torch ops.

:func:`plan_program` places the program in the kernel's shared memory:
each value in one of P slot tiles, a slot free again after its last
reader (a constant as one word, an int64 or float64 column read in place
from its staged tile), and the tile rows T and copy stages that fit a
block.  :func:`pack_inputs` lays the header (with that plan), the
aggregate state and the referenced columns (padded to the bucket) into
one byte buffer, copied to the device in one piece; :func:`fused_group`
runs it into one output buffer, fetched in one piece, which
:func:`unpack_outputs` reads back in the order of the JAX program's
outputs.  On a CUDA buffer :func:`fused_group` launches K14 (built at
first use) or raises; on a CPU buffer it runs :func:`fused_group_ref`.
Both give the same bytes: ``fused_group_ref`` casts every node to its
dtype explicitly and never lets torch promote (torch takes an int64
tensor and a Python float to float32, where numpy and XLA give float64),
keeps -0.0 below +0.0 in min and max by the same order key, and takes
``first`` at the least passing row.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .projection import check_rc

#: register dtypes by code (csrc/fused_group.cu DType)
DTYPES = (np.dtype(bool), np.dtype(np.int8), np.dtype(np.int16),
          np.dtype(np.int32), np.dtype(np.int64), np.dtype(np.float16),
          np.dtype(np.float32), np.dtype(np.float64))
DT_CODE = {dt: i for i, dt in enumerate(DTYPES)}
TORCH_DT = (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
            torch.float16, torch.float32, torch.float64)
F64 = DT_CODE[np.dtype(np.float64)]
BOOL = DT_CODE[np.dtype(bool)]

#: opcodes (csrc/fused_group.cu Op)
OPS = {name: i for i, name in enumerate(
    ("load", "const", "cast", "+", "-", "*", "/", "neg",
     "=", "!=", "<", "<=", ">", ">=", "and", "or", "not", "isnan",
     "mask"))}
#: aggregate kinds (csrc/fused_group.cu Agg); perf.fusion's _AggSpec.kind
AGG_KINDS = {name: i for i, name in enumerate(
    ("countstar", "count", "sum", "avg", "min", "max", "first"))}

#: header words before the column table (csrc/fused_group.cu Hdr)
HDR_FIXED = 16
#: instructions and aggregate specs the kernel holds (its kMaxRegs,
#: kMaxSpecs)
MAX_REGS = 128
MAX_SPECS = 32
#: threads a block
THREADS = 256
#: tile rows: a multiple of TILE_STEP, at most MAX_TILE
MAX_TILE = 4096
TILE_STEP = 128
#: the kernel's dynamic shared memory: the constants' first word (after
#: the barriers and counters), the bytes of a decoded instruction, a
#: decoded spec, a warp's partials of a spec and a staged column, what one
#: block may take (227 KB) and what an SM holds (228 KB, 1 KB of it
#: reserved a block: :func:`block_budget`)
SMEM_CONST_WORD = 8
CODE_BYTES, SPEC_BYTES, PART_BYTES, STAGED_BYTES = 32, 16, 32, 16
SMEM_BLOCK = 232448
SMEM_SM = 233472
#: the least tile rows for which two blocks share an SM
TWO_BLOCKS_MIN_TILE = 1024
#: the plans tried in turn, (blocks an SM, copy stages, least tile rows):
#: the first at which the program fits a block's share of the SM
#: (:func:`block_budget`) is taken
PLAN_CHOICES = ((2, 2, TWO_BLOCKS_MIN_TILE), (1, 2, TILE_STEP),
                (1, 1, TILE_STEP))
#: copy stages the kernel's ring holds at most (csrc/fused_group.cu
#: kMaxStages)
MAX_STAGES = 3
#: plan word flags (csrc/fused_group.cu kLocStage, kLocConst)
LOC_STAGE = 1 << 30
LOC_CONST = 1 << 31
#: first()'s row before any row passed
NO_ROW = (1 << 63) - 1
_I64_MIN = -(1 << 63)


@dataclasses.dataclass(frozen=True)
class Program:
    """One fusion group's encoded program.

    ``instrs`` [I, 5] int64 rows ``(op, dtype, a, b, imm)``: instruction i
    writes register i; ``load`` reads column ``a``, ``const`` holds ``imm``
    (an int64, or a float's float64 bits), ``cast`` converts register
    ``a`` from dtype ``b``, the others combine registers ``a`` and ``b``
    (their operands' dtype for comparisons, ``isnan`` and ``mask``).
    ``col_dtypes`` are the columns' dtype codes; ``mask_reg`` the WHERE's
    bool register (-1: none); ``items`` the projected ``(register,
    dtype)`` pairs; ``specs`` the aggregate ``(kind, register, dtype)``
    triples (register -1 for ``countstar``)."""

    instrs: np.ndarray
    col_dtypes: Tuple[int, ...]
    terminal: str
    mask_reg: int
    items: Tuple[Tuple[int, int], ...] = ()
    specs: Tuple[Tuple[int, int, int], ...] = ()

    @property
    def outs(self) -> int:
        return len(self.items) if self.terminal == "project" \
            else len(self.specs)


class ProgramBuilder:
    """Emits instructions, sharing one register per column and per
    constant."""

    def __init__(self, col_dtypes: Sequence[np.dtype]):
        self.col_dtypes = tuple(DT_CODE[np.dtype(d)] for d in col_dtypes)
        self.rows: List[Tuple[int, int, int, int, int]] = []
        self._memo = {}

    def emit(self, op: str, dt: int, a: int = -1, b: int = -1,
             imm: int = 0) -> int:
        key = (op, dt, a, b, imm) if op in ("load", "const") else None
        if key is not None and key in self._memo:
            return self._memo[key]
        self.rows.append((OPS[op], dt, a, b, imm))
        reg = len(self.rows) - 1
        if key is not None:
            self._memo[key] = reg
        return reg

    def load(self, col: int) -> int:
        return self.emit("load", self.col_dtypes[col], col)

    def const(self, value, dt: int) -> int:
        """A literal already rounded to ``dt``: an int64, or a float's
        float64 bits."""
        if DTYPES[dt].kind == "f":
            imm = int(np.float64(value).view(np.int64))
        else:
            imm = int(value)
        return self.emit("const", dt, imm=imm)

    def finish(self, terminal: str, mask_reg: int, items=(),
               specs=()) -> Program:
        instrs = np.asarray(self.rows, np.int64).reshape(-1, 5)
        return Program(instrs, self.col_dtypes, terminal, int(mask_reg),
                       tuple(items), tuple(specs))


def _align(n: int) -> int:
    """16-byte alignment: K14's bulk copies and 16-byte stores need it."""
    return (n + 15) // 16 * 16


def header_words(prog: Program) -> int:
    return (HDR_FIXED + 3 * len(prog.col_dtypes) + 6 * len(prog.instrs)
            + 4 * prog.outs)


# ------------------------------------------------------ the plan

def operands(op: int, a: int, b: int) -> Tuple[int, ...]:
    """The registers an instruction reads."""
    if op in (OPS["load"], OPS["const"]):
        return ()
    if op in (OPS["cast"], OPS["neg"], OPS["not"], OPS["isnan"],
              OPS["mask"]):
        return (a,)
    return (a, b)


def terminal_regs(prog: Program) -> Tuple[int, ...]:
    """The registers the terminal reads after the last instruction."""
    regs = [prog.mask_reg] + [r for r, _ in prog.items] + \
        [r for _, r, _ in prog.specs]
    return tuple(r for r in regs if r >= 0)


def held(prog: Program) -> Tuple[str, ...]:
    """Where each instruction's value lives: ``"const"`` (one word),
    ``"stage"`` (a load of an int64 or float64 column, read in place from
    its staged tile) or ``"slot"``."""
    out = []
    for op, dt, *_ in prog.instrs.tolist():
        if op == OPS["const"]:
            out.append("const")
        elif op == OPS["load"] and DTYPES[dt].itemsize == 8:
            out.append("stage")
        else:
            out.append("slot")
    return tuple(out)


def last_readers(prog: Program) -> List[int]:
    """Per instruction, the index of its last reader (``len(instrs)``: the
    terminal), -1 where nothing reads it."""
    n = len(prog.instrs)
    last = [-1] * n
    for j, (op, _, a, b, _) in enumerate(prog.instrs.tolist()):
        for r in operands(op, a, b):
            last[r] = j
    for r in terminal_regs(prog):
        last[r] = n
    return last


def assign_slots(prog: Program) -> Tuple[Tuple[int, ...], int]:
    """``(slot of each instruction (-1: not slot-held), P)``: in program
    order, a value takes the lowest free slot; a slot is free again from
    its value's last reader on, which may write its own result there (the
    kernel reads a row's operands before it writes the row).  A value no
    instruction reads is free again after its own.  Greedy in order of
    definition is optimal on these intervals: P is the peak live count."""
    kinds = held(prog)
    last = last_readers(prog)
    free: List[int] = []
    slot = [-1] * len(kinds)
    dies: dict = {}
    for v, j in enumerate(last):
        if kinds[v] == "slot" and j > v:
            dies.setdefault(j, []).append(v)
    peak = 0
    for i, kind in enumerate(kinds):
        for v in dies.get(i, ()):
            heapq.heappush(free, slot[v])
        if kind != "slot":
            continue
        slot[i] = heapq.heappop(free) if free else peak
        peak = max(peak, slot[i] + 1)
        if last[i] <= i:                        # read by nothing
            heapq.heappush(free, slot[i])
    return tuple(slot), peak


@dataclasses.dataclass(frozen=True)
class Plan:
    """Where K14 keeps a program in a block's shared memory.

    ``tile`` rows T a tile, ``stages`` column copy stages (2: the next
    tile's columns in flight while this one runs), ``slots`` P,
    ``blocks_per_sm`` the persistent blocks an SM holds, ``smem`` the
    dynamic shared memory bytes, ``stage_bytes`` a stage's bytes,
    ``front`` (:func:`front_layout`) the first bytes of the decoded
    program, specs, partials and staged columns, and of the slots;
    ``slot_of`` each instruction's slot (-1: a constant or a column read
    in place), ``col_stage`` each column's byte offset in stage 0 (-1: no
    load reads it), ``locs`` each instruction's plan word."""

    tile: int
    stages: int
    slots: int
    blocks_per_sm: int
    smem: int
    stage_bytes: int
    front: Tuple[int, int, int, int, int]
    slot_of: Tuple[int, ...]
    col_stage: Tuple[int, ...]
    locs: Tuple[int, ...]


def front_layout(n_instrs: int, n_specs: int, n_staged: int):
    """The first bytes of the kernel's decoded program, specs, per-warp
    partials and staged columns in shared memory, and of its slots: after
    the barriers, counters and a constant word an instruction."""
    code = _align(8 * (SMEM_CONST_WORD + n_instrs))
    spec = code + CODE_BYTES * n_instrs
    part = spec + SPEC_BYTES * n_specs
    staged = part + PART_BYTES * (THREADS // 32) * n_specs
    return code, spec, part, staged, _align(staged + STAGED_BYTES * n_staged)


def smem_bytes(front: int, slots: int, row_bytes: int, tile: int,
               stages: int) -> int:
    """Dynamic shared memory of a plan: the front, P slot tiles of 8-byte
    words, and ``stages`` copies of the staged columns' tiles
    (``row_bytes`` a row)."""
    return front + tile * (8 * slots + stages * row_bytes)


def block_budget(blocks: int) -> int:
    """The shared memory each of ``blocks`` blocks on an SM may take: the
    SM's SMEM_SM less 1 KB a block, at most SMEM_BLOCK."""
    return min(SMEM_BLOCK, SMEM_SM // blocks - 1024)


def _fit(front: int, slots: int, row_bytes: int, stages: int,
         budget: int) -> int:
    per_row = 8 * slots + stages * row_bytes
    rows = (budget - front) // per_row if per_row else MAX_TILE
    return min(MAX_TILE, rows // TILE_STEP * TILE_STEP)


def plan_program(prog: Program) -> Plan:
    """K14's plan of ``prog``: the first of PLAN_CHOICES at which the
    largest T that fits (a multiple of TILE_STEP, at most MAX_TILE) is at
    least its least rows: two blocks an SM with two stages, else one
    block with two stages, else with one.  Raises ValueError naming the limit when not even TILE_STEP
    rows fit."""
    key = (prog.instrs.tobytes(), prog.col_dtypes, prog.terminal,
           prog.mask_reg, prog.items, prog.specs)
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= 256:
            _PLANS.clear()
        plan = _PLANS[key] = _make_plan(prog)
    return plan


_PLANS: dict = {}


def _make_plan(prog: Program) -> Plan:
    kinds = held(prog)
    slot_of, slots = assign_slots(prog)
    loaded = {int(a) for op, _, a, _, _ in prog.instrs.tolist()
              if op == OPS["load"]}
    sizes = [DTYPES[dt].itemsize if c in loaded else 0
             for c, dt in enumerate(prog.col_dtypes)]
    row_bytes = sum(sizes)
    n_specs = len(prog.specs) if prog.terminal == "aggregate" else 0
    layout = front_layout(len(kinds), n_specs, sum(1 for z in sizes if z))
    front = layout[-1]
    for blocks, stages, least in PLAN_CHOICES:
        tile = _fit(front, slots, row_bytes, stages, block_budget(blocks))
        if tile >= least:
            break
    else:
        need = smem_bytes(front, slots, row_bytes, TILE_STEP, 1)
        raise ValueError(
            f"fused_group: {slots} live values and {row_bytes} column "
            f"bytes a row need {need} B of shared memory at {TILE_STEP} "
            f"rows; a block holds {SMEM_BLOCK} B")
    stage0 = front + 8 * slots * tile
    col_stage, off = [], stage0
    for size in sizes:
        col_stage.append(off if size else -1)
        off += tile * size
    locs = []
    for i, (op, _, a, _, _) in enumerate(prog.instrs.tolist()):
        if kinds[i] == "const":
            locs.append(LOC_CONST | (SMEM_CONST_WORD + i))
        elif kinds[i] == "stage":
            locs.append(LOC_STAGE | (col_stage[a] // 8))
        else:
            locs.append(front // 8 + slot_of[i] * tile)
    return Plan(tile, stages, slots, blocks, smem_bytes(
        front, slots, row_bytes, tile, stages), tile * row_bytes, layout,
        slot_of, tuple(col_stage), tuple(locs))


def out_layout(prog: Program, bucket: int):
    """``(bytes, item byte offsets, spec word indices)`` of the output
    buffer."""
    if prog.terminal == "project":
        off = _align(8 + bucket)
        offs = []
        for _, dt in prog.items:
            offs.append(off)
            off = _align(off + bucket * DTYPES[dt].itemsize)
        return off, offs, []
    words, w = 1, []
    for kind, _, _ in prog.specs:
        w.append(words)
        words += 1 if kind in (AGG_KINDS["countstar"],
                               AGG_KINDS["count"]) else 2
    return 8 * words, [], w


def _state_init(prog: Program) -> np.ndarray:
    st = np.zeros(2 + 3 * len(prog.specs), np.int64)
    for s, (kind, _, _) in enumerate(prog.specs):
        if kind == AGG_KINDS["min"]:
            st[2 + 3 * s] = NO_ROW              # int64 max: min's identity
        elif kind == AGG_KINDS["max"]:
            st[2 + 3 * s] = _I64_MIN
        st[4 + 3 * s] = NO_ROW
    return st


def _col_offsets(prog: Program, bucket: int) -> Tuple[List[int], int]:
    """The columns' byte offsets in the input buffer, and its bytes."""
    off = _align(8 * (header_words(prog) + 2 + 3 * len(prog.specs)))
    offs = []
    for dt in prog.col_dtypes:
        offs.append(off)
        off = _align(off + bucket * DTYPES[dt].itemsize)
    return offs, off


def pack_inputs(prog: Program, cols: Sequence[np.ndarray], n: int,
                bucket: int) -> np.ndarray:
    """The one host buffer (uint8) K14 and its plain version read: the
    header with K14's plan (:func:`plan_program`), the aggregate state,
    then each column padded with zeros to ``bucket`` rows at a 16-byte
    aligned offset.  Raises ValueError, before anything reaches the card,
    for a program K14 cannot hold."""
    if len(prog.instrs) > MAX_REGS or len(prog.specs) > MAX_SPECS:
        raise ValueError(
            f"fused_group: {len(prog.instrs)} instructions and "
            f"{len(prog.specs)} aggregates; K14 holds {MAX_REGS} and "
            f"{MAX_SPECS}")
    plan = plan_program(prog)
    hw = header_words(prog)
    state = _state_init(prog)
    col_offs, nbytes = _col_offsets(prog, bucket)
    buf = np.zeros(nbytes, np.uint8)
    words = buf[:8 * (hw + len(state))].view(np.int64)
    _, item_offs, spec_words = out_layout(prog, bucket)
    words[:HDR_FIXED] = (len(prog.instrs), len(prog.col_dtypes),
                         0 if prog.terminal == "project" else 1,
                         prog.mask_reg, prog.outs, hw, hw, plan.tile,
                         plan.stages, plan.slots, plan.smem,
                         plan.stage_bytes, *plan.front[:4])
    p = HDR_FIXED
    for o, dt, st in zip(col_offs, prog.col_dtypes, plan.col_stage):
        words[p:p + 3] = (o, dt, st)
        p += 3
    words[p:p + 5 * len(prog.instrs)] = prog.instrs.reshape(-1)
    p += 5 * len(prog.instrs)
    if prog.terminal == "project":
        for (reg, dt), o in zip(prog.items, item_offs):
            words[p:p + 4] = (reg, dt, o, 0)
            p += 4
    else:
        for (kind, reg, dt), w in zip(prog.specs, spec_words):
            words[p:p + 4] = (kind, reg, dt, w)
            p += 4
    words[p:p + len(plan.locs)] = plan.locs
    words[hw:] = state
    for c, o, dt in zip(cols, col_offs, prog.col_dtypes):
        if DT_CODE[c.dtype] != dt:
            raise ValueError(f"fused_group: column dtype {c.dtype} is not "
                             f"the program's {DTYPES[dt]}")
        m = min(len(c), n)
        buf[o:o + m * c.dtype.itemsize] = \
            np.ascontiguousarray(c[:m]).view(np.uint8)
    return buf


# ------------------------------------------------------ plain version

def _ordkey(v: torch.Tensor) -> torch.Tensor:
    """The signed order key of float values: -0.0 below +0.0."""
    b = v.to(torch.float64).view(torch.int64)
    return torch.where(b < 0, b ^ NO_ROW, b)


def _unkey(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k < 0, k ^ NO_ROW, k)


def _run_ref(prog: Program, buf: torch.Tensor, bucket: int) -> list:
    """Every register over all ``bucket`` rows."""
    dev = buf.device
    offs, _ = _col_offsets(prog, bucket)
    regs: list = []
    for op, dt, a, b, imm in prog.instrs.tolist():
        tdt = TORCH_DT[dt]
        if op == OPS["load"]:
            size = DTYPES[dt].itemsize
            v = buf[offs[a]:offs[a] + bucket * size].view(tdt)
        elif op == OPS["const"]:
            val = float(np.int64(imm).view(np.float64)) \
                if DTYPES[dt].kind == "f" else int(imm)
            v = torch.full((), val, dtype=tdt, device=dev)
        elif op == OPS["cast"]:
            v = regs[a].to(tdt)
        elif op in (OPS["+"], OPS["-"], OPS["*"], OPS["/"]):
            x, y = regs[a], regs[b]
            v = {OPS["+"]: torch.add, OPS["-"]: torch.sub,
                 OPS["*"]: torch.mul, OPS["/"]: torch.div}[op](x, y)
        elif op == OPS["neg"]:
            x = regs[a]
            if x.dtype.is_floating_point:
                # flip the sign bit, NaN's too, as numpy and XLA do
                # (torch.neg on CUDA leaves a NaN's sign)
                ib = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                    x.element_size()]
                sign = torch.full((), -(1 << (8 * x.element_size() - 1)),
                                  dtype=ib, device=dev)
                v = (x.contiguous().view(ib) ^ sign).view(x.dtype)
            else:
                v = torch.neg(x)
        elif OPS["="] <= op <= OPS[">="]:
            x, y = regs[a], regs[b]
            v = {OPS["="]: torch.eq, OPS["!="]: torch.ne,
                 OPS["<"]: torch.lt, OPS["<="]: torch.le,
                 OPS[">"]: torch.gt, OPS[">="]: torch.ge}[op](x, y)
        elif op == OPS["and"]:
            v = regs[a] & regs[b]
        elif op == OPS["or"]:
            v = regs[a] | regs[b]
        elif op == OPS["not"]:
            v = ~regs[a]
        elif op == OPS["isnan"]:
            x = regs[a]
            v = torch.isnan(x) if x.dtype.is_floating_point \
                else torch.zeros(x.shape, dtype=torch.bool, device=dev)
        else:                                   # mask: NaN is true
            v = regs[a] != torch.zeros((), dtype=regs[a].dtype, device=dev)
        if v.dtype != tdt and op not in (OPS["isnan"], OPS["mask"]) \
                and not OPS["="] <= op <= OPS[">="]:
            raise AssertionError(f"fused_group_ref: op {op} gave {v.dtype}, "
                                 f"the program says {tdt}")
        regs.append(v)
    return regs


def fused_group_ref(prog: Program, buf: torch.Tensor, n: int,
                    bucket: int) -> torch.Tensor:
    """Plain version of :func:`fused_group`: the program over whole
    columns with torch ops, on ``buf``'s device; the same output bytes."""
    dev = buf.device
    regs = _run_ref(prog, buf, bucket)
    full = lambda v: v.expand(bucket) if v.dim() == 0 else v  # noqa: E731
    live = torch.arange(bucket, device=dev) < n
    mask = live & full(regs[prog.mask_reg]) if prog.mask_reg >= 0 else live
    total = mask.sum(dtype=torch.int64).reshape(1)
    nbytes, item_offs, spec_words = out_layout(prog, bucket)
    out = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    if prog.terminal == "project":
        out[:8] = total.view(torch.uint8)
        out[8:8 + bucket] = mask.to(torch.uint8)
        for (reg, dt), o in zip(prog.items, item_offs):
            v = full(regs[reg])
            v = torch.where(live, v, torch.zeros((), dtype=v.dtype,
                                                 device=dev))
            out[o:o + bucket * DTYPES[dt].itemsize] = \
                v.contiguous().view(torch.uint8)
        return out
    words = torch.zeros(nbytes // 8, dtype=torch.int64, device=dev)
    words[0] = total[0]
    rows = torch.arange(bucket, device=dev)
    for (kind, reg, dt), w in zip(prog.specs, spec_words):
        if kind == AGG_KINDS["countstar"]:
            words[w] = total[0]
            continue
        v = full(regs[reg])
        ok = mask & ~torch.isnan(v) if DTYPES[dt].kind == "f" else mask
        cnt = ok.sum(dtype=torch.int64)
        if kind == AGG_KINDS["count"]:
            words[w] = cnt
            continue
        is_f = DTYPES[dt].kind == "f"
        if kind in (AGG_KINDS["sum"], AGG_KINDS["avg"]):
            val = torch.where(ok, v.to(torch.int64), 0).sum()
        elif kind in (AGG_KINDS["min"], AGG_KINDS["max"]):
            k = _ordkey(v) if is_f else v.to(torch.int64)
            if kind == AGG_KINDS["min"]:
                val = torch.where(ok, k, NO_ROW).amin()
            else:
                val = torch.where(ok, k, _I64_MIN).amax()
            if is_f:
                val = _unkey(val)
        else:                                   # first: least passing row
            at = torch.where(ok, rows, NO_ROW).amin()
            pick = v[at.clamp(max=bucket - 1)]
            pick = pick.to(torch.float64).view(torch.int64) if is_f \
                else pick.to(torch.int64)
            val = torch.where(cnt > 0, pick, 0)
        words[w] = val
        words[w + 1] = cnt
    return words.view(torch.uint8)


# ------------------------------------------------------ the kernel

@functools.cache
def load_kernel() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature;
    its limits checked against this module's."""
    lib = _kernels.load("fused_group")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_group_launch.argtypes = [vp, ll, ll, vp, vp, i, i, vp]
    lib.fused_group_launch.restype = i
    lib.fused_group_limits.argtypes = [i]
    lib.fused_group_limits.restype = i
    lib.fused_group_error_string.argtypes = [i]
    lib.fused_group_error_string.restype = ctypes.c_char_p
    got = tuple(lib.fused_group_limits(k) for k in range(len(LIMITS)))
    if got != LIMITS:
        raise _kernels.KernelError(
            f"csrc/fused_group.cu limits {got} != the wrapper's {LIMITS}")
    return lib


#: csrc/fused_group.cu fused_group_limits, in its order
LIMITS = (MAX_REGS, MAX_SPECS, THREADS, MAX_TILE, TILE_STEP,
          SMEM_CONST_WORD, SMEM_BLOCK, MAX_STAGES,
          CODE_BYTES | SPEC_BYTES << 8 | PART_BYTES << 16 |
          STAGED_BYTES << 24)


def launch_blocks(prog: Program, n: int, bucket: int, sms: int) -> int:
    """Persistent blocks a launch takes: the plan's blocks an SM on every
    SM, or one a tile where there are fewer tiles (a project group's tiles
    cover the bucket, an aggregate group's the n live rows)."""
    plan = plan_program(prog)
    cover = bucket if prog.terminal == "project" else n
    return max(1, min(-(-cover // plan.tile), sms * plan.blocks_per_sm))


def fused_group(prog: Program, buf: torch.Tensor, n: int,
                bucket: int) -> torch.Tensor:
    """The group's output bytes (uint8, on ``buf``'s device) from the
    packed input ``buf`` (:func:`pack_inputs`, uint8) of ``n`` live rows
    in a bucket of ``bucket``.

    CPU tensors run :func:`fused_group_ref`.  CUDA tensors launch K14 once
    on the current stream (it writes its aggregate state into ``buf``; an
    aggregate group with a ``first`` spec keeps a word a spec a block past
    the returned bytes) and raise on a CUDA error; there is no fallback.
    ``fused_group.launches`` counts kernel launches."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("fused_group: buf must be a flat uint8 tensor")
    if not 0 < n <= bucket:
        raise ValueError(f"fused_group: n={n} outside (0, {bucket}]")
    dev = buf.device
    if dev.type == "cpu":
        return fused_group_ref(prog, buf, n, bucket)
    if dev.type != "cuda":
        raise ValueError(f"fused_group: unsupported device {dev}")
    plan = plan_program(prog)
    nbytes, _, _ = out_layout(prog, bucket)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = launch_blocks(prog, n, bucket, sms)
    first = any(k == AGG_KINDS["first"] for k, _, _ in prog.specs)
    scratch = 8 * blocks * len(prog.specs) if first else 0
    out = torch.empty(nbytes + scratch, dtype=torch.uint8, device=dev)
    lib = load_kernel()
    with torch.cuda.device(dev):
        rc = lib.fused_group_launch(
            buf.data_ptr(), int(n), int(bucket), out.data_ptr(),
            out.data_ptr() + nbytes if scratch else None, blocks,
            plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "fused_group", rc, "launch")
    fused_group.launches += 1
    return out[:nbytes] if scratch else out


fused_group.launches = 0


def unpack_outputs(prog: Program, out: np.ndarray, bucket: int) -> list:
    """The host arrays of one fetched output buffer, in the JAX program's
    output order: the passing-row count, then the mask and each projected
    column (project), or each spec's value and count (aggregate; float
    specs' values as float64, integer ones as int64)."""
    out = np.asarray(out, np.uint8)
    nbytes, item_offs, spec_words = out_layout(prog, bucket)
    words = out[:8].view(np.int64)
    host: list = [words[0]]
    if prog.terminal == "project":
        host.append(out[8:8 + bucket].view(np.bool_))
        for (_, dt), o in zip(prog.items, item_offs):
            host.append(out[o:o + bucket * DTYPES[dt].itemsize]
                        .view(DTYPES[dt]))
        return host
    w = out[:nbytes].view(np.int64)
    for (kind, _, dt), i in zip(prog.specs, spec_words):
        if kind in (AGG_KINDS["countstar"], AGG_KINDS["count"]):
            host.append(w[i])
            continue
        if kind in (AGG_KINDS["sum"], AGG_KINDS["avg"]) or \
                DTYPES[dt].kind != "f":
            host.append(w[i])
        else:
            host.append(w[i:i + 1].view(np.float64)[0])
        host.append(w[i + 1])
    return host
