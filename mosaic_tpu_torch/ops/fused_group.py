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
``csrc/fused_group.cu`` interprets row by row, and that
:func:`fused_group_ref` runs over whole columns with torch ops.

:func:`pack_inputs` lays the program, the aggregate state and the
referenced columns (padded to the bucket) into one byte buffer, copied to
the device in one piece; :func:`fused_group` runs it into one output
buffer, fetched in one piece, which :func:`unpack_outputs` reads back in
the order of the JAX program's outputs.  On a CUDA buffer
:func:`fused_group` launches K14 (built at first use) or raises; on a CPU
buffer it runs :func:`fused_group_ref`.  Both give the same bytes:
``fused_group_ref`` casts every node to its dtype explicitly and never
lets torch promote (torch takes an int64 tensor and a Python float to
float32, where numpy and XLA give float64), keeps -0.0 below +0.0 in
min and max by the same order key, and takes ``first`` at the least
passing row.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
HDR_FIXED = 8
#: registers and aggregate specs the kernel holds (its kMaxRegs, kMaxSpecs)
MAX_REGS = 128
MAX_SPECS = 32
#: threads a block, and blocks per SM the wrapper launches at most
THREADS = 256
BLOCKS_PER_SM = 8
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
    return (n + 7) // 8 * 8


def header_words(prog: Program) -> int:
    return (HDR_FIXED + 2 * len(prog.col_dtypes) + 5 * len(prog.instrs)
            + 4 * prog.outs)


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
    off = 8 * (header_words(prog) + 2 + 3 * len(prog.specs))
    offs = []
    for dt in prog.col_dtypes:
        offs.append(off)
        off = _align(off + bucket * DTYPES[dt].itemsize)
    return offs, off


def pack_inputs(prog: Program, cols: Sequence[np.ndarray], n: int,
                bucket: int) -> np.ndarray:
    """The one host buffer (uint8) K14 and its plain version read: the
    header, the aggregate state, then each column padded with zeros to
    ``bucket`` rows at an 8-byte aligned offset."""
    if len(prog.instrs) > MAX_REGS or len(prog.specs) > MAX_SPECS:
        raise ValueError(
            f"fused_group: {len(prog.instrs)} instructions and "
            f"{len(prog.specs)} aggregates; K14 holds {MAX_REGS} and "
            f"{MAX_SPECS}")
    hw = header_words(prog)
    state = _state_init(prog)
    col_offs, nbytes = _col_offsets(prog, bucket)
    buf = np.zeros(nbytes, np.uint8)
    words = buf[:8 * (hw + len(state))].view(np.int64)
    _, item_offs, spec_words = out_layout(prog, bucket)
    words[:HDR_FIXED] = (len(prog.instrs), len(prog.col_dtypes),
                         0 if prog.terminal == "project" else 1,
                         prog.mask_reg, prog.outs, hw, hw, 0)
    p = HDR_FIXED
    for o, dt in zip(col_offs, prog.col_dtypes):
        words[p:p + 2] = (o, dt)
        p += 2
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
    lib.fused_group_launch.argtypes = [vp, ll, ll, vp, i, i, vp]
    lib.fused_group_launch.restype = i
    lib.fused_group_limits.argtypes = [i]
    lib.fused_group_limits.restype = i
    lib.fused_group_error_string.argtypes = [i]
    lib.fused_group_error_string.restype = ctypes.c_char_p
    got = tuple(lib.fused_group_limits(k) for k in range(3))
    if got != (MAX_REGS, MAX_SPECS, THREADS):
        raise _kernels.KernelError(
            f"csrc/fused_group.cu limits {got} != the wrapper's "
            f"{(MAX_REGS, MAX_SPECS, THREADS)}")
    return lib


def fused_group(prog: Program, buf: torch.Tensor, n: int,
                bucket: int) -> torch.Tensor:
    """The group's output bytes (uint8, on ``buf``'s device) from the
    packed input ``buf`` (:func:`pack_inputs`, uint8) of ``n`` live rows
    in a bucket of ``bucket``.

    CPU tensors run :func:`fused_group_ref`.  CUDA tensors launch K14 once
    on the current stream (it writes its aggregate state into ``buf``) and
    raise on a CUDA error; there is no fallback.  ``fused_group.launches``
    counts kernel launches."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("fused_group: buf must be a flat uint8 tensor")
    if not 0 < n <= bucket:
        raise ValueError(f"fused_group: n={n} outside (0, {bucket}]")
    dev = buf.device
    if dev.type == "cpu":
        return fused_group_ref(prog, buf, n, bucket)
    if dev.type != "cuda":
        raise ValueError(f"fused_group: unsupported device {dev}")
    nbytes, _, _ = out_layout(prog, bucket)
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    lib = load_kernel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-bucket // THREADS), sms * BLOCKS_PER_SM))
    with torch.cuda.device(dev):
        rc = lib.fused_group_launch(
            buf.data_ptr(), int(n), int(bucket), out.data_ptr(), blocks,
            8 * header_words(prog),
            torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "fused_group", rc, "launch")
    fused_group.launches += 1
    return out


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
