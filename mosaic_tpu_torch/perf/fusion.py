"""Whole-query fusion: one K14 launch per operator group.

Port of ``mosaic_tpu.perf.fusion``.  The SQL engine dispatches one
operator at a time with a host round-trip at every boundary — the filter
materializes a mask and compacts on the host, then the projection or the
aggregation re-enters (often as a python loop) on the compacted copy.
The planner sees the whole plan first, so an eligible filter and its
projection or aggregation can instead run as one device pass: the rows'
columns go to the device once, the mask and every output are computed
there, and only the group's outputs come back, in one fetch (SOLAR's
adaptive selection, arxiv 2504.01292: learn per size class when fusion
wins).

In the JAX package the group is one jitted XLA program per (group
signature, pow2 size bucket), ``_build_program``.  The port compiles
nothing at run time, and a torch-op program would launch one kernel per
AST node and materialize every intermediate, the unfused dispatch this
module exists to replace.  So the group is encoded once into a typed
register program (:func:`encode_group`: one instruction per node, with
the dtype :class:`_TypeWalk` gives the node) that the fixed hand-written
kernel K14 (``csrc/fused_group.cu``, wrapper ``ops/fused_group.py``)
interprets row by row: one launch and one fetch per group execution.
Off the card the wrapper runs the program's plain version,
``fused_group_ref``.

Fusion is a **pure strategy transform** — results are bit-for-bit
identical to the unfused path — so eligibility is decided by typing rules
that guarantee numpy parity, the JAX package's:

* elementwise f32/f64 arithmetic and every comparison are single IEEE
  operations on both sides (K14 rounds each node once and is built with
  ``-fmad=false``), and pointwise ops commute with row compaction, so
  filter+project chains fuse over bool/int/float columns;
* ``min``/``max``/``count``/``first`` are order-independent exact;
  float ``sum``/``avg`` are NOT, so fused sums are restricted to integer
  columns and guarded at runtime by ``n * max|v| < 2**53``;
* mixed-dtype operands, ``%``, object/string/geometry columns,
  generators, GROUP BY/HAVING, Star expansion and registry calls break
  the group cleanly — those rows run the unfused path unchanged.

Programs are cached in :data:`~.jit_cache.kernel_cache` under
``fused:<opset>:<sig8>``, one entry per group signature (the JAX package
keys a compile per pow2 size bucket as well; an encoded program does not
depend on the bucket), so its ``misses`` count the programs encoded;
nothing compiles.  Every launch lands in the kernel ledger
(``obs.profiler``) under the same name and, its first included, feeds
the planner's ``fusion/<opset>`` cost coefficient, which
:meth:`~..sql.planner.Planner.decide_fusion` compares against the sum of
the members' unfused coefficients.  Cancellation keeps its one-chunk
guarantee: a ``checkpoint("fusion")`` probe runs at the group boundary
before any device work (fault site ``fusion.group``).

Stated divergence (ROADMAP C14): the JAX package's bailout when
``jax_enable_x64`` is off has no counterpart; torch keeps 64-bit types.
A K14 build or launch error is not a bailout: it raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics, recorder
from ..sql.parser import (Binary, Call, Column, Literal, Query, Star,
                          Unary)
from ..ops import fused_group as _fg
from .bucketing import pow2_bucket
from .jit_cache import kernel_cache

__all__ = ["FusionBailout", "FusionGroup", "FusionPlan", "FusedResult",
           "plan_fusion", "encode_group", "execute_group", "MIN_GROUP_OPS",
           "SUM_EXACT_BOUND"]

#: a group below this many member ops is not worth a launch — except
#: a lone aggregate, whose unfused path is a per-row python loop
MIN_GROUP_OPS = 2

#: fused integer sums require ``n * max|v|`` under this bound so the
#: int64 device sum and the unfused float64 accumulation are BOTH
#: exact (every partial sum representable) and therefore identical
SUM_EXACT_BOUND = float(2 ** 53)

#: numpy dtype kinds a fused column may carry (no unsigned — unary
#: minus and literal promotion differ between numpy and XLA there)
_ELIGIBLE_KINDS = "bif"

_CMP_OPS = ("=", "!=", "<", "<=", ">", ">=")
_ARITH_OPS = ("+", "-", "*")


class FusionBailout(Exception):
    """A planned-fused group cannot run fused after all (runtime shape
    of the data differs from the catalog pre-pass — e.g. a LEFT JOIN
    emitted NULLs, or an integer sum failed the exactness bound).  The
    engine falls back to the unfused path for the same stages."""


class _Ineligible(Exception):
    """Static eligibility walk: this expression/op breaks the group."""


# ------------------------------------------------------ group objects

@dataclasses.dataclass
class _AggSpec:
    """One fused aggregate output column."""

    kind: str              # countstar | count | sum | avg | min | max | first
    name: str              # output column name
    expr: object = None    # argument AST (None for count(*))


@dataclasses.dataclass
class FusionGroup:
    """One contiguous run of fusible operators, run as one K14 launch."""

    gid: str                       # "g1" — the EXPLAIN `fused` column
    ops: List[str]                 # member operator names, in order
    opset: str                     # "filter+aggregate" — cost-key part
    sig: str                       # sha1[:8] of exprs + column dtypes
    name: str                      # kernel-cache name: fused:<opset>:<sig>
    cols: List[Tuple[Optional[str], str, str]]  # (qualifier, name, dtype.str)
    raw_index: Dict[Tuple[Optional[str], str], int]  # AST (qual, name) -> col
    where: Optional[object]        # filter AST (None when not a member)
    terminal: str                  # "project" | "aggregate"
    item_names: List[str]          # project output names (project groups)
    item_exprs: List[object]       # project output ASTs
    agg_specs: List[_AggSpec]      # aggregate outputs (aggregate groups)
    sum_cols: List[int]            # col indices needing the 2**53 bound
    decision: object = None        # planner Decision that gated this
    est_n: int = 0                 # input-row estimate the gate used


class FusionPlan:
    """The query's fused groups (at most one in the current engine
    shape — the fusible region is filter → terminal — but the map API
    keeps EXPLAIN and the engine agnostic of that)."""

    def __init__(self, groups: Sequence[FusionGroup]):
        self.groups = list(groups)

    def gid_for(self, op: str) -> str:
        g = self.group_with(op)
        return g.gid if g is not None else "-"

    def group_with(self, op: str) -> Optional[FusionGroup]:
        for g in self.groups:
            if op in g.ops:
                return g
        return None


@dataclasses.dataclass
class FusedResult:
    """What one group execution produced for the engine."""

    rows_filter: int               # rows passing the fused WHERE
    mask: Optional[np.ndarray]     # host bool mask (project groups only)
    out: object                    # terminal Table (engine unpacks it)
    wall_s: float


# ------------------------------------------------- static eligibility

class _TypeWalk:
    """Type-inference walk over the expression AST, enforcing the
    numpy/XLA parity rules (the JAX package's, kept so both packages
    fuse exactly the same queries) and collecting referenced columns.

    Types are numpy dtypes for array-valued subexpressions, or the
    weak-literal markers ``"wi"``/``"wf"`` for python scalars (which
    both numpy and XLA promote without widening the array operand).
    """

    def __init__(self, resolver):
        self.resolver = resolver           # (name, qual) -> (qual, name, dtype)
        self.cols: List[Tuple[Optional[str], str, str]] = []
        self._index: Dict[Tuple[Optional[str], str], int] = {}
        #: every raw AST spelling seen -> column index, so the encoder
        #: can look Columns up without a resolver (an
        #: unqualified and a qualified reference share one input)
        self.raw: Dict[Tuple[Optional[str], str], int] = {}

    def col_index(self, qual, name) -> int:
        rq, rn, dt = self.resolver(name, qual)
        key = (rq, rn)
        if key not in self._index:
            self._index[key] = len(self.cols)
            self.cols.append((rq, rn, dt.str))
        self.raw[(qual, name)] = self._index[key]
        return self._index[key]

    # -- promotion rules (see module docstring) -----------------------

    @staticmethod
    def _combine(a, b, op: str):
        """Result type of a binary ``op`` — raises when numpy and XLA
        would promote differently (mixed concrete dtypes, small ints
        against float literals, ``%`` always)."""
        if op == "%":
            raise _Ineligible("% differs between numpy and XLA for "
                              "negative operands")
        weak_a, weak_b = isinstance(a, str), isinstance(b, str)
        if weak_a and weak_b:
            t = "wf" if "wf" in (a, b) else "wi"
        elif weak_a or weak_b:
            w, c = (a, b) if weak_a else (b, a)
            if c.kind == "b":
                raise _Ineligible("arithmetic on bool columns")
            if w == "wf" and c.kind == "i" and c.itemsize < 8:
                # numpy promotes int32 + float literal to f64; XLA
                # keeps the array width and lands on f32
                raise _Ineligible(
                    f"float literal against {c} widens differently")
            t = np.dtype(np.float64) if (w == "wf" and c.kind == "i") \
                else c
        else:
            if a != b:
                raise _Ineligible(f"mixed operand dtypes {a} vs {b}")
            if a.kind == "b":
                raise _Ineligible("arithmetic on bool columns")
            t = a
        if op == "/":
            if t in ("wi", "wf"):
                return "wf"
            if t.kind == "i":
                return np.dtype(np.float64)   # both sides: true divide
        return t

    def check_literal(self, e: Literal):
        v = e.value
        if isinstance(v, bool) or isinstance(v, (int, np.integer)):
            if not (-(2 ** 63) <= int(v) < 2 ** 63):
                raise _Ineligible("integer literal beyond int64")
            return "wi"
        if isinstance(v, (float, np.floating)):
            return "wf"
        raise _Ineligible(f"literal {v!r} is not numeric")

    def visit(self, e):
        """Type of ``e``; raises :class:`_Ineligible` on any construct
        whose fused evaluation could differ from the unfused one."""
        if isinstance(e, Literal):
            return self.check_literal(e)
        if isinstance(e, Column):
            _, _, dt = self.cols[self.col_index(e.table, e.name)]
            return np.dtype(dt)
        if isinstance(e, Unary):
            t = self.visit(e.operand)
            if e.op == "-":
                if isinstance(t, np.dtype) and t.kind == "b":
                    raise _Ineligible("unary minus on bool")
                return t
            if e.op == "not":
                return np.dtype(bool)
            if e.op in ("isnull", "notnull"):
                if not isinstance(t, np.dtype):
                    raise _Ineligible(f"{e.op} on a literal")
                return np.dtype(bool)
            raise _Ineligible(f"unary {e.op}")
        if isinstance(e, Binary):
            if e.op in ("and", "or"):
                self.visit(e.left)
                self.visit(e.right)
                return np.dtype(bool)
            a, b = self.visit(e.left), self.visit(e.right)
            self._literal_fits(e.left, b)
            self._literal_fits(e.right, a)
            t = self._combine(a, b, e.op)
            return np.dtype(bool) if e.op in _CMP_OPS else t
        raise _Ineligible(f"{type(e).__name__} breaks fusion")

    @staticmethod
    def _literal_fits(e, other) -> None:
        """An int literal beyond its partner column's dtype range
        promotes differently (numpy widens, XLA wraps/raises)."""
        if isinstance(e, Literal) and isinstance(other, np.dtype) and \
                other.kind == "i" and \
                isinstance(e.value, (int, np.integer)) and \
                not isinstance(e.value, bool):
            info = np.iinfo(other)
            if not (info.min <= int(e.value) <= info.max):
                raise _Ineligible(
                    f"literal {e.value} outside {other} range")


def _static_resolver(tables: Dict[str, object]):
    """Column resolution against the catalog tables, mirroring
    ``_Env.resolve`` semantics; only ndarray columns of eligible
    dtype resolve — everything else breaks the group."""

    def resolve(name: str, qual: Optional[str]):
        if qual is not None:
            t = tables.get(qual)
            if t is None or name not in t.columns:
                raise _Ineligible(f"unresolvable column {qual}.{name}")
            hits = [(qual, t)]
        else:
            hits = [(q, t) for q, t in tables.items()
                    if name in t.columns]
            if len(hits) != 1:
                raise _Ineligible(f"column {name!r} resolves to "
                                  f"{len(hits)} tables")
        q, t = hits[0]
        c = t.columns[name]
        if not isinstance(c, np.ndarray) or \
                c.dtype.kind not in _ELIGIBLE_KINDS or \
                c.dtype.itemsize > 8:
            raise _Ineligible(
                f"column {name!r} dtype "
                f"{getattr(c, 'dtype', type(c).__name__)} is host-only")
        return q, name, c.dtype

    return resolve


def _serialize(e, walk: _TypeWalk) -> str:
    """Deterministic AST spelling for the group signature (columns by
    collected index, so the signature is name-independent)."""
    if isinstance(e, Literal):
        v = e.value
        return f"L{type(v).__name__}:{v!r}"
    if isinstance(e, Column):
        return f"C{walk.col_index(e.table, e.name)}"
    if isinstance(e, Unary):
        return f"U{e.op}({_serialize(e.operand, walk)})"
    if isinstance(e, Binary):
        return (f"B{e.op}({_serialize(e.left, walk)},"
                f"{_serialize(e.right, walk)})")
    if isinstance(e, Call):
        args = ",".join("*" if isinstance(a, Star)
                        else _serialize(a, walk) for a in e.args)
        return f"A{e.name}({args})"
    raise _Ineligible(f"cannot serialize {type(e).__name__}")


def _check_agg_item(it, pos: int, walk: _TypeWalk,
                    default_name) -> _AggSpec:
    e = it.expr
    from ..sql.engine import AGGREGATES
    if not (isinstance(e, Call) and e.name in AGGREGATES):
        raise _Ineligible(f"non-aggregate item in implicit group")
    name = it.alias or default_name(e, pos)
    if e.name == "count":
        if len(e.args) == 0 or isinstance(e.args[0], Star):
            return _AggSpec("countstar", name)
        t = walk.visit(e.args[0])
        if not isinstance(t, np.dtype):
            raise _Ineligible("count of a literal")
        return _AggSpec("count", name, e.args[0])
    if len(e.args) != 1:
        raise _Ineligible(f"{e.name} arity")
    arg = e.args[0]
    t = walk.visit(arg)
    if not isinstance(t, np.dtype) or t.kind == "b":
        raise _Ineligible(f"{e.name} needs a numeric column expression")
    if e.name in ("sum", "avg", "mean"):
        # order-independent exactness needs integer values with a
        # runtime magnitude bound — and the bound needs the raw column,
        # so the argument must be a bare column reference
        if not isinstance(arg, Column) or t.kind != "i":
            raise _Ineligible(
                f"{e.name} fuses only over integer columns "
                "(float sums are reduction-order dependent)")
        kind = "avg" if e.name in ("avg", "mean") else "sum"
        return _AggSpec(kind, name, arg)
    if e.name in ("min", "max", "first"):
        return _AggSpec(e.name, name, arg)
    raise _Ineligible(f"aggregate {e.name}")


def plan_fusion(q: Query, session, plan) -> Optional[FusionPlan]:
    """The fusion pass: walk the planner's pre-pass plan, form the
    (single, in this engine shape) contiguous eligible group, and gate
    it through :meth:`~..sql.planner.Planner.decide_fusion`.  Returns
    None when fusion is off, nothing is eligible, or the planner says
    the unfused path is cheaper at this size class."""
    from ..config import default_config
    from ..sql.engine import AGGREGATES, GENERATORS
    from ..sql.planner import planner
    cfg = default_config()
    if not getattr(cfg, "fusion_enabled", True):
        return None
    if any(isinstance(it.expr, Call) and it.expr.name in GENERATORS
           for it in q.items):
        return None          # exploded columns are host-shaped (wkb)
    try:
        tables = {(q.table.alias or q.table.name).lower():
                  session.table(q.table.name)}
        if q.join is not None:
            tables[(q.join.alias or q.join.name).lower()] = \
                session.table(q.join.name)
    except Exception:
        return None          # engine will raise its own error
    has_agg = any(isinstance(it.expr, Call) and
                  it.expr.name in AGGREGATES for it in q.items)

    def eligible(member: str) -> bool:
        """Probe one candidate member with a throwaway collector."""
        w = _TypeWalk(_static_resolver(tables))
        try:
            if member == "filter":
                w.visit(q.where)
            elif member == "aggregate":
                if q.group_by is not None or q.having is not None:
                    raise _Ineligible("grouped aggregation is host-side")
                for pos, it in enumerate(q.items):
                    _check_agg_item(it, pos, w, session._default_name)
            else:                                  # project
                for it in q.items:
                    if isinstance(it.expr, Star):
                        raise _Ineligible("Star expansion")
                    t = w.visit(it.expr)
                    if not isinstance(t, np.dtype):
                        raise _Ineligible("constant projection")
            return True
        except _Ineligible:
            return False

    terminal = "aggregate" if (q.group_by is not None or has_agg) \
        else "project"
    ops: List[str] = []
    if q.where is not None and eligible("filter"):
        ops.append("filter")
    if eligible(terminal):
        ops.append(terminal)
    elif ops:
        ops = []             # [filter] alone is not worth a compile
    if "aggregate" not in ops and len(ops) < MIN_GROUP_OPS:
        return None
    max_ops = max(int(getattr(cfg, "fusion_max_ops", 8)), 1)
    while len(ops) > max_ops:
        ops.pop(0)           # keep the terminal; earlier ops unfuse
    if "aggregate" not in ops and len(ops) < MIN_GROUP_OPS:
        return None

    # final pass with ONE shared collector, in member order, so column
    # indices (and the signature) are deterministic
    walk = _TypeWalk(_static_resolver(tables))
    parts: List[str] = []
    where = None
    item_names: List[str] = []
    item_exprs: List[object] = []
    agg_specs: List[_AggSpec] = []
    try:
        if "filter" in ops:
            where = q.where
            walk.visit(where)
            parts.append(f"F:{_serialize(where, walk)}")
        if ops[-1] == "aggregate":
            for pos, it in enumerate(q.items):
                agg_specs.append(_check_agg_item(
                    it, pos, walk, session._default_name))
            parts.append("A:" + ";".join(
                f"{s.kind}:{_serialize(s.expr, walk) if s.expr is not None else '*'}"
                for s in agg_specs))
        else:
            for pos, it in enumerate(q.items):
                walk.visit(it.expr)
                item_names.append(it.alias or
                                  session._default_name(it.expr, pos))
                item_exprs.append(it.expr)
            parts.append("P:" + ";".join(
                f"{n}={_serialize(e, walk)}"
                for n, e in zip(item_names, item_exprs)))
    except _Ineligible:       # raced catalog change; stay unfused
        return None
    sum_cols = sorted({walk.col_index(s.expr.table, s.expr.name)
                       for s in agg_specs if s.kind in ("sum", "avg")})
    opset = "+".join(ops)
    src = (opset + "|" + ";".join(parts) + "|" +
           ",".join(dt for _, _, dt in walk.cols))
    sig = hashlib.sha1(src.encode()).hexdigest()[:8]
    n_est = len(next(iter(tables.values())))
    step = plan.steps.get(ops[0]) if plan is not None else None
    if step is not None and step.key_n > 0:
        n_est = step.key_n
    d = planner.decide_fusion(opset, ops, n_est)
    if d.strategy != "fused":
        return None
    group = FusionGroup(
        gid="g1", ops=ops, opset=opset, sig=sig,
        name=f"fused:{opset}:{sig}", cols=walk.cols,
        raw_index=dict(walk.raw), where=where,
        terminal=ops[-1], item_names=item_names, item_exprs=item_exprs,
        agg_specs=agg_specs, sum_cols=sum_cols, decision=d,
        est_n=n_est)
    return FusionPlan([group])


# ------------------------------------------------------------ encoding

class _Encoder:
    """Emits a group's :class:`~..ops.fused_group.Program`.

    Mirrors ``_jnp_eval`` of the JAX package node for node, with the
    dtype :class:`_TypeWalk` gives each node made explicit: a subtree of
    literals folds to a python value (weak-typed, as python computes it);
    a literal meeting a column is rounded to the combined dtype once; an
    operand of another dtype is cast to it first (integers to float64
    for ``/`` and against a float literal)."""

    def __init__(self, group: "FusionGroup"):
        self.group = group
        self.b = _fg.ProgramBuilder([np.dtype(dt) for _, _, dt
                                     in group.cols])

    # values: ("lit", python value, "wi" | "wf" | "b") or
    # ("reg", register, dtype code)
    def _type(self, v):
        if v[0] == "reg":
            return _fg.DTYPES[v[2]]
        return np.dtype(bool) if v[2] == "b" else v[2]

    def reg_of(self, v, dt: int) -> int:
        """``v`` as a register of dtype code ``dt``."""
        if v[0] == "lit":
            return self.b.const(np.array(v[1], dtype=_fg.DTYPES[dt])
                                .item(), dt)
        if v[2] == dt:
            return v[1]
        return self.b.emit("cast", dt, v[1], v[2])

    def mask(self, v) -> int:
        """``_jnp_mask``: scalars broadcast, numerics cast to bool (NaN
        -> True)."""
        if v[0] == "lit":
            return self.b.const(int(bool(v[1])), _fg.BOOL)
        if v[2] == _fg.BOOL:
            return v[1]
        return self.b.emit("mask", v[2], v[1])

    def visit(self, e):
        if isinstance(e, Literal):
            v = e.value
            return ("lit", v, "wf" if isinstance(v, (float, np.floating))
                    else "wi")
        if isinstance(e, Column):
            ci = self.group.raw_index[(e.table, e.name)]
            return ("reg", self.b.load(ci), self.b.col_dtypes[ci])
        if isinstance(e, Unary):
            v = self.visit(e.operand)
            if e.op == "-":
                if v[0] == "lit":
                    return ("lit", -v[1], v[2])
                return ("reg", self.b.emit("neg", v[2], v[1]), v[2])
            if e.op == "not":
                return ("reg", self.b.emit("not", _fg.BOOL, self.mask(v)),
                        _fg.BOOL)
            isna = self.b.emit("isnan", v[2], v[1])
            if e.op == "isnull":
                return ("reg", isna, _fg.BOOL)
            return ("reg", self.b.emit("not", _fg.BOOL, isna), _fg.BOOL)
        if isinstance(e, Binary):
            if e.op in ("and", "or"):
                a = self.mask(self.visit(e.left))
                b = self.mask(self.visit(e.right))
                return ("reg", self.b.emit(e.op, _fg.BOOL, a, b), _fg.BOOL)
            a, b = self.visit(e.left), self.visit(e.right)
            if a[0] == "lit" and b[0] == "lit":
                import operator as op_
                fn = {"+": op_.add, "-": op_.sub, "*": op_.mul,
                      "/": op_.truediv, "=": op_.eq, "!=": op_.ne,
                      "<": op_.lt, "<=": op_.le, ">": op_.gt,
                      ">=": op_.ge}[e.op]
                r = fn(a[1], b[1])
                if e.op in _CMP_OPS:
                    return ("lit", bool(r), "b")
                return ("lit", r, "wf" if isinstance(r, float) else "wi")
            t = _TypeWalk._combine(self._type(a), self._type(b), e.op)
            dt = _fg.DT_CODE[np.dtype(t)]
            ra, rb = self.reg_of(a, dt), self.reg_of(b, dt)
            if e.op in _CMP_OPS:
                return ("reg", self.b.emit(e.op, dt, ra, rb), _fg.BOOL)
            return ("reg", self.b.emit(e.op, dt, ra, rb), dt)
        raise FusionBailout(f"cannot encode {type(e).__name__}")

    def array(self, e) -> Tuple[int, int]:
        """(register, dtype code) of an array-valued output (the type
        walk admits no literal output but a comparison of two)."""
        v = self.visit(e)
        if v[0] == "lit":
            return self.mask(v), _fg.BOOL
        return v[1], v[2]


def encode_group(group: FusionGroup) -> "_fg.Program":
    """The group's K14 program: the WHERE mask (when the filter is a
    member), then the projected columns or the aggregate specs."""
    enc = _Encoder(group)
    mask_reg = -1
    if group.where is not None:
        mask_reg = enc.mask(enc.visit(group.where))
    if group.terminal == "project":
        items = [enc.array(e) for e in group.item_exprs]
        return enc.b.finish("project", mask_reg, items=items)
    specs = []
    for spec in group.agg_specs:
        kind = _fg.AGG_KINDS[spec.kind]
        if spec.kind == "countstar":
            specs.append((kind, -1, _fg.BOOL))
        else:
            reg, dt = enc.array(spec.expr)
            specs.append((kind, reg, dt))
    return enc.b.finish("aggregate", mask_reg, specs=specs)


# --------------------------------------------------------- execution

def execute_group(group: FusionGroup, q: Query, env,
                  session) -> FusedResult:
    """Run one fused group over the engine's live environment: one K14
    launch on the session's device (its plain version off the card) and
    one fetch.

    Re-checks runtime eligibility against the ACTUAL columns (a LEFT
    JOIN may have null-converted what the catalog pre-pass saw, an
    integer sum may exceed the exactness bound) and raises
    :class:`FusionBailout` — never a wrong answer — when the data
    disagrees with the plan."""
    import torch
    from ..obs.devicemon import devicemon
    from ..obs.inflight import (charge_d2h_bytes, charge_h2d_bytes,
                                checkpoint, note_fusion_group)
    from ..obs.memwatch import device_keys_of, memwatch
    from ..obs.profiler import ledger
    from ..resilience import faults
    from ..sql.engine import Table
    from ..sql.planner import planner

    n = session._env_len(env)
    if n == 0:
        raise FusionBailout("empty input")
    cols: List[np.ndarray] = []
    for qual, name, dt in group.cols:
        try:
            c = env.resolve(name, qual)
        except Exception as e:
            raise FusionBailout(f"column {name!r}: {e}") from e
        if not isinstance(c, np.ndarray) or c.dtype.str != dt:
            raise FusionBailout(
                f"column {name!r} is {getattr(c, 'dtype', type(c).__name__)}"
                f" at runtime, planned {dt}")
        cols.append(c)
    for ci in group.sum_cols:
        mx = float(np.abs(cols[ci]).max()) if len(cols[ci]) else 0.0
        if mx * n >= SUM_EXACT_BOUND:
            raise FusionBailout(
                f"integer sum over column {group.cols[ci][1]!r} may "
                f"exceed 2**53 (n={n}, max|v|={mx:.0f}) — exactness "
                "not guaranteed in either order")

    # group boundary: the cooperative cancellation probe + chaos site
    # (a cancel landing mid-stall raises at the NEXT stage boundary)
    checkpoint("fusion")
    faults.stall("fusion.group")

    bucket = pow2_bucket(n)
    # a miss encodes the group's program, outside the timed launch below
    prog = kernel_cache.get_or_build(group.name, (),
                                     lambda: encode_group(group))
    # the columns as the JAX program's inputs: padded to the bucket
    h2d = sum(bucket * c.dtype.itemsize for c in cols)
    if metrics.enabled:
        metrics.count("fusion/h2d_bytes", h2d)
    charge_h2d_bytes(h2d)
    dev = torch.device(getattr(session.mc, "device", "cpu"))
    if dev.type == "cuda":
        # K14 builds at its first use in a process; build it before the
        # clock starts, so that no launch's wall holds a build (the JAX
        # package's first call at a bucket compiles, and it keeps that
        # wall out of the planner; the port has none to keep out)
        _fg.load_kernel()
    t0 = time.perf_counter()
    host_in = torch.from_numpy(_fg.pack_inputs(prog, cols, n, bucket))
    if dev.type == "cuda":
        buf = host_in.pin_memory().to(dev, non_blocking=True)
    else:
        buf = host_in
    dev_out = _fg.fused_group(prog, buf, n, bucket)
    # the group's device output lives from launch to the one fetch
    # below — register the span so the memory ledger attributes the
    # group's device footprint to this query's trace
    mem_tok = memwatch.register(
        f"fusion/{group.name}", int(dev_out.numel()),
        devices=device_keys_of(dev_out)) if memwatch.enabled else None
    try:
        out = dev_out.cpu().numpy()           # the ONE group fetch
    finally:
        # a fetch unwinding (cancel, chaos fault) must still drain the
        # span — a stranded token reads as a leak
        memwatch.release(mem_tok)
    wall = time.perf_counter() - t0
    host = _fg.unpack_outputs(prog, out, bucket)
    d2h = sum(int(np.asarray(h).nbytes) for h in host)
    if metrics.enabled:
        metrics.count("fusion/groups")
        metrics.count("fusion/fetches")
        metrics.count("fusion/d2h_bytes", d2h)
    # the fused fetch bypasses pipeline.stream, so charge the owning
    # query here — same trace join the device-seconds charge uses
    charge_d2h_bytes(d2h)
    ledger.observe(group.name, (), wall, rows=n)
    devicemon.attribute(group.name, wall)
    planner.observe_op(f"fusion/{group.opset}", n, wall)
    note_fusion_group(group.name)
    recorder.record("fusion_group", name=group.name, rows=n,
                    bucket=bucket, wall_ms=round(wall * 1e3, 3))

    rows_filter = int(host[0])
    if group.terminal == "project":
        mask = host[1]
        out_t = Table({name: col[mask] for name, col in
                       zip(group.item_names, host[2:])})
        return FusedResult(rows_filter, mask, out_t, wall)
    out_cols: Dict[str, object] = {}
    i = 1
    for spec in group.agg_specs:
        if spec.kind in ("countstar", "count"):
            out_cols[spec.name] = np.asarray([int(host[i])], np.int64)
            i += 1
            continue
        v, cnt = host[i], int(host[i + 1])
        i += 2
        if spec.kind == "avg":
            out_cols[spec.name] = np.asarray(
                [float(v) / cnt if cnt else np.nan])
        else:
            out_cols[spec.name] = np.asarray(
                [float(v) if cnt else np.nan])
    return FusedResult(rows_filter, None, Table(out_cols), wall)
