"""SQL parser for the mosaic_tpu_torch SQL surface.

Port copy of ``mosaic_tpu.sql.parser``: the same grammar and the same
dataclass tree, so a query parses to equal trees in both packages.  The
chip store's WHERE pushdown (``store/pushdown.py``) reads it; the engine
that executes the tree is not ported yet (ROADMAP §A7).

Reference counterpart: sql/extensions/MosaicSQL.scala:21-47 registers the
function surface into Spark's SQL parser; here (no Spark) a small
recursive-descent parser covers the query shapes the reference's docs and
Quickstart notebook actually use: projections with ``st_*``/``grid_*``
function calls, tessellate-explode generators, equi-joins on cell id,
filters (``is_core OR st_contains(...)``), grouped aggregation, ordering
and limits.

Grammar (case-insensitive keywords)::

    query   := (EXPLAIN ANALYZE?)? SELECT item (',' item)* FROM ref
               (JOIN ref ON expr)?
               (WHERE expr)? (GROUP BY expr (',' expr)*)?
               (ORDER BY expr (ASC|DESC)?)? (LIMIT int)?
    ref     := ident (AS? ident)?
    item    := '*' | expr (AS? ident)?
    expr    := OR-chain of AND-chains of NOT/comparison/arith terms;
               calls ``f(a, b, ...)``, qualified names ``t.col``,
               numeric/string/bool/NULL literals, parens, unary '-',
               ``IS [NOT] NULL``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple


# ---------------------------------------------------------------- AST

@dataclasses.dataclass
class Literal:
    value: object


@dataclasses.dataclass
class Column:
    name: str
    table: Optional[str] = None


@dataclasses.dataclass
class Star:
    pass


@dataclasses.dataclass
class Call:
    name: str
    args: List[object]


@dataclasses.dataclass
class Unary:
    op: str                    # '-' | 'not' | 'isnull' | 'notnull'
    operand: object


@dataclasses.dataclass
class Binary:
    op: str
    left: object
    right: object


@dataclasses.dataclass
class SelectItem:
    expr: object
    alias: Optional[str] = None


@dataclasses.dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclasses.dataclass
class Query:
    items: List[SelectItem]
    table: TableRef
    join: Optional[TableRef] = None
    join_on: Optional[object] = None
    join_kind: str = "inner"
    where: Optional[object] = None
    group_by: Optional[List[object]] = None
    having: Optional[object] = None
    order_by: Optional[List[Tuple[object, bool]]] = None   # (expr, desc)
    limit: Optional[int] = None
    explain: Optional[str] = None      # None | 'plan' | 'analyze'


# ------------------------------------------------------------- tokens

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?
             |\d+(?:[eE][+-]?\d+)?)
    | (?P<str>'(?:[^']|'')*')
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><>|!=|<=|>=|==|[=<>+\-*/%(),.\*])
    )""", re.VERBOSE)

_KEYWORDS = {"select", "from", "where", "group", "by", "order", "limit",
             "and", "or", "not", "as", "join", "on", "asc", "desc",
             "true", "false", "null", "is", "inner", "left", "outer",
             "having", "explain", "analyze"}


def _tokenize(sql: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m or m.end() == pos:
            if sql[pos:].strip():
                raise SQLParseError(f"unexpected character at: "
                                    f"{sql[pos:pos+20]!r}")
            break
        pos = m.end()
        if m.lastgroup == "num":
            out.append(("num", m.group("num")))
        elif m.lastgroup == "str":
            out.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.lastgroup == "id":
            word = m.group("id")
            if word.lower() in _KEYWORDS:
                out.append(("kw", word.lower()))
            else:
                out.append(("id", word))
        else:
            out.append(("op", m.group("op")))
    out.append(("eof", ""))
    return out


class SQLParseError(ValueError):
    pass


class _Parser:
    def __init__(self, sql: str):
        self.toks = _tokenize(sql)
        self.i = 0

    # -- token helpers
    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, val: Optional[str] = None) -> bool:
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, val: Optional[str] = None) -> str:
        k, v = self.next()
        if k != kind or (val is not None and v != val):
            want = val or kind
            raise SQLParseError(f"expected {want!r}, got {v!r}")
        return v

    # -- grammar
    def query(self) -> Query:
        explain = None
        if self.accept("kw", "explain"):
            explain = "analyze" if self.accept("kw", "analyze") \
                else "plan"
        self.expect("kw", "select")
        items = [self.select_item()]
        while self.accept("op", ","):
            items.append(self.select_item())
        self.expect("kw", "from")
        table = self.table_ref()
        join = join_on = None
        join_kind = "inner"
        if self.accept("kw", "inner"):
            self.expect("kw", "join")
            join = self.table_ref()
            self.expect("kw", "on")
            join_on = self.expr()
        elif self.accept("kw", "left"):
            self.accept("kw", "outer")
            self.expect("kw", "join")
            join_kind = "left"
            join = self.table_ref()
            self.expect("kw", "on")
            join_on = self.expr()
        elif self.accept("kw", "join"):
            join = self.table_ref()
            self.expect("kw", "on")
            join_on = self.expr()
        where = None
        if self.accept("kw", "where"):
            where = self.expr()
        group_by = None
        having = None
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by = [self.expr()]
            while self.accept("op", ","):
                group_by.append(self.expr())
        # standard SQL allows HAVING without GROUP BY (whole-table
        # implicit group)
        if self.accept("kw", "having"):
            having = self.expr()

        order_by = None
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            order_by = [self.order_item()]
            while self.accept("op", ","):
                order_by.append(self.order_item())
        limit = None
        if self.accept("kw", "limit"):
            limit = int(self.expect("num"))
        self.expect("eof")
        return Query(items, table, join, join_on, join_kind, where,
                     group_by, having, order_by, limit, explain)

    def order_item(self) -> Tuple[object, bool]:
        e = self.expr()
        desc = False
        if self.accept("kw", "desc"):
            desc = True
        else:
            self.accept("kw", "asc")
        return (e, desc)

    def table_ref(self) -> TableRef:
        name = self.expect("id")
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("id")
        elif self.peek()[0] == "id":
            alias = self.next()[1]
        return TableRef(name, alias)

    def select_item(self) -> SelectItem:
        if self.accept("op", "*"):
            return SelectItem(Star())
        e = self.expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("id")
        elif self.peek()[0] == "id":
            alias = self.next()[1]
        return SelectItem(e, alias)

    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.accept("kw", "or"):
            e = Binary("or", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.accept("kw", "and"):
            e = Binary("and", e, self.not_expr())
        return e

    def not_expr(self):
        if self.accept("kw", "not"):
            return Unary("not", self.not_expr())
        return self.comparison()

    def comparison(self):
        e = self.additive()
        k, v = self.peek()
        if k == "op" and v in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = {"==": "=", "<>": "!="}.get(v, v)
            return Binary(op, e, self.additive())
        if k == "kw" and v == "is":
            self.next()
            if self.accept("kw", "not"):
                self.expect("kw", "null")
                return Unary("notnull", e)
            self.expect("kw", "null")
            return Unary("isnull", e)
        return e

    def additive(self):
        e = self.multiplicative()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                e = Binary(v, e, self.multiplicative())
            else:
                return e

    def multiplicative(self):
        e = self.unary()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/", "%"):
                self.next()
                e = Binary(v, e, self.unary())
            else:
                return e

    def unary(self):
        if self.accept("op", "-"):
            return Unary("-", self.unary())
        return self.primary()

    def primary(self):
        k, v = self.next()
        if k == "num":
            return Literal(float(v) if ("." in v or "e" in v.lower())
                           else int(v))
        if k == "str":
            return Literal(v)
        if k == "kw" and v in ("true", "false"):
            return Literal(v == "true")
        if k == "kw" and v == "null":
            return Literal(None)
        if k == "op" and v == "(":
            e = self.expr()
            self.expect("op", ")")
            return e
        if k == "id":
            # call?
            if self.accept("op", "("):
                if self.accept("op", "*"):       # count(*)
                    self.expect("op", ")")
                    return Call(v.lower(), [Star()])
                args = []
                if not self.accept("op", ")"):
                    args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    self.expect("op", ")")
                return Call(v.lower(), args)
            # qualified column?
            if self.accept("op", "."):
                col = self.expect("id")
                return Column(col, table=v)
            return Column(v)
        raise SQLParseError(f"unexpected token {v!r}")


def parse(sql: str) -> Query:
    return _Parser(sql).query()
