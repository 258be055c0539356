"""The fused SQL groups K14 is held on: tables (seeded numpy columns) and
queries.

``tests/test_torch_fusion.py`` runs them on the CPU, the port's plain
version ``fused_group_ref`` against the JAX package's ``_build_program``;
``chip_smoke.py`` phase 22b runs them through K14 on the card against
``fused_group_ref`` over the same packed buffer.  numpy only: no JAX and
no torch, so the chip script can import it.
"""

import numpy as np


def fx_table(n=4000):
    """tests/test_fusion.py's table: NaN in ``px``, a string column."""
    rng = np.random.default_rng(42)
    px = rng.normal(size=n)
    px[::53] = np.nan
    return {"px": px, "py": rng.normal(size=n),
            "k": rng.integers(0, 100, size=n),
            "b32": rng.integers(0, 9, size=n).astype(np.int32),
            "flag": rng.integers(0, 2, size=n).astype(bool),
            "tag": np.array(["a", "b"] * (n // 2))}


#: groups over ``fx``: every aggregate kind, a projection of each dtype
PROGRAM_CASES = [
    "SELECT count(*) AS n, max(px) AS mx, min(py) AS mn, sum(k) AS sk, "
    "avg(k) AS ak, first(py) AS fp, count(px) AS c FROM fx "
    "WHERE px*px + py*py < 1.44 AND px > 0.1",
    "SELECT -px AS np_, (k + 1) / 2 AS h, px * 0.5 + py AS m, flag AS f, "
    "b32 * 3 AS t FROM fx WHERE flag OR py > 1.0",
    "SELECT count(*) AS n, first(k) AS f, min(b32) AS mb FROM fx "
    "WHERE px IS NOT NULL AND py < 0.0",
    "SELECT sum(k) AS s, max(k) AS mx, first(b32) AS fb FROM fx",
]


def hazard_table(n=300, seed=3):
    """NaN, signed zeros, int64 and int32 extremes, and the narrow
    dtypes int8, int16 and float16."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 1e3
    x[::17] = np.nan
    z = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    big = rng.integers(-(2 ** 62), 2 ** 62, size=n)
    big[:4] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min,
               np.iinfo(np.int64).max - 1, -1]
    t = {"x": x, "y": rng.normal(size=n), "z": z,
         "w": rng.normal(size=n).astype(np.float32),
         "k": rng.integers(-50, 50, size=n), "big": big,
         "b32": rng.integers(-(2 ** 31), 2 ** 31 - 1, size=n,
                             dtype=np.int64).astype(np.int32)}
    h16 = (rng.normal(size=n) * 300).astype(np.float16)
    h16[::23] = np.nan
    t.update(a8=rng.integers(-128, 128, size=n).astype(np.int8),
             a16=rng.integers(-2 ** 15, 2 ** 15, size=n).astype(np.int16),
             h16=h16)
    return t


HAZARDS = {
    # products and sums rounded one by one, never contracted
    "fma": "SELECT x * 0.1 + y AS a, x * 2 + 1 AS u, x * y - y AS b "
           "FROM h WHERE k < 40",
    # float literal against int64 and float32, int / int
    "promotion": "SELECT k * 0.5 AS a, w * 0.1 AS b, w * 0.5 AS v, "
                 "k / 3 AS c, w + 1 AS d FROM h WHERE w < 0.3",
    # int64 and int32 wrap around
    "overflow": "SELECT big + 1 AS a, big * 3 AS b, -big AS c, "
                "b32 * 1000 AS d, b32 + 2147483647 AS e FROM h "
                "WHERE k > -60",
    # NaN: true as a mask, false in = and <, true in !=
    "nan_mask": "SELECT count(*) AS n FROM h WHERE x OR k = 1000",
    "nan_cmp": "SELECT count(*) AS n, count(x) AS c FROM h "
               "WHERE x = x OR x < 0.0",
    "nan_ne": "SELECT count(*) AS n FROM h WHERE x != x AND k < 100",
    "isnull_int": "SELECT count(*) AS n FROM h WHERE k IS NULL OR "
                  "x IS NULL",
    # -0.0 beside 0.0
    "signed_zero": "SELECT min(z) AS mn, max(z) AS mx, first(z) AS f "
                   "FROM h WHERE k < 40",
    # int8 and int16 wrap around; float16 rounded a node at a time
    "narrow": "SELECT a8 * 3 AS a, a16 + 30000 AS b, -a8 AS c, "
              "h16 * 0.5 AS d, h16 + h16 AS e, h16 / 3.0 AS f FROM h "
              "WHERE h16 < 100.0 OR a16 > 0",
    "narrow_agg": "SELECT min(h16) AS mn, max(h16) AS mx, first(h16) AS f, "
                  "count(h16) AS c, sum(a8) AS s8, max(a16) AS m16 "
                  "FROM h WHERE a8 > -100",
}

#: where XLA:CPU's program leaves numpy's rounding (the JAX package's own
#: fused path then differs from its unfused one by an ulp): it contracts
#: ``x * 0.1 + y`` into an FMA and divides by the constant 3 (int64 or
#: float16) through its reciprocal.  K14 follows numpy, the unfused
#: authority, bit for bit.
XLA_REWRITES = {"fma", "promotion", "narrow"}


#: -0.0 and 0.0 in both orders, and the query that reduces them
SIGNED_ZERO_QUERY = "SELECT min(z) AS mn, max(z) AS mx FROM h WHERE k >= 0"


def signed_zero_tables():
    return [{"z": np.tile(z, 50), "k": np.arange(150, dtype=np.int64)}
            for z in (np.array([0.0, -0.0, 0.0]),
                      np.array([-0.0, 0.0, -0.0]))]


#: row counts below their pow2 bucket, whose zero padding would pass the
#: query's ``k >= 0`` and give min 0
PADDING_ROWS = (1, 100, 129, 1000)
PADDING_QUERY = "SELECT count(*) AS n, min(x) AS mn, sum(k) AS s FROM h " \
    "WHERE k >= 0"


def padding_table(n):
    rng = np.random.default_rng(n)
    return {"k": rng.integers(0, 9, size=n),
            "x": rng.uniform(1.0, 2.0, size=n)}


def edge_table(n, seed=7):
    """The columns of the tile-edge groups: float64 with NaN, int64, float32,
    and the narrow bool, int8 and float16; ``r`` the row number.  Row 0
    passes the edge groups' WHERE."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[5::29] = np.nan
    k = rng.integers(-1000, 1000, size=n)
    b = rng.integers(0, 2, size=n).astype(bool)
    k[0], b[0] = 0, True
    h16 = (rng.normal(size=n) * 100).astype(np.float16)
    h16[3::31] = np.nan
    return {"x": x, "k": k, "w": rng.normal(size=n).astype(np.float32),
            "b": b, "a8": rng.integers(-128, 128, size=n).astype(np.int8),
            "h16": h16, "r": np.arange(n, dtype=np.int64)}


EDGE_AGGREGATE = (
    "SELECT count(*) AS n, count(x) AS cx, sum(k) AS sk, avg(k) AS ak, "
    "min(x) AS mnx, max(w) AS mxw, first(x) AS fx, first(k) AS fk, "
    "min(h16) AS mh, max(a8) AS ma FROM e WHERE k > -500 AND (b OR x < 0.5)")
EDGE_PROJECT = (
    "SELECT x * 2 + 1 AS u, w * 0.5 AS v, k * 3 AS t, b AS f, a8 + 1 AS g, "
    "h16 * 2.0 AS h FROM e WHERE k > -500")
#: first() whose least passing row lies in the last tile (of any T)
EDGE_FIRST_ROWS = 9000
EDGE_FIRST_LAST = (
    "SELECT count(*) AS n, first(x) AS fx, first(k) AS fk, first(w) AS fw, "
    f"first(h16) AS fh FROM e WHERE r >= {EDGE_FIRST_ROWS - 3}")
#: bool, int8 and float16 columns read and written at an odd n
EDGE_NARROW = ("SELECT b AS f, a8 AS g, h16 AS h, -a8 AS na FROM e "
               "WHERE h16 < 50.0 OR a8 > 0 OR b")

#: (label, rows, query) over ``edge_table(rows)``, table ``e``: n = 1, n
#: below one tile, n not a multiple of the tile rows, n equal to its pow2
#: bucket, first() in the last tile, narrow columns at an odd n
EDGE_CASES = [
    ("one row aggregate", 1, EDGE_AGGREGATE),
    ("one row project", 1, EDGE_PROJECT),
    ("below a tile aggregate", 77, EDGE_AGGREGATE),
    ("below a tile project", 77, EDGE_PROJECT),
    ("ragged last tile aggregate", 5003, EDGE_AGGREGATE),
    ("ragged last tile project", 5003, EDGE_PROJECT),
    ("full bucket aggregate", 4096, EDGE_AGGREGATE),
    ("full bucket project", 4096, EDGE_PROJECT),
    ("first in the last tile", EDGE_FIRST_ROWS, EDGE_FIRST_LAST),
    ("narrow columns at odd n", 1001, EDGE_NARROW),
]

#: the deep WHERE: a balanced sum of DEEP_COLS float64 columns, 127
#: instructions with the load of each column, the sums and the comparison;
#: its staged columns force K14's smallest tile
DEEP_COLS = 63
DEEP_ROWS = 3000


def deep_table(n=DEEP_ROWS, seed=63):
    rng = np.random.default_rng(seed)
    return {f"c{i}": rng.normal(size=n) for i in range(DEEP_COLS)}


def deep_query():
    def tree(lo, hi):
        if hi - lo == 1:
            return f"c{lo}"
        mid = (lo + hi) // 2
        return f"({tree(lo, mid)} + {tree(mid, hi)})"
    return (f"SELECT count(*) AS n, min(c0) AS m, max(c{DEEP_COLS - 1}) AS "
            f"mx FROM d WHERE {tree(0, DEEP_COLS)} > 0.0")
