"""H3 icosahedron constants.

The H3 grid (reference dependency: com.uber:h3 3.7.0 via JNI,
databrickslabs/mosaic pom.xml:92-96) is a fixed mathematical object: an
icosahedral aperture-7 hexagonal DGGS.  These constants pin down the
icosahedron orientation and per-face lattice azimuths that define it.  All
derived combinatorics (base cells, neighbor tables, face adjacency) are
GENERATED numerically from these by tools/gen_h3_tables.py and validated
for icosahedral symmetry + known H3 test vectors — nothing is copied from
the C library.
"""

import numpy as np

# ---------------------------------------------------------------- scalars
M_SQRT7 = 2.6457513110645905905016157536392604257102
M_RSQRT7 = 1.0 / M_SQRT7
M_SIN60 = np.sqrt(3.0) / 2.0
# rotation between Class II and Class III resolution axes: asin(sqrt(3/28))
M_AP7_ROT_RADS = float(np.arcsin(np.sqrt(3.0 / 28.0)))
# gnomonic scale of a res-0 unit: tan of the angular distance from an
# icosahedron face center to its vertices (validated in the generator)
RES0_U_GNOMONIC = 0.38196601125010500003
EPSILON = 1.0e-16

MAX_H3_RES = 15
NUM_ICOSA_FACES = 20
NUM_BASE_CELLS = 122

# ------------------------------------------------- icosahedron geometry
# Face center (lat, lng) in radians, faces 0-19.
FACE_CENTER_GEO = np.array([
    [0.803582649718989942, 1.248397419617396099],
    [1.307747883455638156, 2.536945009877921159],
    [1.054751253523952054, -1.347517358900396623],
    [0.600191595538186799, -0.450603909469755746],
    [0.491715428198773866, 0.401988202911306943],
    [0.172745327415618701, 1.678146885280433686],
    [0.605929321571350690, 2.953923329812411617],
    [0.427370518328979641, -1.888876200336285401],
    [-0.079066118549212831, -0.733429513380867741],
    [-0.230961644455383637, 0.506495587332349035],
    [0.079066118549212831, 2.408163140208925497],
    [0.230961644455383637, -2.635097066257444203],
    [-0.172745327415618701, -1.463445768309359553],
    [-0.605929321571350690, -0.187669323777381622],
    [-0.427370518328979641, 1.252716453253507838],
    [-0.600191595538186799, 2.690988744120037492],
    [-0.491715428198773866, -2.739604450678486295],
    [-0.803582649718989942, -1.893195233972397139],
    [-1.307747883455638156, -0.604647643711872080],
    [-1.054751253523952054, 1.794075294689396615],
], dtype=np.float64)

# Azimuth (radians, clockwise from north) from each face center to the
# vertex its Class II i-axis points at.  The j/k axes are this minus
# 2π/3 and 4π/3 (checked by the generator).
FACE_AXES_AZ_I = np.array([
    5.619958268523939882,
    5.760339081714187279,
    0.780213654393430055,
    0.430469363979999913,
    6.130269123335111400,
    2.692877706530642877,
    2.982963003477243874,
    3.532912002790141181,
    3.494305004259568154,
    3.003214169499538391,
    5.930472956509811562,
    0.138378484090254847,
    0.448714947059150361,
    0.158629650112549365,
    5.891865957979238535,
    2.711123289609793325,
    3.294508837434268316,
    3.804819692245439833,
    3.664438879055192436,
    2.361378999196363184,
], dtype=np.float64)


def face_center_xyz() -> np.ndarray:
    """[20, 3] unit vectors of face centers."""
    lat = FACE_CENTER_GEO[:, 0]
    lng = FACE_CENTER_GEO[:, 1]
    return np.stack([np.cos(lat) * np.cos(lng),
                     np.cos(lat) * np.sin(lng),
                     np.sin(lat)], axis=-1)


# max |ijk| coordinate sum at a Class II resolution (2 * 7^(res/2))
def max_dim_by_cii_res(res: int) -> int:
    assert res % 2 == 0
    return 2 * 7 ** (res // 2)


def unit_scale_by_cii_res(res: int) -> int:
    assert res % 2 == 0
    return 7 ** (res // 2)


def is_res_class_iii(res) -> bool:
    return res % 2 == 1
