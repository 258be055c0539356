"""H3 grid of the PyTorch port against the JAX package's.

The port keeps its own numpy copy of the H3 modules; the same inputs
must give bit-equal cell ids, centers, boundaries and candidate cells.
Fixtures follow tests/test_h3.py and tests/test_h3_canonical.py.
"""

import numpy as np
import pytest
import torch

import mosaic_tpu.core.index.h3.index as jix
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu_torch.core.index.factory import get_index_system as tget
from mosaic_tpu_torch.core.index.h3 import index as tix
from mosaic_tpu_torch.core.index.h3.system import H3IndexSystem


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    return jget("H3"), tget("H3")


@pytest.fixture(scope="module")
def rng_pts():
    rng = np.random.default_rng(7)
    n = 5000
    lat = np.arcsin(rng.uniform(-1, 1, n))
    lng = rng.uniform(-np.pi, np.pi, n)
    return np.stack([lat, lng], -1)


@pytest.mark.parametrize("res", [0, 1, 2, 5, 9, 15])
def test_cells_centers_boundaries_bit_equal(grids, rng_pts, res):
    jg, tg = grids
    xy = np.degrees(rng_pts[:, ::-1])
    jc = jg.point_to_cell(xy, res)
    tc = tg.point_to_cell(xy, res)
    assert np.array_equal(jc, tc)
    assert np.array_equal(jg.cell_center(jc), tg.cell_center(tc))
    jv, jn = jg.cell_boundary(jc)
    tv, tn = tg.cell_boundary(tc)
    assert np.array_equal(jn, tn)
    assert np.array_equal(jv, tv)
    assert np.array_equal(jix.cell_to_parent(jc, max(res - 1, 0)),
                          tix.cell_to_parent(tc, max(res - 1, 0)))


def test_published_vectors():
    # h3.geo_to_h3(37.3615593, -122.0553238, 5) == '85283473fffffff'
    cell = tix.latlng_to_cell(np.radians([[37.3615593, -122.0553238]]), 5)
    assert format(int(cell[0]), "x") == "85283473fffffff"
    # h3.k_ring('8928308280fffff', 1) (h3-py docs example)
    want = {"8928308280fffff", "8928308280bffff", "89283082873ffff",
            "89283082877ffff", "8928308283bffff", "89283082807ffff",
            "89283082803ffff"}
    ring = tix.k_ring(np.array([0x8928308280fffff], np.int64), 1)[0]
    assert {format(int(c), "x") for c in ring if c >= 0} == want
    cells = np.array([622236750694711295, 623060282076758015], np.int64)
    assert np.array_equal(tix.latlng_to_cell(tix.cell_to_latlng(cells), 10),
                          cells)
    area = H3IndexSystem().cell_area(np.array([0x871969500ffffff],
                                              np.int64))
    assert area[0] == pytest.approx(4.327624974422719, rel=2e-4)


@pytest.mark.parametrize("bbox,res", [
    ((-74.30, 40.45, -73.65, 40.95), 7),       # the NYC workload bbox
    ((-74.02, 40.70, -73.95, 40.76), 9),
    ((10.0, 69.0, 30.0, 71.0), 4),              # high latitude span
])
def test_candidate_cells_bit_equal(grids, bbox, res):
    jg, tg = grids
    bb = np.asarray(bbox, np.float64)
    assert np.array_equal(jg.candidate_cells(bb, res),
                          tg.candidate_cells(bb, res))


def test_candidate_cells_batch_and_sagitta_bit_equal(grids):
    jg, tg = grids
    rng = np.random.default_rng(3)
    lo = np.stack([rng.uniform(-74.3, -73.8, 12),
                   rng.uniform(40.45, 40.9, 12)], -1)
    bbs = np.concatenate([lo, lo + rng.uniform(0.005, 0.05, (12, 2))], 1)
    jb = jg.candidate_cells_batch(bbs, 9)
    tb = tg.candidate_cells_batch(bbs, 9)
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert np.array_equal(a, b)
    cells = np.unique(np.concatenate(tb))
    assert jg.cells_edge_sagitta_deg(cells) == \
        tg.cells_edge_sagitta_deg(cells)
    assert jg._cell_metrics_deg(9) == tg._cell_metrics_deg(9)


def test_bng_not_ported_yet():
    """BNG is ported now (the name predates it): the factory gives the
    port's grid, with the JAX package's ids."""
    bng, jbng = tget("BNG"), jget("BNG")
    assert bng.name == "BNG" and type(bng).__module__.startswith(
        "mosaic_tpu_torch.")
    en = np.random.default_rng(1).uniform(0, 700_000, (100, 2))
    assert np.array_equal(bng.point_to_cell(en, 4),
                          jbng.point_to_cell(en, 4))
    custom = tget("CUSTOM(0,16,0,16,2,1,1)")
    jcustom = jget("CUSTOM(0,16,0,16,2,1,1)")
    xy = np.random.default_rng(0).uniform(0, 16, (100, 2))
    assert np.array_equal(custom.point_to_cell(xy, 2),
                          jcustom.point_to_cell(xy, 2))
