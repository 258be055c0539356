"""Tessellation of the PyTorch port against the JAX package's.

The port carries the float64 numpy branches of core/tessellate.py, which
the JAX package calls its bit-exact parity path and takes whenever
``_f64_jit_enabled()`` is false.  The JAX side runs on those branches
here: its jitted f64 kernels round chip coordinates differently in the
last bits, and classify an edge that exactly touches a cell differently
(a CUSTOM res-1 cell of the quadrilateral below).  ChipSets must then be
bit-equal: cell_id, geom_id, is_core and every chip coordinate and
offset.
"""

import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu import read_wkt as jread_wkt
from mosaic_tpu.bench.workloads import build_workload as jbuild
from mosaic_tpu.core.index.custom import CustomIndexSystem as JCustom
from mosaic_tpu.core.index.custom import GridConf as JConf
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.core.tessellate import tessellate as jtess
from mosaic_tpu_torch.bench.workloads import build_workload as tbuild
from mosaic_tpu_torch.core.geometry.wkt import read_wkt as tread_wkt
from mosaic_tpu_torch.core.index.custom import CustomIndexSystem as TCustom
from mosaic_tpu_torch.core.index.custom import GridConf as TConf
from mosaic_tpu_torch.core.index.factory import get_index_system as tget
from mosaic_tpu_torch.core.tessellate import tessellate as ttess


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_numpy_branches(monkeypatch):
    monkeypatch.setattr(jtess_module, "_f64_jit_enabled",
                        lambda disable_env=None: False)


def assert_chipsets_equal(j, t):
    assert np.array_equal(j.cell_id, t.cell_id)
    assert np.array_equal(j.geom_id, t.geom_id)
    assert np.array_equal(j.is_core, t.is_core)
    for f in ("coords", "ring_offsets", "part_offsets", "geom_offsets",
              "types"):
        assert np.array_equal(np.asarray(getattr(j.geoms, f)),
                              np.asarray(getattr(t.geoms, f))), f


def test_taxi_workload_res9_bit_equal():
    jp, jg, res = jbuild(n_side=4, grid_name="H3", zones="taxi")
    tp, tg, tres = tbuild(n_side=4, grid_name="H3", zones="taxi")
    # the workload itself: same seeds, byte-identical polygons
    assert res == tres == 9
    assert np.asarray(jp.coords).tobytes() == np.asarray(tp.coords).tobytes()
    assert np.array_equal(jp.ring_offsets, tp.ring_offsets)
    j = jtess(jp, res, jg, keep_core_geom=False)
    t = ttess(tp, res, tg, keep_core_geom=False, device="cpu")
    assert len(t) > 1000 and t.is_core.any() and (~t.is_core).any()
    assert_chipsets_equal(j, t)


CUSTOM_WKT = [
    "POLYGON ((0.5 0.5, 7.5 0.5, 7.5 7.5, 0.5 7.5, 0.5 0.5),"
    " (2.5 2.5, 5.5 2.5, 5.5 5.5, 2.5 5.5, 2.5 2.5))",
    "MULTIPOLYGON (((8.2 8.2, 10.9 8.4, 10.1 11.3, 8.2 8.2)),"
    " ((12.1 1.1, 15.5 1.3, 14.2 4.8, 12.1 1.1),"
    " (13.0 2.0, 14.0 2.2, 13.6 3.1, 13.0 2.0)))",
    "POLYGON ((1.3 1.7, 6.8 2.1, 5.9 6.3, 2.2 5.8, 1.3 1.7))",
    "POINT (2.2 3.3)",
    "LINESTRING (0.5 0.5, 3.5 0.5)",
]


@pytest.mark.parametrize("res", [0, 1])
def test_holes_and_multipolygons_custom_grid_bit_equal(res):
    j = jtess(jread_wkt(CUSTOM_WKT), res,
              JCustom(JConf(0, 16, 0, 16, 2, 1.0, 1.0)))
    t = ttess(tread_wkt(CUSTOM_WKT), res,
              TCustom(TConf(0, 16, 0, 16, 2, 1.0, 1.0)), device="cpu")
    assert_chipsets_equal(j, t)


def test_h3_polygon_with_hole_keep_core_bit_equal():
    wkt = ["POLYGON ((-74.02 40.70, -73.95 40.70, -73.95 40.76,"
           " -74.02 40.76, -74.02 40.70),"
           " (-74.00 40.72, -73.98 40.72, -73.98 40.74, -74.00 40.74,"
           " -74.00 40.72))"]
    assert jget("CUSTOM(0,16,0,16,2,1,1)") is not None
    j = jtess(jread_wkt(wkt), 9, jget("H3"), keep_core_geom=True)
    t = ttess(tread_wkt(wkt), 9, tget("H3"), keep_core_geom=True,
              device="cpu")
    assert t.is_core.sum() > 0
    assert_chipsets_equal(j, t)
