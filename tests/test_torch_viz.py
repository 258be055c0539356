"""The port's result export (``utils.viz``) against the JAX package's.

tests/test_viz_arrow.py's three viz cases on both packages'
tessellations of ``nyc_zones(3, seed=4)`` at H3 res 8 (the JAX side on
its float64 numpy branches, the bit-exact parity path, as in
tests/test_torch_tessellate.py): the chip sets are bit-equal, and the
GeoJSON and SVG strings are equal byte for byte.
"""

import json

import numpy as np
import pytest

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu.bench.workloads import nyc_zones as jnyc_zones
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.utils.viz import cells_to_geojson as jcells_to_geojson
from mosaic_tpu.utils.viz import chips_to_geojson as jchips_to_geojson
from mosaic_tpu.utils.viz import render_svg as jrender_svg
from mosaic_tpu_torch.bench.workloads import nyc_zones
from mosaic_tpu_torch.core.index.factory import get_index_system
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.utils.viz import (cells_to_geojson, chips_to_geojson,
                                        render_svg)


@pytest.fixture(scope="module")
def chips():
    mp = pytest.MonkeyPatch()
    mp.setattr(jtess_module, "_f64_jit_enabled",
               lambda disable_env=None: False)
    try:
        jzones = jnyc_zones(3, seed=4)
        jcs = jtess_module.tessellate(jzones, 8, jget("H3"))
    finally:
        mp.undo()
    zones = nyc_zones(3, seed=4)
    cs = tessellate(zones, 8, get_index_system("H3"), device="cpu")
    assert np.array_equal(cs.cell_id, jcs.cell_id)
    assert np.array_equal(cs.geom_id, jcs.geom_id)
    assert np.array_equal(cs.is_core, jcs.is_core)
    assert np.asarray(cs.geoms.coords).tobytes() == \
        np.asarray(jcs.geoms.coords).tobytes()
    return (cs, zones), (jcs, jzones)


def test_chips_geojson(chips):
    (cs, _), (jcs, _) = chips
    text = chips_to_geojson(cs)
    assert text == jchips_to_geojson(jcs)
    fc = json.loads(text)
    assert len(fc["features"]) == len(cs)
    assert set(fc["features"][0]["properties"]) == {"cell_id", "geom_id",
                                                    "is_core"}


@pytest.mark.parametrize("with_values", [True, False])
def test_cells_geojson(chips, with_values):
    (cs, _), _ = chips
    cells = np.unique(cs.cell_id)[:20]
    vals = {int(c): float(i) for i, c in enumerate(cells)} \
        if with_values else None
    text = cells_to_geojson(cells, get_index_system("H3"), vals)
    assert text == jcells_to_geojson(cells, jget("H3"), vals)
    fc = json.loads(text)
    assert len(fc["features"]) == 20
    if with_values:
        assert fc["features"][3]["properties"]["value"] == 3.0
    ring = fc["features"][0]["geometry"]["coordinates"][0]
    assert ring[0] == ring[-1]


@pytest.mark.parametrize("values", ["ramp", None])
def test_render_svg(chips, values):
    (_, zones), (_, jzones) = chips
    vals = list(range(len(zones))) if values else None
    svg = render_svg(zones, values=vals)
    assert svg == jrender_svg(jzones, values=vals)
    assert svg.startswith("<svg") and svg.endswith("</svg>")
    assert svg.count("<path") == len(zones)
