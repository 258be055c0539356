"""The PyTorch port stands alone: no JAX, no mosaic_tpu, the card by
default.

* In a subprocess where ``jax`` and ``mosaic_tpu`` cannot be imported,
  the port imports and runs a small dense PIP join on the CPU, exact
  against its own oracle.
  So does the raster layer: a small DEM through ``raster_to_grid``,
  equal to per-cell means of the host cell ids; the chip store: a
  small store written, read back and fed to the store-fed join; and the
  geometry surface: the WKB and GeoJSON codecs, edge blocks with their
  measures and predicates (containment equal to the oracle), a hull, a
  triangulation, a buffer, a UTM round trip, the analyzer and a warp.
* No file of the port, nor chip_smoke.py, imports ``jax`` or
  ``mosaic_tpu`` (an ``ast`` scan over every subpackage, ``core/raster``,
  ``io`` and ``resilience`` among them; the root module name must match
  exactly, so ``mosaic_tpu_torch`` itself does not count).
* pyproject.toml's package data covers every file under ``csrc/`` and
  the ``.npz`` tables ``crs.py`` reads.
* Entry points that create device state (``build_edges`` and
  ``points_block`` among them), called without ``device`` on a host
  without CUDA, raise RuntimeError instead of running on the CPU; the
  planned join runs on its index's device.
"""

import ast
import fnmatch
import re
import subprocess
import tomllib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mosaic_tpu_torch as mt
from mosaic_tpu_torch.core.tessellate import convex_clip_rings

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "mosaic_tpu"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SLICE = r"""
import sys
sys.modules["jax"] = None
sys.modules["mosaic_tpu"] = None
import numpy as np
import torch
import mosaic_tpu_torch as mt
from mosaic_tpu_torch.core.tessellate import convex_clip_rings

torch.set_num_threads(1)
polys = mt.read_wkt([
    "POLYGON ((-74.02 40.70, -73.95 40.70, -73.95 40.76, -74.02 40.76,"
    " -74.02 40.70), (-74.00 40.72, -73.98 40.72, -73.98 40.74,"
    " -74.00 40.74, -74.00 40.72))",
    "POLYGON ((-73.95 40.70, -73.90 40.71, -73.91 40.76, -73.95 40.76,"
    " -73.95 40.70))"])
grid = mt.get_index_system("H3")
idx = mt.build_pip_index(polys, 9, grid, device="cpu")
rng = np.random.default_rng(0)
pts = np.stack([rng.uniform(-74.03, -73.89, 4000),
                rng.uniform(40.69, 40.77, 4000)], -1)
run = mt.make_streamed_pip_join(idx, grid, polys, chunk=1000, device="cpu")
zone, rechecked = run(pts)
assert np.array_equal(zone, mt.pip_host_truth(pts, polys))
from mosaic_tpu_torch import config
from mosaic_tpu_torch.sql.planner import planner
config.set_default_config(config.apply_conf(
    config.default_config(), "mosaic.planner.force.refine", "refined"))
refined = mt.make_refined_pip_join(polys, grid, 9, chunk=1000, device="cpu")
assert np.array_equal(refined(pts)[0], zone)
assert np.array_equal(mt.make_planned_pip_join(idx, grid, polys)(pts)[0],
                      zone)
assert planner.report()["decisions"] == 2
hist = mt.zone_histogram(torch.from_numpy(zone), len(polys))
assert int(hist.sum()) == int((zone >= 0).sum()) > 0
yy, xx = np.mgrid[0:40, 0:50]
dem = mt.RasterTile((np.sin(xx / 60.0) * 50 + yy * 0.1)[None],
                    mt.GeoTransform(-74.25, 0.0005, 0.0, 40.92, 0.0, -0.0005))
cells = mt.raster_to_grid([dem], 8, grid, combiner="avg", device="cpu")
cx, cy = dem.pixel_centers()
own = grid.point_to_cell(np.stack([cx.ravel(), cy.ravel()], -1), 8)
assert cells == {int(c): float(dem.data[0].ravel()[own == c].mean())
                 for c in np.unique(own)}
import tempfile
from mosaic_tpu_torch.store import ChipStore, write_store
with tempfile.TemporaryDirectory() as root:
    write_store(root, pts, columns={"i": np.arange(len(pts))},
                grid_res=4096, shard_rows=256)
    st = ChipStore(root)
    back = st.read_columns()
    order = back["i"]
    assert np.array_equal(np.stack([back["x"], back["y"]], -1), pts[order])
    sj = mt.make_store_sharded_pip_join(st, idx, grid, polys=polys,
                                        chunk=1000, device="cpu")
    szone, _ = sj()
    assert np.array_equal(szone, zone[order])
    assert sum(sj.staged_bytes_by_partition.values()) > 0
from mosaic_tpu_torch import analyzer
from mosaic_tpu_torch.core.geometry import (crs, geojson, measures, ops,
                                            predicates, triangulate, wkb)
from mosaic_tpu_torch.core.geometry.padded import build_edges, points_block
assert mt.write_wkt(wkb.read_wkb(wkb.write_wkb(polys))) == \
    mt.write_wkt(polys)
assert geojson.read_geojson(geojson.write_geojson(polys)).coords.tolist() \
    == polys.coords.tolist()
from mosaic_tpu_torch.core.geometry.clip import (_normalize_rings,
                                                 geometry_rings,
                                                 ring_signed_area)
e = build_edges(polys, dtype=torch.float64, device="cpu")
want = [sum(ring_signed_area(r) for r in
            _normalize_rings(geometry_rings(polys, i))) for i in range(2)]
assert np.allclose(measures.area(e).numpy(), want, rtol=1e-12)
inside, dist = predicates.points_in_polygons(
    torch.from_numpy(pts), e, with_boundary_dist=True)
first = np.where(inside.numpy().any(1), inside.numpy().argmax(1), -1)
assert np.array_equal(first, mt.pip_host_truth(pts, polys))
assert predicates.polygons_intersect(e, e).numpy().all()
hull = ops.convex_hull_points(pts)
verts, tri = triangulate.delaunay(pts[:50])
assert len(tri) > 0 and len(hull) >= 3
buf = ops.buffer_geometry(polys, 0.001)
assert len(buf) == 2
utm = crs.transform_xy(pts[:10], 4326, 32618)
assert np.abs(crs.transform_xy(utm, 32618, 4326) - pts[:10]).max() < 1e-9
assert analyzer.get_optimal_resolution(polys, grid) > 0
from mosaic_tpu_torch.core.raster import rops
warped = rops.warp(mt.RasterTile(dem.data, mt.GeoTransform(
    float(utm[0, 0]), 50.0, 0.0, float(utm[0, 1]), 0.0, -50.0),
    srid=32618), 4326)
assert warped.srid == 4326 and np.isfinite(warped.data).mean() > 0.9
assert len(points_block(polys, device="cpu")) == 2
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("SLICE_OK", int((zone >= 0).sum()), rechecked, len(cells))
"""


def test_slice_runs_without_jax_or_mosaic_tpu():
    out = subprocess.run([sys.executable, "-c", SLICE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SLICE_OK" in out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_mosaic_tpu():
    files = sorted((REPO / "mosaic_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"mosaic_tpu_torch/config.py",
            "mosaic_tpu_torch/sql/planner.py",
            "mosaic_tpu_torch/core/raster/tile.py",
            "mosaic_tpu_torch/core/raster/gtiff.py",
            "mosaic_tpu_torch/core/raster/rops.py",
            "mosaic_tpu_torch/core/raster/checkpoint.py",
            "mosaic_tpu_torch/io/raster_grid.py",
            "mosaic_tpu_torch/resilience/ingest.py",
            "mosaic_tpu_torch/parallel/raster_halo.py",
            "mosaic_tpu_torch/ops/raster_convolve.py",
            "mosaic_tpu_torch/ops/raster_combine.py",
            "mosaic_tpu_torch/obs/__init__.py",
            "mosaic_tpu_torch/obs/metrics.py",
            "mosaic_tpu_torch/obs/heat.py",
            "mosaic_tpu_torch/store/__init__.py",
            "mosaic_tpu_torch/store/manifest.py",
            "mosaic_tpu_torch/store/writer.py",
            "mosaic_tpu_torch/store/reader.py",
            "mosaic_tpu_torch/store/pushdown.py",
            "mosaic_tpu_torch/sql/parser.py",
            "mosaic_tpu_torch/sql/layout.py",
            "mosaic_tpu_torch/analyzer.py",
            "mosaic_tpu_torch/core/geometry/wkb.py",
            "mosaic_tpu_torch/core/geometry/geojson.py",
            "mosaic_tpu_torch/core/geometry/ops.py",
            "mosaic_tpu_torch/core/geometry/triangulate.py",
            "mosaic_tpu_torch/core/geometry/crs.py",
            "mosaic_tpu_torch/core/geometry/clip.py",
            "mosaic_tpu_torch/core/geometry/padded.py",
            "mosaic_tpu_torch/core/geometry/measures.py",
            "mosaic_tpu_torch/core/geometry/predicates.py",
            "mosaic_tpu_torch/ops/edge_measures.py",
            "mosaic_tpu_torch/ops/edge_point.py",
            "mosaic_tpu_torch/ops/edges_cross.py"} <= names
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) &
                                            FORBIDDEN)
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_package_data_covers_kernel_sources_and_tables():
    """An installed copy of the port carries what it builds and reads at
    run time: every file under ``csrc/`` (the kernels and the headers
    they include) and every ``.npz`` table ``crs.py`` opens matches a
    ``package-data`` glob of pyproject.toml."""
    conf = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["mosaic_tpu_torch"]
    pkg = REPO / "mosaic_tpu_torch"
    needed = [p.relative_to(pkg).as_posix()
              for p in sorted((pkg / "csrc").iterdir()) if p.is_file()]
    crs = (pkg / "core" / "geometry" / "crs.py").read_text()
    tables = sorted(set(re.findall(r'"(\w+\.npz)"', crs)))
    assert tables == ["epsg_bounds.npz", "epsg_params.npz"]
    needed += [f"core/geometry/{t}" for t in tables]
    assert "csrc/h3_df.cuh" in needed
    for rel in needed:
        assert (pkg / rel).is_file(), rel
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    polys = mt.read_wkt(["POLYGON ((-74.02 40.70, -73.95 40.70, "
                         "-73.95 40.76, -74.02 40.76, -74.02 40.70))"])
    grid = mt.get_index_system("H3")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.tessellate(polys, 9, grid)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.polyfill(polys, 9, grid)
    assert len(mt.tessellate(polys, 9, grid, device="cpu")) > 0
    square = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convex_clip_rings([square], square[None], np.array([4], np.int32))
    assert convex_clip_rings([square], square[None], np.array([4], np.int32),
                             device="cpu")[0][0].shape == (4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.build_pip_index(polys, 9, grid)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.build_dense_pip_index(polys, 9, grid)
    idx = mt.build_pip_index(polys, 9, grid, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.make_streamed_pip_join(idx, grid, polys)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.make_refined_pip_join(polys, grid, 9)
    from mosaic_tpu_torch.store import ChipStore, write_store
    write_store(str(tmp_path), np.array([[-74.0, 40.73], [-73.0, 40.0]]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.make_store_sharded_pip_join(ChipStore(str(tmp_path)), idx, grid,
                                       polys)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.tessellate_subset(polys, [0], 9, grid)
    sub, chips = mt.tessellate_subset(polys, [0], 9, grid, device="cpu")
    assert len(sub) == 1 and len(chips) > 0
    # the planned join runs on its index's device, here the CPU
    planned = mt.make_planned_pip_join(idx, grid, polys)
    pts = np.array([[-74.0, 40.73], [-73.0, 40.0]])
    assert np.array_equal(planned(pts)[0], mt.pip_host_truth(pts, polys))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.dense_index_from_arrays({}, None)
    dem = mt.RasterTile(np.zeros((1, 4, 4)),
                        mt.GeoTransform(-74.0, 0.001, 0.0, 40.7, 0.0, -0.001))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.raster_to_grid([dem], 8, grid)
    assert len(mt.raster_to_grid([dem], 8, grid, device="cpu")) > 0
    from mosaic_tpu_torch.core.geometry import measures
    from mosaic_tpu_torch.core.geometry.padded import (build_edges,
                                                       points_block)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_edges(polys)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        points_block(polys)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measures.haversine(51.5, -0.13, 48.9, 2.35)
    assert build_edges(polys, device="cpu").a.device.type == "cpu"
    with pytest.raises(RuntimeError):
        mt.resolve_device("cuda")
    assert np.array_equal(mt.localize(idx, np.zeros((1, 2))),
                          -idx.origin[None].astype(np.float32))
