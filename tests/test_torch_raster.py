"""The port's raster layer against the JAX package's.

The same seeded numpy inputs go through ``mosaic_tpu`` (on the CPU, as
the tier-1 suite runs it) and through ``mosaic_tpu_torch`` on
``device="cpu"`` (the kernels' plain versions; ``chip_smoke.py`` holds
the kernels to them on the card).  Grids come from each package's
``get_index_system`` (the JAX tests take theirs from ``MosaicContext``,
which the port has not yet).

* The cases of tests/test_raster.py that touch ported modules (the
  geotransform, the codec, the tile, the host and device ops, the
  raster_to_grid pipeline), each also held to the JAX package's output;
  the ``rst_*`` surface waits for the functions layer (ROADMAP §A7).
* ``write_gtiff`` gives the JAX package's bytes and ``read_gtiff`` its
  tiles, with and without compression; the ``on_error`` raise, skip and
  null modes act alike on truncated and corrupt files.
* Checkpoint wire records equal the JAX package's, in bytes and in path
  mode.
* ``tessellate_raster`` and ``clip_to_cell``: cell ids and masked data
  bit-equal, on CUSTOM and on H3 at res 8.
* ``ndvi`` bit-equal; ``map_algebra`` on device tensors equal.
* ``raster_to_grid`` on a 200x160 cut of bench.py's DEM at H3 res 8:
  same keys for every combiner, values bit-equal where no tile overlap
  ran ``combine``, within 4 ulp where it did; ``kring_interpolate=1``.
* The world-of-one halo form within the JAX test's own rtol=2e-6,
  atol=1e-4; its guards; a group given with no process group initialised
  raises (more ranks: tests/test_torch_sharded.py).
* ``warp`` and ``dtm_from_geoms`` raise (ROADMAP §A6), and so does
  ``raster_to_grid`` on a tile in another CRS.
* The five ``mosaic.raster.*`` and ``mosaic.io.on.error`` keys accept and
  reject what the JAX config does.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

import mosaic_tpu as mj
import mosaic_tpu_torch as mt
from mosaic_tpu import config as jconfig
from mosaic_tpu.core.raster import checkpoint as jckpt
from mosaic_tpu.core.raster import gtiff as jgtiff
from mosaic_tpu.core.raster import rops as jrops
from mosaic_tpu.core.raster.tile import GeoTransform as JGT
from mosaic_tpu.core.raster.tile import RasterTile as JRT
from mosaic_tpu.io.raster_grid import raster_to_grid as jraster_to_grid
from mosaic_tpu.io.raster_grid import read_gtiff_files as jread_files
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.core.raster import checkpoint as tckpt
from mosaic_tpu_torch.core.raster import rops
from mosaic_tpu_torch.core.raster.gtiff import read_gtiff, write_gtiff
from mosaic_tpu_torch.core.raster.tile import GeoTransform, RasterTile
from mosaic_tpu_torch.io.raster_grid import read_gtiff_files
from mosaic_tpu_torch.parallel.raster_halo import (sharded_convolve,
                                                   sharded_convolve_stream)
from mosaic_tpu_torch.resilience.ingest import CodecError

CUSTOM = "CUSTOM(0,16,0,16,2,1,1)"
#: bench.py:1446's DEM geotransform
DEM_GT = (-74.25, 0.0005, 0.0, 40.92, 0.0, -0.0005)
DEV = "cpu"


@pytest.fixture(scope="module")
def grids():
    return mj.get_index_system(CUSTOM), mt.get_index_system(CUSTOM)


@pytest.fixture(scope="module")
def h3():
    return mj.get_index_system("H3"), mt.get_index_system("H3")


def dem_tile(rng, h=64, w=64, bands=1, nodata=-9999.0):
    data = rng.uniform(0, 1000, (bands, h, w)).astype(np.float32)
    gt = (0.0, 16.0 / w, 0.0, 16.0, 0.0, -16.0 / h)
    return pair(data, gt, nodata=nodata)


def ulp_diff(a, b) -> np.ndarray:
    """|a - b| in f64 units in the last place (NaN against NaN 0)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)

    def ordered(x):
        i = x.view(np.int64)
        i = np.where(i < 0, np.int64(-(2 ** 63)) - i, i)
        return i.view(np.uint64) ^ np.uint64(1 << 63)

    ua, ub = ordered(a), ordered(b)
    d = np.where(ua >= ub, ua - ub, ub - ua).astype(np.float64)
    return np.where(np.isnan(a) & np.isnan(b), 0.0,
                    np.where(np.isnan(a) ^ np.isnan(b), np.inf, d))


def pair(data, gt, **kw):
    """The same tile in both packages."""
    return (JRT(np.array(data), JGT(*gt), **kw),
            RasterTile(np.array(data), GeoTransform(*gt), **kw))


def bench_dem(h=160, w=200):
    """A cut of bench.py:1446-1448's synthetic DEM."""
    yy, xx = np.mgrid[0:h, 0:w]
    return (np.sin(xx / 60.0) * 50 + yy * 0.1)[None]


def same_tile(j, t, bits=True):
    """Tiles equal: data (bitwise, NaN included), geotransform, nodata,
    srid, cell id and meta."""
    jd, td = np.asarray(j.data), np.asarray(t.data)
    assert jd.dtype == td.dtype and jd.shape == td.shape
    if bits:
        assert np.array_equal(jd.view(np.uint8), td.view(np.uint8))
    assert j.gt.to_tuple() == t.gt.to_tuple()
    assert (j.nodata, j.srid, j.cell_id) == (t.nodata, t.srid, t.cell_id)
    assert j.meta == t.meta


def same_tiles(js, ts):
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        same_tile(j, t)


# ------------------------------------------------------------ test_raster

class TestGeoTransform:
    def test_world_raster_roundtrip(self, rng):
        gt = GeoTransform(-74.3, 0.01, 0.0, 40.95, 0.0, -0.01)
        cols = rng.uniform(0, 100, 50)
        rows = rng.uniform(0, 100, 50)
        x, y = gt.to_world(cols, rows)
        c2, r2 = gt.to_raster(x, y)
        np.testing.assert_allclose(c2, cols, atol=1e-9)
        np.testing.assert_allclose(r2, rows, atol=1e-9)
        jx, jy = JGT(*gt.to_tuple()).to_world(cols, rows)
        assert np.array_equal(x, jx) and np.array_equal(y, jy)

    def test_rotated_inverse(self):
        gt = GeoTransform(10.0, 1.0, 0.2, 20.0, -0.1, -1.0)
        x, y = gt.to_world(3.0, 7.0)
        c, r = gt.to_raster(x, y)
        assert c == pytest.approx(3.0) and r == pytest.approx(7.0)
        assert (c, r) == JGT(*gt.to_tuple()).to_raster(x, y)


class TestCodec:
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16,
                                       np.int32, np.float32, np.float64])
    @pytest.mark.parametrize("compress", [False, True])
    def test_roundtrip(self, rng, dtype, compress):
        """The JAX package's bytes out, its tile back in."""
        d = rng.uniform(0, 100, (2, 33, 47)).astype(dtype)
        jt, t = pair(d, (-74.0, 1e-3, 0, 40.9, 0, -1e-3), nodata=7.0,
                     srid=4326)
        blob = write_gtiff(t, compress=compress)
        assert blob == jgtiff.write_gtiff(jt, compress=compress)
        back = read_gtiff(blob)
        assert np.array_equal(back.data, d)
        assert back.gt.to_tuple() == pytest.approx(t.gt.to_tuple())
        assert back.nodata == 7.0
        assert back.srid == 4326
        same_tile(jgtiff.read_gtiff(blob), back)

    def test_projected_srid_roundtrip(self, rng):
        d = rng.uniform(0, 10, (1, 8, 8)).astype(np.float32)
        jt, t = pair(d, (0, 10, 0, 0, 0, -10), srid=27700)
        assert write_gtiff(t) == jgtiff.write_gtiff(jt)
        assert read_gtiff(write_gtiff(t)).srid == 27700

    def test_pil_interop(self, rng):
        """Cross-decode TIFFs produced by an independent writer."""
        from PIL import Image
        arr = rng.uniform(0, 255, (21, 34)).astype(np.uint8)
        for comp in (None, "tiff_deflate", "packbits"):
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="TIFF",
                                      **({"compression": comp}
                                         if comp else {}))
            t = read_gtiff(buf.getvalue())
            assert np.array_equal(t.data[0], arr), comp
            same_tile(jgtiff.read_gtiff(buf.getvalue()), t)

    def test_pil_predictor2_multiband(self, rng):
        """Horizontal differencing must undo per component, not across
        interleaved samples (regression)."""
        from PIL import Image
        arr = rng.integers(0, 255, (20, 30, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="TIFF",
                                  compression="tiff_deflate",
                                  tiffinfo={317: 2})
        t = read_gtiff(buf.getvalue())
        assert np.array_equal(np.moveaxis(t.data, 0, -1), arr)
        same_tile(jgtiff.read_gtiff(buf.getvalue()), t)

    def test_srid_out_of_geokey_range(self, rng):
        _, t = dem_tile(rng, 4, 4)
        t = dataclasses.replace(t, srid=900913)
        with pytest.raises(ValueError, match="SRID"):
            write_gtiff(t)

    def test_bad_input_raises(self):
        with pytest.raises(ValueError, match="TIFF"):
            read_gtiff(b"nope")
        with pytest.raises(ValueError, match="truncated"):
            read_gtiff(b"II")


class TestTile:
    def test_band_stats_respect_nodata(self):
        d = np.array([[[1.0, 2.0], [-9999.0, 3.0]]], np.float32)
        jt, t = pair(d, (0, 1, 0, 0, 0, -1), nodata=-9999.0)
        s = t.band_stats(0)
        assert s["count"] == 3 and s["min"] == 1.0 and s["max"] == 3.0
        assert s == jt.band_stats(0)

    def test_is_empty(self):
        d = np.full((1, 4, 4), -1.0, np.float32)
        t = RasterTile(d, GeoTransform(0, 1, 0, 0, 0, -1), nodata=-1.0)
        assert t.is_empty()
        assert not t.with_data(d + 1).is_empty()

    def test_window_geotransform(self, rng):
        jt, t = dem_tile(rng)
        w = t.window(8, 4, 16, 16)
        # window's upper-left world coord == parent's pixel (8,4) coord
        x, y = t.gt.to_world(8, 4)
        assert w.gt.x0 == pytest.approx(x)
        assert w.gt.y0 == pytest.approx(y)
        assert np.array_equal(np.asarray(w.data),
                              np.asarray(t.data)[:, 4:20, 8:24])
        same_tile(jt.window(8, 4, 16, 16), w)

    def test_band_out_of_range(self, rng):
        with pytest.raises(IndexError):
            dem_tile(rng)[1].band(5)


class TestOps:
    def test_clip_to_cell_masks_outside(self, rng, grids):
        jt, t = dem_tile(rng)
        jg, grid = grids
        cells = grid.candidate_cells(np.array([0, 0, 16, 16]), 2)
        ct = rops.clip_to_cell(t, int(cells[5]), grid, device=DEV)
        assert ct.cell_id == int(cells[5])
        # all valid pixels' centers must fall inside the cell bbox
        xs, ys = ct.pixel_centers()
        m = ct.valid_mask()[0]
        verts, counts = grid.cell_boundary(cells[5:6])
        ring = verts[0, :counts[0]]
        assert xs[m].min() >= ring[:, 0].min() - 1e-9
        assert xs[m].max() <= ring[:, 0].max() + 1e-9
        assert ys[m].min() >= ring[:, 1].min() - 1e-9
        assert ys[m].max() <= ring[:, 1].max() + 1e-9
        same_tile(jrops.clip_to_cell(jt, int(cells[5]), jg), ct)

    def test_tessellate_partitions_pixels(self, rng, grids):
        """Every pixel appears in exactly one cell tile (grid-aligned
        raster ⇒ clean partition), the tiles equal to the JAX package's."""
        jt, t = dem_tile(rng, 64, 64)
        tiles = rops.tessellate_raster(t, 2, grids[1], device=DEV)
        total = sum(int(x.valid_mask().sum()) for x in tiles)
        assert total == 64 * 64
        same_tiles(jrops.tessellate_raster(jt, 2, grids[0]), tiles)

    def test_merge_and_combine(self, rng):
        jt, t = dem_tile(rng, 32, 32)
        left = t.window(0, 0, 16, 32)
        right = t.window(16, 0, 16, 32)
        m = rops.merge([left, right])
        np.testing.assert_allclose(np.asarray(m.data),
                                   np.asarray(t.data, np.float64))
        same_tile(jrops.merge([jt.window(0, 0, 16, 32),
                               jt.window(16, 0, 16, 32)]), m)
        c = rops.combine([t, t.with_data(np.asarray(t.data) + 10)], "avg",
                         device=DEV)
        np.testing.assert_allclose(np.asarray(c.data),
                                   np.asarray(t.data, np.float64) + 5)

    def test_combine_reducers(self, rng):
        jt, t = dem_tile(rng, 8, 8)
        t2 = t.with_data(np.asarray(t.data) + 10)
        jt2 = jt.with_data(np.asarray(jt.data) + 10)
        for reducer, want in (("min", np.asarray(t.data, np.float64)),
                              ("max", np.asarray(t.data, np.float64) + 10),
                              ("count", 2.0)):
            got = rops.combine([t, t2], reducer, device=DEV)
            assert np.allclose(np.asarray(got.data), want)
            same_tile(jrops.combine([jt, jt2], reducer), got)

    def test_ndvi_oracle(self, rng):
        d = rng.uniform(1, 100, (2, 16, 16)).astype(np.float32)
        d[0, 0, :3] = 0.0
        d[1, 0, :3] = 0.0                       # denominator 0 -> NaN
        jt, t = pair(d, (0, 1, 0, 16, 0, -1), nodata=np.float32(d[0, 5, 5]))
        out = rops.ndvi(t, 0, 1, device=DEV)
        red, nir = d[0].astype(np.float64), d[1].astype(np.float64)
        with np.errstate(all="ignore"):
            want = (nir - red) / (nir + red)
        want[5, 5] = np.nan                     # red is nodata there
        np.testing.assert_allclose(np.asarray(out.data[0])[1:], want[1:],
                                   rtol=1e-12)
        assert np.isnan(out.data[0, 0, :3]).all() and \
            np.isnan(out.data[0, 5, 5])
        same_tile(jrops.ndvi(jt, 0, 1), out)

    def test_convolve_box_oracle(self, rng):
        d = rng.uniform(0, 10, (1, 12, 12)).astype(np.float64)
        t = RasterTile(d, GeoTransform(0, 1, 0, 12, 0, -1))
        k = np.ones((3, 3))
        out = np.asarray(rops.convolve(t, k, device=DEV).data[0])
        # interior pixel oracle
        for (r, c) in [(5, 5), (3, 8)]:
            assert out[r, c] == pytest.approx(
                d[0, r - 1:r + 2, c - 1:c + 2].sum())

    def test_filter_median(self, rng):
        d = rng.uniform(0, 10, (1, 9, 9))
        jt, t = pair(d, (0, 1, 0, 9, 0, -1))
        out = np.asarray(rops.filter_tile(t, 3, "median").data[0])
        assert out[4, 4] == pytest.approx(np.median(d[0, 3:6, 3:6]))
        for op in ("avg", "min", "max", "median", "mode"):
            same_tile(jrops.filter_tile(jt, 3, op), rops.filter_tile(t, 3, op))

    def test_subdivide_respects_bound(self, rng):
        jt, t = dem_tile(rng, 128, 128)
        parts = rops.subdivide(t, 0.01)       # 10 KB bound
        assert all(p.memsize() <= 0.01 * (1 << 20) for p in parts)
        assert sum(p.width * p.height for p in parts) == 128 * 128
        same_tiles(jrops.subdivide(jt, 0.01), parts)

    def test_retile_covers(self, rng):
        jt, t = dem_tile(rng, 50, 70)
        parts = rops.retile(t, 32, 32)
        assert sum(p.width * p.height for p in parts) == 50 * 70
        same_tiles(jrops.retile(jt, 32, 32), parts)


class TestRasterToGrid:
    def test_pipeline_matches_oracle(self, rng, grids):
        """BASELINE config 5 in miniature: synthetic DEM → grid measures,
        vs direct per-cell pixel binning and the JAX package."""
        jt, t = dem_tile(rng, 64, 64)
        grid = grids[1]
        got = mt.raster_to_grid([t], 2, grid, "avg", device=DEV)
        xs, ys = t.pixel_centers()
        cells = grid.point_to_cell(np.stack([xs.ravel(), ys.ravel()], -1), 2)
        vals = np.asarray(t.data[0], np.float64).ravel()
        assert set(got) == set(int(c) for c in np.unique(cells))
        for c in np.unique(cells):
            assert got[int(c)] == pytest.approx(vals[cells == c].mean(),
                                                rel=1e-9)
        assert got == jraster_to_grid([jt], 2, grids[0], "avg")

    def test_pipeline_overlapping_tiles(self, rng, grids):
        """Two overlapping tiles: per-cell combine averages them."""
        jt, t = dem_tile(rng, 32, 32)
        t2 = t.with_data(np.asarray(t.data) + 100)
        got = mt.raster_to_grid([t, t2], 2, grids[1], "avg", device=DEV)
        solo = mt.raster_to_grid([t], 2, grids[1], "avg", device=DEV)
        for c, v in solo.items():
            # t2's +100 rounds in its float32 storage before combining
            assert got[c] == pytest.approx(v + 50, rel=1e-5)
        want = jraster_to_grid([jt, jt.with_data(np.asarray(jt.data) + 100)],
                               2, grids[0], "avg")
        assert set(got) == set(want)
        assert ulp_diff([got[c] for c in want], list(want.values())).max() \
            <= 4

    def test_subdivision_invariance(self, rng, grids):
        """raster_to_grid over subdivided halves == over the whole
        raster, even when pixel centers align exactly with cell
        boundaries (the windowed-frame ulp tie regression)."""
        dem = rng.uniform(0, 500, (1, 96, 96)).astype(np.float32)
        t = RasterTile(dem, GeoTransform(0.0, 16 / 96, 0, 16.0, 0,
                                         -16 / 96), nodata=-1.0)
        whole = mt.raster_to_grid([t], 2, grids[1], "avg", device=DEV)
        halves = rops.subdivide(t, 0.02)
        assert len(halves) > 1
        split = mt.raster_to_grid(halves, 2, grids[1], "avg", device=DEV)
        assert set(whole) == set(split)
        for c, v in whole.items():
            assert split[c] == pytest.approx(v, rel=1e-12)

    def test_kring_interpolation(self, rng, grids):
        # 64×64 px over a 64×64-cell grid: every cell carries a value,
        # so each 1-ring has 9 valued members and smoothing contracts
        jt, t = dem_tile(rng, 64, 64)
        plain = mt.raster_to_grid([t], 2, grids[1], "avg", device=DEV)
        smooth = mt.raster_to_grid([t], 2, grids[1], "avg",
                                   kring_interpolate=1, device=DEV)
        assert set(plain) == set(smooth)
        # smoothing shrinks the value spread
        assert np.std(list(smooth.values())) < np.std(list(plain.values()))
        assert smooth == jraster_to_grid([jt], 2, grids[0], "avg",
                                         kring_interpolate=1)


# ------------------------------------------------------- codec contracts

def _three_strips(rng, compress):
    """A float32 tile written as 3 strips (8192-byte strips of 32 x 64
    pixels): its bytes, strip offsets and strip byte counts."""
    d = rng.uniform(0, 100, (1, 96, 64)).astype(np.float32)
    _, t = pair(d, (-74.0, 1e-3, 0, 40.9, 0, -1e-3), nodata=-1.0)
    blob = write_gtiff(t, compress=compress)
    entries, _ = jgtiff._read_ifd_entries(blob, 8, "<")
    offs = jgtiff._values(entries[273], "<")
    cnts = jgtiff._values(entries[279], "<")
    assert len(offs) == 3
    return blob, offs, cnts


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("on_error", ["raise", "skip", "null"])
@pytest.mark.parametrize("damage", ["truncated", "corrupt"])
def test_on_error_contract(rng, compress, on_error, damage):
    """A damaged second strip: raise -> a located CodecError, skip ->
    zeros, null -> nodata; tiles and decode_errors equal to the JAX
    package's."""
    blob, offs, cnts = _three_strips(rng, compress)
    if damage == "truncated":
        bad = blob[:offs[1] + cnts[1] // 2]
    else:
        b = bytearray(blob)
        b[offs[1]:offs[1] + 16] = b"\xff" * 16
        bad = bytes(b)
    if damage == "corrupt" and not compress:
        # raw strips decode any bytes: nothing to drop
        same_tile(jgtiff.read_gtiff(bad, on_error=on_error),
                  read_gtiff(bad, on_error=on_error))
        return
    if on_error == "raise":
        with pytest.raises(CodecError, match="strip 1") as got:
            read_gtiff(bad, on_error="raise", path="x.tif")
        with pytest.raises(ValueError) as want:
            jgtiff.read_gtiff(bad, on_error="raise", path="x.tif")
        assert str(got.value) == str(want.value)
        assert (got.value.path, got.value.feature, got.value.offset) == \
            (want.value.path, want.value.feature, want.value.offset)
        return
    t = read_gtiff(bad, on_error=on_error, path="x.tif")
    same_tile(jgtiff.read_gtiff(bad, on_error=on_error, path="x.tif"), t)
    assert t.meta["decode_errors"][0]["feature"] == "strip 1"


def test_on_error_default_from_config(rng):
    """``on_error=None`` takes ``mosaic.io.on.error`` from the port's
    config, as the JAX package takes it from its own."""
    blob, offs, cnts = _three_strips(rng, True)
    bad = blob[:offs[1] + cnts[1] // 2]
    prev = tconfig.default_config()
    try:
        tconfig.set_default_config(tconfig.apply_conf(
            prev, "mosaic.io.on.error", "null"))
        t = read_gtiff(bad)
        assert np.isnan(t.data[0, 32:]).all() or \
            (t.data[0, 32:] == -1.0).all()
    finally:
        tconfig.set_default_config(prev)
    with pytest.raises(CodecError):
        read_gtiff(bad)


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_checkpoint_records_equal_jax(rng, tmp_path, use_checkpoint):
    jt, t = dem_tile(rng, 16, 24)
    jt = dataclasses.replace(jt, cell_id=42, meta={"a": "1",
                                                   "checkpoint_path": "old"})
    t = dataclasses.replace(t, cell_id=42, meta={"a": "1",
                                                 "checkpoint_path": "old"})
    jcfg = dataclasses.replace(jconfig.MosaicConfig(),
                               raster_use_checkpoint=use_checkpoint,
                               raster_checkpoint=str(tmp_path / "jax"))
    tcfg = dataclasses.replace(tconfig.MosaicConfig(),
                               raster_use_checkpoint=use_checkpoint,
                               raster_checkpoint=str(tmp_path / "torch"))
    jrec = jckpt.serialize_tile(jt, jcfg)
    rec = tckpt.serialize_tile(t, tcfg)
    assert rec.keys() == jrec.keys() and rec["cell_id"] == 42
    if use_checkpoint:
        assert os.path.basename(rec["raster"]) == \
            os.path.basename(jrec["raster"])
        assert open(rec["raster"], "rb").read() == \
            open(jrec["raster"], "rb").read()
        assert rec["metadata"] == dict(jrec["metadata"],
                                       checkpoint_path=rec["raster"])
    else:
        assert rec == jrec
    back = tckpt.deserialize_tile(rec)
    same_tile(jckpt.deserialize_tile(jrec),
              dataclasses.replace(back, meta=dict(
                  back.meta, **{k: v for k, v in
                                jckpt.deserialize_tile(jrec).meta.items()
                                if k == "checkpoint_path"})))
    assert np.array_equal(back.data, t.data)


def test_checkpoint_switches_follow_config(tmp_path):
    prev = tconfig.default_config()
    try:
        tckpt.enable_checkpoint(str(tmp_path))
        assert tckpt.is_checkpoint_enabled()
        assert tckpt.checkpoint_dir() == str(tmp_path)
        tckpt.set_checkpoint_dir(str(tmp_path / "b"))
        assert tckpt.checkpoint_dir() == str(tmp_path / "b")
        tckpt.disable_checkpoint()
        assert not tckpt.is_checkpoint_enabled()
    finally:
        tconfig.set_default_config(prev)


@pytest.mark.parametrize("strategy", ["in_memory", "retile_on_read",
                                      "as_path"])
def test_read_gtiff_files(rng, tmp_path, strategy):
    jt, _ = dem_tile(rng, 40, 50)
    path = str(tmp_path / "a.tif")
    with open(path, "wb") as f:
        f.write(jgtiff.write_gtiff(jt))
    size = 0.002 if strategy == "retile_on_read" else None
    got = read_gtiff_files([path], size, strategy)
    want = jread_files([path], size, strategy)
    if strategy == "as_path":
        assert got == want
    else:
        assert len(got) > (strategy == "retile_on_read")
        same_tiles(want, got)


# ----------------------------------------------- ownership and the pipeline

def test_tessellate_and_clip_on_h3_bit_equal(h3):
    """H3 res 8 over a 200x160 cut of bench.py's DEM: every cell tile of
    tessellate_raster and clip_to_cell (ids, masks, data, geotransforms)
    bit-equal to the JAX package's."""
    d = bench_dem()
    jt, t = pair(d, DEM_GT, srid=4326)
    want = jrops.tessellate_raster(jt, 8, h3[0])
    got = rops.tessellate_raster(t, 8, h3[1], device=DEV)
    assert len(got) == 124
    same_tiles(want, got)
    own, host = rops._ownership(t, 8, h3[1], torch.device(DEV))
    pts = rops._pixel_points(t)
    assert np.array_equal(own.ravel(), h3[0].point_to_cell(pts, 8))
    assert 0 < host < own.size
    for ct in got[::31]:
        same_tile(jrops.clip_to_cell(jt, ct.cell_id, h3[0]),
                  rops.clip_to_cell(t, ct.cell_id, h3[1], device=DEV))


@pytest.mark.parametrize("combiner", ["avg", "min", "max", "median",
                                      "count"])
def test_raster_to_grid_dem_cut(h3, combiner):
    """raster_to_grid on a 200x160 cut of bench.py's DEM at H3 res 8:
    the JAX package's dict, bit for bit (no tile overlaps, so no
    combine runs)."""
    jt, t = pair(bench_dem(), DEM_GT, srid=4326)
    got = mt.raster_to_grid([t], 8, h3[1], combiner=combiner, device=DEV)
    want = jraster_to_grid([jt], 8, h3[0], combiner=combiner)
    assert len(got) == 124 and list(got) == list(want)
    assert np.array_equal(np.array(list(got.values()), np.float64),
                          np.array(list(want.values()), np.float64))


def test_raster_to_grid_overlapping_and_kring(h3):
    """Four phase-aligned quarter tiles of the DEM cut, overlapping by 8
    pixels: the same keys as the JAX package; values of cells that
    ``combine`` ran on within 4 ulp, the rest bit-equal; the same with
    k-ring smoothing."""
    d = bench_dem()
    rng = np.random.default_rng(5)
    d = np.where(rng.random(d.shape) < 0.02, np.nan, d)
    quads = []
    for r0, c0, h, w in ((0, 0, 88, 108), (0, 92, 88, 108),
                         (72, 0, 88, 108), (72, 92, 88, 108)):
        gt = (DEM_GT[0] + c0 * DEM_GT[1], DEM_GT[1], 0.0,
              DEM_GT[3] + r0 * DEM_GT[5], 0.0, DEM_GT[5])
        quads.append(pair(d[:, r0:r0 + h, c0:c0 + w], gt, srid=4326))
    jts, ts = [q[0] for q in quads], [q[1] for q in quads]
    for k in (0, 1):
        want = jraster_to_grid(jts, 8, h3[0], kring_interpolate=k)
        got = mt.raster_to_grid(ts, 8, h3[1], kring_interpolate=k,
                                device=DEV)
        assert set(got) == set(want) and len(got) >= 124
        diff = ulp_diff([got[c] for c in want], list(want.values()))
        assert diff.max() <= 4
    whole = mt.raster_to_grid([pair(d, DEM_GT, srid=4326)[1]], 8, h3[1],
                              combiner="count", device=DEV)
    counts = mt.raster_to_grid(ts, 8, h3[1], combiner="count", device=DEV)
    assert counts == whole
    assert sum(counts.values()) == int((~np.isnan(d)).sum())


def test_map_algebra_on_device_tensors():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 10, (1, 6, 8))
    b = rng.uniform(0, 10, (1, 6, 8))
    a[0, 0, 0] = -1.0
    (ja, ta), (jb, tb) = (pair(a, (0, 1, 0, 6, 0, -1), nodata=-1.0),
                          pair(b, (0, 1, 0, 6, 0, -1)))

    def fn(x, y):
        return x * 2.0 + y

    got = rops.map_algebra([ta, tb], fn, device=DEV)
    same_tile(jrops.map_algebra([ja, jb], fn), got)
    assert got.data.dtype == np.float64 and np.isnan(got.data[0, 0, 0])


def test_warp_and_dtm_raise(h3):
    _, t = pair(bench_dem(8, 8), DEM_GT, srid=4326)
    with pytest.raises(NotImplementedError, match="§A6"):
        rops.warp(t, 3857)
    with pytest.raises(NotImplementedError, match="§A6"):
        rops.dtm_from_geoms(np.zeros((3, 3)), t.gt, 4, 4)
    other = dataclasses.replace(t, srid=3857)
    with pytest.raises(NotImplementedError, match="§A6"):
        mt.raster_to_grid([other], 8, h3[1], device=DEV)


def test_entry_points_default_to_cuda(h3):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    _, t = pair(bench_dem(8, 8), DEM_GT, srid=4326)
    for call in (lambda: mt.raster_to_grid([t], 8, h3[1]),
                 lambda: rops.tessellate_raster(t, 8, h3[1]),
                 lambda: rops.combine([t, t]),
                 lambda: rops.convolve(t, np.ones((3, 3))),
                 lambda: rops.ndvi(t, 0, 0),
                 lambda: sharded_convolve(t, np.ones((3, 3)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ------------------------------------------------------------- the halo

def _halo_tile(h=64, w=40, bands=2, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 10, (bands, h, w))
    return pair(data, (-74.0, 0.001, 0.0, 40.9, 0.0, -0.001), srid=4326)


@pytest.fixture(scope="module")
def mesh1():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), axis_names=("data",))


@pytest.mark.parametrize("ksize", [3, 5])
def test_halo_world_of_one_matches_single_device(mesh1, ksize):
    """tests/test_raster_halo.py's case on a world of one: the port's f32
    stencil within the JAX test's own tolerance of ``rops.convolve`` and
    of the JAX package's one-device sharded form."""
    from mosaic_tpu.parallel.raster_halo import sharded_convolve as jhalo
    jt, t = _halo_tile()
    k = np.random.default_rng(ksize).normal(0, 1, (ksize, ksize))
    got = sharded_convolve(t, k, None, device=DEV)
    assert got.data.dtype == np.float32 and got.meta["sharded"] == "halo"
    np.testing.assert_allclose(got.data, jrops.convolve(jt, k).data,
                               rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(got.data, jhalo(jt, k, mesh1).data,
                               rtol=2e-6, atol=1e-4)


def test_halo_nodata_respected(mesh1):
    jt, t = _halo_tile(seed=3)
    d = np.asarray(t.data).copy()
    d[0, 10:20, 5:15] = -9999.0
    jt2, t2 = pair(d, t.gt.to_tuple(), nodata=-9999.0, srid=4326)
    k = np.ones((3, 3)) / 9.0
    np.testing.assert_allclose(sharded_convolve(t2, k, device=DEV).data,
                               jrops.convolve(jt2, k).data, rtol=2e-6,
                               atol=1e-4)


def test_halo_guards(monkeypatch):
    _, t = _halo_tile()
    with pytest.raises(ValueError, match="odd"):
        sharded_convolve(t, np.ones((2, 2)), device=DEV)
    _, flat = _halo_tile(h=1)
    with pytest.raises(ValueError, match="halo"):
        sharded_convolve(flat, np.ones((5, 5)), device=DEV)
    import torch.distributed as dist
    # a group given while no process group is initialised raises; the
    # guards over more ranks are held in tests/test_torch_sharded.py
    with pytest.raises(RuntimeError, match="not initialised"):
        sharded_convolve(t, np.ones((3, 3)), group=object(), device=DEV)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    assert sharded_convolve(t, np.ones((3, 3)), group=object(),
                            device=DEV).data.shape == t.data.shape


def test_halo_stream_equals_one_by_one():
    tiles = [_halo_tile(seed=s)[1] for s in range(3)]
    k = np.random.default_rng(9).normal(0, 1, (3, 3))
    got = sharded_convolve_stream(tiles, k, device=DEV)
    assert len(got) == 3
    for t, g in zip(tiles, got):
        assert np.array_equal(g.data, sharded_convolve(t, k, device=DEV).data)
        assert g.gt == t.gt
    assert sharded_convolve_stream([], k, device=DEV) == []
    with pytest.raises(ValueError, match="same-shaped"):
        sharded_convolve_stream([tiles[0], _halo_tile(h=32)[1]], k,
                                device=DEV)


# ------------------------------------------------------------- the config

KEY_VALUES = {
    "mosaic.raster.checkpoint": ["/data/ckpt", "", " x "],
    "mosaic.raster.use.checkpoint": ["true", "false", "1", "off", "maybe"],
    "mosaic.raster.tmp.prefix": ["/tmp", "scratch"],
    "mosaic.raster.blocksize": ["128", "1", "0", "-8", "x", "1.5"],
    "mosaic.io.on.error": ["raise", "skip", "null", "NULL", " skip ",
                           "drop", ""],
}


@pytest.mark.parametrize("key", sorted(KEY_VALUES))
def test_config_keys_accept_and_reject_alike(key):
    jcfg, tcfg = jconfig.MosaicConfig(), tconfig.MosaicConfig()
    field = tconfig._CONF_FIELDS[key][0]
    assert getattr(tcfg, field) == getattr(jcfg, field)
    for value in KEY_VALUES[key]:
        try:
            want = getattr(jconfig.apply_conf(jcfg, key, value), field)
        except jconfig.ConfigError as e:
            with pytest.raises(tconfig.ConfigError) as got:
                tconfig.apply_conf(tcfg, key, value)
            assert str(got.value) == str(e)
            continue
        assert getattr(tconfig.apply_conf(tcfg, key, value), field) == want
