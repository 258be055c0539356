"""The raster kernels' plain versions against the JAX package and against
numpy models of the kernels' order of operations.

* ``convolve_ref`` (the stencil's plain version, ``ops/raster_convolve``)
  equals a numpy model of the kernel (taps in row-major order from 0,
  each product and sum rounded once, w * 0 outside the tile) bit for bit
  in f64 and f32, with odd and even sides.
* ``combine_ref`` (the tile combine's plain version, ``ops/raster_combine``)
  equals a per-pixel numpy model of the kernel bit for bit for every
  reducer, with all-NaN pixels, even and odd counts, ties and infinities.
* Against the JAX package: ``rops.convolve`` through the port within
  1e-12 * sum |w| |x| per pixel of the JAX package's
  ``conv_general_dilated`` (XLA sums the taps in its own order), even
  sides included; ``rops.combine`` within 4 ulp of ``jnp.nan*`` for every
  reducer (XLA's reduction order and its median's mul-add may differ in
  the last bits).
* ``torch.nanmedian`` is not the function: it takes the lower middle
  value where ``jnp.nanmedian`` takes the mean of the two.
* The wrappers reject what the kernels do not take, and on CPU tensors
  launch nothing.
* The stencil kernel's launch plan (``launch_plan``: the instance and its
  tile, the limits) is plain Python: every stencil maps to an instance
  whose shared memory fits, and an input the kernel does not take is
  refused before any launch.  A numpy model of the kernel's march (the
  persistent grid's unit ranges, the shared-memory ring with its halo
  rows kept from step to step and the next step staged ahead, the rows a
  thread sums in registers) is bit-equal to ``convolve_ref`` for every
  instance, with ranges that cross strips and bands.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu.core.raster import rops as jrops
from mosaic_tpu.core.raster.tile import GeoTransform as JGeoTransform
from mosaic_tpu.core.raster.tile import RasterTile as JRasterTile
from mosaic_tpu_torch.core.raster import rops as trops
from mosaic_tpu_torch.core.raster.tile import GeoTransform, RasterTile
from mosaic_tpu_torch.ops.raster_combine import (REDUCERS, combine_ref,
                                                 raster_combine)
from mosaic_tpu_torch.ops import raster_convolve as rc
from mosaic_tpu_torch.ops.raster_convolve import (convolve_ref,
                                                  raster_convolve, same_pads)

GT = (-74.0, 0.001, 0.0, 40.9, 0.0, -0.001)
SHAPES = [(3, 3), (5, 5), (4, 4), (2, 3), (1, 1), (3, 6), (7, 7), (1, 9),
          (9, 1), (11, 11)]
#: rasters smaller than a 5 x 5 stencil, and a multi-band raster
SMALL_AND_BANDS = [(1, 1, 1), (1, 3, 1), (1, 5, 7), (1, 2, 9), (3, 9, 10)]


def ulp_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of f64, NaN against NaN 0 and
    -0 against +0 0; NaN against a number is a huge difference."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)

    def ordered(x):
        # the f64 bits as an unsigned integer that ascends with the value
        i = x.view(np.int64)
        i = np.where(i < 0, np.int64(-(2 ** 63)) - i, i)
        return i.view(np.uint64) ^ np.uint64(1 << 63)

    ua, ub = ordered(a), ordered(b)
    d = np.where(ua >= ub, ua - ub, ub - ua).astype(np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    one_nan = np.isnan(a) ^ np.isnan(b)
    return np.where(both_nan, 0.0, np.where(one_nan, np.inf, d))


def convolve_model(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """numpy model of the kernel: every output pixel sums its taps in
    row-major order from 0, w * 0 for a tap outside the tile."""
    kh, kw = w.shape
    top, bottom, left, right = same_pads(kh, kw)
    B, H, W = x.shape
    xp = np.zeros((B, H + kh - 1, W + kw - 1), x.dtype)
    xp[:, top:top + H, left:left + W] = x
    out = np.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            prod = (w[i, j] * xp[:, i:i + H, j:j + W]).astype(x.dtype)
            out = (out + prod).astype(x.dtype)
    return out


def march_model(x: np.ndarray, w: np.ndarray, instance: int,
                grid: int) -> np.ndarray:
    """numpy model of the stencil kernel's march as
    csrc/raster_convolve.cu runs it with ``grid`` resident blocks: each
    block's range of (band, strip, step) units, its ring of shared rows
    (values never staged read as NaN, so a read of a stale or unstaged row
    shows), the next step's rows staged before this step's sums, and each
    thread's ROWS_PER_THREAD outputs summed input row by input row.
    Every output is written once."""
    kh, kw = w.shape
    _, _, tw, ny = rc.INSTANCES[instance]
    R, th = rc.ROWS_PER_THREAD, rc.tile_rows(instance)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    n_ring, sw = 2 * th + kh - 1, tw + kw - 1
    B, H, W = x.shape
    strips, steps = -(-W // tw), -(-H // th)
    units = B * strips * steps
    G = min(units, grid)
    out = np.full_like(x, np.nan)
    written = np.zeros(x.shape, bool)
    tx = np.arange(tw)
    for blk in range(G):
        u, u_end = units * blk // G, units * (blk + 1) // G
        band, rem = divmod(u, strips * steps)
        strip, step = divmod(rem, steps)
        ring = np.full((n_ring, sw), np.nan, x.dtype)
        base, fresh = 0, True

        def stage(ring_row, g0, nrows):
            gc = c0 - pw + np.arange(sw)
            for rr in range(nrows):
                rp = ring_row + rr
                rp = rp - n_ring if rp >= n_ring else rp
                gr = g0 + rr
                row = np.zeros(sw, x.dtype)
                if 0 <= gr < H:
                    ok = (gc >= 0) & (gc < W)
                    row[ok] = x[band, gr, gc[ok]]
                ring[rp] = row

        while u < u_end:
            r0, c0 = step * th, strip * tw
            if fresh:
                base = 0
                stage(0, r0 - ph, th + kh - 1)
            more = u + 1 < u_end and step + 1 < steps
            if more:
                nxt = base + th + kh - 1
                stage(nxt - n_ring if nxt >= n_ring else nxt,
                      r0 + th + kh - 1 - ph, th)
            snap = ring.copy()
            for ty in range(ny):
                acc = np.zeros((R, tw), x.dtype)
                rbase = base + ty * R
                for q in range(R + kh - 1):
                    p = rbase + q
                    p = p - n_ring if p >= n_ring else p
                    for j in range(kw):
                        v = snap[p, tx + j]
                        for o in range(R):
                            i = q - o
                            if 0 <= i < kh:
                                acc[o] = (acc[o] + (w[i, j] * v).astype(
                                    x.dtype)).astype(x.dtype)
                for o in range(R):
                    r = r0 + ty * R + o
                    c = c0 + tx
                    ok = c < W
                    if r < H:
                        assert not written[band, r, c[ok]].any()
                        written[band, r, c[ok]] = True
                        out[band, r, c[ok]] = acc[o][ok]
            base += th
            base = base - n_ring if base >= n_ring else base
            fresh = not more
            step += 1
            if step == steps:
                step = 0
                strip += 1
                if strip == strips:
                    strip, band = 0, band + 1
            u += 1
    assert written.all()
    return out


def combine_model(col: np.ndarray, reducer: str) -> float:
    """numpy model of the kernel for one pixel's column of T values."""
    f = np.float64
    valid = [v for v in col if not np.isnan(v)]
    n = len(valid)
    if reducer in ("avg", "sum", "count"):
        s = f(0.0)
        for v in valid:
            s = f(s + v)
        if reducer == "sum":
            return s
        with np.errstate(all="ignore"):
            return f(n) if reducer == "count" else f(s / f(n))
    if reducer in ("min", "max"):
        m = f(np.inf) if reducer == "min" else f(-np.inf)
        for v in col:
            if (v < m) if reducer == "min" else (v > m):
                m = v
        return m if n else f(np.nan)
    if n == 0:
        return f(np.nan)
    q = f(0.5) * f(n - 1)
    lo, hi = np.floor(q), np.ceil(q)
    hw = f(q - lo)
    lw = f(1.0 - hw)
    picks = {}
    for k in (int(lo), int(hi)):
        for v in col:
            if np.isnan(v):
                continue
            lt = sum(1 for u in col if u < v)
            eq = sum(1 for u in col if u == v)
            if lt <= k < lt + eq:
                picks[k] = v
                break
    with np.errstate(all="ignore"):
        return f(f(picks[int(lo)] * lw) + f(picks[int(hi)] * hw))


def stack_cases(rng):
    """[T, 1, 6, 7] f64 stacks: NaN holes, all-NaN pixels, ties, an
    infinity, T from 1 to 5."""
    out = []
    for T in (1, 2, 3, 4, 5):
        s = np.round(rng.normal(0, 10, (T, 1, 6, 7)), 1)
        s[rng.random(s.shape) < 0.3] = np.nan
        s[:, :, 0, 0] = np.nan                    # all-NaN pixel
        s[:, :, 1, 1] = 2.5                       # ties
        if T >= 2:
            s[0, 0, 2, 2] = np.inf
        out.append(s)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_convolve_ref_equals_numpy_model(dtype, shape):
    rng = np.random.default_rng(31 * sum(shape) + shape[0])
    x = rng.normal(0, 100, (2, 11, 13)).astype(dtype)
    w = rng.normal(0, 1, shape).astype(dtype)
    got = convolve_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = convolve_model(x, w)
    assert got.dtype == dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("reducer", sorted(REDUCERS))
def test_combine_ref_equals_numpy_model(reducer):
    for s in stack_cases(np.random.default_rng(7)):
        got = combine_ref(torch.from_numpy(s), reducer).numpy()
        T = s.shape[0]
        want = np.array([combine_model(s[:, 0, r, c], reducer)
                         for r in range(6) for c in range(7)]
                        ).reshape(1, 6, 7)
        assert np.array_equal(got.view(np.int64), want.view(np.int64)), \
            (reducer, T)


@pytest.mark.parametrize("shape", SHAPES)
def test_convolve_against_jax(shape):
    """rops.convolve: the port within 1e-12 sum |w||x| of XLA's
    convolution (another summation order), invalid pixels read as 0."""
    rng = np.random.default_rng(sum(shape))
    d = rng.uniform(-50, 50, (2, 17, 19))
    d[0, 3:6, 4:9] = -9999.0
    w = rng.normal(0, 1, shape)
    jt = JRasterTile(d, JGeoTransform(*GT), nodata=-9999.0)
    tt = RasterTile(d, GeoTransform(*GT), nodata=-9999.0)
    want = np.asarray(jrops.convolve(jt, w).data)
    got = trops.convolve(tt, w, device="cpu").data
    assert got.shape == want.shape == d.shape and got.dtype == np.float64
    x = np.where(tt.valid_mask(), d, 0.0)
    scale = convolve_model(np.abs(x), np.abs(w))
    assert np.all(np.abs(got - want) <= 1e-12 * scale + 1e-300)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bhw", SMALL_AND_BANDS)
def test_convolve_small_and_multiband(dtype, bhw):
    """Rasters smaller than the 5 x 5 stencil (1 x 1, 3 x 1, 5 x 7, 2 x 9)
    and a 3-band raster: the plain version bit-equal to the numpy model,
    and rops.convolve within the JAX tolerance of jrops.convolve."""
    rng = np.random.default_rng(sum(bhw))
    x = rng.normal(0, 100, bhw).astype(dtype)
    w = rng.normal(0, 1, (5, 5)).astype(dtype)
    got = convolve_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert np.array_equal(got.view(np.uint8),
                          convolve_model(x, w).view(np.uint8))
    d = x.astype(np.float64)
    want = np.asarray(jrops.convolve(JRasterTile(d, JGeoTransform(*GT)),
                                     w.astype(np.float64)).data)
    port = trops.convolve(RasterTile(d, GeoTransform(*GT)),
                          w.astype(np.float64), device="cpu").data
    assert port.shape == want.shape == d.shape
    scale = convolve_model(np.abs(d), np.abs(w.astype(np.float64)))
    assert np.all(np.abs(port - want) <= 1e-12 * scale + 1e-300)


def test_launch_plan_instances_and_limits():
    """The wrapper's instance and tile picker, pure Python: the fixed
    stencils take their own instance, every other stencil the first
    runtime-size instance whose shared memory fits (a large one the
    small tile), each within SMEM_LIMIT; the limits follow the kernel's
    int indices and the tile; what the kernel does not take raises
    ValueError before any launch."""
    fixed = {(kh, kw): i for i, (kh, kw, _, _) in enumerate(rc.INSTANCES)
             if kh}
    assert set(fixed) == {(3, 3), (4, 4), (5, 5), (7, 7)}
    runtime = [i for i, inst in enumerate(rc.INSTANCES) if inst[0] == 0]
    assert len(runtime) == 2
    for item in (8, 4):
        for kh in range(1, 40):
            for kw in (1, 2, 3, 5, 9, 16, 33):
                i = rc.launch_plan((2, 3601, 3601), (kh, kw), item)
                assert i == fixed.get((kh, kw), runtime[0])
                assert rc.smem_bytes(i, kh, kw, item) <= rc.SMEM_LIMIT
                assert rc.tile_rows(i) == rc.ROWS_PER_THREAD * \
                    rc.INSTANCES[i][3]
        # past the large tile's shared memory, the small tile, then none
        big = next(k for k in range(1, 200)
                   if rc.smem_bytes(runtime[0], k, k, item) > rc.SMEM_LIMIT)
        assert rc.pick_instance(big, big, item) == runtime[1]
        none = next(k for k in range(big, 2000)
                    if rc.smem_bytes(runtime[1], k, k, item) > rc.SMEM_LIMIT)
        with pytest.raises(ValueError, match="shared memory"):
            rc.launch_plan((1, 8, 8), (none, none), item)
    # a stencil side of SMEM_LIMIT / 4 fits no instance, so the kernel's
    # int indices (a side, two steps, a stencil side) stay below 2^31
    side = rc.SMEM_LIMIT // 4
    for i in range(len(rc.INSTANCES)):
        assert rc.smem_bytes(i, side, 1, 4) > rc.SMEM_LIMIT
        assert rc.smem_bytes(i, 1, side, 4) > rc.SMEM_LIMIT
    steps = max(rc.tile_rows(i) for i in range(len(rc.INSTANCES)))
    assert rc.MAX_ROWS + 2 * steps + rc.SMEM_LIMIT // 4 < 2 ** 31
    assert rc.MAX_COLS + 2 * max(i[2] for i in rc.INSTANCES) + \
        rc.SMEM_LIMIT // 4 < 2 ** 31
    assert rc.MAX_BANDS == 2 ** 31 - 1
    for shape in ((rc.MAX_BANDS + 1, 1, 1), (1, rc.MAX_ROWS + 1, 1),
                  (1, 1, rc.MAX_COLS + 1)):
        with pytest.raises(ValueError, match="limits"):
            rc.launch_plan(shape, (3, 3), 8)
    before = raster_convolve.launches
    rc.launch_plan((1, rc.MAX_ROWS, rc.MAX_COLS), (3, 3), 4)
    assert raster_convolve.launches == before


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("instance,kshape,bhw,grid", [
    (0, (3, 3), (2, 37, 70), 3),
    (1, (4, 4), (1, 70, 130), 4),
    (2, (5, 5), (2, 33, 65), 5),
    (3, (7, 7), (1, 65, 64), 2),
    (4, (1, 9), (2, 40, 67), 3),
    (4, (9, 1), (1, 70, 30), 2),
    (5, (11, 11), (2, 19, 40), 5),
    (5, (2, 3), (1, 3, 2), 7),
    (4, (3, 5), (1, 230, 30), 1),
    (5, (6, 2), (2, 61, 20), 3),
])
def test_march_model_equals_plain(dtype, instance, kshape, bhw, grid):
    """The kernel's march, modelled in numpy, bit-equal to convolve_ref:
    block ranges that start mid-strip, cross strips and bands, rings that
    wrap, a step past the last row, a tile narrower than the strip."""
    rng = np.random.default_rng(instance * 100 + sum(bhw))
    x = rng.normal(0, 100, bhw).astype(dtype)
    w = rng.normal(0, 1, kshape).astype(dtype)
    w[0, 0] = -0.0
    want = convolve_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    got = march_model(x, w, instance, grid)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_convolve_is_not_flipped():
    """[[0, 1], [2, 3]] at the origin: 0 x00 + 1 x01 + 2 x10 + 3 x11, as
    XLA gives it (a cross-correlation, the even side padded after)."""
    x = np.arange(20.0).reshape(1, 4, 5)
    w = np.array([[0.0, 1.0], [2.0, 3.0]])
    got = convolve_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got[0, 0, 0] == x[0, 0, 1] + 2 * x[0, 1, 0] + 3 * x[0, 1, 1]
    jt = JRasterTile(x, JGeoTransform(*GT))
    assert np.array_equal(np.asarray(jrops.convolve(jt, w).data), got)


@pytest.mark.parametrize("reducer", sorted(REDUCERS))
def test_combine_against_jax(reducer):
    """rops.combine over overlapping tiles with NaN holes, within 4 ulp of
    the JAX package's jnp.nan* reductions (NaN where JAX has NaN)."""
    rng = np.random.default_rng(11)
    base = rng.normal(0, 30, (2, 12, 14))
    tiles = []
    for k, (c0, r0) in enumerate([(0, 0), (4, 0), (0, 3), (4, 3)]):
        d = base[:, r0:r0 + 9, c0:c0 + 10] + k
        d = np.where(rng.random(d.shape) < 0.25, np.nan, d)
        tiles.append((d, (GT[0] + c0 * GT[1], GT[1], 0.0,
                          GT[3] + r0 * GT[5], 0.0, GT[5])))
    jt = [JRasterTile(d, JGeoTransform(*g)) for d, g in tiles]
    tt = [RasterTile(d, GeoTransform(*g)) for d, g in tiles]
    want = jrops.combine(jt, reducer)
    got = trops.combine(tt, reducer, device="cpu")
    assert got.gt == GeoTransform(*want.gt.to_tuple())
    w, g = np.asarray(want.data), got.data
    assert g.shape == w.shape
    assert np.isnan(g).any() == (reducer not in ("sum", "count"))
    assert ulp_diff(g, w).max() <= 4


def test_median_even_count_and_all_nan_against_jax():
    """Even counts average the two middle values as jnp.nanmedian does
    (torch.nanmedian takes the lower one); all-NaN pixels give NaN for
    avg, min, max and median, 0 for sum and count."""
    import jax.numpy as jnp
    s = np.array([[1.0, 2.0, np.nan, 7.0, np.nan],
                  [4.0, np.nan, np.nan, 1e308, np.nan],
                  [10.0, 3.0, np.nan, 1e308, np.nan],
                  [2.0, np.nan, np.nan, -1.0, np.nan]])[:, None, None, :]
    t = torch.from_numpy(s)
    assert np.array_equal(combine_ref(t, "median").numpy(),
                          np.asarray(jnp.nanmedian(s, axis=0)),
                          equal_nan=True)
    assert combine_ref(t, "median").numpy()[0, 0, 0] == 3.0
    assert torch.nanmedian(t, dim=0).values.numpy()[0, 0, 0] == 2.0
    for reducer, fn in (("avg", jnp.nanmean), ("min", jnp.nanmin),
                        ("max", jnp.nanmax), ("sum", jnp.nansum)):
        with np.errstate(all="ignore"):
            want = np.asarray(fn(s, axis=0))
        assert ulp_diff(combine_ref(t, reducer).numpy(), want).max() <= 4
    assert combine_ref(t, "count").numpy()[0, 0].tolist() == \
        [4.0, 2.0, 0.0, 4.0, 0.0]
    assert combine_ref(t, "sum").numpy()[0, 0, 4] == 0.0


def test_wrappers_reject_and_count():
    x = torch.zeros((1, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="both be float64"):
        raster_convolve(x, torch.ones((3, 3), dtype=torch.float32))
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        raster_convolve(x[0], torch.ones((3, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="kh, kw"):
        raster_convolve(x, torch.ones((0, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown reducer"):
        raster_combine(x[None], "mode")
    with pytest.raises(ValueError, match="float64"):
        raster_combine(x[None].float(), "avg")
    before = (raster_convolve.launches, raster_combine.launches)
    raster_convolve(x, torch.ones((3, 3), dtype=torch.float64))
    raster_combine(x[None], "avg")
    assert (raster_convolve.launches, raster_combine.launches) == before
