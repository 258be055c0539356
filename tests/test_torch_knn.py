"""SpatialKNN of the PyTorch port against the JAX package and the f64 oracle.

The JAX package runs on the CPU as the tier-1 suite runs it.  Both
packages' engines are pinned through their own ``mosaic.knn.strategy``
conf ("brute" or "ring"), so both take the same engine and their counts
compare; both cost planners are reset before each test, so an unpinned
choice is the cold rule in both.  The port runs on ``device="cpu"``,
where the brute top-k (K5) and the ring step (K6) are their plain
versions.

* The ENGINES matrix of tests/test_knn.py (brute and rings) over its
  brute-force, k-larger, threshold, small-right-side, vertex-anchored and
  global multi-face cases: ``right_id`` equal to the JAX package's and to
  ``knn_host_truth``'s, distances bit-equal to the JAX package's,
  ``iterations`` and ``rechecked`` equal.
* The BNG fallback, geometry rows (tests/test_knn.py's fixture, both
  engines), all-POINT GeometryArrays, checkpoint resume and the
  checkpoint's fallback past a torn file, and BinaryTransformer's
  pre-transforms and loop against the JAX package's.
* ``build_knn_indexes`` tables bit-equal to the JAX package's on the
  global fixture.
* The kernels' plain versions against the JAX package's device bodies.
  XLA:CPU contracts ``dx * dx + dy * dy`` into ``fma(dx, dx, dy * dy)``;
  the port rounds the product and the sum apart (the kernels build with
  ``-fmad=false``), so on general inputs the two differ by one ulp at
  most.  The rule there: d2 within 2 ulp, and indices (codes) equal
  wherever the neighbouring d2 differ by more than 4 ulp.  On inputs
  whose distances are exact in f32 (small integers) no rounding happens,
  and there the two are held bit for bit, ties included.
* Any k: brute at k = 57, 64 and 100 (kc = k + 8 past 64) and the
  rings at k = 64 and 100 (lists of k + 1 past 64), with and without a
  threshold, equal to the JAX package's and to ``knn_host_truth``; the
  plain versions at those widths (kc 65 and m, lists of 65 and 130)
  against the JAX device bodies on integer inputs with ties, bit for bit.
* The engine choice (``_points_strategy`` and ``_last_decision``) equal
  to the JAX package's under ``mosaic.knn.strategy`` = brute, ring, auto
  and a numeric threshold, cold and after the same learned costs, with
  the ``brute_ok`` guard past 4 * ``brute_right_max``; the one stated
  divergence, ``brute_right_max=0`` forcing the ring over a learned
  brute pick.
* ``ais_pings_ports`` byte-identical to bench.py's inline config-4
  generator; the wrappers' refusals (kc < 1, wrong dtypes); the CUDA
  default; the chunk index ``stream`` hands to ``compute``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu import config as jconfig
from mosaic_tpu.sql.planner import planner as jplanner
from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.models import CheckpointManager as JCheckpoint
from mosaic_tpu.models import SpatialKNN as JKNN
from mosaic_tpu.models import core as jcore
from mosaic_tpu.models import knn as jknn
from mosaic_tpu.parallel.pip_join import _host_lattice as jlattice
import mosaic_tpu_torch as mt
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.core.geometry.array import GeometryBuilder as TBuilder
from mosaic_tpu_torch.models import core as tcore
from mosaic_tpu_torch.models import knn as tknn
from mosaic_tpu_torch.ops import knn_brute, knn_ring
from mosaic_tpu_torch.perf.pipeline import chunk_rows, stream
from mosaic_tpu_torch.sql.planner import planner as tplanner

NYC = (-74.25, 40.5, -73.7, 40.9)

ENGINES = [
    pytest.param(("brute", {}), id="brute"),
    pytest.param(("ring", {"brute_right_max": 0}), id="rings"),
]


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
    return jget("H3"), mt.get_index_system("H3")


@pytest.fixture(autouse=True)
def cold_planners():
    """Both packages' configs snapshotted and restored around each test,
    and both cost planners reset: no test's engine choice comes from
    another's timings."""
    jprev, tprev = jconfig.default_config(), tconfig.default_config()
    jplanner.reset()
    tplanner.reset()
    yield
    jconfig.set_default_config(jprev)
    tconfig.set_default_config(tprev)
    jplanner.reset()
    tplanner.reset()


@contextlib.contextmanager
def pinned_engine(strategy: str):
    """Pin both packages' KNN engine through their conf keys."""
    old = jconfig.default_config(), tconfig.default_config()
    jconfig.set_default_config(dataclasses.replace(old[0],
                                                   knn_strategy=strategy))
    tconfig.set_default_config(dataclasses.replace(old[1],
                                                   knn_strategy=strategy))
    try:
        yield
    finally:
        jconfig.set_default_config(old[0])
        tconfig.set_default_config(old[1])


def _pts(n, seed, bbox=NYC):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(bbox[0], bbox[2], n),
                     rng.uniform(bbox[1], bbox[3], n)], -1)


def _global(n, rng):
    return np.stack([rng.uniform(-180, 180, n),
                     np.degrees(np.arcsin(rng.uniform(-1, 1, n)))], -1)


def _global_fixture():
    """tests/test_knn.py's global multi-face case: (pings, ports)."""
    rng = np.random.default_rng(11)
    ports = _global(6000, rng)
    pings = _global(3000, rng)
    return pings, ports


def _vertex_left(jgrid):
    cells = np.unique(jgrid.point_to_cell(_pts(64, 14), 8))
    verts, _ = jgrid.cell_boundary(cells)
    return verts.reshape(-1, 2)[:256]


#: tests/test_knn.py's cases: (left, right, SpatialKNN kwargs)
CASES = {
    "bruteforce": lambda g: (_pts(2000, 1), _pts(300, 2),
                             dict(k=5, index_resolution=7,
                                  max_iterations=32)),
    "k_larger": lambda g: (_pts(500, 3), _pts(40, 4),
                           dict(k=7, index_resolution=8, max_iterations=64)),
    "threshold": lambda g: (_pts(800, 5), _pts(200, 6),
                            dict(k=4, index_resolution=8, max_iterations=64,
                                 distance_threshold=0.02)),
    "small_right": lambda g: (_pts(50, 11), _pts(2, 12),
                              dict(k=5, index_resolution=8,
                                   max_iterations=64)),
    "vertex_anchored": lambda g: (_vertex_left(g), _pts(120, 13),
                                  dict(k=3, index_resolution=8,
                                       max_iterations=64)),
    "global_multi_face": lambda g: (*_global_fixture(),
                                    dict(k=4, index_resolution=4,
                                         max_iterations=64)),
}


def _check_oracle(out, left, right, k, thr=None):
    ids, dist = mt.knn_host_truth(left, right, k, thr)
    assert np.array_equal(out["right_id"], ids)
    both = np.isfinite(dist)
    assert np.allclose(out["distance"][both], dist[both], rtol=0, atol=1e-12)
    assert not np.any(np.isfinite(out["distance"]) ^ both)


def _same_as_jax(out, ref):
    assert np.array_equal(out["right_id"], ref["right_id"])
    assert out["distance"].dtype == ref["distance"].dtype
    assert np.array_equal(out["distance"], ref["distance"], equal_nan=True)
    assert np.array_equal(out["left_id"], ref["left_id"])
    assert np.array_equal(out["rank"], ref["rank"])
    assert (out["iterations"], out["rechecked"]) == \
        (ref["iterations"], ref["rechecked"])


@pytest.mark.parametrize("eng", ENGINES)
@pytest.mark.parametrize("case", list(CASES))
def test_knn_equals_jax_and_oracle(grids, case, eng):
    jg, tg = grids
    strategy, kw = eng
    left, right, params = CASES[case](jg)
    with pinned_engine(strategy):
        ref = JKNN(jg, **params, **kw).transform(left, right)
        out = mt.SpatialKNN(tg, **params, **kw, device="cpu").transform(
            left, right)
    _same_as_jax(out, ref)
    _check_oracle(out, left, right, params["k"],
                  params.get("distance_threshold"))
    if case == "bruteforce":
        assert out["iterations"] < 32
    if case == "threshold":
        assert np.any(out["right_id"] < 0)
    if case == "small_right":
        assert np.all(out["right_id"][:, 2:] == -1)
    if case == "global_multi_face":
        assert out["rechecked"] < 0.7 * len(left), out["rechecked"]


def test_non_h3_grid_fallback():
    bbox = (-5.0, 50.5, 1.5, 54.0)
    left, right = _pts(500, 3, bbox=bbox), _pts(80, 4, bbox=bbox)
    ref = JKNN(jget("BNG"), k=3, index_resolution=4,
               max_iterations=16).transform(left, right)
    out = mt.SpatialKNN(mt.get_index_system("BNG"), k=3, index_resolution=4,
                        max_iterations=16, device="cpu").transform(left,
                                                                   right)
    _same_as_jax(out, ref)
    _check_oracle(out, left, right, 3)


def _boxes(make, rng, n):
    b = make()
    for _ in range(n):
        cx = rng.uniform(-74.05, -73.9)
        cy = rng.uniform(40.6, 40.85)
        w, h = rng.uniform(1e-3, 6e-3, 2)
        b.add_polygon(np.array([[cx - w, cy - h], [cx + w, cy - h],
                                [cx + w, cy + h], [cx - w, cy + h],
                                [cx - w, cy - h]]))
    return b.finish()


@pytest.mark.parametrize("eng", ENGINES)
def test_knn_geometry_rows(grids, eng):
    """tests/test_knn.py's geometry fixture: small right sides take the
    bounded all-pairs pass, ``brute_right_max=0`` the ring join over
    tessellation cells; both equal the JAX package's and the all-pairs
    exact distance."""
    jg, tg = grids
    _, kw = eng
    side = {}
    for name, make in (("j", JBuilder), ("t", TBuilder)):
        rng = np.random.default_rng(5)
        side[name] = (_boxes(make, rng, 40), _boxes(make, rng, 25))
    k = 3
    ref = JKNN(jg, k=k, index_resolution=8, max_iterations=64,
               **kw).transform(*side["j"])
    out = mt.SpatialKNN(tg, k=k, index_resolution=8, max_iterations=64,
                        device="cpu", **kw).transform(*side["t"])
    _same_as_jax(out, ref)
    L, R = side["t"]
    ii = np.repeat(np.arange(len(L)), len(R))
    jj = np.tile(np.arange(len(R)), len(L))
    dall = tknn.pairwise_geometry_distance(L.take(ii), R.take(jj)).reshape(
        len(L), len(R))
    want = np.take_along_axis(dall, np.argsort(dall, axis=1,
                                               kind="stable")[:, :k], axis=1)
    assert np.allclose(out["distance"], want, rtol=0, atol=1e-12)
    got = np.take_along_axis(dall, out["right_id"], axis=1)
    assert np.all(np.abs(got - want) < 1e-12)


def test_knn_geometry_point_rows(grids):
    jg, tg = grids
    left, right = _pts(300, 7), _pts(50, 8)
    arrays = {}
    for name, make in (("j", JBuilder), ("t", TBuilder)):
        bl, br = make(), make()
        for p in left:
            bl.add_point(p)
        for p in right:
            br.add_point(p)
        arrays[name] = (bl.finish(), br.finish())
    assert np.array_equal(tknn.points_block_np(arrays["t"][0], np.float64),
                          left)
    ref = JKNN(jg, k=3, index_resolution=7,
               max_iterations=32).transform(*arrays["j"])
    out = mt.SpatialKNN(tg, k=3, index_resolution=7, max_iterations=32,
                        device="cpu").transform(*arrays["t"])
    _same_as_jax(out, ref)
    _check_oracle(out, left, right, 3)


def test_knn_checkpoint_resume(grids, tmp_path):
    """Stop the ring march after 2 rings, resume from the port's
    checkpoint: the answer equals a full run's and the JAX package's
    resumed run's."""
    jg, tg = grids
    left, right = _pts(600, 7), _pts(150, 8)
    full = mt.SpatialKNN(tg, k=3, index_resolution=8, max_iterations=64,
                         device="cpu").transform(left, right)
    outs = {}
    for name, make, ck in (
            ("t", lambda **kw: mt.SpatialKNN(tg, device="cpu", **kw),
             mt.CheckpointManager(str(tmp_path / "t"))),
            ("j", lambda **kw: JKNN(jg, **kw),
             JCheckpoint(str(tmp_path / "j")))):
        make(k=3, index_resolution=8, max_iterations=2, checkpoint=ck,
             brute_right_max=0).transform(left, right)
        state = ck.load_latest()
        assert state.iteration == 2 and not state.converged
        outs[name] = make(k=3, index_resolution=8, max_iterations=64,
                          checkpoint=ck, brute_right_max=0).transform(left,
                                                                      right)
    assert np.array_equal(outs["t"]["right_id"], full["right_id"])
    _same_as_jax(outs["t"], outs["j"])


def test_checkpoint_falls_back_past_a_torn_file(tmp_path):
    ck = mt.CheckpointManager(str(tmp_path), keep=3)
    for it in (1, 2):
        ck.save(mt.models.IterationState(iteration=it, payload={
            "top_d2": torch.full((4, 2), float(it)),
            "top_code": np.arange(8, dtype=np.int32).reshape(4, 2)}))
    (tmp_path / "iter_0003.npz").write_bytes(b"torn write")
    state = ck.load_latest()
    assert state.iteration == 2 and not state.converged
    assert isinstance(state.payload["top_d2"], np.ndarray)
    assert np.array_equal(state.payload["top_d2"], np.full((4, 2), 2.0,
                                                           np.float32))
    ck.save(mt.models.IterationState(iteration=4, payload={}))
    assert ck._iterations() == [2, 3, 4]


def _halving(core):
    """A BinaryTransformer of ``core`` (either package's models.core) that
    halves the gap between the left sum and the right sum each step, and
    stops once the gap is below 1."""
    class Halving(core.BinaryTransformer):
        def initial_state(self, left, right):
            return core.IterationState(iteration=0, payload={
                "gap": float(np.sum(left) - np.sum(right))})

        def step(self, state):
            return core.IterationState(iteration=state.iteration, payload={
                "gap": state.payload["gap"] / 2})

        def early_stop(self, prev, cur):
            return abs(cur.payload["gap"]) < 1.0
    return Halving


@pytest.mark.parametrize("max_iterations", [3, 16])
def test_binary_transformer_matches_jax(tmp_path, max_iterations):
    left = np.arange(10, dtype=np.float64)
    right = np.ones(4)
    runs = {}
    for name, core in (("j", jcore), ("t", tcore)):
        ck = mt.CheckpointManager(str(tmp_path / name)) if name == "t" \
            else None
        runs[name] = _halving(core)(max_iterations=max_iterations, checkpoint=ck,
                         left_transform=lambda x: x * 2,
                         right_transform=lambda x: x + 1).transform(left,
                                                                    right)
    j, t = runs["j"], runs["t"]
    # the pre-transforms ran: gap 2 * 45 - 8 = 82, halved each step
    assert (t.iteration, t.converged, t.payload) == \
        (j.iteration, j.converged, j.payload)
    assert t.iteration == min(max_iterations, 7)
    assert t.converged == (max_iterations >= 7)
    assert t.payload["gap"] == 82 / 2 ** t.iteration
    saved = mt.CheckpointManager(str(tmp_path / "t")).load_latest()
    assert saved.iteration == t.iteration


def test_build_knn_indexes_tables_bit_equal(grids):
    jg, tg = grids
    _, ports = _global_fixture()
    jidx, jrows, jres = jknn.build_knn_indexes(ports, 4, jg)
    tidx, trows, tres = mt.build_knn_indexes(ports, 4, tg, device="cpu")
    for name in ("entry", "pool_xy"):
        j = np.asarray(getattr(jidx, name))
        t = getattr(tidx, name).numpy()
        assert j.dtype == t.dtype and j.shape == t.shape
        assert j.tobytes() == t.tobytes(), name
    assert np.array_equal(jidx.pool_rowid, tidx.pool_rowid)
    for name in ("res", "cap", "inr_deg", "circ_deg", "n_right"):
        assert getattr(jidx, name) == getattr(tidx, name), name
    assert jidx.face_params.keys() == tidx.face_params.keys()
    for f, jp in jidx.face_params.items():
        tp = tidx.face_params[f]
        assert tuple(jp[:5]) == tuple(tp[:5])
        assert np.array_equal(jp[5], tp[5])
    assert jrows.keys() == trows.keys()
    assert all(np.array_equal(jrows[f], trows[f]) for f in jrows)
    assert np.array_equal(jres, tres) and len(tres) > 0
    assert len(tidx.face_params) > 10


def _ulps(a, b):
    """|a - b| in f32 ulps (finite, same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64) -
                  b.view(np.int32).astype(np.int64))


def _ambiguous(d2, ulps=4):
    """[rows, K] where a neighbour in the row lies within ``ulps``."""
    near = _ulps(d2[:, 1:], d2[:, :-1]) <= ulps
    amb = np.zeros(d2.shape, bool)
    amb[:, 1:] |= near
    amb[:, :-1] |= near
    return amb


def _jax_brute(lc, rc, kc):
    def kern(lc, rc):
        dx = lc[:, None, 0] - rc[None, :, 0]
        dy = lc[:, None, 1] - rc[None, :, 1]
        negd2, idx = jax.lax.top_k(-(dx * dx + dy * dy), kc)
        return -negd2, idx
    d2, idx = jax.jit(kern)(jnp.asarray(lc), jnp.asarray(rc))
    return np.asarray(d2), np.asarray(idx)


def test_brute_topk_ref_against_lax_top_k():
    """A config-4-like block: 2,048 pings around a center, 3,000 global
    ports, both centered and cast as the brute pass does; kc = 13."""
    pings, ports = mt.ais_pings_ports(2048, 3000, seed=5)
    center = pings.mean(axis=0)
    lc = (pings - center).astype(np.float32)
    rc = (ports - center).astype(np.float32)
    jd2, jidx = _jax_brute(lc, rc, 13)
    td2, tidx = (t.numpy() for t in knn_brute.brute_topk_ref(
        torch.from_numpy(lc), torch.from_numpy(rc), 13))
    assert tidx.dtype == np.int32 and td2.dtype == np.float32
    assert _ulps(td2, jd2).max() <= 2
    amb = _ambiguous(jd2) | _ambiguous(td2)
    assert np.array_equal(tidx[~amb], jidx[~amb])
    assert amb.mean() < 1e-3


def _tie_block():
    """Integer coordinates, duplicated right points: (lc, rc)."""
    rng = np.random.default_rng(3)
    lc = rng.integers(-40, 40, (512, 2)).astype(np.float32)
    base = rng.integers(-40, 40, (300, 2)).astype(np.float32)
    rc = np.concatenate([base, base[::3], base[:50]])
    rng.shuffle(rc)
    return lc, rc


def _brute_ties_bit_equal(kc):
    lc, rc = _tie_block()
    jd2, jidx = _jax_brute(lc, rc, kc)
    td2, tidx = (t.numpy() for t in knn_brute.brute_topk_ref(
        torch.from_numpy(lc), torch.from_numpy(rc), kc))
    assert td2.tobytes() == jd2.tobytes()
    assert np.array_equal(tidx, jidx)
    return td2


def test_brute_topk_ref_ties_bit_equal():
    """Integer coordinates: every distance exact in f32, so no rounding
    separates the packages; duplicated right points tie exactly and both
    keep the lower index first."""
    for kc in (1, 13, 64):
        td2 = _brute_ties_bit_equal(kc)
    assert np.any(td2[:, 1:] == td2[:, :-1])         # ties were there


@pytest.mark.parametrize("kc", [65, 450], ids=["kc65", "kc_m"])
def test_brute_topk_ref_wide_ties_bit_equal(kc):
    """The same block past the old 64-candidate limit, up to every right
    point (m = 450)."""
    assert len(_tie_block()[1]) == 450
    td2 = _brute_ties_bit_equal(kc)
    assert np.any(td2[:, 1:] == td2[:, :-1])


def test_brute_topk_wrapper_on_cpu():
    """The wrapper's CPU path: the right side centered in f64 and rounded
    (numpy's bits), then the plain version, at any kc up to the right
    side's length; kc < 1, kc past it and a wrong dtype raise."""
    pings, ports = mt.ais_pings_ports(1000, 500, seed=9)
    center = pings[:300].mean(axis=0)
    rc = knn_brute.center_right(torch.from_numpy(ports), center)
    assert rc.numpy().tobytes() == \
        (ports - center).astype(np.float32).tobytes()
    lc = torch.from_numpy((pings[:300] - center).astype(np.float32))
    got = knn_brute.brute_topk(lc, torch.from_numpy(ports), center, 13)
    want = knn_brute.brute_topk_ref(lc, rc, 13)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert knn_brute.brute_topk.launches == 0
    right = torch.from_numpy(ports)
    for kc in (65, len(ports)):
        got = knn_brute.brute_topk(lc, right, center, kc)
        want = knn_brute.brute_topk_ref(lc, rc, kc)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert knn_brute.brute_topk.launches == 0
    with pytest.raises(ValueError, match="kc 0 < 1"):
        knn_brute.brute_topk(lc, right, center, 0)
    with pytest.raises(ValueError, match="501 > 500 right rows"):
        knn_brute.brute_topk(lc, right, center, 501)
    with pytest.raises(ValueError, match="float64"):
        knn_brute.brute_topk(lc, right.float(), center, 13)


#: k past the 64-entry register lists of the port's first kernels: the
#: brute pass keeps kc = k + 8 candidates a row, the rings k + 1
WIDE_K = [
    pytest.param(("brute", {}), 57, None, id="brute-k57"),
    pytest.param(("brute", {}), 64, None, id="brute-k64"),
    pytest.param(("brute", {}), 100, None, id="brute-k100"),
    pytest.param(("brute", {}), 100, 0.02, id="brute-k100-threshold"),
    pytest.param(("ring", {"brute_right_max": 0}), 64, None,
                 id="rings-k64"),
    pytest.param(("ring", {"brute_right_max": 0}), 100, None,
                 id="rings-k100"),
    pytest.param(("ring", {"brute_right_max": 0}), 100, 0.02,
                 id="rings-k100-threshold"),
]


@pytest.mark.parametrize("eng, k, thr", WIDE_K)
def test_knn_any_k_equals_jax_and_oracle(grids, eng, k, thr):
    """300 NYC pings x 400 points at H3 res 7: ids, f64 distances,
    iterations and rechecked equal to the JAX package's; ids equal to
    ``knn_host_truth``'s."""
    jg, tg = grids
    strategy, kw = eng
    left, right = _pts(300, 21), _pts(400, 22)
    params = dict(k=k, index_resolution=7, max_iterations=32,
                  distance_threshold=thr)
    with pinned_engine(strategy):
        ref = JKNN(jg, **params, **kw).transform(left, right)
        out = mt.SpatialKNN(tg, **params, **kw, device="cpu").transform(
            left, right)
    _same_as_jax(out, ref)
    _check_oracle(out, left, right, k, thr)
    assert out["right_id"].shape == (300, k)
    if thr is not None:
        assert np.any(out["right_id"] < 0) and np.any(out["right_id"] >= 0)


def _row_params(idx, left, res, lattice):
    """The ring path's per-row inputs, as the transform builds them."""
    n = len(left)
    face, al, bl = lattice(left, res)
    cols = {c: np.zeros(n, np.int32) for c in ("a0", "b0", "W", "H",
                                                "eoff")}
    pts = np.zeros((n, 2), np.float32)
    for f, (a0, b0, W, H, eoff, origin) in idx.face_params.items():
        rows = face == f
        for c, v in zip(("a0", "b0", "W", "H", "eoff"), (a0, b0, W, H,
                                                          eoff)):
            cols[c][rows] = v
        pts[rows] = (left[rows] - origin[None]).astype(np.float32)
    return [pts, al.astype(np.int32), bl.astype(np.int32), cols["a0"],
            cols["b0"], cols["W"], cols["H"], cols["eoff"]]


def _ring_inputs(d):
    offs = tknn._ring_offsets(d)
    assert np.array_equal(offs, jknn._ring_offsets(d))
    pad = 1
    while pad < len(offs):
        pad *= 2
    omask = np.zeros(pad, bool)
    omask[:len(offs)] = True
    offs_p = np.zeros((pad, 2), np.int32)
    offs_p[:len(offs)] = offs
    return offs_p, omask


def _march(jidx, rows, k, rings, thr=None):
    """(JAX lists, port lists) after each ring 0..rings-1, the JAX
    package's jitted step on its index and the port's plain version on
    the index carried across by ``knn_index_from_arrays``."""
    tidx = mt.knn_index_from_arrays({
        "entry": np.asarray(jidx.entry), "pool_xy": np.asarray(jidx.pool_xy),
        "pool_rowid": jidx.pool_rowid, "face_params": jidx.face_params,
        "res": jidx.res, "cap": jidx.cap, "inr_deg": jidx.inr_deg,
        "circ_deg": jidx.circ_deg, "n_right": jidx.n_right}, device="cpu")
    assert tidx.entry.numpy().tobytes() == np.asarray(jidx.entry).tobytes()
    jk = JKNN(jget("H3"), k=k, distance_threshold=thr)
    tk = mt.SpatialKNN(mt.get_index_system("H3"), k=k,
                       distance_threshold=thr, device="cpu")
    n = len(rows[0])
    jd2 = np.full((n, k + 1), np.inf, np.float32)
    jcode = np.full((n, k + 1), -1, np.int32)
    td2, tcode = torch.from_numpy(jd2.copy()), torch.from_numpy(jcode.copy())
    trows = [torch.from_numpy(r) for r in rows]
    out = []
    for d in range(rings):
        offs, omask = _ring_inputs(d)
        fn = jk._make_step(len(offs), jidx)
        jd2, jcode = fn(jidx.entry, jidx.pool_xy,
                        *[jnp.asarray(r) for r in rows], jd2, jcode,
                        jnp.asarray(offs), jnp.asarray(omask))
        td2, tcode = knn_ring.ring_step(
            tidx.entry, tidx.pool_xy, *trows, td2, tcode,
            torch.from_numpy(offs), torch.from_numpy(omask), tidx.cap,
            tk._thr2())
        out.append((np.asarray(jd2), np.asarray(jcode), td2.numpy(),
                    tcode.numpy()))
    return out


@pytest.mark.parametrize("thr", [None, 2.0])
def test_ring_step_ref_against_jax_step(grids, thr):
    """Ten rings of the global fixture (res 4, k = 4) on the JAX index:
    the ulp rule ring by ring; the lists hold real candidates."""
    jg, _ = grids
    pings, ports = _global_fixture()
    jidx, _, _ = jknn.build_knn_indexes(ports, 4, jg)
    rows = _row_params(jidx, pings, 4, lambda p, r: jlattice(jg, p, r))
    for jd2, jcode, td2, tcode in _march(jidx, rows, 4, 10, thr):
        finite = np.isfinite(jd2)
        assert np.array_equal(finite, np.isfinite(td2))
        assert _ulps(td2[finite], jd2[finite]).max() <= 2
        amb = (_ambiguous(np.where(finite, jd2, 0)) |
               _ambiguous(np.where(finite, td2, 0))) & finite
        assert np.array_equal(tcode[~amb], jcode[~amb])
    assert finite.mean() > (0.9 if thr is None else 0.2)
    if thr is not None:
        assert np.all(td2[finite] <= np.float32(thr) ** 2)


@pytest.mark.parametrize("k", [5, 64, 129], ids=["k1_6", "k1_65",
                                                 "k1_130"])
def test_ring_step_ref_ties_bit_equal(k):
    """A synthetic one-face window with integer pool coordinates and
    duplicated points in several cells (so equal distances arrive in one
    offset and across offsets), 1e9-padded slots, a threshold and
    masked offsets: the port's lists equal the JAX step's bit for bit,
    and the padded slots come through live, as in the reference; also
    with lists of 65 and 130 entries, past the old 64."""
    rng = np.random.default_rng(4)
    W, H, cap = 12, 10, 3
    C = 60
    cells = rng.choice(W * H, C, replace=False)
    entry = np.full(W * H, -1, np.int32)
    entry[cells] = np.arange(C, dtype=np.int32)
    pool = np.full((C, cap, 2), 1e9, np.float32)
    fill = rng.integers(1, cap + 1, C)
    pts_int = rng.integers(-6, 7, (20, 2)).astype(np.float32)
    for c in range(C):
        pool[c, :fill[c]] = pts_int[rng.integers(0, 20, fill[c])]
    jidx = jknn.FusedKNNIndex(
        entry=jnp.asarray(entry), pool_xy=jnp.asarray(pool),
        pool_rowid=np.zeros((C, cap), np.int32),
        face_params={0: (0, 0, W, H, 0, np.zeros(2))}, res=4, cap=cap,
        inr_deg=1.0, circ_deg=1.0, n_right=C * cap)
    n = 400
    left = np.stack([rng.integers(-1, W + 1, n), rng.integers(-1, H + 1, n)],
                    -1).astype(np.int32)
    rows = [rng.integers(-6, 7, (n, 2)).astype(np.float32), left[:, 0],
            left[:, 1]] + [np.full(n, v, np.int32) for v in (0, 0, W, H, 0)]
    for thr in (None, 5.0):
        padded = False
        for jd2, jcode, td2, tcode in _march(jidx, rows, k, 5, thr):
            assert td2.tobytes() == jd2.tobytes()
            assert np.array_equal(tcode, jcode)
            padded |= bool(np.any((tcode >= 0) & (td2 > 1e17)))
        # ties between numbers were there
        assert np.any((td2[:, 1:] == td2[:, :-1]) & np.isfinite(td2[:, 1:]))
        assert padded == (thr is None)


def _set_both(key, val):
    for m in (jconfig, tconfig):
        m.set_default_config(m.apply_conf(m.default_config(), key, val))


def _learn(brute_ms: float, ring_ms: float):
    """The same knn/brute and knn/ring costs fed to both planners."""
    for pl in (jplanner, tplanner):
        pl.observe_op("knn/brute", 1000, brute_ms * 1e-3)
        pl.observe_op("knn/ring", 1000, ring_ms * 1e-3)


def _choice(knn, m):
    strategy, d = knn._points_strategy(1000, m)
    fields = None if d is None else (
        d.op, d.strategy, d.reason, d.est_rows, d.cost_key, d.key_n,
        d.forced)
    return strategy, fields


@pytest.mark.parametrize("conf", ["auto", "brute", "ring", "64"])
@pytest.mark.parametrize("learned", [None, "brute", "ring"])
@pytest.mark.parametrize("enabled", ["true", "false"])
def test_engine_choice_equals_jax(grids, conf, learned, enabled):
    """_points_strategy's engine and decision equal the JAX package's,
    the ``brute_ok`` guard included: past 4 * brute_right_max (400 here)
    no learned cost picks brute."""
    jg, tg = grids
    _set_both("mosaic.knn.strategy", conf)
    _set_both("mosaic.planner.enabled", enabled)
    if learned:
        _learn(0.01 if learned == "brute" else 5.0,
               0.01 if learned == "ring" else 5.0)
    jk = JKNN(jg, k=3, brute_right_max=100)
    tk = mt.SpatialKNN(tg, k=3, brute_right_max=100, device="cpu")
    for m in (0, 1, 50, 64, 65, 100, 101, 300, 400, 401, 5000):
        got = _choice(tk, m)
        assert got == _choice(jk, m), (m, got)
        if conf == "auto" and enabled == "true" and learned == "brute":
            assert got[0] == ("brute" if 0 < m <= 400 else "ring")
    assert jplanner.decisions == tplanner.decisions


@pytest.mark.parametrize("conf,learned", [("auto", None), ("ring", None),
                                          ("brute", None),
                                          ("auto", "ring")])
def test_transform_decision_equals_jax(grids, conf, learned):
    """A whole transform takes the same engine, keeps the same
    ``_last_decision`` and feeds the planner once, as the JAX package's."""
    jg, tg = grids
    _set_both("mosaic.knn.strategy", conf)
    if learned:
        _learn(5.0, 0.01)
    left, right = _pts(400, 31), _pts(60, 32)
    params = dict(k=3, index_resolution=7, max_iterations=32)
    jk, tk = JKNN(jg, **params), mt.SpatialKNN(tg, **params, device="cpu")
    ref = jk.transform(left, right)
    out = tk.transform(left, right)
    _same_as_jax(out, ref)
    d, jd = tk._last_decision, jk._last_decision
    assert (d.strategy, d.reason, d.cost_key, d.forced) == \
        (jd.strategy, jd.reason, jd.cost_key, jd.forced)
    assert d.strategy == (conf if conf != "auto" else
                          ("ring" if learned else "brute"))
    rt, rj = tplanner.report(), jplanner.report()
    assert (rt["decisions"], rt["observations"], rt["ms_keys"]) == \
        (rj["decisions"], rj["observations"], rj["ms_keys"])


def test_zero_brute_right_max_forces_the_ring(grids):
    """Cold, both packages march rings at ``brute_right_max=0``.  With
    learned costs favouring brute and a right side within the guard
    (4 * max(0, 1) rows) the JAX package's planner picks brute; the port
    keeps the ring (the stated divergence)."""
    jg, tg = grids
    jk = JKNN(jg, k=3, brute_right_max=0)
    tk = mt.SpatialKNN(tg, k=3, brute_right_max=0, device="cpu")
    for m in (1, 4, 5, 300):
        assert _choice(tk, m) == _choice(jk, m)
        assert _choice(tk, m)[0] == "ring"
    _learn(0.01, 5.0)
    for m in (1, 4):
        assert _choice(jk, m)[0] == "brute"
        strategy, d = tk._points_strategy(1000, m)
        assert strategy == "ring" and d.forced
        assert (d.reason, d.cost_key) == ("brute_right_max=0 forces the "
                                          "ring", "knn/ring")
    assert _choice(tk, 5) == _choice(jk, 5)


def test_ais_pings_ports_matches_bench_generator():
    """bench.py's inline config-4 generator (bench.py:1511-1518), as it
    stands there."""
    rngk = np.random.default_rng(31)
    ports = np.stack([
        rngk.uniform(-180, 180, 3000),
        np.degrees(np.arcsin(rngk.uniform(-0.98, 0.98, 3000)))], -1)
    n_pings = 1 << 20
    ctr = ports[rngk.integers(0, len(ports), n_pings)]
    pings = ctr + rngk.normal(0, 1.5, (n_pings, 2))
    pings[:, 1] = np.clip(pings[:, 1], -88, 88)
    got_pings, got_ports = mt.ais_pings_ports()
    assert got_ports.tobytes() == ports.tobytes()
    assert got_pings.tobytes() == pings.tobytes()


def test_spatial_knn_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.SpatialKNN(mt.get_index_system("H3"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.build_knn_indexes(_pts(10, 1), 7, mt.get_index_system("H3"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.knn_index_from_arrays({})


def test_stream_hands_compute_its_chunk_index():
    seen = []
    out = np.zeros(10, np.float32)

    def stage(sl, buf):
        buf[:, 0] = np.arange(sl.start, sl.stop)

    def compute(i, x):
        seen.append(i)
        return (x[:, 0] + 100 * i,)

    def consume(i, sl, host):
        out[sl] = host[0]

    stream(chunk_rows(10, 4), stage, 1, compute, consume,
           torch.device("cpu"))
    assert seen == [0, 1, 2]
    assert np.array_equal(out, np.arange(10) + 100 * (np.arange(10) // 4))
