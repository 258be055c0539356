"""Dense H3 PIP join of the PyTorch port against the JAX package's.

* The port's DensePIPIndex tables are bit-equal to the JAX one's, built
  from the same workload (the JAX side on its numpy tessellation branches
  and with the df margin bound, the arithmetic the port runs).
* The very index the JAX package built, carried across with
  ``dense_index_from_arrays``, joins 50,000 NYC points: after the f64
  recheck both packages give the same zones, and both equal the exact
  oracle ``pip_host_truth``.
* The streamed join equals the one-shot join; the zone histogram equals
  ``np.bincount`` of the matched zones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu.bench.workloads import build_workload as jbuild
from mosaic_tpu.bench.workloads import nyc_points as jnyc_points
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu_torch.bench.workloads import build_workload as tbuild
from mosaic_tpu_torch.bench.workloads import nyc_points
from mosaic_tpu_torch.core.index.factory import get_index_system
from mosaic_tpu_torch.parallel import pip_join as tpj

STATICS = ("face0", "a0", "b0", "W", "H", "res", "err_lattice", "n_zones",
           "ext_deg")

AUX = ("flat_a", "flat_b", "edge_zslot", "gstart", "gzones64")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tables_of(idx) -> dict:
    out = {k: np.asarray(getattr(idx, k)) for k in
           ("entry", "pool", "gzones", "gwide", "origin")}
    out.update({k: getattr(idx, k) for k in STATICS})
    out["aux"] = {k: np.asarray(idx.aux[k]) for k in AUX}
    return out


@pytest.fixture(scope="module")
def flagship():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtess_module, "_f64_jit_enabled",
                   lambda disable_env=None: False)
        jp, jg, res = jbuild(n_side=4, grid_name="H3", zones="taxi")
        jidx = jpj.build_dense_pip_index(jp, res, jg, precision="df")
    tp, tg, _ = tbuild(n_side=4, grid_name="H3", zones="taxi")
    tidx = tpj.build_pip_index(tp, res, tg, device="cpu")
    return {"jp": jp, "jg": jg, "jidx": jidx, "tp": tp, "tg": tg,
            "tidx": tidx, "res": res}


def test_index_tables_bit_equal(flagship):
    jidx, tidx = flagship["jidx"], flagship["tidx"]
    assert isinstance(jidx, jpj.DensePIPIndex)
    assert isinstance(tidx, tpj.DensePIPIndex)
    assert tidx.device == torch.device("cpu")
    for k in ("entry", "pool", "gzones", "gwide"):
        a, b = np.asarray(getattr(jidx, k)), getattr(tidx, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert np.array_equal(jidx.origin, tidx.origin)
    for k in STATICS:
        assert getattr(jidx, k) == getattr(tidx, k), k
    for k in AUX:
        assert np.array_equal(jidx.aux[k], tidx.aux[k]), k
    pts = nyc_points(1000, seed=3)
    assert np.array_equal(jpj.localize(jidx, pts), tpj.localize(tidx, pts))


def test_join_parity_on_carried_index(flagship):
    jidx, jp = flagship["jidx"], flagship["jp"]
    pidx = tpj.dense_index_from_arrays(tables_of(jidx), device="cpu")
    pts64 = nyc_points(50_000, seed=7)
    assert np.array_equal(pts64, jnyc_points(50_000, seed=7))

    jfn = jax.jit(jpj.make_pip_join_fn(jidx, flagship["jg"]))
    jz, ju = [np.asarray(v) for v in jfn(jnp.asarray(
        jpj.localize(jidx, pts64)))]
    j_final = jpj.host_recheck_fn(jidx)(pts64, jz, ju)

    tfn = tpj.make_pip_join_fn(pidx, flagship["tg"])
    tz, tu = tfn(torch.from_numpy(tpj.localize(pidx, pts64)))
    assert tz.dtype == torch.int32 and tu.dtype == torch.bool
    tz, tu = tz.numpy(), tu.numpy()
    t_final = tpj.host_recheck_fn(pidx)(pts64, tz, tu)

    truth = tpj.pip_host_truth(pts64, flagship["tp"])
    assert np.array_equal(truth, jpj.pip_host_truth(pts64, jp))
    assert np.array_equal(t_final, j_final)
    assert np.array_equal(t_final, truth)
    assert tu.mean() < 5e-3
    # certain points agree before any recheck
    sure = ~tu & ~ju
    assert np.array_equal(tz[sure], jz[sure])


def test_streamed_equals_one_shot_and_histogram(flagship):
    tidx, tp = flagship["tidx"], flagship["tp"]
    pts64 = nyc_points(30_000, seed=11)
    fn = tpj.make_pip_join_fn(tidx, flagship["tg"])
    z, u = fn(torch.from_numpy(tpj.localize(tidx, pts64)))
    one_shot = tpj.host_recheck_fn(tidx)(pts64, z.numpy(), u.numpy())
    run = tpj.make_streamed_pip_join(tidx, flagship["tg"], tp, chunk=4096,
                                     device="cpu")
    streamed, rechecked = run(pts64)
    assert np.array_equal(streamed, one_shot)
    assert rechecked == int(u.sum())
    # -1 rows (and out-of-range ids) are dropped, not wrapped
    zones = np.concatenate([streamed, [-1, -1, len(tp)]]).astype(np.int32)
    hist = tpj.zone_histogram(torch.from_numpy(zones), len(tp)).numpy()
    want = np.bincount(streamed[streamed >= 0], minlength=len(tp))
    assert np.array_equal(hist, want)
    assert int(hist.sum()) == int(np.sum(streamed >= 0))


def test_non_dense_workloads_raise_with_reason(flagship):
    grid = get_index_system("CUSTOM(-75,-73,40,42,2,2,2)")
    assert tpj.build_dense_pip_index(flagship["tp"], 5, grid,
                                     device="cpu") is None
    assert tpj.LAST_DENSE_REJECT == "non_h3_grid"
    with pytest.raises(NotImplementedError, match="non_h3_grid"):
        tpj.build_pip_index(flagship["tp"], 5, grid, device="cpu")
    with pytest.raises(NotImplementedError):
        tpj.build_pip_index(flagship["tp"], flagship["res"], flagship["tg"],
                            dense="never", device="cpu")
