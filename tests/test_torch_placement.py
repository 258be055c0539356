"""The sharded paths' host pieces against the JAX package's: placement, the
overlay's cell hash and the power-of-two bucket.

* ``placement_slots``: slots equal to JAX's on seeded preferences (none,
  uniform, all on one shard, capacity exactly full), every slot unique
  and inside the padded buffer; the same error past capacity.
* ``SkewRebalancer``: after the same seeded ``observe`` sequence (and
  after ``prime``) the same arming, rebalance count, preferred shard per
  row, planned and contiguous skew as JAX's, bit for bit (its arithmetic
  is numpy in both packages); the same ``prime`` shape error.
* The overlay's ``_hash_dest`` in torch and its numpy mirror equal JAX's
  ``_hash_dest_np`` and JAX's jitted ``_hash_dest`` bit for bit, on
  seeded int64 values of the whole range (negatives included) and on
  real H3 cell ids, which use the high bits; ``_exact_bucket_cap`` equal.
* ``pow2_bucket`` equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.parallel import overlay as jov
from mosaic_tpu.parallel.placement import SkewRebalancer as JRebalancer
from mosaic_tpu.parallel.placement import placement_slots as jslots
from mosaic_tpu.perf.bucketing import pow2_bucket as jpow2
from mosaic_tpu_torch.parallel import overlay as tov
from mosaic_tpu_torch.parallel.placement import SkewRebalancer as TRebalancer
from mosaic_tpu_torch.parallel.placement import placement_slots as tslots
from mosaic_tpu_torch.perf.bucketing import pow2_bucket as tpow2


def _prefs(kind, n, shards, rng):
    if kind == "none":
        return None
    if kind == "uniform":
        return rng.integers(0, shards, n)
    if kind == "one_shard":
        return np.zeros(n, np.int64)
    return np.repeat(np.arange(shards), n // shards)     # exactly full


@pytest.mark.parametrize("kind", ["none", "uniform", "one_shard", "full"])
@pytest.mark.parametrize("shards,cap", [(4, 64), (8, 300), (3, 1024)])
def test_placement_slots_equal(kind, shards, cap):
    rng = np.random.default_rng(shards * cap)
    n = shards * cap if kind == "full" else int(shards * cap * 0.8)
    pref = _prefs(kind, n, shards, rng)
    t = tslots(pref, n, shards, cap)
    assert np.array_equal(t, jslots(pref, n, shards, cap))
    assert len(np.unique(t)) == n
    assert t.min() >= 0 and t.max() < shards * cap
    assert np.bincount(t // cap, minlength=shards).max() <= cap


def test_placement_slots_past_capacity_raise_alike():
    for fn in (tslots, jslots):
        with pytest.raises(ValueError, match="capacity"):
            fn(None, 9, 4, 2)


def _cloud(rng, n, hot):
    """``hot`` of the rows in one corner quarter, the rest uniform."""
    n_hot = int(n * hot)
    return np.concatenate([rng.uniform(0.0, 0.25, (n_hot, 2)),
                           rng.uniform(0.0, 1.0, (n - n_hot, 2))])


def _state(r, pts):
    return (r.armed, r.rebalances, r.observations, r.planned_skew(),
            r.contiguous_skew(),
            None if r.preferred(pts) is None else r.preferred(pts).tolist())


@pytest.mark.parametrize("shards,refresh,nbins", [(4, 2, 16), (8, 3, 8),
                                                   (3, 1, 5)])
def test_rebalancer_equal_after_the_same_feedback(shards, refresh, nbins):
    rng = np.random.default_rng(refresh * 31 + shards)
    t = TRebalancer(shards, refresh=refresh, nbins=nbins)
    j = JRebalancer(shards, refresh=refresh, nbins=nbins)
    probe = _cloud(rng, 5000, 0.5)
    for step in range(7):
        pts = _cloud(rng, 4096, 0.9 if step % 2 else 0.3)
        matched = rng.random(len(pts)) < 0.8
        t.observe(pts, matched)
        j.observe(pts, matched)
        assert _state(t, probe) == _state(j, probe)
    assert t.armed and t.planned_skew() <= 1.5


def test_rebalancer_prime_equal_and_validates():
    rng = np.random.default_rng(5)
    density = rng.gamma(0.5, 1.0, 64)
    t, j = TRebalancer(4, nbins=8), JRebalancer(4, nbins=8)
    t.prime((0.0, 0.0, 1.0, 1.0), density)
    j.prime((0.0, 0.0, 1.0, 1.0), density)
    probe = _cloud(rng, 3000, 0.7)
    assert _state(t, probe) == _state(j, probe)
    for r in (t, j):
        with pytest.raises(ValueError, match="bins"):
            r.prime((0.0, 0.0, 1.0, 1.0), density[:10])


def _hash_inputs():
    rng = np.random.default_rng(13)
    wide = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        20_000, dtype=np.int64)
    edges = np.array([0, 1, -1, 2 ** 62, -2 ** 62, np.iinfo(np.int64).min,
                      np.iinfo(np.int64).max], np.int64)
    grid = jget("H3")
    lon = rng.uniform(-180, 180, 20_000)
    lat = rng.uniform(-85, 85, 20_000)
    h3 = np.asarray(grid.point_to_cell(np.stack([lon, lat], -1), 9),
                    np.int64)
    return np.concatenate([wide, edges, h3])


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_cell_hash_bit_equal(n_dev):
    cells = _hash_inputs()
    want = jov._hash_dest_np(cells, n_dev)
    got = tov._hash_dest(torch.from_numpy(cells), n_dev)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tov._hash_dest_np(cells, n_dev), want)
    assert np.array_equal(
        np.asarray(jax.jit(lambda c: jov._hash_dest(c, n_dev))(
            jnp.asarray(cells))), want)
    valid = np.random.default_rng(n_dev).random(len(cells)) < 0.7
    assert tov._exact_bucket_cap(cells, valid, n_dev) == \
        jov._exact_bucket_cap(cells, valid, n_dev)


def test_pow2_bucket_equal():
    for n in list(range(0, 70)) + [127, 128, 129, 4095, 4096, 10_037,
                                   (1 << 20) + 1]:
        for floor in (1, 4, 64):
            for cap in (None, 256):
                assert tpow2(n, floor, cap) == jpow2(n, floor, cap)
