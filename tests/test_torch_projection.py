"""H3 lattice projection of the PyTorch port (mosaic_tpu_torch.ops.projection).

On the CPU the wrapper runs the plain version of the CUDA kernel
(``project_lattice_ref``).  It is held against

* the Pallas kernel it replaces, in interpret mode, with the structural
  bounds of tests/test_pallas_projection.py (XLA:CPU contracts the
  interpret path's Dekker chains, so only structure can be compared);
* the JAX package's native-f64 projection: zero disagreements where the
  margin clears the df error bound (the contract of
  tests_tpu/test_tpu_numerics.py).

The kernel itself runs only on the card; chip_smoke.py holds it against
the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.index.h3.jaxkernel import (err_lattice_bound as
                                                jerr_bound,
                                                project_lattice_jax)
from mosaic_tpu.ops.pallas_projection import project_lattice_pallas
from mosaic_tpu_torch.core.index.h3.torchkernel import err_lattice_bound
from mosaic_tpu_torch.ops.projection import (project_lattice,
                                             project_lattice_ref)


ORIGIN = (-74.0, 40.7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _local(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.4, 0.4, n),
                     rng.uniform(-0.3, 0.3, n)], -1).astype(np.float32)


def _port(loc, res):
    return [v.numpy() for v in project_lattice(torch.from_numpy(loc), res,
                                               ORIGIN)]


@pytest.mark.parametrize("res", [7, 9])
def test_matches_pallas_kernel_structurally(res):
    loc = _local(6, 20_000)
    f1, a1, b1, m1, g1 = [np.asarray(v) for v in project_lattice_pallas(
        jnp.asarray(loc), res, ORIGIN, interpret=True)]
    f2, a2, b2, m2, g2 = _port(loc, res)
    same = (f1 == f2) & (a1 == a2) & (b1 == b2)
    assert same.mean() >= 0.999
    if (~same).any():
        assert np.max(np.minimum(m1[~same], m2[~same])) < 1e-3
    np.testing.assert_allclose(m1[same], m2[same], atol=2e-3)
    np.testing.assert_allclose(g1, g2, atol=1e-5)


@pytest.mark.parametrize("res", [7, 9])
def test_df_contract_against_f64(res):
    loc = _local(3, 200_000)
    fd, ad, bd, margin, _ = _port(loc, res)
    fh, ah, bh, _, _ = [np.asarray(v) for v in project_lattice_jax(
        jnp.asarray(loc), res, np.asarray(ORIGIN), precision="f64")]
    dis = ~((fd == fh) & (ad == ah) & (bd == bh))
    bound = err_lattice_bound(res, "df", 0.4)
    assert bound == jerr_bound(res, "df", 0.4)
    assert int(np.sum(dis & (margin >= bound))) == 0


def test_padding_and_small_batches():
    loc = np.array([[0.01, 0.02], [-0.3, 0.25], [0.0, 0.0]], np.float32)
    f, a, b, m, g = project_lattice_pallas(jnp.asarray(loc), 9, ORIGIN,
                                           interpret=True)
    got = _port(loc, 9)
    assert got[0].shape == (3,)
    assert got[0].dtype == np.int32 and got[3].dtype == np.float32
    assert np.array_equal(got[0], np.asarray(f))
    assert np.array_equal(got[1], np.asarray(a))
    assert np.array_equal(got[2], np.asarray(b))
    empty = project_lattice(torch.zeros((0, 2)), 9, ORIGIN)
    assert [tuple(v.shape) for v in empty] == [(0,)] * 5


def test_wrapper_dispatches_cpu_to_plain_version():
    loc = torch.from_numpy(_local(1, 1000))
    before = project_lattice.launches
    out = project_lattice(loc, 9, ORIGIN)
    ref = project_lattice_ref(loc, 9, ORIGIN)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    # the count moves only where the kernel launches
    assert project_lattice.launches == before
    with pytest.raises(ValueError, match="device"):
        project_lattice(loc.to("meta"), 9, ORIGIN)
