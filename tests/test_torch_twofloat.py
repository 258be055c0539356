"""Double-single arithmetic of the PyTorch port (mosaic_tpu_torch.ops.twofloat).

The six contracts of tests/test_twofloat.py, applied to the port's ops,
with the same inputs fed to both packages.  Torch's CPU eager mode runs
each op as its own rounded kernel and never contracts a multiply into an
add, so df keeps its full precision there (checked against f64 truth,
as tests_tpu/test_tpu_numerics.py checks the TPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.ops import twofloat as jtf
from mosaic_tpu_torch.ops import twofloat as tf


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def total(df):
    return np.asarray(df.hi, np.float64) + np.asarray(df.lo, np.float64)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def vals():
    rng = np.random.default_rng(1)
    return rng.uniform(-2.0, 2.0, 64).astype(np.float32)


def test_two_sum_exact(vals):
    b = vals[::-1].copy() * np.float32(1e-4)
    s, e = tf.two_sum(t(vals), t(b))
    got = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    want = vals.astype(np.float64) + b.astype(np.float64)
    assert np.array_equal(got, want)
    js, je = jtf.two_sum(jnp.asarray(vals), jnp.asarray(b))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(e.numpy(), np.asarray(je))


@pytest.mark.parametrize("n", [64, 100_000])
def test_two_prod_exact(n):
    rng = np.random.default_rng(1)
    a = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    b = a[::-1].copy()
    p, e = tf.two_prod(t(a), t(b))
    got = p.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    assert np.array_equal(got, a.astype(np.float64) * b.astype(np.float64))


def test_df_mul_precision(vals):
    r = tf.df_mul(tf.df_from_f32(t(vals)), tf.df_const(np.pi / 180.0))
    want = vals.astype(np.float64) * np.pi / 180.0
    assert np.max(np.abs(total(r) - want)) < 1e-10


def test_df_div_precision(vals):
    den_v = np.abs(vals) + np.float32(0.5)
    r = tf.df_div(tf.df_const(np.ones_like(den_v, np.float64)),
                  tf.df_from_f32(t(den_v)))
    want = 1.0 / den_v.astype(np.float64)
    assert np.max(np.abs(total(r) - want) / np.abs(want)) < 1e-12


def test_df_trig_small_angle():
    d = np.linspace(-0.04, 0.04, 101).astype(np.float32)
    df = tf.df_mul(tf.df_from_f32(t(d)), tf.df_const(1.0))
    s = tf.df_poly_sin(df)
    c = tf.df_poly_cos(df)
    assert np.max(np.abs(total(s) - np.sin(d.astype(np.float64)))) < 1e-12
    assert np.max(np.abs(total(c) - np.cos(d.astype(np.float64)))) < 1e-12
    # the port's ops give the JAX package's eager df values bit for bit
    jd = jtf.df_mul(jtf.df_from_f32(jnp.asarray(d)), jtf.df_const(1.0))
    js = jtf.df_poly_sin(jd)
    assert np.array_equal(s.hi.numpy(), np.asarray(js.hi))
    assert np.array_equal(s.lo.numpy(), np.asarray(js.lo))


def test_df_round_carries_residual():
    v = np.array([1234.4999, -77.5001, 0.49997, 2.5, -3.5], np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    r, frac = tf.df_round(tf.DF(t(hi), t(lo)))
    got = r.numpy().astype(np.float64)
    assert np.allclose(got + frac.numpy().astype(np.float64), v, atol=1e-7)
    assert np.max(np.abs(got - np.round(v))) <= 1.0
    jr, jfrac = jtf.df_round(jtf.DF(jnp.asarray(hi), jnp.asarray(lo)))
    # half-to-even, as jnp.round
    assert np.array_equal(r.numpy(), np.asarray(jr))
    assert np.array_equal(frac.numpy(), np.asarray(jfrac))


def test_df_survives_torch_eager():
    """tests_tpu/test_tpu_numerics.py:23 on torch CPU eager: a collapsed
    (plain f32) chain would show ~1e-8."""
    rng = np.random.default_rng(2)
    vals = rng.uniform(-2.0, 2.0, 4096).astype(np.float32)
    d = tf.df_mul(tf.df_from_f32(t(vals)), tf.df_const(np.pi / 180.0))
    s = tf.df_poly_sin(d)
    want = np.sin(vals.astype(np.float64) * np.pi / 180.0)
    assert np.abs(total(s) - want).max() < 1e-10


def test_fma_error_term_equals_dekker():
    """The CUDA kernels take two_prod's error term from one FMA,
    fma(a, b, -p); the plain version keeps the Veltkamp split.  Both are
    the exact residual of an f32 product, so they agree bit for bit.
    The FMA's result is computed here as float32(a*b - p) in f64, exact
    for f32 inputs (the f64 product is exact and the residual fits f32).
    Magnitudes span 2^-50..2^50 per operand, the range where no residual
    underflows, which covers the projection's products."""
    rng = np.random.default_rng(5)
    n = 100_000
    mant = rng.uniform(1.0, 2.0, (2, n))
    expo = rng.integers(-50, 51, (2, n))
    sign = rng.choice([-1.0, 1.0], (2, n))
    a, b = (sign * mant * np.exp2(expo)).astype(np.float32)
    # the projection's own regime: degrees, radians, unit vectors
    a[:1000] = rng.uniform(-2.2, 2.2, 1000).astype(np.float32)
    b[:1000] = np.float32(np.pi / 180.0)
    b[1000:2000] = rng.uniform(-1.0, 1.0, 1000).astype(np.float32)
    p, err = tf.two_prod(t(a), t(b))
    p = p.numpy()
    fma_err = (a.astype(np.float64) * b.astype(np.float64) -
               p.astype(np.float64)).astype(np.float32)
    assert np.array_equal(p, a * b)
    assert np.array_equal(err.numpy().view(np.int32), fma_err.view(np.int32))
