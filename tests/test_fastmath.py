import struct

import numpy as np
import jax.numpy as jnp

from project_desert_tortoise_tpu.ops import fastmath as FM


def _c_arctan2(y, x):
    """Literal float32 model of CarrierTrackingPLL.c:15-40."""
    c1, c2 = 0.78539816339744825, 2.35619449019234475
    abs_y = np.float32(np.abs(np.float32(y)) + 1e-10)
    if x >= 0:
        r = np.float32((x - abs_y) / (x + abs_y))
        angle = np.float32(c1 - c1 * r)
    else:
        r = np.float32((x + abs_y) / (abs_y - x))
        angle = np.float32(c2 - c1 * r)
    return -angle if y < 0 else angle


def _c_q_rsqrt(x):
    """Literal model of CarrierTrackingPLL.c:43-52."""
    x = np.float32(x)
    xhalf = np.float32(0.5) * x
    i = struct.unpack("<i", struct.pack("<f", x))[0]
    i = np.int32(0x5F3759DF - (i >> 1))
    x = np.float32(struct.unpack("<f", struct.pack("<i", i))[0])
    x = np.float32(x * (np.float32(1.5) - xhalf * x * x))
    x = np.float32(x * (np.float32(1.5) - xhalf * x * x))
    return x


def test_arctan2_matches_c_model():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(500).astype(np.float32) * 3
    x = rng.standard_normal(500).astype(np.float32) * 3
    got = np.asarray(FM.arctan2_approx(jnp.asarray(y), jnp.asarray(x)))
    want = np.array([_c_arctan2(a, b) for a, b in zip(y, x)], np.float32)
    assert np.abs(got - want).max() < 2e-6


def test_arctan2_near_true_atan2():
    rng = np.random.default_rng(1)
    y = rng.standard_normal(1000).astype(np.float32)
    x = rng.standard_normal(1000).astype(np.float32)
    got = np.asarray(FM.arctan2_approx(jnp.asarray(y), jnp.asarray(x)))
    # the reference's first-order rational approximation has ~0.07 rad max
    # error by design; the PLL tolerates it (it is the same on both sides)
    assert np.abs(got - np.arctan2(y, x)).max() < 0.08


def test_q_rsqrt_bit_exact():
    rng = np.random.default_rng(2)
    x = (rng.uniform(1e-6, 1e4, 300)).astype(np.float32)
    got = np.asarray(FM.q_rsqrt(jnp.asarray(x)))
    want = np.array([_c_q_rsqrt(v) for v in x], np.float32)
    assert np.array_equal(got, want)


def test_q_rsqrt_double_input_squeezes_through_float():
    # the reference calls the float Q_rsqrt even in double builds
    x64 = np.float64(123.456)
    got = float(FM.q_rsqrt(jnp.asarray(np.float32(x64))))
    want = float(_c_q_rsqrt(np.float32(x64)))
    assert got == want


def test_sign():
    x = jnp.asarray(np.array([-2.0, -0.0, 0.0, 3.0], np.float32))
    assert np.array_equal(np.asarray(FM.sign(x)), [-1, 0, 0, 1])


def test_round_half_even_matches_jnp_round():
    """The kernel's rounding (floor/compare/select only) equals jnp.round
    bit for bit: ties both ways, negatives, signed zeros, values past
    2^23 where every float32 is an integer, and non-finite values."""
    rng = np.random.default_rng(0)
    ties = np.arange(-20, 20, dtype=np.float32) + np.float32(0.5)
    specials = np.array([0.0, -0.0, 0.49999997, -0.49999997, 0.5, -0.5,
                         1.5, -1.5, 2.5, -2.5, 8388607.5, -8388607.5,
                         8388608.0, 16777217.0, 3.4e38, -3.4e38,
                         np.inf, -np.inf, np.nan], np.float32)
    rand = (rng.standard_normal(20000) * 10.0 ** rng.integers(
        -3, 9, 20000)).astype(np.float32)
    grid = (rng.integers(-2 ** 20, 2 ** 20, 20000) / 16.0).astype(
        np.float32)          # the Gardner pointer's 1/16 grid near 2^19
    for x in (ties, specials, rand, grid):
        got = np.asarray(FM.round_half_even(jnp.asarray(x)))
        want = np.asarray(jnp.round(jnp.asarray(x)))
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
