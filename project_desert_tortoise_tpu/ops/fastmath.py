"""Fast-math primitives shared by the kernels.

The reference PLL leans on two classic approximations whose exact numerical
behavior shapes the loop trajectory, so we reproduce them operation-for-
operation rather than substituting library atan2/rsqrt:

- ``arctan2``: the quarter-circle rational approximation of
  ``common/CarrierTrackingPLL.c:15-40`` (max err ~0.005 rad).
- ``q_rsqrt``: the bit-trick inverse square root with two Newton rounds,
  ``common/CarrierTrackingPLL.c:43-52``.  Note the reference applies the
  *float* version even in double builds (``CarrierTrackingPLL.c:202``), which
  we mirror: inputs are squeezed through float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

COEFF_1 = 0.78539816339744825   # pi/4
COEFF_2 = 2.35619449019234475   # 3*pi/4


def arctan2_approx(y, x):
    """Rational atan2 approximation (CarrierTrackingPLL.c:15)."""
    dt = jnp.result_type(y, x)
    c1 = jnp.asarray(COEFF_1, dt)
    c2 = jnp.asarray(COEFF_2, dt)
    abs_y = jnp.abs(y) + jnp.asarray(1e-10, dt)  # avoids 0/0
    r_pos = (x - abs_y) / (x + abs_y)
    r_neg = (x + abs_y) / (abs_y - x)
    angle = jnp.where(x >= 0, c1 - c1 * r_pos, c2 - c1 * r_neg)
    return jnp.where(y < 0, -angle, angle)


def q_rsqrt(x):
    """Quake fast inverse sqrt, float32 bit-exact (CarrierTrackingPLL.c:43)."""
    xf = x.astype(jnp.float32)
    xhalf = jnp.float32(0.5) * xf
    i = jax.lax.bitcast_convert_type(xf, jnp.int32)
    i = jnp.int32(0x5F3759DF) - (i >> 1)
    g = jax.lax.bitcast_convert_type(i, jnp.float32)
    g = g * (jnp.float32(1.5) - xhalf * g * g)
    g = g * (jnp.float32(1.5) - xhalf * g * g)
    return g.astype(jnp.result_type(x))


def round_half_even(x):
    """``jnp.round`` (half to even, signed zeros kept) from floor, compare
    and select alone -- ops every kernel route lowers.  ``x - floor(x)`` is
    exact in binary floating point, so ties are detected exactly."""
    dt = jnp.result_type(x)
    f = jnp.floor(x)
    d = x - f
    odd = (f - 2.0 * jnp.floor(f * 0.5)) != 0
    up = (d > 0.5) | ((d == 0.5) & odd)
    r = f + up.astype(dt)
    return jnp.where(r == 0, x * 0, r)    # -0.5 -> -0.0, like jnp.round


def sign(x):
    """C-style sign: (x > 0) - (x < 0), in the input dtype."""
    dt = jnp.result_type(x)
    return (x > 0).astype(dt) - (x < 0).astype(dt)
