"""Gain control: static gain probe, normalizing AGC, complex AGC, squelch.

Twins of ``common/AGC.c``.  The AGC feedback loops become scans with explicit
state; the squelch and amplitude probe are data-parallel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


def static_gain(iq: np.ndarray, desired_level: float, dtype=np.float32) -> float:
    """Normalization probe over the first chunk (``AGC.c:48-75``).

    Reproduces the reference's exponential halving recurrence exactly,
    including seeding with |z[0]| and then adding it again in the loop:
    ``avg = |z0|; for i: avg = (avg + |z_i|) / 2``.  Host-side numpy — this
    runs once per stream.
    """
    dt = np.dtype(dtype)
    mags = np.abs(iq).astype(dt)
    avg = mags[0] if len(mags) else dt.type(0)
    for m in mags:
        # C: avg = (avg + |z|) / 2.0 — double intermediate, stored DECIMAL_TYPE
        avg = dt.type((np.float64(avg) + np.float64(m)) / 2.0)
    if avg == 0.0:
        # Silent/empty input: the C oracle divides by zero and carries inf
        # through a chain that decodes nothing (garbage tolerated,
        # AGC.c:48-75).  Emit unity gain instead of inf — same no-frames
        # outcome, no IEEE garbage in the stream.
        return 1.0
    return float(dt.type(np.float64(desired_level) / np.float64(avg)))


def static_gain_fast(iq, desired_level: float):
    """Closed-form equivalent of `static_gain` for the fast path.

    avg = |z0|*2^-n + sum_i |z_i| * 2^(i-n); computed with exact weights in
    float64 (weights below ~2^-60 underflow to zero identically to the
    recurrence's asymptotic forgetting).
    """
    mags = jnp.abs(iq)
    n = mags.shape[-1]
    k = min(n, 64)  # only the trailing 64 samples can influence the result
    tail = mags[..., -k:].astype(jnp.float64) if jax.config.jax_enable_x64 else \
        mags[..., -k:].astype(jnp.float32)
    w = (2.0 ** jnp.arange(-k, 0, dtype=tail.dtype))
    avg = jnp.sum(tail * w, axis=-1)
    return jnp.where(avg > 0, desired_level / jnp.where(avg > 0, avg, 1.0),
                     jnp.ones((), avg.dtype))


class AGCState(NamedTuple):
    gain: jnp.ndarray


def agc_init(initial_gain, dtype=jnp.float32, batch_shape=()) -> AGCState:
    return AGCState(gain=jnp.full(batch_shape, initial_gain, jnp.dtype(dtype)))


def agc_scan(state: AGCState, x, attack_rate: float, decay_rate: float,
             reference: float = 1.0, max_gain: float = 5000.0,
             min_gain: float = 10e-5, unroll: int = 8, window: int = 0):
    """GNURadio-style attack/decay AGC (``AGC.c:78-132``).

    x: (..., n), scanned over the last axis.  Returns (state, y).
    `window > 0` nests the scan over fixed-size chunks (see pll_scan).
    """
    dt = x.dtype
    c = lambda v: jnp.asarray(v, dt)

    def step(gain, xi):
        y = xi * gain
        error = jnp.abs(y) - c(reference)
        rate = jnp.where(jnp.abs(error) > gain, c(attack_rate), c(decay_rate))
        gain = gain - error * rate
        gain = jnp.where(gain < 0.0, c(min_gain), gain)
        gain = jnp.where(gain > c(max_gain), c(max_gain), gain)
        return gain, y

    xs = jnp.moveaxis(x, -1, 0)
    if window:
        n = xs.shape[0]
        assert n % window == 0, (n, window)
        xs_w = xs.reshape((n // window, window) + xs.shape[1:])

        def outer(g, xw):
            return jax.lax.scan(step, g, xw, unroll=unroll)

        gain, y = jax.lax.scan(outer, state.gain, xs_w)
        y = y.reshape((n,) + y.shape[2:])
    else:
        gain, y = jax.lax.scan(step, state.gain, xs, unroll=unroll)
    return AGCState(gain=gain), jnp.moveaxis(y, 0, -1)


def agc_complex_scan(gain, z, loop_gain: float, desired: float = 5.0,
                     unroll: int = 8):
    """First-order complex AGC (``AGC.c:164-200``); kept for parity though the
    current reference apps have it commented out."""
    def step(g, zi):
        y = zi * g
        error = desired - (g * jnp.abs(y))
        return g + loop_gain * error, y

    gain, y = jax.lax.scan(step, gain, jnp.moveaxis(z, -1, 0), unroll=unroll)
    return gain, jnp.moveaxis(y, 0, -1)


def squelch(x, squelch_stream, threshold: float):
    """Zero-stuff samples whose side-channel (PLL lock) is below threshold
    (``AGC.c:24-46``)."""
    return jnp.where(squelch_stream < jnp.asarray(threshold, x.dtype),
                     jnp.zeros((), x.dtype), x)


def find_signal_amplitude(state, x, alpha: float, unroll: int = 8):
    """One-pole envelope tracker (``AGC.c:6-20``); feeds SNR estimation."""
    dt = x.dtype
    a = jnp.asarray(alpha, dt)

    def step(avg, xi):
        avg = avg * (1.0 - a) + a * jnp.abs(xi)
        return avg, None

    state, _ = jax.lax.scan(step, state, jnp.moveaxis(x, -1, 0), unroll=unroll)
    return state
