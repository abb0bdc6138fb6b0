"""Costas carrier-tracking PLL as a JAX scan.

Behavioral twin of ``common/CarrierTrackingPLL.c:54-278``: second-order loop
(phase detector = wrapped fast-atan2 of the raw input minus NCO phase), BPSK
data on the imaginary arm, EWMA lock detector over the Q_rsqrt-normalized
carrier dot product, triangle frequency sweep during acquisition gated on the
average-phase criterion, and a one-shot acquisition->track bandwidth switch.

The C static locals become an explicit `PLLState` pytree; the per-sample loop
becomes `jax.lax.scan`, so the same step function serves
  - the exact chunked streaming mode (scan over one chunk, carry the state),
  - the block-parallel fast mode (vmap over blocks: each scan step advances
    hundreds of independent block-lanes).

All loop gains are per-sample (pre-scaled by 2*pi/Fs by the caller, matching
the reference call sites, e.g. ``POESTIPdemod/main.c:413``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from project_desert_tortoise_tpu.ops.fastmath import arctan2_approx, q_rsqrt


class PLLParams(NamedTuple):
    """Static per-mode parameters (python floats; baked into the jit)."""
    alpha_acq: float
    beta_acq: float
    alpha_track: float
    beta_track: float
    max_freq: float          # +/- 2*pi*freqRange/Fs
    lock_alpha: float
    lock_threshold: float
    sweep_step: float        # 0.2 * 2*pi/Fs (CarrierTrackingPLL.c:99)
    sweep_threshold: float
    avg_phase_alpha: float


def loop_coeffs(bw: float, damp: float = 0.999):
    """2nd-order loop alpha/beta from bandwidth (CarrierTrackingPLL.c:90)."""
    alpha = (4.0 * damp * bw) / (1.0 + 2.0 * damp * bw + bw * bw)
    beta = (4.0 * bw * bw) / (1.0 + 2.0 * damp * bw + bw * bw)
    return alpha, beta


def make_params(pll_cfg, fs: float) -> PLLParams:
    two_pi_fs = 2.0 * np.pi / fs
    aa, ba = loop_coeffs(pll_cfg.acq_gain_rad_s * two_pi_fs, pll_cfg.damping)
    at, bt = loop_coeffs(pll_cfg.track_gain_rad_s * two_pi_fs, pll_cfg.damping)
    return PLLParams(
        alpha_acq=aa, beta_acq=ba, alpha_track=at, beta_track=bt,
        max_freq=2.0 * np.pi * pll_cfg.max_carrier_deviation_hz / fs,
        lock_alpha=pll_cfg.lock_alpha_rad_s * two_pi_fs,
        lock_threshold=pll_cfg.lock_threshold,
        sweep_step=pll_cfg.sweep_rad_s2 * two_pi_fs,
        sweep_threshold=pll_cfg.sweep_threshold,
        avg_phase_alpha=pll_cfg.avg_phase_alpha,
    )


class PLLState(NamedTuple):
    phase: jnp.ndarray       # d_phase
    freq: jnp.ndarray        # d_freq
    locksig: jnp.ndarray     # d_locksig
    avg_phase: jnp.ndarray   # quality EWMA, init pi/2
    sweep: jnp.ndarray       # signed sweep step
    locked: jnp.ndarray      # bool: bandwidth switched to tracking


def init_state(params: PLLParams, dtype=jnp.float32, batch_shape=()) -> PLLState:
    dt = jnp.dtype(dtype)
    full = lambda v: jnp.full(batch_shape, v, dt)
    return PLLState(
        phase=full(0.1),                 # CarrierTrackingPLL.c:93
        freq=full(0.0),
        locksig=full(0.0),
        avg_phase=full(np.pi / 2.0),
        sweep=full(params.sweep_step),
        locked=jnp.zeros(batch_shape, bool),
    )


def _step(params: PLLParams, state: PLLState, zre, zim):
    dt = zre.dtype
    c = lambda v: jnp.asarray(v, dt)
    two_pi = c(2.0 * np.pi)

    t_im = jnp.sin(state.phase)
    t_re = jnp.cos(state.phase)

    # mix by conjugate carrier; data rides the imaginary arm
    out = zim * t_re - zre * t_im
    pll_re = zre * t_re + zim * t_im

    out_phase = arctan2_approx(out, pll_re)
    avg_phase = (state.avg_phase * (1.0 - c(params.avg_phase_alpha))
                 + c(params.avg_phase_alpha) * jnp.abs(out_phase))

    # wrapped phase error against the NCO
    sample_phase = arctan2_approx(zim, zre)
    # negated constants are folded here, not negated in the graph: the
    # Triton route cannot lower a negation of a constant
    pi, neg_pi = c(np.pi), c(-np.pi)
    err = sample_phase - state.phase
    err = jnp.where(err > pi, err - two_pi,
                    jnp.where(err < neg_pi, err + two_pi, err))

    alpha = jnp.where(state.locked, c(params.alpha_track), c(params.alpha_acq))
    beta = jnp.where(state.locked, c(params.beta_track), c(params.beta_acq))

    freq = state.freq + beta * err
    phase = state.phase + freq + alpha * err
    phase = jnp.where(phase > two_pi, phase - two_pi, phase)
    phase = jnp.where(phase < c(-2.0 * np.pi), phase + two_pi, phase)
    freq = jnp.clip(freq, c(-params.max_freq), c(params.max_freq))

    # lock detector over the Q_rsqrt-normalized carrier projection
    mag2 = zre * zre + zim * zim
    inv = q_rsqrt(mag2)
    locksig = (state.locksig * (1.0 - c(params.lock_alpha))
               + c(params.lock_alpha) * ((zre * inv) * t_re + (zim * inv) * t_im))

    # acquisition frequency sweep (CarrierTrackingPLL.c:231-263)
    sweeping = (jnp.abs(c(np.pi / 2.0) - avg_phase) < c(params.sweep_threshold)
                ) & ~state.locked
    freq_swept = freq + state.sweep
    at_edge = (freq_swept >= c(params.max_freq)) | (freq_swept <= c(-params.max_freq))
    sweep_new = jnp.where(
        at_edge, -state.sweep,
        jnp.where(freq_swept >= 0, jnp.abs(state.sweep), -jnp.abs(state.sweep)))
    freq = jnp.where(sweeping, freq_swept, freq)
    sweep = jnp.where(sweeping, sweep_new, state.sweep)

    locked = state.locked | (locksig > c(params.lock_threshold))

    new_state = PLLState(phase=phase, freq=freq, locksig=locksig,
                         avg_phase=avg_phase, sweep=sweep, locked=locked)
    return new_state, (out, locksig)


def pll_scan(params: PLLParams, state: PLLState, z, unroll: int = 8,
             window: int = 0):
    """Run the PLL over a block.

    z: complex (n,) or a (re, im) tuple of (..., n) arrays scanned over the
    LAST axis (leading axes are batch lanes).  Returns (state, out, locksig).

    `window > 0` nests the scan (outer over length-`window` chunks, inner over
    samples) — identical math, a loop-local chunk buffer per outer step.
    Requires n % window == 0.
    """
    if isinstance(z, tuple):
        zre, zim = z
    else:
        zre, zim = jnp.real(z), jnp.imag(z)

    def step(s, x):
        return _step(params, s, x[0], x[1])

    xs = (jnp.moveaxis(zre, -1, 0), jnp.moveaxis(zim, -1, 0))
    if window:
        n = xs[0].shape[0]
        assert n % window == 0, (n, window)
        nw = n // window
        xs_w = jax.tree.map(
            lambda a: a.reshape((nw, window) + a.shape[1:]), xs)

        def outer(s, xw):
            return jax.lax.scan(step, s, xw, unroll=unroll)

        state, (out, locksig) = jax.lax.scan(outer, state, xs_w)
        out = out.reshape((n,) + out.shape[2:])
        locksig = locksig.reshape((n,) + locksig.shape[2:])
    else:
        state, (out, locksig) = jax.lax.scan(step, state, xs, unroll=unroll)
    return state, jnp.moveaxis(out, 0, -1), jnp.moveaxis(locksig, 0, -1)
