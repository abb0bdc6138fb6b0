"""Value-interpolating upsamplers for the MATLAB clock-recovery variants.

Twin of the ``interp1(x, 1:1/L:numel(x), 'cubic'|'spline'|'linear')``
upsampling inside ``standalone_matlab/Functionized/
UpsamplingGardenerClockRecovery2.m:7-10`` and ``UpsamplingMMClockRecovery.m``:
instead of the C apps' zero-stuff FIR interpolation, the sample VALUES are
interpolated with a smooth kernel and clock recovery runs on the denser
stream.

Vectorized formulation: the interpolant is polyphase — every output phase
``p/L`` is a fixed small-tap convolution of the input, so the whole
upsample is L shifted multiply-adds on full vectors (static shapes), not a
per-point evaluation loop.

Kernels:
- ``linear``: 2-tap, exact twin of ``interp1 .. 'linear'``.
- ``cubic``: 4-tap Catmull-Rom / Keys cubic convolution (a = -1/2) — the
  classical 'cubic' interpolation kernel (MATLAB's legacy 'v5cubic').
  Modern MATLAB aliases 'cubic' to pchip and 'spline' solves a global
  tridiagonal system; both are within O(h^3) of Catmull-Rom on smooth
  data, and the study artifact (tools/study_upsampling.py) shows the
  decode-success-vs-level curve this family was used for is insensitive
  to the choice.  Catmull-Rom keeps the op local and compiler-friendly.

Convention: ``out[j*L + p]`` interpolates input position ``j + p/L``
(``out[::L] == x`` exactly); edges clamp-replicate.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _phase_taps(level: int, kind: str):
    """(L, T) tap matrix: out[j*L+p] = sum_k taps[p, k] * x[j + k + k0]."""
    f = np.arange(level) / level
    if kind == "linear":
        return np.stack([1.0 - f, f], axis=1), 0
    if kind == "cubic":
        # Keys cubic convolution, a = -0.5 (Catmull-Rom): taps over
        # x[j-1], x[j], x[j+1], x[j+2]
        a = -0.5
        t = f
        k_m1 = a * t ** 3 - 2 * a * t ** 2 + a * t
        k_0 = (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        k_p1 = -(a + 2) * t ** 3 + (2 * a + 3) * t ** 2 - a * t
        k_p2 = -a * t ** 3 + a * t ** 2
        return np.stack([k_m1, k_0, k_p1, k_p2], axis=1), -1
    raise ValueError(f"unknown upsample kind: {kind!r}")


def upsample(x, level: int, kind: str = "cubic"):
    """Interpolate (..., n) -> (..., n*L) at positions j + p/L.

    Static shapes; L shifted fused multiply-adds per tap.  Edge samples
    clamp-replicate (only the first/last input sample's phases differ
    from an unbounded stream — inside the chunk-margin protocol these
    positions are never consumed, see chain.chunk_step).
    """
    if level == 1:
        return x
    taps, k0 = _phase_taps(level, kind)
    n = x.shape[-1]
    nt = taps.shape[1]
    dt = x.dtype
    # shifted views x[j + k + k0], clamped to [0, n-1]
    shifted = []
    for k in range(nt):
        s = k + k0
        idx = np.clip(np.arange(n) + s, 0, n - 1)
        shifted.append(jnp.take(x, jnp.asarray(idx), axis=-1))
    # (..., n, L): phase-major accumulate
    out = jnp.zeros(x.shape[:-1] + (n, level), dt)
    for k in range(nt):
        out = out + shifted[k][..., :, None] * jnp.asarray(taps[:, k], dt)
    return out.reshape(x.shape[:-1] + (n * level,))


def uniform_times(t, level: int, ts_over_l: float):
    """MATLAB-style rebuilt time axis for the upsampled stream:
    ``t_up[j*L + p] = t[j] + p * (Ts / L)`` (the scripts regenerate
    ``0:Ts:...`` rather than interpolating the input axis,
    UpsamplingGardenerClockRecovery2.m:16)."""
    if level == 1:
        return t
    dt = t.dtype
    p = jnp.arange(level, dtype=dt) * jnp.asarray(ts_over_l, dt)
    out = t[..., :, None] + p
    return out.reshape(t.shape[:-1] + (t.shape[-1] * level,))
