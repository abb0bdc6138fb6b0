"""Dynamic lowpass FIR design and vectorized (interpolating) application.

Design (`make_lpfir`) mirrors ``common/LowPassFilter.c:127-175``: windowed-sinc
ideal response, Blackman window, taps scaled by the interpolation factor so the
1:N zero-stuffing upsampler keeps unity passband gain.

Application is where the design departs from the reference completely.  The C
code runs a per-sample circular buffer (``LowPassFilter.c:13-125``); here the
whole block is one convolution so XLA can tile it onto the MXU/VPU:

    y[n] = sum_j h[j] * s[n - (N-1) + j],   s = zero-stuffed input

which is exactly the reference's steady-state output (derived from its
"follow the LPF buffer" indexing at ``LowPassFilter.c:62``), expressed as a
cross-correlation with left padding N-1.  Zero-stuffing is expressed with
``lhs_dilation`` so XLA never materializes the stuffed signal; equivalently,
the polyphase form (one 26-tap filter bank per output phase) is available for
the Pallas kernel.

Streaming state is the trailing ``ceil((N-1)/interp)`` real input samples
(`FIRState`), replacing the reference's static circular buffer so that chunk
boundaries are seamless *by construction* (and block-size invariant, fixing
the reference's chunk-size sensitivity noted at ``changelog.txt:107``).

The output time axis follows ``LowPassFilter.c:68``: every output in input-
group ``i`` carries the timestamp of input sample ``i+1`` (the reference reads
one past the consumed sample; at the end of a block that read is out of
bounds in C — we use the true next-sample time instead).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def make_lpfir(order: int, cutoff_hz: float, fs_hz: float, interp: int,
               dtype=np.float32) -> np.ndarray:
    """Blackman windowed-sinc lowpass, gain-scaled by `interp`.

    `fs_hz` is the *output* (post-interpolation) rate, as at the reference
    call site ``POESTIPdemod/main.c:369``.
    """
    dtype = np.dtype(dtype)
    n = np.arange(order, dtype=np.float64)
    # The reference computes wc and tou in the stream dtype; round to match.
    wc = np.float64(dtype.type(2.0 * np.pi * cutoff_hz / fs_hz))
    tou = np.float64(dtype.type((order - 1.0) / 2.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        hd = np.sin(wc * (n - tou)) / (np.pi * (n - tou))
    if order % 2 == 1:
        hd[(order - 1) // 2] = wc / np.pi  # center-tap fix (LowPassFilter.c:151)
    wn = (0.42 - 0.5 * np.cos(2 * np.pi * n / (order - 1))
          + 0.08 * np.cos(4 * np.pi * n / (order - 1)))
    return (hd * wn * float(interp)).astype(dtype)


def fir_interp(x, taps, interp: int, history=None):
    """Zero-stuffing 1:interp upsampler + FIR over one block.

    x: (..., n) real block. history: (..., H) previous real samples with
    H = ceil((N-1)/interp), or None for stream start (zeros).
    Returns y of shape (..., n*interp).
    """
    taps = jnp.asarray(taps, x.dtype)
    n_taps = taps.shape[0]
    hist_len = -(-(n_taps - 1) // interp)  # ceil
    if history is None:
        history = jnp.zeros(x.shape[:-1] + (hist_len,), x.dtype)
    xh = jnp.concatenate([history, x], axis=-1)

    batch_shape = xh.shape[:-1]
    lhs = xh.reshape((-1, 1, xh.shape[-1]))
    rhs = taps.reshape((1, 1, n_taps))
    # Stuffed length of history = hist_len*interp; its last (n_taps-1) stuffed
    # entries are the warm-up context.  Left-trim the excess, keep N-1 context,
    # right-pad by `interp` to complete the final output group.
    excess = hist_len * interp - (n_taps - 1)
    y = jax.lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(1,),
        padding=[(-excess, interp - 1)],
        lhs_dilation=(interp,),
        dimension_numbers=("NCW", "IOW", "NCW"),
        preferred_element_type=x.dtype,
        # float32 taps and data must not run in TF32 on a GPU: the exact
        # path holds line-for-line parity with the C oracle
        precision=jax.lax.Precision.HIGHEST,
    )
    out_len = x.shape[-1] * interp
    return y.reshape(batch_shape + (-1,))[..., :out_len]


def fir_apply(x, taps, history=None):
    """Plain streaming FIR (interp == 1), reference ``LowPassFilter.c:76``."""
    return fir_interp(x, taps, 1, history)


def fir_history_update(x, history, n_taps: int, interp: int):
    """New trailing-history window after consuming block `x`."""
    hist_len = -(-(n_taps - 1) // interp)
    xh = jnp.concatenate([history, x], axis=-1)
    return xh[..., -hist_len:]


def fir_out_times(t_next, interp: int):
    """Output time axis: group i carries t[i+1] (LowPassFilter.c:68).

    `t_next` must be the time axis shifted by one sample, i.e. t_next[i] =
    time of input sample i+1 (the driver supplies the continuation value for
    the final group).
    """
    return jnp.repeat(t_next, interp, axis=-1)
