"""Symbol-timing recovery: Gardner (primary) and Mueller & Muller (alt).

Twin of ``common/GardenerClockRecovery.c`` /  ``common/MMClockRecovery.c``.

The C version is a data-dependent while loop that strides a fractional sample
pointer through the block (`nextSample += Fs/baud - err`), reading the on-time
sample and the mid-bit sample.  Here it is a fixed-length masked `lax.scan`
over symbol slots (static capacity = block_len/step + slack), so it jits with
static shapes and vmaps across block lanes for the fast path.

Reference quirks reproduced deliberately (see SURVEY.md section 1):
- the fractional pointer rolls over between chunks *without* adjusting the
  pending mid-bit index (``GardenerClockRecovery.c:111``), so the first
  mid-bit read of a chunk lands near the end of the buffer *image* — the
  caller passes the persistent buffer image (previous chunk's tail surviving
  a partial final chunk), and out-of-image reads yield 0.0 exactly like the
  reference's never-written heap pages;
- `rint` rounds half-to-even (C default rounding mode);
- the returned count is the reference's `count` (not count-1;
  ``GardenerClockRecovery.c:112-113``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from project_desert_tortoise_tpu.ops.fastmath import sign


class GardnerState(NamedTuple):
    next_sample: jnp.ndarray   # fractional on-time pointer (chunk-relative)
    half_raw: jnp.ndarray      # pending mid-bit pointer (NOT rolled over)
    prev_bit: jnp.ndarray


def gardner_init(dtype=jnp.float32, batch_shape=()) -> GardnerState:
    z = jnp.zeros(batch_shape, jnp.dtype(dtype))
    return GardnerState(next_sample=z, half_raw=z, prev_bit=z)


def upsampling_init(dtype=jnp.float32, batch_shape=()) -> GardnerState:
    """State for the upsampling_* scans: split (int, frac) pointers."""
    z2 = jnp.zeros(batch_shape + (2,), jnp.dtype(dtype))
    return GardnerState(next_sample=z2, half_raw=z2,
                        prev_bit=jnp.zeros(batch_shape, jnp.dtype(dtype)))


def gardner_step_size(fs: float, baud: float, dtype=np.float32):
    """stepSize = Fs/baud computed in double then stored in stream dtype,
    as the C mixed-precision expression does (GardenerClockRecovery.c:19)."""
    return float(np.dtype(dtype).type(np.float64(fs) / np.float64(baud)))


def gardner_scan(state: GardnerState, x, t, n, step_size: float,
                 err_limit: float, kp: float, max_syms: int, unroll: int = 4):
    """Recover up to `max_syms` symbols from block `x` (buffer image).

    x, t: (..., cap) buffer images; n: valid length (scalar or (...,)).
    Returns (state, symbols, times, valid_mask, count).
    """
    dt = x.dtype
    cap = x.shape[-1]
    c = lambda v: jnp.asarray(v, dt)
    n = jnp.asarray(n)

    def take(arr, i):
        # batched lane-wise gather along the last axis
        return jnp.take_along_axis(arr, i[..., None], axis=-1)[..., 0]

    def step(carry, _):
        st, count = carry
        idx = jnp.round(st.next_sample)
        active = idx < n
        ii = jnp.clip(idx.astype(jnp.int32), 0, cap - 1)
        cur = take(x, ii)
        hidx = jnp.round(st.half_raw)
        hi = hidx.astype(jnp.int32)
        in_img = (hidx >= 0) & (hidx < cap)
        hval = jnp.where(in_img, take(x, jnp.clip(hi, 0, cap - 1)),
                         jnp.zeros((), dt))
        tval = take(t, ii)

        err = c(kp) * (cur - st.prev_bit) * hval
        err = jnp.clip(err, c(-err_limit), c(err_limit))
        ns = st.next_sample - err
        half_new = ns + c(step_size) / 2.0
        ns = ns + c(step_size)

        new = GardnerState(
            next_sample=jnp.where(active, ns, st.next_sample),
            half_raw=jnp.where(active, half_new, st.half_raw),
            prev_bit=jnp.where(active, cur, st.prev_bit),
        )
        return (new, count + active.astype(jnp.int32)), (cur, tval, active)

    count0 = jnp.zeros(x.shape[:-1], jnp.int32)
    (state, count), (syms, times, valid) = jax.lax.scan(
        step, (state, count0), None, length=max_syms, unroll=unroll)
    syms = jnp.moveaxis(syms, 0, -1)
    times = jnp.moveaxis(times, 0, -1)
    valid = jnp.moveaxis(valid, 0, -1)
    # chunk rollover (GardenerClockRecovery.c:111): half_raw intentionally kept
    state = state._replace(next_sample=state.next_sample - n.astype(dt))
    return state, syms, times, valid, count


def mm_scan(state, x, t, n, fs: float, baud: float, step_range: float,
            kp: float, max_syms: int, unroll: int = 4):
    """Mueller & Muller TED with adaptive step (``common/MMClockRecovery.c``).

    Kept for capability parity ("gardner works better!",
    POESTIPdemod/main.c:23).  state: (next_sample, prev_bit, step_size).
    """
    dt = x.dtype
    cap = x.shape[-1]
    c = lambda v: jnp.asarray(v, dt)
    n = jnp.asarray(n)
    smin = c(fs / (baud + step_range))
    smax = c(fs / (baud - step_range))

    def take(arr, i):
        return jnp.take_along_axis(arr, i[..., None], axis=-1)[..., 0]

    def step(carry, _):
        (ns, prev, ss), count = carry
        idx = jnp.round(ns)
        active = idx < n
        ii = jnp.clip(idx.astype(jnp.int32), 0, cap - 1)
        cur = take(x, ii)
        tval = take(t, ii)
        err = sign(prev) * cur - sign(cur) * prev
        ss_new = jnp.clip(ss + c(kp) * err, smin, smax)
        ns_new = ns + ss_new
        carry_new = (jnp.where(active, ns_new, ns),
                     jnp.where(active, cur, prev),
                     jnp.where(active, ss_new, ss))
        return (carry_new, count + active.astype(jnp.int32)), (cur, tval, active)

    count0 = jnp.zeros(x.shape[:-1], jnp.int32)
    (st, count), (syms, times, valid) = jax.lax.scan(
        step, (state, count0), None, length=max_syms, unroll=unroll)
    st = (st[0] - n.astype(dt), st[1], st[2])
    return st, (jnp.moveaxis(syms, 0, -1), jnp.moveaxis(times, 0, -1),
                jnp.moveaxis(valid, 0, -1), count)


def gardner_manchester_windowed(g_state, m_state, x, t, n, step_size: float,
                                err_limit: float, kp: float,
                                resync_threshold: float, window: int,
                                margin: int = None, unroll: int = 2):
    """Fused Gardner + Manchester over fixed-size windows — the XLA fast
    path.

    The monolithic `gardner_scan` gathers from the whole (B, cap) array every
    step, which dominates the pipeline once that array is large.  Here an
    outer scan walks length-`window` chunks (each a loop-local buffer, plus
    a `margin` of left-context for
    the mid-bit read) and an inner masked scan recovers that window's symbols
    and Manchester-decodes them in the same step.  Identical arithmetic to the
    separate scans; symbol order is preserved via emit masks.

    x, t: (..., cap) with cap % window == 0; n: valid length (<= cap).
    Returns (g_state, m_state, bits, bit_times, emit_mask) where the output
    arrays have trailing dim n_win * syms_per_window.
    """
    from project_desert_tortoise_tpu.ops.manchester import ManchesterState

    dt = x.dtype
    cap = x.shape[-1]
    if margin is None:
        # the mid-bit sample lies step_size/2 behind the on-time read; a
        # fixed margin of 16 lost that read near window starts for
        # interp==1 modes (step 40 -> offset 20), silently zeroing the TED
        # error there (round-3 fix, mirrors fused_kernel.ring_size)
        margin = max(16, int(np.ceil(step_size / 2.0 + err_limit)) + 2)
    assert cap % window == 0, (cap, window)
    n_win = cap // window
    spw = int(window / step_size * 1.08) + 4
    c = lambda v: jnp.asarray(v, dt)
    n = jnp.asarray(n)
    thr = jnp.asarray(resync_threshold, dt)

    # windows with left margin: wnd[w] = padded(x)[w*window : w*window+window+margin]
    xp = jnp.concatenate(
        [jnp.zeros(x.shape[:-1] + (margin,), dt), x], axis=-1)
    tp = jnp.concatenate(
        [jnp.zeros(t.shape[:-1] + (margin,), dt), t], axis=-1)
    idx = (jnp.arange(n_win)[:, None] * window
           + jnp.arange(window + margin)[None, :])            # (n_win, W+m)
    xw_all = jnp.take(xp, idx, axis=-1)   # (..., n_win, W+m)
    tw_all = jnp.take(tp, idx, axis=-1)
    xw_all = jnp.moveaxis(xw_all, -2, 0)  # (n_win, ..., W+m)
    tw_all = jnp.moveaxis(tw_all, -2, 0)

    def take(arr, i):
        return jnp.take_along_axis(arr, i[..., None], axis=-1)[..., 0]

    def outer(carry, inp):
        g, m, w = carry[0], carry[1], carry[2]
        xw, tw = inp
        w_end = jnp.minimum((w + 1) * window, n).astype(dt)
        base = (w * window - margin).astype(jnp.int32)

        def inner(ic, _):
            g, m = ic
            idxf = jnp.round(g.next_sample)
            active = idxf < w_end
            ii = jnp.clip(idxf.astype(jnp.int32) - base, 0, window + margin - 1)
            cur = take(xw, ii)
            tval = take(tw, ii)
            hidxf = jnp.round(g.half_raw)
            hl = hidxf.astype(jnp.int32) - base
            h_ok = (hl >= 0) & (hl < window + margin) & (hidxf >= 0)
            hval = jnp.where(h_ok, take(xw, jnp.clip(hl, 0, window + margin - 1)),
                             jnp.zeros((), dt))

            err = jnp.clip(c(kp) * (cur - g.prev_bit) * hval,
                           c(-err_limit), c(err_limit))
            ns = g.next_sample - err
            half_new = ns + c(step_size) / 2.0
            ns = ns + c(step_size)
            g_new = GardnerState(
                next_sample=jnp.where(active, ns, g.next_sample),
                half_raw=jnp.where(active, half_new, g.half_raw),
                prev_bit=jnp.where(active, cur, g.prev_bit),
            )

            # Manchester on this symbol (ManchesterDecode.c:27-97)
            prevprev = m.prev
            prev = m.cur
            mismatch = m.evenodd != m.clockmod
            strong = (jnp.abs(prevprev) > thr) & (jnp.abs(prev) > thr)
            resync = (mismatch & (sign(prevprev) == sign(prev)) & strong)
            clockmod = jnp.where(resync, m.evenodd, m.clockmod)
            boundary = m.evenodd == clockmod
            use_prev = jnp.abs(prev) > jnp.abs(cur)
            bit = jnp.where(use_prev, (prev > 0).astype(jnp.uint8),
                            1 - (cur > 0).astype(jnp.uint8))
            emit = active & boundary
            m_new = ManchesterState(
                clockmod=jnp.where(active, clockmod, m.clockmod),
                evenodd=jnp.where(active, (m.evenodd + 1) & 1, m.evenodd),
                cur=jnp.where(active, cur, m.cur),
                prev=jnp.where(active, prev, m.prev),
                prevprev=jnp.where(active, prevprev, m.prevprev),
            )
            return (g_new, m_new), (bit, tval, emit)

        (g, m), outs = jax.lax.scan(inner, (g, m), None, length=spw,
                                    unroll=unroll)
        return (g, m, w + 1), outs

    (g_state, m_state, _), (bits, btimes, emit) = jax.lax.scan(
        outer, (g_state, m_state, jnp.int32(0)), (xw_all, tw_all))
    # (n_win, spw, ...) -> (..., n_win*spw)
    def flat(a):
        a = jnp.moveaxis(a.reshape((n_win * spw,) + a.shape[2:]), 0, -1)
        return a
    g_state = g_state._replace(next_sample=g_state.next_sample - n.astype(dt))
    return g_state, m_state, flat(bits), flat(btimes), flat(emit)


def _split_norm(i, f):
    """Renormalize a split pointer so the fraction lies in [0, 1)."""
    k = jnp.floor(f)
    return i + k, f - k


def upsampling_gardner_scan(state: GardnerState, x, t, n, step_size: float,
                            err_limit: float, kp: float, max_syms: int,
                            unroll: int = 4):
    """Gardner TED on a value-upsampled stream with a SPLIT pointer
    (``UpsamplingGardenerClockRecovery2.m:60-95`` made chunkable).

    The MATLAB original is a whole-file loop whose fractional pointer
    accumulates at stream-absolute magnitude; re-basing such a float
    pointer per chunk changes which magnitudes its arithmetic rounds at
    and the recurrence drifts between chunk sizes (observed even in
    f64).  Here positions are (integer-part, fraction in [0,1)) pairs:
    every update renormalizes through the exact small-magnitude
    fraction, so pointer math is magnitude-independent and the chunked
    protocol is bit-exact chunk-size invariant (chain.chunk_step).

    state: GardnerState with next_sample/half_raw shaped (..., 2) =
    [int part (exact float), fraction); prev_bit as usual.  The caller
    handles chunk-roll by subtracting integers from the int parts.
    Returns (state, syms, times, valid, count); round-half-up at reads.
    """
    dt = x.dtype
    cap = x.shape[-1]
    c = lambda v: jnp.asarray(v, dt)
    n = jnp.asarray(n)
    si = float(np.floor(step_size))
    sf = float(step_size - np.floor(step_size))
    hs = step_size / 2.0
    hsi = float(np.floor(hs))
    hsf = float(hs - np.floor(hs))

    def take(arr, i):
        return jnp.take_along_axis(arr, i[..., None], axis=-1)[..., 0]

    def step(carry, _):
        st, count = carry
        ni, nf = st.next_sample[..., 0], st.next_sample[..., 1]
        hi_, hf_ = st.half_raw[..., 0], st.half_raw[..., 1]
        idx = ni + (nf >= 0.5).astype(dt)
        active = idx < n
        ii = jnp.clip(idx.astype(jnp.int32), 0, cap - 1)
        cur = take(x, ii)
        tval = take(t, ii)
        hidx = hi_ + (hf_ >= 0.5).astype(dt)
        in_img = (hidx >= 0) & (hidx < cap)
        hval = jnp.where(in_img,
                         take(x, jnp.clip(hidx.astype(jnp.int32), 0,
                                          cap - 1)),
                         jnp.zeros((), dt))

        err = jnp.clip(c(kp) * (cur - st.prev_bit) * hval,
                       c(-err_limit), c(err_limit))
        ai, af = _split_norm(ni, nf - err)          # nextSample -= Error
        nhi, nhf = _split_norm(ai + c(hsi), af + c(hsf))   # + step/2
        nni, nnf = _split_norm(ai + c(si), af + c(sf))     # + step
        new = GardnerState(
            next_sample=jnp.stack(
                [jnp.where(active, nni, ni), jnp.where(active, nnf, nf)],
                axis=-1),
            half_raw=jnp.stack(
                [jnp.where(active, nhi, hi_), jnp.where(active, nhf, hf_)],
                axis=-1),
            prev_bit=jnp.where(active, cur, st.prev_bit),
        )
        return (new, count + active.astype(jnp.int32)), (cur, tval, active)

    count0 = jnp.zeros(x.shape[:-1], jnp.int32)
    (state, count), (syms, times, valid) = jax.lax.scan(
        step, (state, count0), None, length=max_syms, unroll=unroll)
    return (state, jnp.moveaxis(syms, 0, -1), jnp.moveaxis(times, 0, -1),
            jnp.moveaxis(valid, 0, -1), count)


def upsampling_mm_scan(state, x, t, n, step_size: float, err_limit: float,
                       kp: float, max_syms: int, unroll: int = 4):
    """M&M TED on a value-upsampled stream, split pointer
    (``UpsamplingMMClockRecovery.m``).  Unlike ``common/MMClockRecovery.c``
    the MATLAB upsampling variant keeps the step FIXED (its
    "Updates Step Size" line is commented out) and nudges the pointer by
    the clipped sign-law error: ``nextSample += Error; nextSample +=
    stepSize``.  state: (next_sample (..., 2) split, prev_bit)."""
    dt = x.dtype
    cap = x.shape[-1]
    c = lambda v: jnp.asarray(v, dt)
    n = jnp.asarray(n)
    si = float(np.floor(step_size))
    sf = float(step_size - np.floor(step_size))

    def take(arr, i):
        return jnp.take_along_axis(arr, i[..., None], axis=-1)[..., 0]

    def step(carry, _):
        (ns2, prev), count = carry
        ni, nf = ns2[..., 0], ns2[..., 1]
        idx = ni + (nf >= 0.5).astype(dt)
        active = idx < n
        ii = jnp.clip(idx.astype(jnp.int32), 0, cap - 1)
        cur = take(x, ii)
        tval = take(t, ii)
        err = jnp.clip(c(kp) * (sign(prev) * cur - sign(cur) * prev),
                       c(-err_limit), c(err_limit))
        ai, af = _split_norm(ni, nf + err)          # nextSample += Error
        nni, nnf = _split_norm(ai + c(si), af + c(sf))     # + step
        ns2n = jnp.stack([jnp.where(active, nni, ni),
                          jnp.where(active, nnf, nf)], axis=-1)
        return ((ns2n, jnp.where(active, cur, prev)),
                count + active.astype(jnp.int32)), (cur, tval, active)

    count0 = jnp.zeros(x.shape[:-1], jnp.int32)
    (st, count), (syms, times, valid) = jax.lax.scan(
        step, (state, count0), None, length=max_syms, unroll=unroll)
    return (st, jnp.moveaxis(syms, 0, -1), jnp.moveaxis(times, 0, -1),
            jnp.moveaxis(valid, 0, -1), count)
