"""Manchester decoder as a masked scan (twin of ``common/ManchesterDecode.c``).

Pairs soft symbols into bits on an even/odd phase (`clockmod`), decides each
bit from the stronger half, and self-resynchronizes when two strong same-sign
symbols appear at a non-boundary (``ManchesterDecode.c:35-53``).  The C static
phase state becomes `ManchesterState`; resync and decision happen in the same
step in the reference order (resync can make the current position a boundary).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from project_desert_tortoise_tpu.ops.fastmath import sign


class ManchesterState(NamedTuple):
    clockmod: jnp.ndarray    # int32 0/1
    evenodd: jnp.ndarray     # int32 0/1 (uchar counter mod 2)
    cur: jnp.ndarray
    prev: jnp.ndarray
    prevprev: jnp.ndarray


def manchester_init(dtype=jnp.float32, batch_shape=()) -> ManchesterState:
    z = jnp.zeros(batch_shape, jnp.dtype(dtype))
    zi = jnp.zeros(batch_shape, jnp.int32)
    return ManchesterState(clockmod=zi, evenodd=zi, cur=z, prev=z, prevprev=z)


def manchester_scan(state: ManchesterState, syms, times, valid,
                    resync_threshold: float, unroll: int = 4):
    """syms/times/valid: (..., max_syms); scans the last axis.

    Returns (state, bits u8 (0/1), bit_times, emit_mask).
    """
    dt = syms.dtype
    thr = jnp.asarray(resync_threshold, dt)

    def step(st, inp):
        s, tval, v = inp
        prevprev = st.prev
        prev = st.cur
        cur = s

        mismatch = st.evenodd != st.clockmod
        strong = (jnp.abs(prevprev) > thr) & (jnp.abs(prev) > thr)
        resync = mismatch & (sign(prevprev) == sign(prev)) & strong
        clockmod = jnp.where(resync, st.evenodd, st.clockmod)

        boundary = st.evenodd == clockmod
        use_prev = jnp.abs(prev) > jnp.abs(cur)
        bit = jnp.where(use_prev,
                        (prev > 0).astype(jnp.uint8),
                        1 - (cur > 0).astype(jnp.uint8))
        emit = v & boundary

        new = ManchesterState(
            clockmod=jnp.where(v, clockmod, st.clockmod),
            evenodd=jnp.where(v, (st.evenodd + 1) & 1, st.evenodd),
            cur=jnp.where(v, cur, st.cur),
            prev=jnp.where(v, prev, st.prev),
            prevprev=jnp.where(v, prevprev, st.prevprev),
        )
        return new, (bit, tval, emit)

    xs = (jnp.moveaxis(syms, -1, 0), jnp.moveaxis(times, -1, 0),
          jnp.moveaxis(valid, -1, 0))
    state, (bits, btimes, emit) = jax.lax.scan(step, state, xs, unroll=unroll)
    return (state, jnp.moveaxis(bits, 0, -1), jnp.moveaxis(btimes, 0, -1),
            jnp.moveaxis(emit, 0, -1))


def compress_stream(values, times, mask, capacity: int):
    """Pack masked stream entries to the front of fixed-capacity arrays.

    Returns (values (..., capacity), times, count).  Order-preserving; used to
    hand Manchester output to the framer with static shapes inside jit.
    """
    idx = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
    idx = jnp.where(mask, idx, capacity)  # parked past the end
    out_v = jnp.zeros(values.shape[:-1] + (capacity + 1,), values.dtype)
    out_t = jnp.zeros(times.shape[:-1] + (capacity + 1,), times.dtype)
    out_v = _scatter_last(out_v, idx, values)
    out_t = _scatter_last(out_t, idx, times)
    count = jnp.sum(mask.astype(jnp.int32), axis=-1)
    return out_v[..., :capacity], out_t[..., :capacity], count


def compress_sorted(values, times, mask, capacity: int):
    """`compress_stream` via a stable sort instead of a scatter.

    A stable 2-way-key sort avoids an XLA scatter and is order-preserving
    by stability.
    Semantics identical to `compress_stream`: masked entries packed to the
    front, zeros past `count`.
    """
    n = values.shape[-1]
    key = jnp.where(mask, jnp.int32(0), jnp.int32(1))
    _, sv, st = jax.lax.sort(
        [key, values, times], dimension=-1, num_keys=1, is_stable=True)
    count = jnp.sum(mask.astype(jnp.int32), axis=-1)
    if n < capacity:
        pad = [(0, 0)] * (values.ndim - 1) + [(0, capacity - n)]
        sv, st = jnp.pad(sv, pad), jnp.pad(st, pad)
    else:
        sv, st = sv[..., :capacity], st[..., :capacity]
    live = jnp.arange(capacity) < count[..., None]
    return (jnp.where(live, sv, jnp.zeros_like(sv)),
            jnp.where(live, st, jnp.zeros_like(st)),
            count)


def compress_spaced(values, times, mask, capacity: int, min_spacing: int = 4):
    """`compress_stream` for sample-dense streams whose set bits are at least
    `min_spacing` apart along the last axis (the fused-kernel output: bit
    emissions are >= ~6 input samples apart, ``GardenerClockRecovery.c:57``).

    Reduces P = min_spacing samples to one slot first (each chunk holds at
    most one set bit), then sort-compacts the 1/P-size slot stream.
    """
    p = min_spacing
    n = values.shape[-1]
    assert n % p == 0, (n, p)
    lead = values.shape[:-1]
    m = mask.reshape(lead + (n // p, p))
    cm = m.any(-1)
    vv = values.astype(times.dtype)
    cv = jnp.sum(vv.reshape(lead + (n // p, p)) * m, axis=-1)
    ct = jnp.sum(times.reshape(lead + (n // p, p)) * m, axis=-1)
    out_v, out_t, count = compress_sorted(cv, ct, cm, capacity)
    return out_v.astype(values.dtype), out_t, count


def _scatter_last(out, idx, vals):
    if out.ndim == 1:
        return out.at[idx].set(vals, mode="drop")
    flat_out = out.reshape((-1, out.shape[-1]))
    flat_idx = idx.reshape((-1, idx.shape[-1]))
    flat_vals = vals.reshape((-1, vals.shape[-1]))
    res = jax.vmap(lambda o, i, v: o.at[i].set(v, mode="drop"))(
        flat_out, flat_idx, flat_vals)
    return res.reshape(out.shape)
