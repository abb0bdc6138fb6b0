"""The demodulation chain: explicit state + one jitted chunk step.

This is the JAX reformulation of the reference's chunked ``while(!feof)``
driver loop (``POESTIPdemod/main.c:373-492``): every C static local across
the DSP library becomes a field of `ChainState` (a small serializable pytree
— simultaneously the streaming-session state, the checkpoint format, and the
shard-boundary carry), and one call to `chunk_step` advances a chunk through

    PLL -> [squelch] -> FIR(1:N interp) -> AGC -> Gardner -> Manchester

entirely inside jit, returning fixed-capacity bit output.  The sync-word
framer runs host-side on the (tiny) bit stream in exact mode; the block-
parallel fast path uses the data-parallel framer instead (parallel/blocked.py).

Chunk-boundary semantics replicate the reference exactly, including its
buffer-image quirks (see ops/clock.py docstring); with `quirks=False` the
chain is chunk-size invariant by construction (fixing ``changelog.txt:9,107``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from project_desert_tortoise_tpu.ops import agc as agc_ops
from project_desert_tortoise_tpu.ops import clock as clock_ops
from project_desert_tortoise_tpu.ops import fir as fir_ops
from project_desert_tortoise_tpu.ops import manchester as man_ops
from project_desert_tortoise_tpu.ops import pll as pll_ops


class ChainParams(NamedTuple):
    """Static, hashable per-stream parameters (derived from ModeConfig + Fs)."""
    pll: pll_ops.PLLParams
    taps: tuple                 # FIR taps as a tuple (hashable static)
    interp: int
    agc_attack: float
    agc_decay: float
    squelch_threshold: Optional[float]
    squelch_position: Optional[str]   # "after_pll" | "after_agc"
    step_size: float
    fs_interp: float
    baud: float
    gardner_err_limit: float
    gardner_gain: float
    clock_algorithm: str              # "gardner" | "mm" | "upsampling_*"
    upsample_level: int               # upsampling_* variants only
    upsample_kind: str
    resync_threshold: float
    quirks: bool


class ChainState(NamedTuple):
    pll: pll_ops.PLLState
    fir_hist: jnp.ndarray
    agc: agc_ops.AGCState
    gardner: clock_ops.GardnerState
    manchester: man_ops.ManchesterState
    x_img: jnp.ndarray          # persistent interp-domain buffer image
    t_img: jnp.ndarray


def make_params(mode_cfg, fs: float, quirks: bool = True) -> ChainParams:
    if mode_cfg.gardner.algorithm.startswith("upsampling") and quirks:
        raise ValueError(
            "the MATLAB upsampling clock-recovery variants are whole-"
            "stream formulations with no C chunk-quirk counterpart; use "
            "quirks=False (the chunk-invariant mode)")
    dtype = mode_cfg.np_dtype()
    interp = mode_cfg.fir.interp_factor(fs)
    order = mode_cfg.fir.order(fs)
    taps = fir_ops.make_lpfir(order, mode_cfg.fir.cutoff_hz, fs * interp,
                              interp, dtype)
    fs_i = fs * interp
    return ChainParams(
        pll=pll_ops.make_params(mode_cfg.pll, fs),
        taps=tuple(taps.tolist()),
        interp=interp,
        agc_attack=mode_cfg.scaled(mode_cfg.agc.attack_rate_rad_s, fs_i),
        agc_decay=mode_cfg.scaled(mode_cfg.agc.decay_rate_rad_s, fs_i),
        squelch_threshold=(mode_cfg.squelch.threshold
                           if mode_cfg.squelch else None),
        squelch_position=(mode_cfg.squelch.position
                          if mode_cfg.squelch else None),
        step_size=clock_ops.gardner_step_size(fs_i, mode_cfg.gardner.baud, dtype),
        fs_interp=fs_i,
        baud=mode_cfg.gardner.baud,
        gardner_err_limit=mode_cfg.gardner.error_limit,
        gardner_gain=mode_cfg.gardner.gain,
        clock_algorithm=mode_cfg.gardner.algorithm,
        upsample_level=mode_cfg.gardner.upsample_level,
        upsample_kind=mode_cfg.gardner.upsample_kind,
        resync_threshold=mode_cfg.manchester.resync_threshold,
        quirks=quirks,
    )


TAIL_MARGIN = 16  # carried interp-domain samples for chunk-invariant mode


def max_symbols(cap_interp: int, step_size: float) -> int:
    return int(cap_interp / step_size * 1.05) + 8


def init_state(params: ChainParams, initial_gain: float, chunk_cap: int,
               dtype, batch_shape=()) -> ChainState:
    dt = jnp.dtype(dtype)
    n_taps = len(params.taps)
    hist_len = -(-(n_taps - 1) // params.interp)
    cap_i = chunk_cap * params.interp
    return ChainState(
        pll=pll_ops.init_state(params.pll, dt, batch_shape),
        fir_hist=jnp.zeros(batch_shape + (hist_len,), dt),
        agc=agc_ops.agc_init(initial_gain, dt, batch_shape),
        gardner=(clock_ops.upsampling_init(dt, batch_shape)
                 if params.clock_algorithm.startswith("upsampling")
                 else clock_ops.gardner_init(dt, batch_shape)),
        manchester=man_ops.manchester_init(dt, batch_shape),
        x_img=jnp.zeros(batch_shape + (cap_i,), dt),
        t_img=jnp.zeros(batch_shape + (cap_i,), dt),
    )


def _timing(params: ChainParams, g_state, x, t, n, msyms):
    """Timing recovery dispatch: Gardner (reference default) or M&M.

    For "mm" the GardnerState.half_raw slot carries the adaptive step size
    (M&M has no mid-bit pointer); 0 means uninitialized -> Fs/baud, matching
    the C static init (MMClockRecovery.c).
    """
    if params.clock_algorithm == "gardner":
        return clock_ops.gardner_scan(
            g_state, x, t, n, params.step_size,
            params.gardner_err_limit, params.gardner_gain, msyms)
    ss0 = jnp.where(g_state.half_raw == 0,
                    jnp.asarray(params.step_size, x.dtype), g_state.half_raw)
    st, (syms, times, valid, count) = clock_ops.mm_scan(
        (g_state.next_sample, g_state.prev_bit, ss0), x, t, n,
        params.fs_interp, params.baud, params.gardner_err_limit,
        params.gardner_gain, msyms)
    new = clock_ops.GardnerState(next_sample=st[0], half_raw=st[2],
                                 prev_bit=st[1])
    return new, syms, times, valid, count


class ChunkOutput(NamedTuple):
    bits: jnp.ndarray           # (..., max_syms) uint8
    bit_times: jnp.ndarray      # (..., max_syms)
    bit_mask: jnp.ndarray       # (..., max_syms) bool
    sym_count: jnp.ndarray
    locksig: jnp.ndarray        # (..., n) lock-detector stream
    avg_phase: jnp.ndarray      # per-chunk-end quality EWMA
    agc_stream: jnp.ndarray     # (..., n*interp) post-AGC soft stream (-r tap)
    syms: jnp.ndarray           # (..., max_syms) recovered soft symbols
    sym_valid: jnp.ndarray      # (..., max_syms) validity mask


@functools.partial(jax.jit, static_argnums=(0,))
def chunk_step(params: ChainParams, state: ChainState, iq_re, iq_im,
               t, t_next):
    """Advance one chunk.  iq_re/iq_im/t/t_next: (..., n); n = chunk length
    (static per compilation), t_next[i] = time of input sample i+1."""
    n = iq_re.shape[-1]
    interp = params.interp
    dt = iq_re.dtype
    cap_i = state.x_img.shape[-1]
    taps = np.asarray(params.taps, dt)

    pll_state, soft, locksig = pll_ops.pll_scan(params.pll, state.pll,
                                                (iq_re, iq_im))
    if params.squelch_position == "after_pll":
        soft = agc_ops.squelch(soft, locksig, params.squelch_threshold)

    y = fir_ops.fir_interp(soft, taps, interp, state.fir_hist)
    fir_hist = fir_ops.fir_history_update(soft, state.fir_hist, len(taps),
                                          interp)
    # LowPassFilterInterp emits t[i+1] per output group (LowPassFilter.c:68);
    # the plain LowPassFilter (interp == 1 modes) leaves the time axis alone
    t_out = fir_ops.fir_out_times(t_next, interp) if interp > 1 else t

    agc_state, y = agc_ops.agc_scan(state.agc, y, params.agc_attack,
                                    params.agc_decay)
    if params.squelch_position == "after_agc":
        assert interp == 1, "after_agc squelch requires interp == 1"
        y = agc_ops.squelch(y, locksig, params.squelch_threshold)

    n_i = n * interp
    if params.quirks:
        # persistent buffer images (C heap semantics; see ops/clock.py): the
        # carried mid-bit pointer is NOT rolled over and reads the new
        # chunk's buffer image at its stale absolute index
        x_img = jax.lax.dynamic_update_slice_in_dim(state.x_img, y, 0, axis=-1)
        t_img = jax.lax.dynamic_update_slice_in_dim(state.t_img, t_out, 0,
                                                    axis=-1)
        msyms = max_symbols(cap_i, params.step_size)
        gardner_state, syms, sym_times, sym_valid, sym_count = _timing(
            params, state.gardner, x_img, t_img, n_i, msyms)
    else:
        # chunk-size-invariant streaming: carry a small tail of the previous
        # chunk so the pending mid-bit read resolves to the true stream
        # sample (fixing the reference's chunk-boundary bug,
        # changelog.txt:9,107).  Work in margin-offset coordinates.
        m = TAIL_MARGIN
        x_ext = jnp.concatenate([state.x_img[..., -m:], y], axis=-1)
        t_ext2 = jnp.concatenate([state.t_img[..., -m:], t_out], axis=-1)
        msyms = max_symbols(cap_i, params.step_size)
        alg = params.clock_algorithm
        if alg.startswith("upsampling"):
            # MATLAB value-interpolating variants
            # (UpsamplingGardenerClockRecovery2.m:7-10, 60-95 /
            # UpsamplingMMClockRecovery.m): upsample the post-AGC stream
            # L x with a smooth kernel, rebuild a uniform time axis, run
            # the TED on the dense stream.  Pointers are split
            # (int, frac) pairs in upsampled units (clock.py upsampling
            # scans) so the per-chunk re-basing below is exact and the
            # chunked protocol is bit-exact chunk-size invariant.
            from project_desert_tortoise_tpu.ops import resample
            L = params.upsample_level
            x_up = resample.upsample(x_ext, L, params.upsample_kind)
            ts_i = float(np.float64(1.0) / params.fs_interp)
            t_up = resample.uniform_times(t_ext2, L, ts_i / L)
            step_u = params.step_size * L
            # emission stops EDGE input samples short of the chunk end:
            # the cubic kernel reads one future input sample, and the
            # carried margin (m >= EDGE + kernel tail) re-presents these
            # positions with full context next chunk -> whole-stream
            # values (test_upsampling_clock)
            EDGE = 2
            n_lim = (m + n_i - EDGE) * L

            def _shift(p2, delta):   # exact integer-part shift
                return p2.at[..., 0].add(jnp.asarray(delta, dt))

            g0 = state.gardner
            if alg == "upsampling_gardner":
                g_in = clock_ops.GardnerState(
                    next_sample=_shift(g0.next_sample, m * L),
                    half_raw=_shift(g0.half_raw, m * L),
                    prev_bit=g0.prev_bit)
                g_out, syms, sym_times, sym_valid, sym_count = \
                    clock_ops.upsampling_gardner_scan(
                        g_in, x_up, t_up, n_lim, step_u,
                        params.gardner_err_limit, params.gardner_gain,
                        msyms)
                gardner_state = clock_ops.GardnerState(
                    next_sample=_shift(g_out.next_sample, -(m + n_i) * L),
                    half_raw=_shift(g_out.half_raw, -(m + n_i) * L),
                    prev_bit=g_out.prev_bit)
            else:   # upsampling_mm: fixed step + sign-law nudge
                st, syms, sym_times, sym_valid, sym_count = \
                    clock_ops.upsampling_mm_scan(
                        (_shift(g0.next_sample, m * L), g0.prev_bit),
                        x_up, t_up, n_lim, step_u,
                        params.gardner_err_limit, params.gardner_gain,
                        msyms)
                gardner_state = clock_ops.GardnerState(
                    next_sample=_shift(st[0], -(m + n_i) * L),
                    half_raw=g0.half_raw, prev_bit=st[1])
        else:
            g_in = state.gardner._replace(
                next_sample=state.gardner.next_sample + m,
                # for "mm" the half_raw slot carries the adaptive step
                # size, not a pointer — no margin offset there
                half_raw=state.gardner.half_raw
                + (m if alg == "gardner" else 0))
            gardner_state, syms, sym_times, sym_valid, sym_count = _timing(
                params, g_in, x_ext, t_ext2, m + n_i, msyms)
            if alg == "gardner":
                # gardner_scan subtracted (m + n_i) from next_sample;
                # bring half_raw into the same next-chunk-relative
                # coordinates
                gardner_state = gardner_state._replace(
                    half_raw=gardner_state.half_raw - (m + n_i))
        x_img = x_ext
        t_img = t_ext2

    man_state, bits, bit_times, bit_mask = man_ops.manchester_scan(
        state.manchester, syms, sym_times, sym_valid, params.resync_threshold)

    if params.quirks and t_img.ndim == 1:
        # Gardner/Manchester write their outputs over the head of the shared
        # time buffer in C; replicate so a shorter final chunk sees the same
        # stale tail the reference would.
        pos = jnp.arange(cap_i)
        symt_pad = jnp.zeros((cap_i,), dt).at[:msyms].set(sym_times)
        t_img = jnp.where(pos < sym_count, symt_pad, t_img)
        bt_packed, _, nbits = man_ops.compress_stream(
            bit_times, bit_times, bit_mask, msyms)
        bitt_pad = jnp.zeros((cap_i,), dt).at[:msyms].set(bt_packed)
        t_img = jnp.where(pos < nbits, bitt_pad, t_img)

    new_state = ChainState(pll=pll_state, fir_hist=fir_hist, agc=agc_state,
                           gardner=gardner_state, manchester=man_state,
                           x_img=x_img, t_img=t_img)
    out = ChunkOutput(bits=bits, bit_times=bit_times, bit_mask=bit_mask,
                      sym_count=sym_count, locksig=locksig,
                      avg_phase=pll_state.avg_phase, agc_stream=y,
                      syms=syms, sym_valid=sym_valid)
    return new_state, out
