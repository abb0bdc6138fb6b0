"""Fully fused demod kernel: PLL -> polyphase FIR -> AGC -> Gardner ->
Manchester for every input sample in ONE Pallas kernel, Triton route.

Layout: one lane (an independent demod block) per thread.  The grid runs
over lane tiles of ``LANE_TILE`` lanes; each program runs the WHOLE time
loop of its tile as a ``fori_loop`` whose carry (the chain's entire state,
49 values per lane for POES, 73 for ARGOS) stays in registers.  Sample
planes are time-major ``(L, B)``, so each step loads one coalesced row of
the tile's lanes, and nothing but the inputs, the two output planes and the
state is ever touched in device memory.  The chain is a serial feedback loop
per lane; an XLA ``lax.scan`` of it runs as a device loop with a kernel
launch per step, which this kernel replaces by one launch per call.

Timing recovery: the ``interp`` outputs of each input sample rotate through
a shallow shift-register ring (values + sample positions); a lane emits a
symbol when its fractional pointer crosses the newest produced interp index,
reading the on-time sample from the ring with an unrolled compare-select.
The Gardner
MID-BIT sample -- ``step_size/2`` outputs behind the on-time read in the
reference (``GardenerClockRecovery.c:78``) -- is caught by a one-value
capture latch: its target index is set at the previous emission and always
lies in the future at that point, so the latch grabs the value the step it is
produced.  Manchester decodes emitted symbols in the same step.  Since the
symbol stride (Fs*interp/baud) exceeds ``interp``, each lane emits at most
one bit per input sample, so outputs are dense per-sample planes with emit
marks, compressed downstream exactly like the scan path's.

Output parity with the XLA op path is exact on the CPU (interpret mode, see
tests/test_pallas_fused.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from project_desert_tortoise_tpu.ops import pll as pll_ops
from project_desert_tortoise_tpu.ops.fastmath import round_half_even, sign

# lanes per program, one per thread (num_warps = LANE_TILE // 32); chosen by
# the lane-tile sweep on the card (PERF.md)
LANE_TILE = 32


def _polyphase(taps, interp: int):
    """g[p][m] = h[(N-1-p) - m*interp] as python floats.

    Output phase p of input sample i is
        y[i*interp + p] = sum_m g[p][m] * x[i - m],  m = 0..N/interp-1,
    the reference's zero-stuff circular FIR in steady state
    (``LowPassFilter.c:58-67``; matches ops/fir.py)."""
    n = len(taps)
    hist = n // interp
    return [[float(taps[(n - 1 - p) - m * interp]) for m in range(hist)]
            for p in range(interp)]


def ring_size(step_size: float, err_limit: float, interp: int) -> int:
    """Mid-bit history depth: the Gardner half-sample lies ``step_size/2``
    outputs behind the newest, plus timing-error slack.  16 covers POES
    (step ~9); ARGOS needs 26 (step 40 -> half offset 20).  The fused kernel
    serves the mid-bit read with a capture latch instead; this sizing
    governs the XLA windowed variant's buffer image (ops/clock.py)."""
    need = int(np.ceil(step_size / 2.0 + err_limit)) + interp + 2
    return max(16, -(-need // 2) * 2)


def ring_t_size(step_size: float, err_limit: float, interp: int) -> int:
    """On-time ring depth.  Its read age is ``j_hi - round(next_sample)``,
    bounded by the emission condition (``target <= j_hi``, and each
    emission advances the pointer by ``step_size > interp``) to
    ``interp - 1`` plus the clamped timing error (``err_limit``, 0.1
    samples for both reference modes, POESTIPdemod/main.c:111 / ARGOSdemod
    config), so ``interp + ceil(err_limit) + 2`` entries suffice."""
    need = interp + int(np.ceil(err_limit)) + 2
    return min(max(4, -(-need // 2) * 2),
               ring_size(step_size, err_limit, interp))


def _ring_read(ring, age):
    """age: int32 lanes, 0 = newest; unrolled compare-select over the
    shift-register ring."""
    acc = jnp.zeros_like(ring[0])
    for k in range(len(ring)):
        acc = jnp.where(age == k, ring[k], acc)
    return acc


def _kernel(cp, agc_params, poly, interp, n_steps, ring_t, n_tg, in_scale,
            re_ref, im_ref, st_in_ref, be_ref, bt_ref, st_out_ref):
    (attack, decay, reference, max_gain, min_gain, squelch_thr) = agc_params
    hist_len = len(poly[0])
    # state layout: PLL (6) | FIR history (hist_len) | AGC gain (1) |
    # on-time value ring (ring_t) | mid-bit latch (1) | time ring, one entry
    # per interp group (n_tg) | Gardner ns, half (2) | Manchester clockmod,
    # evenodd, prev_sym (== Gardner prev_bit), prev, prevprev (5)
    P0 = 0
    H0 = 6
    G0 = H0 + hist_len
    R0 = G0 + 1
    HL = R0 + ring_t
    T0 = HL + 1
    GD = T0 + n_tg
    MA = GD + 2
    n_state = MA + 5

    def body(i, s):
        dt = s[0].dtype
        c = lambda v: jnp.asarray(v, dt)
        st = pll_ops.PLLState(
            phase=s[P0], freq=s[P0 + 1], locksig=s[P0 + 2],
            avg_phase=s[P0 + 3], sweep=s[P0 + 4], locked=s[P0 + 5] > 0.5)
        xre, xim = re_ref[i], im_ref[i]
        if in_scale is not None:     # int16 PCM rows: exact wave.c:117
            xre = xre.astype(dt) * c(in_scale)
            xim = xim.astype(dt) * c(in_scale)
        new, (soft, lock) = pll_ops._step(cp.pll, st, xre, xim)
        if cp.squelch_position == "after_pll":
            # |lock|: block relock may settle at the inverted BPSK point
            # (see parallel/blocked.py squelch note)
            soft = jnp.where(jnp.abs(lock) < c(squelch_thr),
                             jnp.zeros_like(soft), soft)

        hist = [soft] + [s[H0 + m] for m in range(hist_len - 1)]
        gain = s[G0]
        ring_v = [s[R0 + k] for k in range(ring_t)]
        hlatch = s[HL]
        tgroups = [s[T0 + k] for k in range(n_tg)]
        # the time axis is the block-local sample position (exact in f32
        # below 2^24 samples); the host maps it to the recording's times
        pos_in = jnp.broadcast_to(i.astype(dt), soft.shape)

        # ring entry k = interp output at age k (0 = newest); produce this
        # sample's `interp` outputs (AGC.c:98-130 per output)
        j_base = i * interp
        produced = []
        for p in range(interp):
            y = jnp.zeros_like(soft)
            for m in range(hist_len):
                y = y + c(poly[p][m]) * hist[m]
            y = y * gain
            error = jnp.abs(y) - c(reference)
            rate = jnp.where(jnp.abs(error) > gain, c(attack), c(decay))
            gain = gain - error * rate
            gain = jnp.where(gain < 0.0, c(min_gain), gain)
            gain = jnp.where(gain > c(max_gain), c(max_gain), gain)
            if cp.squelch_position == "after_agc":
                y = jnp.where(jnp.abs(lock) < c(squelch_thr),
                              jnp.zeros_like(y), y)
            produced.append(y)
        ring_v = produced[::-1] + ring_v[:ring_t - interp]
        tgroups = [pos_in] + tgroups[:n_tg - 1]

        # --- Gardner: emit at most one symbol this input sample ---
        ns, half_raw = s[GD], s[GD + 1]
        prev_sym = s[MA + 2]      # == gardner prev_bit == manchester mcur:
        #                           both latch `cur` on emission (merged)
        j_hi = j_base + interp - 1

        # mid-bit capture: the half target set at the previous emission is
        # always strictly ahead of j_hi at that point (half_new - j_hi >=
        # step/2 - err_limit - interp > 0 for both reference geometries), so
        # the value at round(half_raw) is latched the step it is produced;
        # negative or never-produced targets leave the latch at its reset
        # value 0.0 (GardenerClockRecovery.c:78-83)
        hidx = round_half_even(half_raw).astype(jnp.int32)
        off = hidx - j_base
        capv = jnp.zeros_like(soft)
        for p in range(interp):
            capv = jnp.where(off == p, produced[p], capv)
        hlatch = jnp.where((off >= 0) & (off < interp), capv, hlatch)

        target = round_half_even(ns)
        emit_sym = target <= j_hi
        tgt_i = jnp.maximum(target.astype(jnp.int32), 0)
        age = jnp.clip(j_hi - tgt_i, 0, ring_t - 1)
        cur = _ring_read(ring_v, age)
        # time ring entries are inserted `interp` at a time with one value,
        # so group g = age // interp holds the time
        sym_t = tgroups[-1]
        for k in reversed(range(n_tg - 1)):
            sym_t = jnp.where(age < (k + 1) * interp, tgroups[k], sym_t)
        hval = hlatch

        err = jnp.clip(c(cp.gardner_gain) * (cur - prev_sym) * hval,
                       c(-cp.gardner_err_limit), c(cp.gardner_err_limit))
        ns_adj = ns - err
        half_new = ns_adj + c(cp.step_size) / 2.0
        ns_new = ns_adj + c(cp.step_size)
        ns = jnp.where(emit_sym, ns_new, ns)
        half_raw = jnp.where(emit_sym, half_new, half_raw)
        # a consumed mid-bit resets the latch for the new (future) target
        hlatch = jnp.where(emit_sym, jnp.zeros_like(hlatch), hlatch)

        # --- Manchester on the emitted symbol ---
        clockmod, evenodd = s[MA], s[MA + 1]
        mprev, mprevprev = s[MA + 3], s[MA + 4]
        prevprev = mprev
        prev = prev_sym
        thr = c(cp.resync_threshold)
        mismatch = evenodd != clockmod
        strong = (jnp.abs(prevprev) > thr) & (jnp.abs(prev) > thr)
        resync = mismatch & (sign(prevprev) == sign(prev)) & strong
        clockmod_n = jnp.where(resync, evenodd, clockmod)
        boundary = evenodd == clockmod_n
        use_prev = jnp.abs(prev) > jnp.abs(cur)
        bit = jnp.where(use_prev, (prev > 0).astype(dt),
                        1.0 - (cur > 0).astype(dt))
        emit_bit = emit_sym & boundary

        # merged bit+emit output plane: value in {0, 1} when no emission,
        # {2, 3} = 2 + bit on emission -- exact small integers in f32
        be_ref[i] = bit + 2.0 * emit_bit.astype(dt)
        bt_ref[i] = sym_t

        clockmod = jnp.where(emit_sym, clockmod_n, clockmod)
        evenodd = jnp.where(emit_sym,
                            jnp.remainder(evenodd + 1.0, 2.0), evenodd)
        prev_sym = jnp.where(emit_sym, cur, prev_sym)
        mprev = jnp.where(emit_sym, prev, mprev)
        mprevprev = jnp.where(emit_sym, prevprev, mprevprev)

        return tuple(
            [new.phase, new.freq, new.locksig, new.avg_phase, new.sweep,
             new.locked.astype(dt)] + hist + [gain] + ring_v + [hlatch]
            + tgroups + [ns, half_raw]
            + [clockmod, evenodd, prev_sym, mprev, mprevprev])

    # the state is read once, carried in registers through the whole time
    # loop, and written once
    s0 = tuple(st_in_ref[k] for k in range(n_state))
    final = jax.lax.fori_loop(0, n_steps, body, s0)
    for k in range(n_state):
        st_out_ref[k] = final[k]


def pad_lanes(b: int) -> int:
    """Lane count rounded up to whole tiles (the kernel's launch width)."""
    return -(-b // LANE_TILE) * LANE_TILE


@functools.partial(jax.jit, static_argnames=("chain_params", "interpret"))
def fused_demod_pallas(chain_params, pll_state, agc_gain, z,
                       interpret: bool = False):
    """Full chain on (B, L) blocks, any B (lanes are padded to whole tiles
    with silent lanes whose outputs are sliced off).

    Returns (bits (B, L) float 0/1, bit_pos (B, L), emit_mask (B, L) bool,
    avg_phase (B,)): bit_pos is the block-local position of the input
    sample whose interp group holds the bit's on-time sample, the same axis
    the XLA path carries when given ``arange(L)`` as its time plane.  At
    most one bit per input sample per lane.

    z may be int16 PCM planes: the kernel loads the half-width rows and
    applies the exact /32768 normalization in-body (bit-identical to a
    separate conversion pass).

    interpret=True runs the kernel through the Pallas interpreter: only for
    arrays on the CPU (tests, CPU virtual meshes).
    """
    zre, zim = z
    B, L = zre.shape
    in_i16 = zre.dtype == jnp.int16
    dt = jnp.float32 if in_i16 else zre.dtype
    interp = chain_params.interp
    poly = tuple(tuple(r) for r in _polyphase(chain_params.taps, interp))
    hist_len = len(poly[0])
    # capture-latch validity (module docstring): a freshly set mid-bit
    # target must round strictly ahead of the newest produced index.  At an
    # emission step ns >= j_hi - interp + 0.5 (else the emission would have
    # fired a step earlier), so half_new - j_hi >= step/2 - err_limit -
    # interp + 0.5; requiring that to exceed 0.5 (round-half-even) gives
    # step/2 - err_limit - interp > 0.  POES: 4.55 - 0.1 - 3 = 1.45;
    # ARGOS: 20 - 0.1 - 1 = 18.9.  Custom geometries that violate it must
    # use the XLA scan path (the latch would miss targets a deep ring
    # serves).
    margin = (chain_params.step_size / 2.0
              - chain_params.gardner_err_limit - interp)
    if margin <= 0:
        raise ValueError(
            "fused kernel capture-latch invariant violated: "
            f"step_size/2 - err_limit - interp = {margin:.3f} <= 0 "
            f"(step_size={chain_params.step_size}, interp={interp}); this "
            "geometry's mid-bit target can be produced before its emission "
            "is consumed -- use the XLA path (use_pallas=False)")
    ring_t = ring_t_size(chain_params.step_size,
                         chain_params.gardner_err_limit, interp)
    n_tg = -(-ring_t // interp)   # time-ring group entries (one per interp)
    n_state = 6 + hist_len + 1 + ring_t + 1 + n_tg + 2 + 5

    agc_params = (chain_params.agc_attack, chain_params.agc_decay,
                  1.0, 5000.0, 10e-5, chain_params.squelch_threshold or 0.0)

    Bp = pad_lanes(B)

    def time_major(a):
        # (B, L) -> (L, Bp): rows of lanes, silent (zero) pad lanes
        return jnp.pad(a.T, ((0, 0), (0, Bp - B)))

    planes = [
        jnp.stack([pll_state.phase, pll_state.freq, pll_state.locksig,
                   pll_state.avg_phase, pll_state.sweep,
                   pll_state.locked.astype(dt)]),
        jnp.zeros((n_state - 6, B), dt).at[hist_len].set(agc_gain.astype(dt)),
    ]
    st_in = jnp.pad(jnp.concatenate(planes), ((0, 0), (0, Bp - B)))

    spec_t = pl.BlockSpec((L, LANE_TILE), lambda j: (0, j))
    spec_s = pl.BlockSpec((n_state, LANE_TILE), lambda j: (0, j))
    be, bpos, st_out = pl.pallas_call(
        functools.partial(_kernel, chain_params, agc_params, poly, interp,
                          L, ring_t, n_tg,
                          1.0 / 32768.0 if in_i16 else None),
        grid=(Bp // LANE_TILE,),
        in_specs=[spec_t, spec_t, spec_s],
        out_specs=[spec_t, spec_t, spec_s],
        out_shape=[
            jax.ShapeDtypeStruct((L, Bp), dt),
            jax.ShapeDtypeStruct((L, Bp), dt),
            jax.ShapeDtypeStruct((n_state, Bp), dt),
        ],
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(
            num_warps=LANE_TILE // 32, num_stages=1),
        interpret=interpret,
        name="fused_demod",
    )(time_major(zre), time_major(zim), st_in)

    avg_phase = st_out[3, :B]
    be = be[:, :B].T
    emit = be > 1.5               # merged plane: 2 + bit on emission
    bits = be - 2.0 * emit.astype(dt)
    return (bits, bpos[:, :B].T, emit, avg_phase)
