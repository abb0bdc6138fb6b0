"""Fully fused demod kernel: exact bit/position parity with the XLA op path
(given the kernel's own time axis, the block-local sample positions), and
frame-level parity via demod_blocks(use_pallas='fused') on synthetic data."""

import numpy as np
import jax.numpy as jnp
import pytest

from project_desert_tortoise_tpu import chain as chain_lib
from project_desert_tortoise_tpu.ops import agc as A, clock as C, fir as F
from project_desert_tortoise_tpu.ops import manchester as M, pll as P
from project_desert_tortoise_tpu.ops.pallas.fused_kernel import (
    fused_demod_pallas)
from project_desert_tortoise_tpu.utils.config import POES_TIP


def _positions(B, L):
    """The kernel's time axis: each block's own sample positions."""
    return jnp.asarray(np.tile(np.arange(L, dtype=np.float32), (B, 1)))


def test_fused_matches_xla_all_lanes():
    fs = 50000.0
    params = chain_lib.make_params(POES_TIP, fs, quirks=False)
    B, L = 128, 2048
    rng = np.random.default_rng(0)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 3 + 9))
    base = np.repeat(sym, 3, axis=1)[:, :L]
    re = jnp.asarray((base * 0.01
                      + 0.002 * rng.standard_normal((B, L))).astype(np.float32))
    im = jnp.asarray((0.002 * rng.standard_normal((B, L))).astype(np.float32))
    tn = _positions(B, L)
    pst = P.init_state(params.pll, jnp.float32, (B,))
    gain0 = jnp.full((B,), 17.58, jnp.float32)

    _, soft, _ = P.pll_scan(params.pll, pst, (re, im))
    taps = np.asarray(params.taps, np.float32)
    y = F.fir_interp(soft, taps, params.interp)
    _, y1 = A.agc_scan(A.AGCState(gain=gain0), y, params.agc_attack,
                       params.agc_decay)
    t_out = F.fir_out_times(tn, params.interp)
    g0 = C.gardner_init(jnp.float32, (B,))
    m0 = M.manchester_init(jnp.float32, (B,))
    _, _, bits1, bt1, em1 = C.gardner_manchester_windowed(
        g0, m0, y1, t_out, jnp.full((B,), L * params.interp),
        params.step_size, params.gardner_err_limit, params.gardner_gain,
        params.resync_threshold, window=1024 * 3)

    bits2, bt2, em2, avgp = fused_demod_pallas(
        params, pst, gain0, (re, im), interpret=True)

    for k in range(B):
        a = np.asarray(bits1[k])[np.asarray(em1[k])]
        ta = np.asarray(bt1[k])[np.asarray(em1[k])]
        b = np.asarray(bits2[k])[np.asarray(em2[k])]
        tb = np.asarray(bt2[k])[np.asarray(em2[k])]
        assert len(a) == len(b)
        assert np.array_equal(a, b.astype(np.uint8))
        assert np.array_equal(ta, tb)


def test_fused_golden_clip_compiled(poes_clip, oracle_frames):
    """Fused kernel via demod_blocks (Pallas interpreter on CPU) on the real
    golden clip must reproduce every oracle frame byte-identically."""
    from project_desert_tortoise_tpu.parallel.blocked import (BlockPlan,
                                                              demodulate_blocked)
    iq, t, fs = poes_clip
    plan = BlockPlan(core=8192, head=12288, tail=8192, max_frames=8)
    frames = demodulate_blocked(iq, t, fs, POES_TIP, plan=plan,
                                batch_blocks=128, use_pallas="fused")
    mine = {round(f.time, 5): f.hex_line() for f in frames}
    complete = [o for o in oracle_frames if len(o[2]) == 104]
    matched = 0
    for ot, oinv, obytes in complete:
        line = mine.get(round(ot, 5))
        body = " ".join(f"{b:02X}" for b in obytes)
        if line is not None and line.endswith(body):
            matched += 1
    assert matched >= len(complete) - 1


def test_fused_interp1_argos_shape():
    """Fused kernel with interp == 1 (ARGOS fast-path shape, 50-tap FIR,
    after-AGC squelch) matches the XLA path."""
    from project_desert_tortoise_tpu.utils.config import ARGOS
    from project_desert_tortoise_tpu.ops import agc as A
    fs = 32000.0
    params = chain_lib.make_params(ARGOS, fs, quirks=False)
    B, L = 128, 1024
    rng = np.random.default_rng(1)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 40 + 2))
    base = np.repeat(sym, 40, axis=1)[:, :L]
    re = jnp.asarray((base * 0.01
                      + 0.001 * rng.standard_normal((B, L))).astype(np.float32))
    im = jnp.asarray((0.001 * rng.standard_normal((B, L))).astype(np.float32))
    tn = _positions(B, L)
    pst = P.init_state(params.pll, jnp.float32, (B,))
    gain0 = jnp.full((B,), 50.0, jnp.float32)

    _, soft, lock = P.pll_scan(params.pll, pst, (re, im))
    taps = np.asarray(params.taps, np.float32)
    y = F.fir_interp(soft, taps, 1)
    _, y1 = A.agc_scan(A.AGCState(gain=gain0), y, params.agc_attack,
                       params.agc_decay)
    y1 = A.squelch(y1, lock, params.squelch_threshold)
    g0 = C.gardner_init(jnp.float32, (B,))
    m0 = M.manchester_init(jnp.float32, (B,))
    _, _, bits1, bt1, em1 = C.gardner_manchester_windowed(
        g0, m0, y1, tn, jnp.full((B,), L), params.step_size,
        params.gardner_err_limit, params.gardner_gain,
        params.resync_threshold, window=512)

    bits2, bt2, em2, _ = fused_demod_pallas(
        params, pst, gain0, (re, im), interpret=True)

    for k in range(0, B, 17):
        a = np.asarray(bits1[k])[np.asarray(em1[k])]
        ta = np.asarray(bt1[k])[np.asarray(em1[k])]
        b = np.asarray(bits2[k])[np.asarray(em2[k])]
        tb = np.asarray(bt2[k])[np.asarray(em2[k])]
        assert len(a) == len(b)
        assert np.array_equal(a, b.astype(np.uint8))
        # times must match too: with the pre-round-3 fixed RING=16 the
        # kernel's Gardner mid-bit read fell off the ring for step 40 and
        # the timing loop silently free-ran (bits still matched on clean
        # data, times did not)
        assert np.array_equal(ta, tb)


def test_fused_tight_geometry_latch_parity():
    """Capture-latch stress: a geometry where the mid-bit target is only
    ~1 body step ahead of its capture (step/2 - err_limit - interp = 0.025
    vs POES's 1.45) must still be bit/time-exact vs the XLA path — the
    tightest geometry the round-5 capture-latch diet admits."""
    fs = 50000.0
    params = chain_lib.make_params(POES_TIP, fs, quirks=False)
    # step 6.25 at interp 3: half offset 3.125, margin 0.025
    params = params._replace(step_size=6.25, baud=fs * 3 / 6.25)
    B, L = 128, 1536
    rng = np.random.default_rng(7)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 2 + 4))
    base = np.repeat(sym, 2, axis=1)[:, :L]     # ~2 samples/symbol
    re = jnp.asarray((base * 0.01
                      + 0.002 * rng.standard_normal((B, L))).astype(np.float32))
    im = jnp.asarray((0.002 * rng.standard_normal((B, L))).astype(np.float32))
    tn = _positions(B, L)
    pst = P.init_state(params.pll, jnp.float32, (B,))
    gain0 = jnp.full((B,), 17.58, jnp.float32)

    from project_desert_tortoise_tpu.ops import agc as A
    _, soft, _ = P.pll_scan(params.pll, pst, (re, im))
    taps = np.asarray(params.taps, np.float32)
    y = F.fir_interp(soft, taps, params.interp)
    _, y1 = A.agc_scan(A.AGCState(gain=gain0), y, params.agc_attack,
                       params.agc_decay)
    t_out = F.fir_out_times(tn, params.interp)
    g0 = C.gardner_init(jnp.float32, (B,))
    m0 = M.manchester_init(jnp.float32, (B,))
    _, _, bits1, bt1, em1 = C.gardner_manchester_windowed(
        g0, m0, y1, t_out, jnp.full((B,), L * params.interp),
        params.step_size, params.gardner_err_limit, params.gardner_gain,
        params.resync_threshold, window=L * params.interp // 2)

    bits2, bt2, em2, _ = fused_demod_pallas(
        params, pst, gain0, (re, im), interpret=True)

    n_emitted = 0
    for k in range(0, B, 11):
        a = np.asarray(bits1[k])[np.asarray(em1[k])]
        ta = np.asarray(bt1[k])[np.asarray(em1[k])]
        b = np.asarray(bits2[k])[np.asarray(em2[k])]
        tb = np.asarray(bt2[k])[np.asarray(em2[k])]
        assert len(a) == len(b)
        assert np.array_equal(a, b.astype(np.uint8))
        assert np.array_equal(ta, tb)
        n_emitted += len(b)
    assert n_emitted > 100        # the stress actually emitted symbols


def test_fused_rejects_latch_invariant_violation():
    """step/2 - err_limit - interp <= 0 cannot be served by the capture
    latch; the kernel must refuse instead of silently diverging from the
    deep-ring semantics (use the XLA path for such geometries)."""
    import pytest
    fs = 50000.0
    params = chain_lib.make_params(POES_TIP, fs, quirks=False)
    params = params._replace(step_size=4.0, baud=fs * 3 / 4.0)
    B, L = 128, 512
    z = jnp.zeros((B, L), jnp.float32)
    pst = P.init_state(params.pll, jnp.float32, (B,))
    gain0 = jnp.full((B,), 17.58, jnp.float32)
    with pytest.raises(ValueError, match="capture-latch"):
        fused_demod_pallas(params, pst, gain0, (z, z), interpret=True)


def _geometry(name):
    from project_desert_tortoise_tpu.utils.config import ARGOS_REALTIME
    if name == "poes":
        return chain_lib.make_params(POES_TIP, 50000.0, quirks=False)
    return chain_lib.make_params(ARGOS_REALTIME, 32000.0, quirks=False)


@pytest.mark.parametrize("geometry", ["poes", "argos"])
def test_fused_lowers_for_cuda_through_triton(geometry):
    """The kernel lowers for CUDA on the Triton route at the bench widths
    (int16 planes): no memory space or primitive without a Pallas GPU
    lowering.  Only the GPU compiler's own
    verdict (registers, PTX) needs the card."""
    import jax
    params = _geometry(geometry)
    B, L = 2048, 245760
    z = jax.ShapeDtypeStruct((B, L), jnp.int16)
    lane = jax.ShapeDtypeStruct((B,), jnp.float32)
    pst = P.init_state(params.pll, jnp.float32, (B,))

    def fn(pst, gain, zre, zim):
        return fused_demod_pallas(params, pst, gain, (zre, zim))
    text = jax.jit(fn).trace(pst, lane, z, z).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "fused_demod" in text


def test_fused_pads_lanes_to_whole_tiles():
    """B=100 is not a whole number of lane tiles: the wrapper pads silent
    lanes and slices them off, and every real lane matches the XLA path."""
    from project_desert_tortoise_tpu.ops.pallas.fused_kernel import (
        LANE_TILE, pad_lanes)
    assert pad_lanes(100) % LANE_TILE == 0 and pad_lanes(100) >= 100
    assert pad_lanes(LANE_TILE) == LANE_TILE
    params = _geometry("poes")
    B, L = 100, 1536
    rng = np.random.default_rng(3)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 3 + 9))
    base = np.repeat(sym, 3, axis=1)[:, :L]
    re = jnp.asarray((base * 0.01
                      + 0.002 * rng.standard_normal((B, L))).astype(np.float32))
    im = jnp.asarray((0.002 * rng.standard_normal((B, L))).astype(np.float32))
    tn = _positions(B, L)
    pst = P.init_state(params.pll, jnp.float32, (B,))
    gain0 = jnp.full((B,), 17.58, jnp.float32)

    _, soft, _ = P.pll_scan(params.pll, pst, (re, im))
    y = F.fir_interp(soft, np.asarray(params.taps, np.float32), params.interp)
    _, y1 = A.agc_scan(A.AGCState(gain=gain0), y, params.agc_attack,
                       params.agc_decay)
    _, _, bits1, bt1, em1 = C.gardner_manchester_windowed(
        C.gardner_init(jnp.float32, (B,)), M.manchester_init(jnp.float32, (B,)),
        y1, F.fir_out_times(tn, params.interp),
        jnp.full((B,), L * params.interp), params.step_size,
        params.gardner_err_limit, params.gardner_gain,
        params.resync_threshold, window=L * params.interp // 2)

    bits2, bt2, em2, avgp = fused_demod_pallas(
        params, pst, gain0, (re, im), interpret=True)
    assert bits2.shape == (B, L) and avgp.shape == (B,)
    for k in range(B):
        e1, e2 = np.asarray(em1[k]), np.asarray(em2[k])
        assert np.array_equal(np.asarray(bits1[k])[e1],
                              np.asarray(bits2[k])[e2].astype(np.uint8))
        assert np.array_equal(np.asarray(bt1[k])[e1], np.asarray(bt2[k])[e2])


@pytest.mark.gpu
def test_fused_compiles_and_matches_xla_on_gpu():
    """On the card: the compiled Triton kernel decodes the same frames as
    the XLA scans (chip_smoke.py phase 2 runs this at the bench widths)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (the Triton kernel has no CPU "
                    "compile; its interpret mode is tested above)")
    from project_desert_tortoise_tpu.parallel.blocked import demodulate_blocked
    from project_desert_tortoise_tpu.utils import synth, wav as W
    iq, sent = synth.make_poes_recording(n_frames=40, fs=50000.0)
    t = W.time_axis(len(iq), 50000.0, np.float32)
    with jax.default_device(jax.devices()[0]):
        fk = demodulate_blocked(iq, t, 50000.0, POES_TIP, use_pallas="fused")
        fx = demodulate_blocked(iq, t, 50000.0, POES_TIP, use_pallas=False)
    # frames that match a sent one agree; a misaligned decode where the
    # signal starts may differ between the two (ulp-level differences)
    sent_b = {bytes(s) for s in sent}
    good = [[bytes(f.data) for f in fr if bytes(f.data) in sent_b]
            for fr in (fk, fx)]
    assert good[0] == good[1]
    assert len(good[0]) >= len(sent) - 1
