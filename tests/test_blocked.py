"""Block-parallel fast path: frame parity with the exact chain / C oracle."""

import numpy as np
import pytest

from project_desert_tortoise_tpu.parallel.blocked import (
    coarse_carrier_est, default_plan, demodulate_blocked)
from project_desert_tortoise_tpu.utils.config import POES_TIP

import jax.numpy as jnp


@pytest.fixture(scope="module")
def blocked_frames(poes_clip):
    iq, t, fs = poes_clip
    plan = default_plan(POES_TIP, fs, core=50000)
    return demodulate_blocked(iq, t, fs, POES_TIP, plan=plan)


def test_carrier_estimator(poes_clip):
    iq, _, fs = poes_clip
    seg = iq[60000:60000 + 8192]
    est = float(coarse_carrier_est(jnp.asarray(np.real(seg)),
                                   jnp.asarray(np.imag(seg)), fs))
    assert abs(est - (-3479.0)) < 30.0  # PLL locked at ~-3466..-3497 Hz


def test_all_oracle_frames_recovered(blocked_frames, oracle_frames):
    """Every complete oracle frame must appear with identical bytes/time."""
    mine = {round(f.time, 5): f for f in blocked_frames}
    complete = [of for of in oracle_frames if len(of[2]) == 104]
    missing, byte_diffs = 0, 0
    for ot, oinv, obytes in complete:
        f = mine.get(round(ot, 5))
        if f is None:
            missing += 1
            continue
        byte_diffs += int(np.sum(np.asarray(f.data) != np.asarray(obytes)))
    assert missing == 0
    assert byte_diffs <= 2


def test_fast_path_decodes_at_least_reference(blocked_frames, oracle_frames):
    """Warm-start blocks may decode MORE frames (during the reference's
    acquisition sweep), never fewer."""
    complete = [of for of in oracle_frames if len(of[2]) == 104]
    assert len(blocked_frames) >= len(complete)
    # extra frames must precede the reference's first lock or continue the
    # 0.1s minor-frame cadence
    times = sorted(f.time for f in blocked_frames)
    d = np.diff(times)
    assert np.all((d > 0.09) & (d < 0.11))


def test_device_staged_flat_matches_host_staged(poes_synth):
    """The flat path (contiguous upload + on-device windowing, int16 or
    f32) must produce the same frames as the host-staged driver."""
    from project_desert_tortoise_tpu import chain as chain_lib
    from project_desert_tortoise_tpu.parallel.blocked import (
        BlockPlan, demod_frames_flat_pipelined)

    iq, t, fs = poes_synth
    plan = BlockPlan(core=49152, head=12288, tail=8192, max_frames=16)
    B = -(-len(iq) // plan.core)
    re = np.real(iq).astype(np.float32)
    im = np.imag(iq).astype(np.float32)
    ts = np.float32(1.0) / np.float32(fs)
    t_ext = np.concatenate([t.astype(np.float32), [np.float32(t[-1] + ts)]])
    params = chain_lib.make_params(POES_TIP, fs, quirks=False)
    flat = lambda r, i: demod_frames_flat_pipelined(
        params, POES_TIP.framer, plan, B, float(fs), 4096, False, r, i,
        t_ext, 17.58, n_slices=1)

    host = demodulate_blocked(iq, t, fs, POES_TIP, plan=plan,
                              norm_factor=17.58)
    dev = flat(re, im)
    assert len(dev) > 40
    assert [f.hex_line() for f in dev] == [f.hex_line() for f in host]

    # int16 upload: device-side /32768 conversion is bit-exact vs the host
    # WAV normalization (common/wave.c:117), halving transfer bytes
    r16 = np.round(re * 32768.0).astype(np.int16)
    i16 = np.round(im * 32768.0).astype(np.int16)
    assert np.array_equal(r16.astype(np.float32) / 32768.0, re)  # lossless
    dev16 = flat(r16, i16)
    assert [f.hex_line() for f in dev16] == [f.hex_line() for f in dev]


def test_flat_time_generation_matches_time_plane(poes_synth):
    """The fused kernel generates its time axis (the block-local sample
    positions) in-kernel; the XLA scans are handed it as a plane.  Both
    must give the same frames through the flat path."""
    from project_desert_tortoise_tpu import chain as chain_lib
    from project_desert_tortoise_tpu.parallel.blocked import (
        BlockPlan, demod_frames_flat_pipelined)
    from project_desert_tortoise_tpu.utils import wav as W

    iq, t, fs = poes_synth
    plan = BlockPlan(core=8192, head=12288, tail=8192, max_frames=8)
    B = 128
    iq = np.tile(iq, -(-B * plan.core // len(iq)))
    t_ext = W.time_axis(len(iq) + 1, fs, np.float32)
    params = chain_lib.make_params(POES_TIP, fs, quirks=False)

    frames = {path: demod_frames_flat_pipelined(
        params, POES_TIP.framer, plan, B, float(fs), 512, path,
        np.real(iq).astype(np.float32), np.imag(iq).astype(np.float32),
        t_ext, 17.58, n_slices=1) for path in (False, "fused")}
    assert [f.hex_line() for f in frames["fused"]] == \
        [f.hex_line() for f in frames[False]]
    assert len(frames[False]) > 40


def test_flat_pipelined_matches_one_shot(poes_synth):
    """demod_frames_flat_pipelined (sliced upload/compute overlap) must be
    frame-identical to one slice — int16 planes, XLA path, and the fused
    kernel."""
    from project_desert_tortoise_tpu import chain as chain_lib
    from project_desert_tortoise_tpu.parallel.blocked import (
        BlockPlan, demod_frames_flat_pipelined)
    from project_desert_tortoise_tpu.utils import wav as W

    iq, t, fs = poes_synth
    plan = BlockPlan(core=8192, head=12288, tail=8192, max_frames=8)
    params = chain_lib.make_params(POES_TIP, fs, quirks=False)

    def run(B, path, window, slices):
        x = np.tile(iq, -(-B * plan.core // len(iq)))
        r16 = np.round(np.real(x) * 32768.0).astype(np.int16)
        i16 = np.round(np.imag(x) * 32768.0).astype(np.int16)
        t_ext = W.time_axis(len(x) + 1, fs, np.float32)
        return [[f.hex_line() for f in demod_frames_flat_pipelined(
            params, POES_TIP.framer, plan, B, float(fs), window, path,
            r16, i16, t_ext, 17.58, n_slices=n)] for n in slices]

    ref, two, four = run(32, False, 4096, (1, 2, 4))
    assert len(ref) > 20
    assert two == ref and four == ref
    # the fused kernel through the sliced path, interpret mode on CPU
    one, two = run(256, "fused", 256, (1, 2))
    assert two == one


def test_block_size_invariance(poes_clip):
    """Frames must not depend on the block plan (core size)."""
    iq, t, fs = poes_clip
    a = demodulate_blocked(iq, t, fs, POES_TIP,
                           plan=default_plan(POES_TIP, fs, core=50000))
    b = demodulate_blocked(iq, t, fs, POES_TIP,
                           plan=default_plan(POES_TIP, fs, core=80000))
    la = [f.hex_line() for f in a]
    lb = [f.hex_line() for f in b]
    # allow a single differing frame at the stream head (half a warm-up)
    assert len(set(la) ^ set(lb)) <= 2


@pytest.mark.parametrize("entry", ["blocked", "many", "flat", "sharded"])
def test_stitching_survives_a_stalled_time_axis(entry):
    """Past 2^9 s at 50 ksps the reference's accumulated float32 time axis
    stops advancing (its ulp outgrows the sample step), so every block of a
    long pass carries the same times.  Stitching works on block-local
    positions, so every frame still comes back once, with the axis's own
    (stalled) time."""
    import jax
    from project_desert_tortoise_tpu import chain as chain_lib
    from project_desert_tortoise_tpu.ops.agc import static_gain
    from project_desert_tortoise_tpu.parallel.blocked import (
        BlockPlan, demod_frames_flat_pipelined, demodulate_many)
    from project_desert_tortoise_tpu.parallel.sharding import (
        demodulate_sharded, make_mesh)
    from project_desert_tortoise_tpu.utils import synth
    fs = 50000.0
    iq, sent = synth.make_poes_recording(n_frames=30, fs=fs, snr_db=28.0)
    t = np.full(len(iq), 512.0, np.float32)       # the stalled axis
    plan = BlockPlan(core=16384, head=8192, tail=8192, max_frames=8)
    if entry == "blocked":
        frames = demodulate_blocked(iq, t, fs, POES_TIP, plan=plan,
                                    batch_blocks=4)
    elif entry == "many":
        frames = demodulate_many(np.stack([iq, iq]), t, fs, POES_TIP,
                                 plan=plan, batch_blocks=4)[1]
    elif entry == "flat":
        B = -(-len(iq) // plan.core)
        B += B % 2
        params = chain_lib.make_params(POES_TIP, fs, quirks=False)
        norm = static_gain(iq[:POES_TIP.chunk_size],
                           POES_TIP.static_gain_level, np.float32)
        frames = demod_frames_flat_pipelined(
            params, POES_TIP.framer, plan, B, fs, 4096, False,
            np.real(iq).astype(np.float32), np.imag(iq).astype(np.float32),
            np.append(t, t[-1]), float(norm), n_slices=2)
    else:
        mesh = make_mesh(2, 2, jax.devices("cpu")[:4])
        frames = demodulate_sharded(np.stack([iq, iq]), t, fs, POES_TIP,
                                    mesh, plan=plan)[1]
    got = [bytes(f.data) for f in frames]
    sent_b = [bytes(s) for s in sent]
    assert len(got) == len(set(got))               # no duplicates
    assert sum(b in got for b in sent_b) >= len(sent_b) - 1
    assert all(f.time == 512.0 for f in frames)
