"""Batched multi-channel streaming serving (parallel/serving.py): frame
parity with the offline fast path over the same recordings, incremental
pushes in awkward chunk sizes, bounded history, partial-final-block drain."""

import numpy as np
import pytest

from project_desert_tortoise_tpu.parallel.blocked import (BlockPlan,
                                                          demodulate_many)
from project_desert_tortoise_tpu.parallel.serving import ChannelBank
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import POES_TIP

PLAN = BlockPlan(core=16384, head=12288, tail=8192, max_frames=8)


@pytest.fixture(scope="module")
def recordings():
    chans = []
    for seed in (3, 11):
        rng = np.random.default_rng(seed)
        iq, _ = synth.make_poes_recording(n_frames=10, fs=50000.0,
                                          snr_db=28.0, rng=rng)
        chans.append(iq)
    n = min(len(c) for c in chans)
    return np.stack([c[:n] for c in chans])


@pytest.fixture(scope="module")
def offline_frames(recordings):
    t = W.time_axis(recordings.shape[1], 50000.0, np.float32)
    return demodulate_many(recordings, t, 50000.0, POES_TIP, plan=PLAN,
                           batch_blocks=16)


def _lines(frames):
    return [f.hex_line() for f in sorted(frames, key=lambda f: f.time)]


def test_serving_matches_offline(recordings, offline_frames):
    C, n = recordings.shape
    bank = ChannelBank(POES_TIP, 50000.0, C, plan=PLAN, batch_blocks=16)
    # push in deliberately awkward, per-channel-different chunk sizes,
    # pumping as we go (the serving loop)
    pos = [0] * C
    steps = [9973, 12000]
    while any(p < n for p in pos):
        for c in range(C):
            lo = pos[c]
            hi = min(lo + steps[c], n)
            if lo < hi:
                bank.push(c, np.real(recordings[c, lo:hi]),
                          np.imag(recordings[c, lo:hi]))
                pos[c] = hi
        bank.pump()
    bank.drain()
    for c in range(C):
        assert _lines(bank.frames[c]) == _lines(offline_frames[c])


def test_serving_trims_history(recordings):
    C, n = recordings.shape
    bank = ChannelBank(POES_TIP, 50000.0, 1, plan=PLAN, batch_blocks=16)
    for lo in range(0, n, 25000):
        bank.push(0, np.real(recordings[0, lo:lo + 25000]),
                  np.imag(recordings[0, lo:lo + 25000]))
        bank.pump()
    c = bank.channels[0]
    # history stays bounded (trim keeps at most a few cores + halo)
    assert len(c.re) <= 6 * PLAN.core + PLAN.total
    assert c.base > 0


def test_fast_streaming_matches_offline(recordings, offline_frames):
    """demod_realtime --fast backing class: a ring-fed 1-channel ChannelBank
    must emit exactly the offline fast-path frames for a replayed recording
    (VERDICT r3 item 5)."""
    import threading
    from project_desert_tortoise_tpu.models.streaming import (
        FastStreamingDemodulator, feed_array)
    sd = FastStreamingDemodulator(POES_TIP, 50000.0, plan=PLAN,
                                  batch_blocks=16)
    iq = recordings[0]

    def produce():
        feed_array(sd.ring, iq, chunk=4096)
        sd.stop()

    prod = threading.Thread(target=produce, daemon=True)
    prod.start()
    frames = sd.run(poll_s=0.002)
    prod.join(timeout=30)
    assert sd.overruns == 0
    assert _lines(frames) == _lines(offline_frames[0])


def test_serving_holds_dispatch_until_norm_probe(recordings, offline_frames):
    """A lagging channel 0 must not cause early blocks to be demodulated
    with gain 1.0 (ADVICE r3): pump() holds ready blocks queued until the
    norm probe has run, then catches up with full parity."""
    C, n = recordings.shape
    bank = ChannelBank(POES_TIP, 50000.0, C, plan=PLAN, batch_blocks=16)
    # channel 1 races ahead: several blocks become ready pre-probe
    bank.push(1, np.real(recordings[1, :80000]),
              np.imag(recordings[1, :80000]))
    assert bank.pump() == 0 and bank.norm is None
    assert not bank.frames[1]
    # channel 0 arrives; the probe runs on ITS first chunk (parity contract)
    bank.push(0, np.real(recordings[0]), np.imag(recordings[0]))
    bank.push(1, np.real(recordings[1, 80000:]),
              np.imag(recordings[1, 80000:]))
    assert bank.norm is not None
    assert bank.pump() > 0
    bank.drain()
    for c in range(C):
        assert _lines(bank.frames[c]) == _lines(offline_frames[c])


def test_serving_fused_kernel_parity(recordings, offline_frames):
    """ChannelBank composes with the fused Pallas kernel: use_pallas='fused'
    engages the kernel (interpret mode on CPU) and the frames match the
    XLA path's."""
    from project_desert_tortoise_tpu.ops.pallas import fused_kernel as FK
    C, n = recordings.shape
    calls = []
    real = FK.fused_demod_pallas
    orig = FK.fused_demod_pallas

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    FK.fused_demod_pallas = spy
    try:
        bank = ChannelBank(POES_TIP, 50000.0, C, plan=PLAN,
                           batch_blocks=128, use_pallas="fused")
        for c in range(C):
            bank.push(c, np.real(recordings[c]), np.imag(recordings[c]))
        bank.pump()
        bank.drain()
    finally:
        FK.fused_demod_pallas = orig
    assert calls, "fused kernel was not engaged by the serving path"
    for c in range(C):
        mine = {l for l in _lines(bank.frames[c])}
        assert mine >= set(_lines(offline_frames[c]))

    # the XLA bank, handed the position axis the kernel generates
    # in-kernel, must produce IDENTICAL frames
    bank2 = ChannelBank(POES_TIP, 50000.0, C, plan=PLAN,
                        batch_blocks=128, use_pallas=False,
                        pad_batches=True)
    for c in range(C):
        bank2.push(c, np.real(recordings[c]), np.imag(recordings[c]))
    bank2.pump()
    bank2.drain()
    for c in range(C):
        assert _lines(bank.frames[c]) == _lines(bank2.frames[c])


def test_serving_norm_backstop_on_dead_channel_zero(recordings):
    """A permanently silent channel 0 must not stall the bank forever:
    once another channel banks several blocks, the norm probe falls back
    to the first full channel and dispatch resumes (bounded memory)."""
    C = 2
    bank = ChannelBank(POES_TIP, 50000.0, C, plan=PLAN, batch_blocks=16)
    n = recordings.shape[1]
    for _ in range(3):                   # channel 1 only; channel 0 dead
        for lo in range(0, n, 40000):    # 3x the recording to exceed the
            bank.push(1, np.real(recordings[1, lo:lo + 40000]),  # backstop
                      np.imag(recordings[1, lo:lo + 40000]))
            bank.pump()
    bank.pump()
    assert bank.norm is not None         # backstop probed from channel 1
    assert bank.frames[1]                # frames flowed without drain()
    c1 = bank.channels[1]
    assert len(c1.re) <= PLAN.total + 10 * PLAN.core  # history bounded


def test_demod_serve_cli(recordings, offline_frames, tmp_path):
    """demod_serve CLI: N wavs in, per-channel frame files out, same frames
    as the offline fast path."""
    from project_desert_tortoise_tpu.apps.demod_serve import run
    paths = []
    for c in range(recordings.shape[0]):
        iq = recordings[c]
        pth = str(tmp_path / f"ch{c}.wav")
        W.write_iq_wav(pth, iq / (np.abs(iq).max() * 1.1), 50000)
        paths.append(pth)
    rc = run(paths + ["--out-dir", str(tmp_path), "--batch-blocks", "16"])
    assert rc == 0
    base_counts = []
    for c in range(recordings.shape[0]):
        out = tmp_path / f"frames_{c}_ch{c}.txt"
        lines = [l.strip() for l in open(out) if l.strip()]
        # WAV write/read quantizes to int16, so compare frame COUNT and
        # payload overlap rather than exact lines
        assert len(lines) >= len(offline_frames[c]) - 2
        assert len(lines) > 3
        base_counts.append(len(lines))
    # low-latency plan (--core, VERDICT r4 item 5) + explicit f32 staging:
    # smaller cores trade throughput for dispatch-to-frame latency but must
    # still decode the stream
    low = tmp_path / "low"
    low.mkdir()
    rc = run(paths + ["--out-dir", str(low), "--batch-blocks", "16",
                      "--core", "16384", "--stage", "f32"])
    assert rc == 0
    for c in range(recordings.shape[0]):
        lines = [l.strip() for l in open(low / f"frames_{c}_ch{c}.txt")
                 if l.strip()]
        assert len(lines) >= base_counts[c] - 2


def test_serving_latency_measurement():
    """Serving latency harness (VERDICT r3 item 4): throttled producers into
    a ChannelBank; per-frame dispatch-to-frame wall latency is finite and
    the run sustains its input rate with bounded backlog."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.bench_serving import measure_serving
    row = measure_serving(POES_TIP, 50000.0, 2, duration_s=5.0, speedup=1.5,
                          plan=PLAN, batch_blocks=8, pump_period_s=0.02)
    assert row["frames"] > 0 and row["latency_n"] > 0
    assert row["sustained"], row
    # wall latency = batching wait + staging + demod + fetch; generous CPU
    # bound — the point is that it IS measured and stays finite (no compile
    # storm in the steady-state loop thanks to padded constant-shape
    # batches); rates on the card come from tools/bench_serving
    assert row["latency_p99_ms"] < 30000.0, row
    assert row["model_core_tail_s"] == pytest.approx(
        (PLAN.core + PLAN.tail) / 50000.0, abs=1e-3)


def test_serving_argos_mode(recordings):
    """ChannelBank in the ARGOS_REALTIME config (interp=1, after-AGC
    squelch, 9-byte packets): streaming frames match the offline fast path
    over the same recording — the mode demod_realtime --fast (ARGOS twin)
    rides."""
    from project_desert_tortoise_tpu.parallel.blocked import demodulate_many
    from project_desert_tortoise_tpu.utils.config import ARGOS_REALTIME
    fs = 32000.0
    iq, payloads = synth.make_argos_recording(n_packets=8, fs=fs,
                                              snr_db=30.0)
    plan = BlockPlan(core=16384, head=12288, tail=8192, max_frames=8)
    t = W.time_axis(len(iq), fs, np.float32)
    offline = demodulate_many(iq[None, :], t, fs, ARGOS_REALTIME, plan=plan,
                              batch_blocks=8)
    bank = ChannelBank(ARGOS_REALTIME, fs, 1, plan=plan, batch_blocks=8)
    for lo in range(0, len(iq), 30000):
        bank.push(0, np.real(iq[lo:lo + 30000]), np.imag(iq[lo:lo + 30000]))
        bank.pump()
    bank.drain()
    assert _lines(bank.frames[0]) == _lines(offline[0])
    sent = {" ".join(f"{b:02X}" for b in p) for p in payloads}
    got = {l.split(" ", 1)[1].strip() for l in _lines(bank.frames[0])}
    assert len(got & sent) >= len(payloads) - 2


def test_serving_on_frame_callback(recordings):
    got = []
    bank = ChannelBank(POES_TIP, 50000.0, 1, plan=PLAN, batch_blocks=16,
                       on_frame=lambda ci, f: got.append((ci, f.time)))
    bank.push(0, np.real(recordings[0]), np.imag(recordings[0]))
    bank.pump()
    bank.drain()
    assert got and all(ci == 0 for ci, _ in got)
    assert [t for _, t in got] == sorted(t for _, t in got)


def test_serving_int16_staging_matches_f32(recordings, offline_frames):
    """stage_dtype=int16 (raw PCM planes, device-side /32768 — VERDICT r4
    item 2) must be frame-identical to float staging for PCM-derived
    streams."""
    C, n = recordings.shape
    # PCM-quantized source: both banks see exactly int16/32768 samples
    r16 = np.clip(np.round(np.real(recordings) * 32768.0),
                  -32768, 32767).astype(np.int16)
    i16 = np.clip(np.round(np.imag(recordings) * 32768.0),
                  -32768, 32767).astype(np.int16)

    def run(stage_dtype, push_int):
        bank = ChannelBank(POES_TIP, 50000.0, C, plan=PLAN, batch_blocks=16,
                           stage_dtype=stage_dtype)
        for lo in range(0, n, 11000):
            for c in range(C):
                if push_int:
                    bank.push(c, r16[c, lo:lo + 11000], i16[c, lo:lo + 11000])
                else:
                    bank.push(c,
                              r16[c, lo:lo + 11000].astype(np.float32)
                              / 32768.0,
                              i16[c, lo:lo + 11000].astype(np.float32)
                              / 32768.0)
            bank.pump()
        bank.drain()
        assert bank.channels[0].re.dtype == np.dtype(stage_dtype)
        return bank.frames

    ref = run(np.float32, push_int=False)
    assert sum(len(f) for f in ref) > 10
    for push_int in (True, False):   # int16 pushes and PCM-derived floats
        got = run(np.int16, push_int=push_int)
        for c in range(C):
            assert _lines(got[c]) == _lines(ref[c])
