"""CLI app end-to-end: demod_poes on the golden clip must reproduce the
oracle output file; -r dumps the post-AGC stream matching the C tap."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def test_demod_poes_cli_matches_oracle(tmp_path, taps_dir):
    out = tmp_path / "frames.txt"
    r = subprocess.run(
        [sys.executable, "-m", "project_desert_tortoise_tpu.apps.demod_poes",
         "/root/reference/5sec_clip.wav", "--out", str(out), "-r"],
        cwd=tmp_path, capture_output=True, text=True, timeout=500, env=ENV)
    assert r.returncode == 0, r.stderr[-500:]
    mine = [l.rstrip() for l in open(out) if l.strip()]
    oracle = [l.rstrip() for l in open(f"{taps_dir}/frames.txt") if l.strip()]
    same = sum(1 for a, b in zip(mine, oracle) if a == b)
    assert same >= len(oracle) - 2

    tap = np.fromfile(tmp_path / "output.raw", np.float32)
    agc_c = np.fromfile(f"{taps_dir}/agc.f32", np.float32)
    n = min(len(tap), len(agc_c))
    assert n > 700000
    assert np.abs(tap[:n] - agc_c[:n]).max() < 2e-3


def test_demod_argos_cli_on_synth(tmp_path):
    """ARGOS CLI end-to-end on a synthesized recording (double-precision
    exact path via the x64 switch in the app)."""
    import numpy as np
    from project_desert_tortoise_tpu.utils import synth, wav as W
    iq, payloads = synth.make_argos_recording(n_packets=3, fs=32000.0,
                                              snr_db=30.0)
    wav = tmp_path / "a.wav"
    W.write_iq_wav(str(wav), iq / (np.abs(iq).max() * 1.2), 32000)
    out = tmp_path / "packets.txt"
    r = subprocess.run(
        [sys.executable, "-m", "project_desert_tortoise_tpu.apps.demod_argos",
         str(wav), "--out", str(out)],
        cwd=tmp_path, capture_output=True, text=True, timeout=500, env=ENV)
    assert r.returncode == 0, r.stderr[-400:]
    lines = [l for l in open(out) if l.strip()]
    sent = {" ".join(f"{b:02X}" for b in p) for p in payloads}
    got = {l.split(" ", 1)[1].strip() for l in lines}
    assert len(got & sent) >= 2


def test_demod_argos_cli_raw_extension_notice(tmp_path):
    """RAW input for ARGOS is a deliberate divergence (the reference rejects
    it, ARGOSdemod/main.c:237-239; DESIGN.md section 6): accepted, with a
    one-line stderr notice."""
    import numpy as np
    from project_desert_tortoise_tpu.utils import synth
    iq, payloads = synth.make_argos_recording(n_packets=3, fs=32000.0,
                                              snr_db=30.0)
    raw = tmp_path / "a.raw"
    planes = np.empty(2 * len(iq), np.float32)
    planes[0::2] = np.real(iq).astype(np.float32)
    planes[1::2] = np.imag(iq).astype(np.float32)
    planes.tofile(raw)
    out = tmp_path / "packets.txt"
    r = subprocess.run(
        [sys.executable, "-m", "project_desert_tortoise_tpu.apps.demod_argos",
         str(raw), "-s", "32", "--out", str(out)],
        cwd=tmp_path, capture_output=True, text=True, timeout=500, env=ENV)
    assert r.returncode == 0, r.stderr[-400:]
    assert "framework extension" in r.stderr
    lines = [l for l in open(out) if l.strip()]
    sent = {" ".join(f"{b:02X}" for b in p) for p in payloads}
    got = {l.split(" ", 1)[1].strip() for l in lines}
    assert len(got & sent) >= 2


def test_demod_realtime_fast_cli_stdin(tmp_path):
    """demod_realtime --fast: the realtime CLI rides the block-parallel
    fast path (1-channel ChannelBank) end-to-end from a stdin IQ stream."""
    import numpy as np
    from project_desert_tortoise_tpu.utils import synth
    iq, sent = synth.make_poes_recording(n_frames=10, fs=50000.0,
                                         snr_db=28.0)
    planes = np.empty(2 * len(iq), np.float32)
    planes[0::2] = np.real(iq).astype(np.float32)
    planes[1::2] = np.imag(iq).astype(np.float32)
    out = tmp_path / "frames.txt"
    r = subprocess.run(
        [sys.executable, "-m",
         "project_desert_tortoise_tpu.apps.demod_realtime",
         "--fast", "-s", "50", "--out", str(out)],
        cwd=tmp_path, input=planes.tobytes(), capture_output=True,
        timeout=500, env=ENV)
    assert r.returncode == 0, r.stderr[-400:]
    lines = [l for l in open(out) if l.strip()]
    sent_set = {" ".join(f"{b:02X}" for b in p) for p in sent}
    got = {l.split(" ", 1)[1].strip() for l in lines}
    assert len(got & sent_set) >= len(sent) - 3


def test_demod_poes_fast_cli_with_products(tmp_path, taps_dir):
    out = tmp_path / "frames.txt"
    prod = tmp_path / "products"
    r = subprocess.run(
        [sys.executable, "-m", "project_desert_tortoise_tpu.apps.demod_poes",
         "/root/reference/5sec_clip.wav", "--out", str(out), "--fast",
         "--products", str(prod)],
        cwd=tmp_path, capture_output=True, text=True, timeout=500, env=ENV)
    assert r.returncode == 0, r.stderr[-400:]
    mine = [l.rstrip() for l in open(out) if l.strip()]
    oracle = [l.rstrip() for l in open(f"{taps_dir}/frames.txt") if l.strip()]
    bodies = {l.split(" ", 1)[1] for l in mine}
    missing = sum(1 for l in oracle[:-1]
                  if l.split(" ", 1)[1] not in bodies)
    assert missing <= 1
    assert (prod / "summary.txt").exists()


def test_demod_poes_integer_timebase_cli(tmp_path):
    """--timebase integer decodes with grid-exact timestamps."""
    import numpy as np
    from project_desert_tortoise_tpu.apps.demod_poes import run
    from project_desert_tortoise_tpu.utils import synth, wav as W

    iq, _ = synth.make_poes_recording(n_frames=6, fs=50000.0, snr_db=28.0)
    wav = str(tmp_path / "in.wav")
    W.write_iq_wav(wav, iq / (np.abs(iq).max() * 1.2), 50000)
    out = str(tmp_path / "frames.txt")
    rc = run([wav, "--timebase", "integer", "--out", out])
    assert rc == 0
    lines = [l for l in open(out) if l.strip()]
    assert len(lines) >= 3
    for l in lines:
        t = float(l.split()[0].rstrip("i"))
        frac = (t * 50000.0) % 1.0
        assert min(frac, 1.0 - frac) < 1e-2, l
