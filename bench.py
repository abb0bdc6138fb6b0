#!/usr/bin/env python3
"""Benchmark: POES TIP and ARGOS block-parallel demod on one GPU.

One process does everything.  It exits non-zero when JAX finds no GPU,
prints the card (JAX's device kind, and nvidia-smi's name and power limit),
then ONE JSON line:
  - kernel row: ``demod_blocks`` over B staged int16 blocks (PLL + FIR-interp
    + AGC + Gardner + Manchester + bit compression), the device-resident
    inputs already uploaded; median of timed calls after a warm-up, each
    ending in ``block_until_ready``;
  - end-to-end row: int16 samples on the host -> stitched minor frames on
    the host, wall clock including host staging, upload, carrier estimate,
    demod, framing/stitching and the frame fetch (the reference's own figure
    of merit is a whole-file elapsed-seconds run, POESTIPdemod/main.c:500);
  - ARGOS row: the kernel row in the ARGOS geometry (interp 1, 51 taps,
    squelch after AGC).

The demod path is the default device's (``blocked.default_use_pallas``:
the fused kernel on a GPU).  ``vs_baseline`` divides by the reference C
demodulator's rate as timed on an earlier host (oracle/c_baseline.json),
not on the host of this run.

    python bench.py
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the bench geometry: B lanes of [head | core | tail] blocks
BENCH_B = 2048
BENCH_HEAD, BENCH_CORE, BENCH_TAIL = 12288, 225280, 8192


def _emit(obj):
    print(json.dumps(obj), flush=True)


def stage_bench(mode_cfg, fs, iq, B=None):
    """Tile ``iq`` over B bench blocks and stage them on the device.

    Returns a dict with the params, plan, int16 block planes (jre, jim) and
    the coarse carrier estimate (fest), all device arrays, and the host
    planes with their time axis (host)."""
    import jax.numpy as jnp
    from project_desert_tortoise_tpu import chain as chain_lib
    from project_desert_tortoise_tpu.parallel import blocked as BL
    from project_desert_tortoise_tpu.utils import wav as W

    B = B or BENCH_B
    dt = np.dtype(np.float32)
    params = chain_lib.make_params(mode_cfg, fs, quirks=False)
    plan = BL.BlockPlan(core=BENCH_CORE, head=BENCH_HEAD, tail=BENCH_TAIL,
                        max_frames=64)
    reps = int(np.ceil((B * plan.core + plan.total) / len(iq)))
    rr = np.tile(np.real(iq).astype(dt), reps)
    ii = np.tile(np.imag(iq).astype(dt), reps)
    tt = W.time_axis(len(rr) + 1, fs, dt)
    # int16 PCM block planes, the layout a 16-bit source stages; the kernel
    # applies the exact /32768 of wave.c:117 in-body
    r16 = np.round(rr * 32768.0).astype(np.int16)
    i16 = np.round(ii * 32768.0).astype(np.int16)
    jre, jim = (jnp.asarray(x)
                for x in BL.stage_blocks(r16, i16, plan, 0, B, np.int16))
    line_spacing = fs * params.interp / (2.0 * params.step_size)
    fest = BL.coarse_carrier_est(jre, jim, float(fs), float(line_spacing))
    return {"params": params, "plan": plan, "fs": float(fs), "B": B,
            "jre": jre, "jim": jim, "fest": fest, "host": (r16, i16, tt)}


def demod_call(st, use_pallas):
    """One demod_blocks dispatch over the staged bench blocks."""
    from project_desert_tortoise_tpu.parallel import blocked as BL
    return BL.demod_blocks(
        st["params"], st["plan"].total, st["jre"], st["jim"], st["fs"],
        st["fest"], 17.58, 4096, use_pallas)


def time_calls(fn, iters: int):
    """(median seconds, all seconds) of ``fn`` after one warm-up call."""
    import jax
    jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def poes_input(fs=50000.0):
    """A seeded synthetic POES recording (40 minor frames)."""
    from project_desert_tortoise_tpu.utils import synth
    return synth.make_poes_recording(n_frames=40, fs=fs)[0]


def run_kernel_row(mode_cfg, fs, iq, use_pallas, iters: int = 5):
    from project_desert_tortoise_tpu.parallel import blocked as BL
    st = stage_bench(mode_cfg, fs, iq)
    med, _ = time_calls(lambda: demod_call(st, use_pallas), iters)
    out = demod_call(st, use_pallas)
    fb = BL.extract_frames(mode_cfg.framer, st["plan"].max_frames, *out[:3])
    n_samp = st["B"] * st["plan"].core
    return {"msps": n_samp / med / 1e6, "step_ms": med * 1e3,
            "frames": int(np.asarray(fb.count).sum()), "B": st["B"],
            "st": st}


def run_e2e(st, use_pallas, passes: int = 5):
    """Whole-file wall clock through the pipelined flat path: host int16
    planes -> stitched frames on the host (upload of slice k+1 overlaps the
    demod of slice k)."""
    from project_desert_tortoise_tpu.parallel import blocked as BL
    from project_desert_tortoise_tpu.utils.config import POES_TIP

    plan, params, B = st["plan"], st["params"], st["B"]
    r16, i16, tt = st["host"]
    n = B * plan.core
    need = n + plan.tail
    n_slices = 4

    def pass_once():
        t0 = time.perf_counter()
        frames = BL.demod_frames_flat_pipelined(
            params, POES_TIP.framer, plan, B, st["fs"], 4096, use_pallas,
            r16[:need], i16[:need], tt[:need + 1], 17.58,
            n_slices=n_slices)
        return frames, time.perf_counter() - t0

    frames, _ = pass_once()           # warm-up / compile (not timed)
    walls = [pass_once()[1] for _ in range(passes)]
    wall = float(np.median(walls))
    return {"e2e_msps": n / wall / 1e6, "e2e_wall_s": wall,
            "e2e_frames": len(frames), "e2e_passes": passes,
            "e2e_wall_spread_s": sorted(walls)}


def main():
    from project_desert_tortoise_tpu.parallel import blocked as BL
    from project_desert_tortoise_tpu.utils import synth
    from project_desert_tortoise_tpu.utils.compile_cache import (
        enable_compile_cache)
    from project_desert_tortoise_tpu.utils.config import (ARGOS_REALTIME,
                                                          POES_TIP)
    from project_desert_tortoise_tpu.utils.device import (card_name_power,
                                                          require_gpu)

    os.chdir(REPO)
    devs = require_gpu()
    enable_compile_cache()
    print(f"device: {devs[0].device_kind} x{len(devs)}", flush=True)
    print(f"card: {card_name_power()}", flush=True)
    baseline = json.load(open(os.path.join(
        REPO, "oracle", "c_baseline.json")))["c_demod_poes_msps"]

    use_pallas = BL.default_use_pallas()
    row = run_kernel_row(POES_TIP, 50000.0, poes_input(), use_pallas)
    line = {"metric": "poes_demod_throughput",
            "value": round(row["msps"], 2), "unit": "Msamples/s/card",
            "vs_baseline": round(row["msps"] / baseline, 2),
            "step_ms": round(row["step_ms"], 2),
            "frames_decoded": row["frames"], "impl": str(use_pallas),
            "B": row["B"], "device": devs[0].device_kind}
    e2e = run_e2e(row["st"], use_pallas)
    line.update({k: (round(v, 3) if isinstance(v, float) else v)
                 for k, v in e2e.items()})
    del row
    iq, _ = synth.make_argos_recording(n_packets=40, fs=32000.0,
                                       snr_db=30.0)
    ar = run_kernel_row(ARGOS_REALTIME, 32000.0, iq, use_pallas)
    line.update({"argos_msps": round(ar["msps"], 2),
                 "argos_step_ms": round(ar["step_ms"], 2),
                 "argos_frames": ar["frames"]})
    _emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
