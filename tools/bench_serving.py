#!/usr/bin/env python3
"""Serving latency / capacity measurement for the ChannelBank
(the "hundreds of live channels per card" claim needs a measurement).

Model under test: N live channels at ``fs`` samples/s feed a ChannelBank;
one consumer loop pumps batched device dispatches (parallel/serving.py).
The displaced baseline is the reference's one-process-per-channel realtime
app (POESTIPdemodPortAudio/main.c:324-401).

Measured per run:
  - dispatch-to-frame latency: wall time from "the sample that completes a
    frame's block (position (k+1)*core + tail) was produced" to "the frame
    was delivered to on_frame".  The core+tail part of the latency model is
    deterministic stream structure (serving.py docstring); this measures
    everything the serving loop adds on top: batching wait, host staging,
    device demod, frame fetch.
  - sustained throughput: samples consumed / wall; a run is "sustained"
    when the bank's backlog at the end is bounded (no channel more than one
    block + halo behind) and consumption kept up with production.

Producers run on a virtual clock ``speedup`` x real time, so capacity
sweeps don't need hours: N channels at speedup S models N*S real channels
of host+device load (frame latency is reported in wall ms and is what a
speedup-1 deployment would see from the same bank config, minus the
shorter batching waits at higher load).

Usage: python tools/bench_serving.py [--channels 8,32] [--duration 10]
       [--speedup 4] [--json out.json] [--use-pallas auto|0|fused]
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def measure_serving(mode_cfg, fs: float, n_channels: int,
                    duration_s: float = 10.0, speedup: float = 1.0,
                    plan=None, batch_blocks: int = 128,
                    window: int = 4096, use_pallas=None,
                    pump_period_s: float = 0.05, seed: int = 0,
                    stage_dtype=np.float32):
    """Run N throttled producers + one pump loop; return a metrics dict."""
    from project_desert_tortoise_tpu.parallel import blocked as BL
    from project_desert_tortoise_tpu.parallel.serving import ChannelBank
    from project_desert_tortoise_tpu.utils import synth

    plan = plan or BL.default_plan(mode_cfg, fs)
    if mode_cfg.name.startswith("poes"):
        iq, _ = synth.make_poes_recording(n_frames=24, fs=fs, snr_db=28.0,
                                          rng=np.random.default_rng(seed))
    else:
        iq, _ = synth.make_argos_recording(n_packets=24, fs=fs,
                                           snr_db=28.0)
    re0 = np.ascontiguousarray(np.real(iq), np.float32)
    im0 = np.ascontiguousarray(np.imag(iq), np.float32)
    if np.dtype(stage_dtype) == np.int16:
        # PCM-sourced channels push raw int16 (the reference realtime
        # app's native sample format, POESTIPdemodPortAudio/main.c:324)
        re0 = np.clip(np.round(re0 * 32768.0), -32768, 32767) \
            .astype(np.int16)
        im0 = np.clip(np.round(im0 * 32768.0), -32768, 32767) \
            .astype(np.int16)
    nrec = len(re0)

    lat_ms = []
    timeline = []          # (stream_pos, wall) of produced samples
    core, tail = plan.core, plan.tail

    def on_frame(ci, f):
        needed = (int(f.time * fs) // core + 1) * core + tail
        i = bisect.bisect_left(timeline, (needed, -1.0))
        if i < len(timeline):
            lat_ms.append((time.perf_counter() - timeline[i][1]) * 1e3)

    bank = ChannelBank(mode_cfg, fs, n_channels, plan=plan,
                       batch_blocks=batch_blocks, window=window,
                       use_pallas=use_pallas, on_frame=on_frame,
                       stage_dtype=stage_dtype)

    # warm the compile OUTSIDE the timed window (one throwaway batch shape)
    warm = ChannelBank(mode_cfg, fs, 1, plan=plan, batch_blocks=batch_blocks,
                       window=window, use_pallas=use_pallas,
                       stage_dtype=stage_dtype)
    warm.push(0, re0[:plan.total + plan.core], im0[:plan.total + plan.core])
    warm.drain()

    stop = threading.Event()
    produced = [0]

    def producer():
        t0 = time.perf_counter()
        chunk = max(2048, int(fs * speedup * pump_period_s))
        while not stop.is_set():
            now = time.perf_counter()
            due = int((now - t0) * fs * speedup)
            n = min(due - produced[0], 4 * chunk)
            if n <= 0:
                time.sleep(pump_period_s / 4)
                continue
            lo = produced[0]
            for c in range(n_channels):
                o = (lo + c * 997) % nrec          # de-correlate channels
                seg_r = np.take(re0, np.arange(o, o + n), mode="wrap")
                seg_i = np.take(im0, np.arange(o, o + n), mode="wrap")
                bank.push(c, seg_r, seg_i)
            produced[0] += n
            timeline.append((produced[0], time.perf_counter()))

    prod = threading.Thread(target=producer, daemon=True)
    t_start = time.perf_counter()
    prod.start()
    pumps = blocks = 0
    while time.perf_counter() - t_start < duration_s:
        blocks += bank.pump()
        pumps += 1
        time.sleep(pump_period_s / 10)
    stop.set()
    prod.join(timeout=5)
    while True:                    # flush remaining ready blocks AND the
        n = bank.pump()            # double-buffered pending batch (a
        blocks += n                # no-work pump collects it) so the
        if n == 0:                 # metrics see every emitted frame
            break
    wall = time.perf_counter() - t_start

    # backlog: how far the slowest channel's emitted blocks trail production
    behind = max(produced[0] - c.next_block * core
                 for c in bank.channels) if produced[0] else 0
    frames = sum(len(f) for f in bank.frames)
    lat = np.asarray(lat_ms) if lat_ms else np.asarray([np.nan])
    consumed_sps = blocks * core * 1.0 / wall
    input_sps = produced[0] * n_channels / wall
    return {
        "n_channels": n_channels, "fs": fs, "speedup": speedup,
        "duration_s": round(wall, 2),
        "input_msps": round(input_sps / 1e6, 3),
        "consumed_msps": round(consumed_sps / 1e6, 3),
        "blocks": blocks, "pumps": pumps, "frames": frames,
        "latency_p50_ms": round(float(np.nanpercentile(lat, 50)), 1),
        "latency_p99_ms": round(float(np.nanpercentile(lat, 99)), 1),
        "latency_max_ms": round(float(np.nanmax(lat)), 1),
        "latency_n": int(len(lat_ms)),
        # stream-structural part of the model: core+tail samples
        "model_core_tail_s": round((core + tail) / fs, 3),
        "backlog_samples_worst": int(behind),
        "sustained": bool(behind <= core + plan.total),
        "use_pallas": str(use_pallas), "batch_blocks": batch_blocks,
        "stage": str(np.dtype(stage_dtype)), "core": core,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--channels", default="8,32")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--speedup", type=float, default=1.0)
    p.add_argument("--fs", type=float, default=48000.0)
    p.add_argument("--use-pallas", default="auto",
                   choices=["auto", "0", "fused"])
    p.add_argument("--batch-blocks", type=int, default=128)
    p.add_argument("--window", type=int, default=4096)
    p.add_argument("--core", type=int, default=0)
    p.add_argument("--stage", default="f32", choices=["f32", "int16"])
    p.add_argument("--json", default=None)
    args = p.parse_args()

    from project_desert_tortoise_tpu.parallel import blocked as BL
    from project_desert_tortoise_tpu.utils.config import POES_TIP_REALTIME

    up = {"auto": None, "0": False, "fused": "fused"}[args.use_pallas]
    plan = None
    if args.core:
        plan = BL.default_plan(POES_TIP_REALTIME, args.fs, core=args.core)
    rows = []
    for nc in [int(x) for x in args.channels.split(",")]:
        row = measure_serving(POES_TIP_REALTIME, args.fs, nc,
                              duration_s=args.duration,
                              speedup=args.speedup, plan=plan,
                              batch_blocks=args.batch_blocks,
                              window=args.window, use_pallas=up,
                              stage_dtype=np.int16 if args.stage == "int16"
                              else np.float32)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "mode": "poes_tip_realtime"}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
