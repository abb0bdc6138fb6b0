"""CLI: batched multi-channel serving (`parallel/serving.ChannelBank`).

The reference runs one process per channel
(``POESTIPdemodPortAudio/main.c``); here N channels share one card: each
input file (wav, or SDR# RAW with ``-s`` rate) feeds a channel of the
bank, ready time-blocks from all channels batch into single device
dispatches, and frames stream into per-channel output files as they
decode.

    python -m project_desert_tortoise_tpu.apps.demod_serve \
        ch0.wav ch1.wav ... [--mode poes_tip] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os
import threading


def run(argv=None):
    p = argparse.ArgumentParser(prog="demod_serve")
    p.add_argument("inputs", nargs="+", help="one recording per channel")
    p.add_argument("--mode", default="poes_tip")
    p.add_argument("--out-dir", default=".")
    p.add_argument("-s", dest="rate_khz", type=float, default=0.0,
                   help="sample rate in kHz for RAW inputs")
    p.add_argument("--chunk", type=int, default=25000,
                   help="producer chunk size (samples)")
    p.add_argument("--batch-blocks", type=int, default=64)
    p.add_argument("--core", type=int, default=0,
                   help="block core size in samples (smaller = lower "
                        "dispatch-to-frame latency at some throughput "
                        "cost; default ~2 s of samples)")
    p.add_argument("--stage", default="auto",
                   choices=["auto", "int16", "f32"],
                   help="sample staging dtype: int16 ships raw PCM planes "
                        "and converts on device (half the staged bytes; "
                        "default when every input is 16-bit PCM)")
    p.add_argument("--use-pallas", default="auto",
                   choices=["auto", "0", "fused"],
                   help="device demod path: auto (default: the fused "
                        "kernel on a GPU, XLA scans on the CPU), XLA scans, "
                        "or the fused kernel")
    args = p.parse_args(argv)
    use_pallas = {"auto": None, "0": False,
                  "fused": "fused"}[args.use_pallas]

    import numpy as np
    from project_desert_tortoise_tpu.models.registry import get_mode
    from project_desert_tortoise_tpu.parallel import blocked as BL
    from project_desert_tortoise_tpu.parallel.serving import ChannelBank
    from project_desert_tortoise_tpu.utils import output as O, wav as W
    from project_desert_tortoise_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    mode = get_mode(args.mode)
    recs = []      # per channel: (re, im) planes — int16 or float32
    fs = None
    int16_ok = args.stage != "f32"
    for path in args.inputs:
        planes = None
        if path.lower().endswith(".wav"):
            if int16_ok:
                try:
                    re, im, f, _ = W.load_iq_wav_int16(path)
                    planes = (re, im)
                except ValueError:      # not 16-bit PCM
                    if args.stage == "int16":
                        raise
                    int16_ok = False
            if planes is None:
                iq, _, f, _ = W.load_iq_wav(path)
        else:
            if not args.rate_khz:
                p.error(f"RAW input {path!r} needs -s rate")
            f = args.rate_khz * 1000.0
            iq = W.load_iq_raw(path, f)
            if isinstance(iq, tuple):
                iq = iq[0]
            if args.stage != "int16":
                int16_ok = False       # RAW is already float-normalized
        if planes is None:
            planes = (np.ascontiguousarray(np.real(iq), np.float32),
                      np.ascontiguousarray(np.imag(iq), np.float32))
        if fs is None:
            fs = f
        elif f != fs:
            p.error("all channels must share one sample rate")
        recs.append(planes)
    if not int16_ok:       # mixed sources: bank everything as float32
        recs = [(re.astype(np.float32) / 32768.0, im.astype(np.float32)
                 / 32768.0) if re.dtype == np.int16 else (re, im)
                for re, im in recs]

    writers = []
    for i, path in enumerate(args.inputs):
        base = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.out_dir, f"frames_{i}_{base}.txt")
        writers.append(O.FrameWriter(out,
                                     inverted_mark=mode.framer.inverted_mark))

    plan = BL.default_plan(mode, fs, core=args.core) if args.core else None
    bank = ChannelBank(mode, fs, len(recs), plan=plan,
                       batch_blocks=args.batch_blocks,
                       use_pallas=use_pallas,
                       stage_dtype=np.int16 if int16_ok else np.float32,
                       on_frame=lambda ci, fr: writers[ci].write(fr))
    if int16_ok:
        print("staging: raw int16 PCM planes (device-side /32768)")

    def producer(ci, planes):
        re, im = planes
        for lo in range(0, len(re), args.chunk):
            bank.push(ci, re[lo:lo + args.chunk], im[lo:lo + args.chunk])
        bank.end_of_stream(ci)

    threads = [threading.Thread(target=producer, args=(ci, pl), daemon=True)
               for ci, pl in enumerate(recs)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        bank.pump()
    bank.drain()
    total = 0
    for ci, w in enumerate(writers):
        w.close()
        n = len(bank.frames[ci])
        total += n
        print(f"channel {ci}: {n} frames -> {w.path}")
    print(f"{total} frames across {len(recs)} channels")
    return 0


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()
