"""CLI: realtime-analogue demodulators (twins of `demodPOESP` / `demodARGOSP`).

The reference reads a soundcard fed by SDR# audio loopback
(``POESTIPdemodPortAudio/main.c:164-165``); here the live source is either
stdin (interleaved float32 IQ) or a growing SDR# RAW file followed with
``--follow``.  Flags ``-n`` / ``-c`` match the reference
(``POESTIPdemodPortAudio/main.c:167``); stop with Ctrl-C (the ``kbhit()``
analogue).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

import numpy as np


def run(argv=None, default_mode="poes_tip_realtime", prefix="minorFrames"):
    p = argparse.ArgumentParser(prog=f"demod_{default_mode}")
    p.add_argument("--follow", default=None,
                   help="tail a growing SDR# RAW file (f32 interleaved IQ)")
    p.add_argument("--source", default=None,
                   help="live source: 'stdin' (default), 'audio' or "
                        "'audio:DEVICE' (ALSA capture, the reference's "
                        "soundcard path), 'follow:PATH'")
    p.add_argument("-s", dest="rate_khz", type=float, default=48.0,
                   help="sample rate in kHz (default 48, as the reference)")
    p.add_argument("-n", dest="norm_factor", type=float, default=0.0)
    p.add_argument("-c", dest="chunk_size", type=int, default=0)
    p.add_argument("--mode", default=default_mode)
    p.add_argument("--out", default=None)
    p.add_argument("--fast", action="store_true",
                   help="route through the block-parallel path (a "
                        "1-channel ChannelBank; offline-fast frame parity, "
                        "core+tail output latency) instead of the exact "
                        "sample-sequential chain")
    args = p.parse_args(argv)

    from project_desert_tortoise_tpu.models.registry import get_mode
    from project_desert_tortoise_tpu.models.streaming import (
        FastStreamingDemodulator, StreamingDemodulator, follow_raw_file)
    from project_desert_tortoise_tpu.utils import output as O
    from project_desert_tortoise_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    mode = get_mode(args.mode)
    fs = args.rate_khz * 1000.0
    out_path = args.out or O.default_output_name(prefix)
    writer = O.FrameWriter(out_path, inverted_mark=mode.framer.inverted_mark)

    if args.fast:
        if args.chunk_size:
            print("note: -c has no effect with --fast (the block-parallel "
                  "path consumes in fixed granules; block size is the "
                  "BlockPlan's)", file=sys.stderr)
        sd = FastStreamingDemodulator(mode, fs,
                                      norm_factor=args.norm_factor or None,
                                      on_frame=writer.write)
    else:
        sd = StreamingDemodulator(mode, fs,
                                  chunk_size=args.chunk_size or None,
                                  norm_factor=args.norm_factor or None,
                                  on_frame=writer.write)
    stop = threading.Event()

    def on_sigint(sig, frm):
        stop.set()
        sd.stop()

    signal.signal(signal.SIGINT, on_sigint)

    source = args.source or ("follow:" + args.follow if args.follow
                             else "stdin")
    if source.startswith("follow"):
        path = source.split(":", 1)[1] if ":" in source else args.follow
        if path is None:
            p.error("--source follow requires a path (follow:PATH or --follow)")
        src = threading.Thread(target=follow_raw_file,
                               args=(sd.ring, path, stop), daemon=True)
    elif source.startswith("audio"):
        # the reference's soundcard ingest: 48 kHz stereo capture feeding
        # the ring, overflow tolerated (POESTIPdemodPortAudio/main.c:246-331)
        from project_desert_tortoise_tpu.utils.audio import (AudioCapture,
                                                             audio_feed)
        device = source.split(":", 1)[1] if ":" in source else "default"
        chunk = args.chunk_size or 2400
        # open in the main thread so a missing device fails loudly here
        capture = AudioCapture(device, fs)
        src = threading.Thread(target=audio_feed,
                               args=(sd.ring, stop, device, fs, chunk),
                               kwargs={"capture": capture}, daemon=True)
    else:
        def stdin_feed():
            while not stop.is_set():
                buf = sys.stdin.buffer.read(8192 * 8)
                if not buf:
                    stop.set()
                    sd.stop()
                    return
                data = np.frombuffer(buf, "<f4")
                n = len(data) // 2
                sd.ring.push(data[0::2][:n], data[1::2][:n])
        src = threading.Thread(target=stdin_feed, daemon=True)
    src.start()

    status = threading.Thread(target=_status_loop, args=(sd, stop), daemon=True)
    status.start()
    try:
        sd.run()
    finally:
        writer.close()
        stop.set()
    print(f"\n{len(sd.frames)} frames -> {out_path} "
          f"({sd.overruns} overrun samples)")
    return 0


def _status_loop(sd, stop, period=1.0):
    import time
    while not stop.is_set():
        sys.stderr.write("\r" + sd.status_line(color=True) + "   ")
        time.sleep(period)


def main():
    raise SystemExit(run())


def main_argos():
    raise SystemExit(run(default_mode="argos_realtime", prefix="packets"))


if __name__ == "__main__":
    main()
