"""CLI: POES TIP file demodulator (twin of the reference `demodPOES`).

Flags match ``POESTIPdemod/main.c:185-234``: ``-s`` sample rate in kHz (for
RAW input), ``-r`` raw debug taps, ``-n`` static gain override, ``-c`` chunk
size; positional input file.  Extra framework flags: ``--fast`` (block-
parallel path), ``--no-quirks`` (chunk-size-invariant exact mode),
``--out`` explicit output path.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser(prog: str, default_mode: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("infile")
    p.add_argument("-s", dest="sample_rate_khz", type=float, default=0.0,
                   help="sample rate in kHz (required for .raw)")
    p.add_argument("-r", dest="raw_taps", action="store_true",
                   help="dump post-AGC raw debug stream to output.raw")
    p.add_argument("-n", dest="norm_factor", type=float, default=0.0,
                   help="static gain override")
    p.add_argument("-c", dest="chunk_size", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--fast", action="store_true",
                   help="block-parallel path (frame-level parity)")
    p.add_argument("--no-quirks", action="store_true",
                   help="chunk-size-invariant exact mode")
    p.add_argument("--timebase", default="accumulated",
                   choices=["accumulated", "integer"],
                   help="'integer' (implies --no-quirks): exact n*Ts "
                        "timestamps from an int64 sample counter instead "
                        "of the reference's drifting f32 accumulated fold")
    p.add_argument("--mode", default=default_mode)
    p.add_argument("--products", default=None, metavar="DIR",
                   help="also run the telemetry explorer on the decoded "
                        "frames (parity, DCS, HIRS images, SEM/SBUV)")
    return p


def run(argv=None, default_mode="poes_tip", prefix="minorFrames"):
    args = build_parser(f"demod_{default_mode}", default_mode).parse_args(argv)
    from project_desert_tortoise_tpu.models.registry import get_mode
    from project_desert_tortoise_tpu.models.demodulator import DemodSession
    from project_desert_tortoise_tpu.utils import wav as W
    from project_desert_tortoise_tpu.utils import output as O
    from project_desert_tortoise_tpu.utils import metrics as M
    from project_desert_tortoise_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    mode = get_mode(args.mode)
    if mode.np_dtype().itemsize == 8:
        import jax
        jax.config.update("jax_enable_x64", True)

    t0 = time.time()
    if args.infile.lower().endswith(".raw"):
        if args.sample_rate_khz < 1:
            print("Sample Rate (in Khz) must be specified when using RAW files")
            return 1
        if mode.name.startswith("argos"):
            # deliberate divergence (docs/DESIGN.md section 6): the reference
            # ARGOS app rejects RAW input (ARGOSdemod/main.c:237-239); the
            # shared RAW reader is mode-agnostic so we accept it, with notice
            print("note: RAW input for ARGOS is a framework extension "
                  "(the reference demodARGOS accepts wav only)",
                  file=sys.stderr)
        iq, t, fs = W.load_iq_raw(args.infile, args.sample_rate_khz * 1000.0,
                                  mode.np_dtype())
    else:
        iq, t, fs, hdr = W.load_iq_wav(args.infile, mode.np_dtype(),
                                       args.sample_rate_khz)
        print(f"Sample Rate {fs/1000.0:.2f}KHz and {hdr.bits_per_sample} bits "
              f"per sample. Total samples {len(iq)}")

    out_path = args.out or O.default_output_name(prefix)

    if args.fast:
        from project_desert_tortoise_tpu.parallel.blocked import demodulate_blocked
        frames = demodulate_blocked(iq, t, fs, mode,
                                    norm_factor=args.norm_factor or None)
        with O.FrameWriter(out_path, inverted_mark=mode.framer.inverted_mark) as w:
            w.write_all(frames)
        print(f"\n{len(frames)} frames -> {out_path}")
        print(f"That took {time.time()-t0:.2f} seconds!")
        if args.products:
            from project_desert_tortoise_tpu.apps import telemetry_explorer
            telemetry_explorer.run([out_path, "--outdir", args.products])
        return 0

    sess = DemodSession(mode, fs, chunk_size=args.chunk_size or None,
                        norm_factor=args.norm_factor or None,
                        quirks=(not args.no_quirks
                                and args.timebase != "integer"),
                        timebase=args.timebase)
    raw_f = open("output.raw", "wb") if args.raw_taps else None
    sess.raw_tap = raw_f
    if sess.norm_factor is None and len(iq):
        pass  # computed from first chunk inside the session
    with O.FrameWriter(out_path, inverted_mark=mode.framer.inverted_mark) as w:
        n = len(iq)
        ts = mode.np_dtype().type(1.0) / mode.np_dtype().type(fs)
        t_ext = np.concatenate([t, [t[-1] + ts] if n else [ts]])
        chunk = sess.chunk_size
        done = 0
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            frames = sess.process(iq[start:end], t[start:end],
                                  t_ext[start + 1:end + 1].astype(sess.dtype))
            w.write_all(frames)
            done = end
            q = M.quality_db(sess.avg_phase)
            sys.stderr.write("\r" + M.progress_line(
                100.0 * done / max(n, 1), done / 1000.0, float(t[end - 1]),
                sess.total_symbols, sess.total_bits, len(sess.framer.frames), q))
        tail = sess.framer.flush()
        if tail is not None:
            w.write(tail)
        sys.stderr.write("\n")
        if sess.lock_freq_hz is not None:
            print(f"PLL locked at {sess.lock_freq_hz:.2f}Hz")
    if raw_f is not None:
        raw_f.close()
    print(f"That took {time.time()-t0:.2f} seconds!")
    if args.products:
        from project_desert_tortoise_tpu.apps import telemetry_explorer
        telemetry_explorer.run([out_path, "--outdir", args.products])
    return 0


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()
