"""Streaming (realtime-analogue) demodulation sessions.

Twin of the reference PortAudio apps (``POESTIPdemodPortAudio/main.c``,
``ARGOSdemodPortAudio/main.c``): a producer thread feeds interleaved IQ into
the native lock-free ring (the PortAudio-callback analogue,
``native/wavio.cpp``); the consumer loop pulls fixed chunks, advances the
jitted chain, and emits frames + console telemetry until stopped (the
``kbhit()`` analogue is a `stop()` event).  Overruns are tolerated and counted
(``POESTIPdemodPortAudio/main.c:327-331``).

Sources provided: live ring push (external producer), file-follow (tail a
growing RAW file, SDR# "RAW output" workflow, ``main.c:164-165``), and replay
(throttled playback of a recording for soak tests).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from project_desert_tortoise_tpu.models.demodulator import DemodSession
from project_desert_tortoise_tpu.ops.framer import Frame
from project_desert_tortoise_tpu.utils import metrics


class StreamingDemodulator:
    """Pull chunks from an IQ ring and demodulate continuously."""

    def __init__(self, mode_cfg, fs: float, ring=None,
                 chunk_size: Optional[int] = None,
                 norm_factor: Optional[float] = None,
                 on_frame: Optional[Callable[[Frame], None]] = None,
                 ring_capacity: int = 1 << 18):
        if ring is None:
            from project_desert_tortoise_tpu.native.wavio import IQRing
            ring = IQRing(ring_capacity)
        self.ring = ring
        self.fs = float(fs)
        self.session = DemodSession(mode_cfg, fs, chunk_size=chunk_size,
                                    norm_factor=norm_factor, quirks=False)
        self.chunk = self.session.chunk_size
        self.on_frame = on_frame
        self.frames: List[Frame] = []
        self._stop = threading.Event()
        self._sample_pos = 0
        self._dt = mode_cfg.np_dtype()
        self._ts = self._dt.type(1.0) / self._dt.type(fs)
        self._t_last = self._dt.type(0.0)

    def stop(self):
        self._stop.set()

    @property
    def overruns(self) -> int:
        return getattr(self.ring, "overruns", 0)

    def _times_for(self, n: int):
        # continue the reference's accumulated f32 timebase across chunks
        steps = np.full(n + 1, self._ts, self._dt)
        steps[0] = self._t_last + self._ts
        acc = np.add.accumulate(steps, dtype=self._dt)
        t = acc[:n]
        t_next = acc[1:n + 1]
        self._t_last = t[-1] if n else self._t_last
        return t, t_next

    def run(self, poll_s: float = 0.02, max_chunks: Optional[int] = None):
        """Consume until stop() (or max_chunks); returns completed frames."""
        done = 0
        while True:
            if max_chunks is not None and done >= max_chunks:
                break
            if self.ring.available < self.chunk:
                # drain-then-stop: honor stop() only once the ring runs dry
                if self._stop.is_set():
                    break
                time.sleep(poll_s)
                continue
            re, im = self.ring.pop(self.chunk)
            iq = re.astype(self._dt) + 1j * im.astype(self._dt)
            t, t_next = self._times_for(len(re))
            new = self.session.process(iq, t, t_next)
            for f in new:
                self.frames.append(f)
                if self.on_frame:
                    self.on_frame(f)
            self._sample_pos += len(re)
            done += 1
        tail = self.session.framer.flush()
        if tail is not None:
            self.frames.append(tail)
            if self.on_frame:
                self.on_frame(tail)
        return self.frames

    def status_line(self, color=False) -> str:
        q = metrics.quality_db(self.session.avg_phase)
        return metrics.progress_line(
            0.0, self._sample_pos / 1000.0,
            float(self._t_last), self.session.total_symbols,
            self.session.total_bits, len(self.frames), q, color)


class FastStreamingDemodulator:
    """Ring-fed streaming demodulation through the block-parallel fast path.

    Same surface as :class:`StreamingDemodulator` (``ring`` / ``run`` /
    ``stop`` / ``frames`` / ``status_line``) but backed by a
    :class:`~project_desert_tortoise_tpu.parallel.serving.ChannelBank`, so
    the single-channel realtime CLI rides the same block-parallel device
    path as offline ``--fast`` and the multi-channel server (the fused
    kernel on a GPU, the XLA scans on the CPU: ``use_pallas=None``).

    Latency tradeoff vs the exact streamer: frames for core interval k are
    emitted once (k+1)*core + tail samples have arrived (the serving
    latency model, ``parallel/serving.py``), so output trails the stream by
    up to core + tail samples; frame parity with offline fast mode is exact.
    """

    def __init__(self, mode_cfg, fs: float, ring=None,
                 norm_factor: Optional[float] = None,
                 on_frame: Optional[Callable[[Frame], None]] = None,
                 plan=None, batch_blocks: int = 16,
                 window: int = 4096, use_pallas=None,
                 ring_capacity: int = 1 << 20):
        from project_desert_tortoise_tpu.parallel.serving import ChannelBank
        if ring is None:
            from project_desert_tortoise_tpu.native.wavio import IQRing
            ring = IQRing(ring_capacity)
        self.ring = ring
        self.fs = float(fs)
        self.frames: List[Frame] = []
        self._user_on_frame = on_frame
        self.bank = ChannelBank(
            mode_cfg, fs, 1, plan=plan, batch_blocks=batch_blocks,
            window=window, use_pallas=use_pallas, norm_factor=norm_factor,
            on_frame=self._collect)
        self._stop = threading.Event()
        self._sample_pos = 0
        self._granule = 8192

    def _collect(self, ci: int, f: Frame):
        self.frames.append(f)
        if self._user_on_frame:
            self._user_on_frame(f)

    def stop(self):
        self._stop.set()

    @property
    def overruns(self) -> int:
        return getattr(self.ring, "overruns", 0)

    def run(self, poll_s: float = 0.02):
        """Consume until stop(); drains the ring, then the bank."""
        while True:
            n = min(self.ring.available, self._granule)
            if n == 0:
                if self._stop.is_set():
                    break
                time.sleep(poll_s)
                continue
            re, im = self.ring.pop(n)
            self.bank.push(0, re, im)
            self._sample_pos += n
            self.bank.pump()
        self.bank.end_of_stream(0)
        self.bank.drain()
        return self.frames

    def status_line(self, color=False) -> str:
        # symbol/bit counters live on-device in the fast path; report the
        # stream position and frame count (the operator-facing signals)
        return metrics.progress_line(
            0.0, self._sample_pos / 1000.0, self._sample_pos / self.fs,
            0, 0, len(self.frames), float("nan"), color)


def feed_array(ring, iq: np.ndarray, chunk: int = 4096,
               realtime_fs: Optional[float] = None, stop=None):
    """Producer helper: push a recording into the ring, optionally throttled
    to real time (soak/replay source)."""
    re = np.ascontiguousarray(np.real(iq), np.float32)
    im = np.ascontiguousarray(np.imag(iq), np.float32)
    for lo in range(0, len(re), chunk):
        if stop is not None and stop.is_set():
            return
        hi = min(lo + chunk, len(re))
        ring.push(re[lo:hi], im[lo:hi])
        if realtime_fs:
            time.sleep((hi - lo) / realtime_fs)


def follow_raw_file(ring, path: str, stop, poll_s: float = 0.05,
                    chunk_frames: int = 8192):
    """Producer: tail a growing SDR# RAW file (interleaved f32 IQ) into the
    ring — the zero-audio-loopback version of the reference's soundcard
    workflow."""
    pos = 0
    frame_bytes = 8
    while not stop.is_set():
        try:
            size = max(0, (os_path_size(path) - pos) // frame_bytes)
        except OSError:
            time.sleep(poll_s)
            continue
        if size == 0:
            time.sleep(poll_s)
            continue
        n = min(size, chunk_frames)
        data = np.fromfile(path, "<f4", count=2 * n, offset=pos)
        if len(data) < 2:
            time.sleep(poll_s)
            continue
        n = len(data) // 2
        ring.push(data[0::2][:n], data[1::2][:n])
        pos += n * frame_bytes


def os_path_size(path: str) -> int:
    import os
    return os.path.getsize(path)
