"""Batched multi-channel streaming serving — the fast path for realtime.

The reference realtime apps are one process per channel, one sample at a
time (``POESTIPdemodPortAudio/main.c:324-401``).  The serving configuration
this framework targets is hundreds of satellite channels per card: each
channel's live stream accumulates in a host buffer, and whenever enough
samples exist to cut finished time blocks (core + relock halos, see
``parallel/blocked.py``), blocks from ALL channels are batched into one
device dispatch through the same demod path the offline fast mode uses
(the fused Pallas kernel on a GPU, XLA scans on the CPU), with
channel-aware frame stitching.

Latency model: a block covering core interval [k*core, (k+1)*core) is cut
once (k+1)*core + tail samples have arrived, so end-to-end latency is
bounded by core + tail samples (~2.3 s at the POES default plan; shrink
``core`` for lower latency at some throughput cost) plus the batching wait
(``pump`` dispatches whatever is ready — it never waits for a full batch).

Parity contract: same frames as ``blocked.demodulate_many`` over the same
recordings (tests/test_serving.py), which itself holds frame-level parity
with the C oracle.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np
import jax.numpy as jnp

from project_desert_tortoise_tpu import chain as chain_lib
from project_desert_tortoise_tpu.ops import agc as agc_ops
from project_desert_tortoise_tpu.ops.framer import Frame
from project_desert_tortoise_tpu.parallel import blocked as BL


class _Channel:
    """Per-channel sample/time history between pumps."""

    def __init__(self, dt, ts, sdt):
        self.re = np.zeros(0, sdt)
        self.im = np.zeros(0, sdt)
        # t_ext[i] = reference accumulated-f32 time of sample (base + i);
        # kept one entry LONGER than the sample buffers (the time a next
        # sample would get), so interpolating modes can stage t[i+1]
        self.t_ext = np.array([ts], dt)
        self.base = 0          # absolute index of re[0]
        self.next_block = 0    # next core index to emit
        self.ended = False
        self.count = 0         # absolute samples received


class ChannelBank:
    """Multi-channel streaming demodulator with batched device dispatch.

    push() is thread-safe per channel; pump() runs the device work and
    distributes frames (call from one consumer thread / event loop).
    """

    def __init__(self, mode_cfg, fs: float, n_channels: int,
                 plan: Optional[BL.BlockPlan] = None,
                 batch_blocks: int = 128,
                 window: int = 4096, use_pallas=None,
                 norm_factor: Optional[float] = None,
                 on_frame: Optional[Callable[[int, Frame], None]] = None,
                 dtype=np.float32, pad_batches: bool = True,
                 stage_dtype=None):
        self.cfg = mode_cfg
        self.fs = float(fs)
        self.dt = np.dtype(dtype)
        # stage_dtype=np.int16: bank and stage RAW PCM planes, converting
        # on device with the exact /32768 of wave.c:117 — halves the
        # staged bytes per channel, which is what bounds channel capacity
        # on host-bandwidth-limited links (VERDICT r4 item 2; the
        # reference realtime app this displaces reads 16-bit PCM,
        # POESTIPdemodPortAudio/main.c:324-401).  Frame-identical to
        # float staging for PCM-sourced streams (test_serving).
        self.sdt = np.dtype(stage_dtype or dtype)
        if self.sdt not in (np.dtype(np.int16), self.dt):
            raise ValueError(f"stage_dtype must be int16 or {self.dt}")
        self.params = chain_lib.make_params(mode_cfg, fs, quirks=False)
        self.plan = plan or BL.default_plan(mode_cfg, fs)
        self.batch_blocks = batch_blocks
        # pad partial batches to batch_blocks with silent blocks (inf
        # bounds -> no frames survive stitching): every dispatch reuses ONE
        # compiled executable instead of recompiling per novel ready-block
        # count — a multi-second latency spike per new batch size otherwise
        self.pad_batches = pad_batches
        self.window = window
        if use_pallas is None:
            use_pallas = BL.default_use_pallas()
        self.use_pallas = use_pallas
        self.on_frame = on_frame
        self.norm = norm_factor
        self._ts = self.dt.type(1.0) / self.dt.type(fs)
        self._lock = threading.Lock()
        self.channels = [_Channel(self.dt, self._ts, self.sdt)
                         for _ in range(n_channels)]
        self.frames: List[List[Frame]] = [[] for _ in range(n_channels)]
        self._shift = BL.time_shift(self.params)
        self._pending = None   # in-flight stitched batch (double buffering)

    # ---------------- producers ----------------

    def _to_stage(self, x):
        x = np.asarray(x)
        if x.dtype == self.sdt:
            return x
        if self.sdt == np.int16:
            # exact for PCM-derived floats (x = int16/32768); quantizes
            # anything else — push int16 directly for non-PCM sources
            return np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                           -32768, 32767).astype(np.int16)
        return x.astype(self.sdt) if x.dtype != np.int16 else \
            x.astype(self.sdt) / self.sdt.type(32768)

    def _chunk_iq(self, c: _Channel, n: int):
        """Float iq view of a channel's first n banked samples (norm probe)."""
        re, im = c.re[:n], c.im[:n]
        if self.sdt == np.int16:
            s = self.dt.type(1.0) / self.dt.type(32768)
            return re.astype(self.dt) * s + 1j * (im.astype(self.dt) * s)
        return re + 1j * im

    def push(self, ch: int, re, im):
        """Append samples to a channel (producer side).  int16 input is
        banked raw when stage_dtype=int16 (the zero-copy PCM path)."""
        c = self.channels[ch]
        re = self._to_stage(re)
        im = self._to_stage(im)
        n = len(re)
        if n == 0:
            return
        # continue the accumulated f32 timebase: t_ext already holds the
        # time of the first new sample; extend by n more accumulated steps
        steps = np.full(n, self._ts, self.dt)
        steps[0] = c.t_ext[-1] + self._ts
        ext = np.add.accumulate(steps, dtype=self.dt)
        with self._lock:
            c.re = np.concatenate([c.re, re])
            c.im = np.concatenate([c.im, im])
            c.t_ext = np.concatenate([c.t_ext, ext])
            c.count += n
            if self.norm is None and ch == 0 and \
                    c.count >= self.cfg.chunk_size:
                # same probe demodulate_many uses: channel 0's first chunk
                # (the parity contract pins WHICH samples feed the probe;
                # pump() holds dispatch until this has run)
                self.norm = agc_ops.static_gain(
                    self._chunk_iq(c, self.cfg.chunk_size),
                    self.cfg.static_gain_level, self.dt)

    def end_of_stream(self, ch: int):
        self.channels[ch].ended = True

    # ---------------- consumer ----------------

    def _ready_blocks(self, c: _Channel):
        """Core indices whose [lo-head, lo+core+tail) window is complete
        (or the stream ended)."""
        out = []
        b = c.next_block
        while True:
            need = (b + 1) * self.plan.core + self.plan.tail
            if c.count >= need or (c.ended and c.count > b * self.plan.core):
                out.append(b)
                b += 1
            else:
                break
        return out

    def _stage(self, items):
        """items: list of (ch, block). Returns staged host batch arrays,
        padded to batch_blocks rows (silent blocks, empty bounds) so the
        dispatch shape is constant, the block-local core bounds, and per
        row its channel, that channel's time axis, and the index in it of
        the row's first sample (BL.frame_times)."""
        bn = self.batch_blocks if (self.pad_batches
                                   and len(items) < self.batch_blocks) \
            else len(items)
        P = self.plan
        brs = np.zeros((bn, P.total), self.sdt)
        bis = np.zeros((bn, P.total), self.sdt)
        bounds = np.zeros((bn, 2))
        chans, axes, los = [], [], []
        for k, (ci, b) in enumerate(items):
            c = self.channels[ci]
            lo_abs, bnd = BL.local_bounds(P, c.count, [b], self._shift)
            lo = int(lo_abs[0]) - c.base            # buffer-relative
            hi = lo + P.total
            avail = len(c.re)
            src_lo, src_hi = max(lo, 0), min(hi, avail)
            d0 = src_lo - lo
            m = src_hi - src_lo
            brs[k, d0:d0 + m] = c.re[src_lo:src_hi]
            bis[k, d0:d0 + m] = c.im[src_lo:src_hi]
            bounds[k] = bnd[0]
            # t_ext[i] = time of sample base+i, held by reference: _trim
            # replaces, never mutates, it
            chans.append(ci)
            axes.append(c.t_ext)
            los.append(lo)
        return brs, bis, bounds, (chans, axes, los)

    def pump(self) -> int:
        """Stage + demodulate every ready block (in batch_blocks batches).

        Returns the number of blocks processed.  Call repeatedly from the
        serving loop; cheap when nothing is ready.  Double-buffered: the
        newest dispatched batch stays in flight (device arrays, not
        fetched) until the next pump, so host staging of the following
        batch overlaps device compute of this one; a no-work pump (and
        drain()'s final iteration) flushes it."""
        with self._lock:
            if self.norm is None:
                # hold blocks queued until the norm probe has run (push()
                # probes channel 0's first chunk, the demodulate_many
                # parity contract; drain() probes at EOS) — dispatching
                # early would demodulate the first blocks with gain 1.0
                # and later ones with the probed gain.  Backstop: if
                # channel 0 stays silent (dead antenna) while another
                # channel has banked several blocks of samples, probe from
                # the first full channel instead of growing history
                # without bound — the deviation only engages when the
                # parity-pinned probe source demonstrably isn't coming.
                backlog = max((len(c.re) for c in self.channels),
                              default=0)
                if backlog > self.plan.total + 8 * self.plan.core:
                    for c in self.channels:
                        if c.count >= self.cfg.chunk_size:
                            self.norm = agc_ops.static_gain(
                                self._chunk_iq(c, self.cfg.chunk_size),
                                self.cfg.static_gain_level, self.dt)
                            break
            if self.norm is None:
                work = []
            else:
                work = [(ci, b) for ci, c in enumerate(self.channels)
                        for b in self._ready_blocks(c)]
            for ci, b in work:
                self.channels[ci].next_block = \
                    max(self.channels[ci].next_block, b + 1)
            staged = []
            for w0 in range(0, len(work), self.batch_blocks):
                staged.append(self._stage(work[w0:w0 + self.batch_blocks]))
            self._trim()
        if staged:
            dispatched = [self._dispatch(*b) for b in staged]
            if self._pending is not None:
                self._collect(self._pending)
            for st in dispatched[:-1]:
                self._collect(st)
            self._pending = dispatched[-1]
        elif self._pending is not None:
            self._collect(self._pending)
            self._pending = None
        return len(work)

    def _dispatch(self, brs, bis, bounds, rows):
        """Stage to device + launch demod; returns un-fetched outputs."""
        total = brs.shape[1]
        jre, jim = jnp.asarray(brs), jnp.asarray(bis)
        fest = BL.coarse_carrier_est(jre, jim, self.fs,
                                     self.cfg.gardner.baud / 2.0)
        stitched = BL.demod_frames(
            self.params, total, self.cfg.framer, self.plan.max_frames,
            self.fs, self.window, self.use_pallas, jre, jim, fest,
            float(self.norm), jnp.asarray(bounds, self.dt))
        return stitched, rows

    def _collect(self, dispatched):
        stitched, (chans, axes, los) = dispatched
        for r, fr in BL.frame_times(stitched, axes, los, self._shift):
            ci = chans[r]
            self.frames[ci].append(fr)
            if self.on_frame:
                self.on_frame(ci, fr)

    def _trim(self):
        """Drop history no future block can touch (bounded memory)."""
        for c in self.channels:
            keep_from = c.next_block * self.plan.core - self.plan.head
            drop = keep_from - c.base
            if drop >= self.plan.core:        # amortize the copies
                c.re = c.re[drop:]
                c.im = c.im[drop:]
                c.t_ext = c.t_ext[drop:]
                c.base += drop

    def drain(self) -> int:
        """End-of-stream: process every remaining partial block."""
        for c in self.channels:
            c.ended = True
        if self.norm is None:
            # EOS with no channel ever filling a chunk: probe the first
            # channel that has any samples (pump() holds work until a norm
            # exists, so this must not stay None when there is data)
            for c in self.channels:
                n = min(len(c.re), self.cfg.chunk_size)
                if n:
                    self.norm = agc_ops.static_gain(
                        self._chunk_iq(c, n),
                        self.cfg.static_gain_level, self.dt)
                    break
        total = 0
        while True:
            n = self.pump()
            total += n
            if n == 0:
                return total
