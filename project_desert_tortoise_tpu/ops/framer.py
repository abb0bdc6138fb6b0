"""Sync-word framers.

Two implementations of the reference's per-app ``ByteSync.c``:

- `StreamFramer`: exact streaming twin of ``POESTIPdemod/ByteSync.c:16`` /
  ``ARGOSdemod/ByteSync.c:17`` (host-side, numpy): 19/13-bit history window,
  optional inverted-sync matching with complemented decoding, detection
  suppressed while a frame is shifting, fixed prefix bytes, per-frame
  timestamp = time of the last sync bit.  State is explicit and serializable,
  so streams resume at any chunk boundary.

- `frame_extract`: data-parallel formulation for the block fast path: match
  all sync positions at once (window compare), greedily suppress overlapping
  candidates with a tiny scan, then pre-pack byte values with two small
  correlations and gather one value per output byte.  Produces the same frames for in-block syncs.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp


@dataclasses.dataclass
class Frame:
    time: float
    inverted: bool
    data: np.ndarray          # uint8 payload including prefix bytes
    complete: bool = True
    quality_db: float = None  # PLL quality at emission (optional annotation)
    snr_db: float = None      # M2M4 SNR at emission (closes README.md:42 TODO)
    carrier_hz: float = None  # PLL carrier offset at emission (Doppler track)

    def hex_line(self, time_decimals: int = 5,
                 with_quality: bool = False, inverted_mark: bool = True) -> str:
        ts = f"{self.time:.{time_decimals}f}"
        if self.inverted and inverted_mark:
            ts += "i"
        body = " ".join(f"{b:02X}" for b in self.data)
        line = f"{ts} {body}"
        if with_quality and self.quality_db is not None:
            line += f" | q={self.quality_db:.1f}dB snr={self.snr_db:.1f}dB"
            if self.carrier_hz is not None:
                line += f" f={self.carrier_hz:+.1f}Hz"
        return line


class StreamFramer:
    """Exact streaming framer; one instance per channel."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.sync = cfg.sync_bits()          # uint8 0/1
        self.n_sync = len(self.sync)
        self.history = np.zeros(self.n_sync, np.uint8)  # memset '0' equivalent
        self.shifting = False
        self.inverted = False
        self.bit_idx = 0
        self.byte = 0
        self.frame: List[int] = []
        self.frame_time = 0.0
        self.frames: List[Frame] = []

    def process(self, bits: np.ndarray, times: np.ndarray) -> List[Frame]:
        """Consume a chunk of bits (uint8 0/1) with per-bit times; returns
        frames completed or started during this chunk (completed ones only)."""
        cfg = self.cfg
        done_before = len(self.frames)
        for i in range(len(bits)):
            b = int(bits[i])
            if self.shifting:
                eff = (1 - b) if self.inverted else b
                self.byte = ((self.byte << 1) | eff) & 0xFF
                self.bit_idx += 1
                if self.bit_idx > 7:
                    self.frame.append(self.byte)
                    self.byte = 0
                    self.bit_idx = 0
                    if len(self.frame) >= cfg.frame_bytes - cfg.data_start_byte + len(cfg.prefix_bytes):
                        self._finish(complete=True)

            self.history = np.roll(self.history, -1)
            self.history[-1] = b

            if not self.shifting:
                if np.array_equal(self.history, self.sync):
                    self._start(float(times[i]), inverted=False)
                elif cfg.detect_inverted and np.array_equal(self.history, 1 - self.sync):
                    self._start(float(times[i]), inverted=True)
        return self.frames[done_before:]

    def _start(self, t: float, inverted: bool):
        cfg = self.cfg
        self.shifting = True
        self.inverted = inverted
        self.frame_time = t
        self.frame = list(cfg.prefix_bytes)
        self.byte = 0
        self.bit_idx = cfg.first_bit_index

    def _finish(self, complete: bool):
        self.frames.append(Frame(self.frame_time, self.inverted,
                                 np.array(self.frame, np.uint8), complete))
        self.shifting = False
        self.frame = []

    def flush(self) -> Optional[Frame]:
        """At end of stream: surface a partial frame, if any (the reference
        leaves it as an unterminated output line)."""
        if self.shifting and self.frame:
            self._finish(complete=False)
            return self.frames[-1]
        return None


class FrameBatch(NamedTuple):
    """Fixed-capacity frame output of the data-parallel framer."""
    times: jnp.ndarray       # (..., cap)
    inverted: jnp.ndarray    # (..., cap) bool
    data: jnp.ndarray        # (..., cap, frame_bytes_out) uint8
    count: jnp.ndarray       # (...,)


def frame_extract(bits, times, n_bits, cfg, max_frames: int):
    """Data-parallel frame extraction over a bit block.

    bits: (..., nb) uint8 0/1; times: (..., nb); n_bits: valid count.
    Frames whose payload would run past n_bits are dropped (the block driver
    provides a tail halo so real frames never do).
    """
    sync = jnp.asarray(cfg.sync_bits())
    n_sync = len(cfg.sync_word)
    payload = cfg.payload_bits
    nb = bits.shape[-1]

    bipolar = bits.astype(jnp.int32) * 2 - 1
    pat = (sync.astype(jnp.int32) * 2 - 1)
    # correlation: windows ending at i; position i = last sync bit
    corr = _corr_last(bipolar, pat)
    pos_ids = jnp.broadcast_to(jnp.arange(nb), bits.shape)
    in_range = (pos_ids >= n_sync - 1) & (pos_ids < jnp.asarray(n_bits)[..., None])
    match_n = (corr == n_sync) & in_range
    match_i = (corr == -n_sync) & in_range if cfg.detect_inverted else jnp.zeros_like(match_n)
    match = match_n | match_i

    # Greedy suppression: a sync inside a shifting frame is ignored (after a
    # sync at i the frame's last bit is i + payload; detection re-arms on
    # that bit, ByteSync.c processes the shift before the sync compare).
    #
    # Windowed formulation: with window length == the suppression span
    # (payload bits), an accepted sync suppresses the remainder of its own
    # window, so each window accepts AT MOST the first match at or past the
    # carried re-arm position — a scan over nb/payload windows instead of nb
    # bits (a per-bit scan dominated the extract cost).
    nw = -(-nb // payload)
    pad = nw * payload - nb
    m_w = jnp.moveaxis(
        jnp.pad(match, [(0, 0)] * (match.ndim - 1) + [(0, pad)])
        .reshape(bits.shape[:-1] + (nw, payload)), -2, 0)
    rel = jnp.arange(payload)

    def suppress_w(carry_end, inp):
        m_row, base = inp                      # m_row: (..., payload)
        pos = base + rel
        ok_row = m_row & (pos >= carry_end[..., None])
        has = jnp.any(ok_row, axis=-1)
        first_rel = jnp.argmax(ok_row, axis=-1)
        accept = ok_row & (rel == first_rel[..., None])
        # int32 carry also under jax_enable_x64 (argmax is int64 there)
        carry_end = jnp.where(has, (base + first_rel + payload)
                              .astype(carry_end.dtype), carry_end)
        return carry_end, accept

    _, acc_w = jax.lax.scan(
        suppress_w, jnp.zeros(bits.shape[:-1], jnp.int32),
        (m_w, jnp.arange(nw) * payload))
    accepted = jnp.moveaxis(acc_w, 0, -2).reshape(
        bits.shape[:-1] + (nw * payload,))[..., :nb]

    # complete frames only: payload must fit in the valid region
    fits = pos_ids + payload < jnp.asarray(n_bits)[..., None]
    accepted = accepted & fits

    # compress accepted positions into frame slots: the first max_frames
    # accepted positions per lane == top_k of (-pos | -BIG), cheaper than
    # an XLA scatter
    big = jnp.int32(nb + 1)
    keyed = jnp.where(accepted, -pos_ids, -big)
    topv, topi = jax.lax.top_k(keyed, max_frames)
    got = topv != -big
    sync_pos = jnp.where(got, -topv, 0)
    inv = jnp.take_along_axis(match_i, jnp.where(got, topi, 0), axis=-1) & got
    count = jnp.sum(accepted.astype(jnp.int32), axis=-1)

    f_times = jnp.take_along_axis(times, sync_pos, axis=-1)

    # Payload extraction.  Gathering all `payload` bits per candidate frame
    # (max_frames x 832 indices per lane) is gather-heavy.  Instead,
    # pre-pack BYTE values
    # at every bit offset with two small correlations, then gather one value
    # per output byte (8x fewer indices):
    #   byteval[i]  = sum_b bits[i+b] * 2^(7-b)          (8-tap conv)
    #   firstval[i] = sum_b bits[i+b] * 2^(fb-1-b)       (fb-tap conv)
    # An inverted frame's complemented bits become (2^w - 1) - value.
    first_bits = 8 - cfg.first_bit_index
    n_data = cfg.frame_bytes - cfg.data_start_byte
    byteval = _corr_first(bits, 2 ** np.arange(7, -1, -1))
    firstval = _corr_first(bits, 2 ** np.arange(first_bits - 1, -1, -1))

    start = sync_pos + 1                                   # first payload bit
    first = jnp.take_along_axis(firstval, jnp.clip(start, 0, nb - 1), axis=-1)
    first = jnp.where(inv, (2 ** first_bits - 1) - first, first)
    bidx = (start[..., None] + first_bits
            + 8 * jnp.arange(n_data - 1))                  # (..., F, n_data-1)
    rest = jnp.take_along_axis(
        byteval, jnp.clip(bidx, 0, nb - 1).reshape(bits.shape[:-1] + (-1,)),
        axis=-1).reshape(bidx.shape)
    rest = jnp.where(inv[..., None], 255 - rest, rest)

    parts = [first[..., None].astype(jnp.uint8), rest.astype(jnp.uint8)]
    if cfg.prefix_bytes:
        parts.insert(0, jnp.broadcast_to(
            jnp.asarray(cfg.prefix_bytes, jnp.uint8),
            first.shape + (len(cfg.prefix_bytes),)))
    data = jnp.concatenate(parts, axis=-1)
    return FrameBatch(times=f_times, inverted=inv, data=data, count=count)


def stitch_frames(fb: FrameBatch, bounds, cap: int, chan=None):
    """Device-side frame stitching across a batch of time blocks.

    Replaces the host per-frame Python loops: keeps frames whose sync time
    falls inside their block's core interval ``[bounds[b,0], bounds[b,1])``
    (exact, dedup-free — cores tile the recording and sync times are values
    of the shared time axis), then compacts the survivors of ALL blocks into
    one time-sorted packed array.

    fb: FrameBatch over a flat block axis — times/inverted (B, F),
    data (B, F, nbytes), count (B,).  bounds: (B, 2).
    Returns (times (cap,), inverted (cap,), data (cap, nbytes), n) with the
    first ``n`` entries valid, in stream (time) order.  When ``chan`` (B,)
    channel ids are given the batch may mix channels: the sort is
    (channel, time) and a fifth array of per-frame channel ids is returned.
    """
    times = fb.times
    B, F = times.shape
    valid = jnp.arange(F)[None, :] < fb.count[:, None]
    b = jnp.asarray(bounds, times.dtype)
    keep = valid & (times >= b[:, :1]) & (times < b[:, 1:2])
    tflat = jnp.where(keep, times, jnp.inf).reshape(-1)
    if chan is None:
        order = jnp.argsort(tflat)[:cap]
    else:
        cflat = jnp.broadcast_to(jnp.asarray(chan, jnp.int32)[:, None],
                                 (B, F)).reshape(-1)
        cflat = jnp.where(jnp.isinf(tflat), jnp.iinfo(jnp.int32).max, cflat)
        order = jnp.lexsort((tflat, cflat))[:cap]
    n = jnp.minimum(jnp.sum(keep.astype(jnp.int32)), cap)
    data = fb.data.reshape((B * F,) + fb.data.shape[2:])
    out = (tflat[order], fb.inverted.reshape(-1)[order], data[order], n)
    if chan is not None:
        out = out + (cflat[order],)
    return out


def _corr_first(x, weights):
    """out[i] = sum_k weights[k] * x[i + k] — window STARTING at i
    (zero-padded past the end).  Returns int32."""
    p = len(weights)
    batch = x.shape[:-1]
    lhs = x.reshape((-1, 1, x.shape[-1])).astype(jnp.float32)
    rhs = np.asarray(weights, np.float32).reshape(1, 1, p)
    # TF32 is exact here: 0/1 bits times powers of two, integer sums far
    # below 2^24
    y = jax.lax.conv_general_dilated(
        lhs, rhs, (1,), [(0, p - 1)], dimension_numbers=("NCW", "IOW", "NCW"))
    return jnp.round(y).astype(jnp.int32).reshape(batch + (x.shape[-1],))


def _corr_last(bipolar, pat):
    """corr[i] = sum_k pat[k] * x[i - (P-1) + k] — window ENDING at i."""
    p = len(pat)
    batch = bipolar.shape[:-1]
    lhs = bipolar.reshape((-1, 1, bipolar.shape[-1])).astype(jnp.float32)
    rhs = pat.reshape((1, 1, p)).astype(jnp.float32)
    # TF32 is exact here: +-1 samples times +-1 pattern, integer sums
    y = jax.lax.conv_general_dilated(
        lhs, rhs, (1,), [(p - 1, 0)], dimension_numbers=("NCW", "IOW", "NCW"))
    return jnp.round(y).astype(jnp.int32).reshape(batch + (bipolar.shape[-1],))


