"""Block-parallel demodulation — the fast path.

The reference is a single sequential stream: every sample passes through four
feedback loops one at a time.  Here the recording is cut into overlapping
time blocks and ALL blocks are demodulated simultaneously:

    [ head halo | core | tail halo ]  x  B blocks  (+ channel axis)

- head halo: warm-up region. Each block's PLL is initialized from a coarse
  FFT carrier estimate of its own halo (the BPSK squared-carrier line), so it
  starts in the tracking regime and settles within a few thousand samples —
  instead of replaying the reference's acquisition sweep per block.  AGC,
  Gardner, and Manchester phase all converge inside the halo too.
- tail halo: frame-completion region, long enough that any sync word whose
  last bit lands inside the core finishes its payload inside the block.
- stitching: keep frames whose sync position falls inside the block's core
  interval — exact and dedup-free, because block cores tile the recording
  (``local_bounds``).

Every stage is the SAME scan/conv code as the exact chain, vmapped over the
block axis: one scan step advances every independent block lane at once.  On
a GPU the fused kernel (ops/pallas/fused_kernel.py) runs the same chain with
one lane per thread and the whole time loop inside the kernel.  The 180-degree
BPSK phase ambiguity of per-block relock is absorbed by the framer's
inverted-sync path (``POESTIPdemod/ByteSync.c:112``).

On the device every block's time axis is its own sample positions (no time
plane is staged).  The host gives each stitched frame the time of its sample
in the reference's float32 *accumulated* timebase (``frame_times``), so
fast-mode frame timestamps match the exact chain bit-for-bit, including its
long-recording rounding behavior — which is why stitching cannot use times.

Correctness contract: frame-level parity with the exact chain (sync-rate
bound, BASELINE.md), validated in tests/test_blocked.py.
"""

from __future__ import annotations

import functools
import itertools
import os
from typing import List, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from project_desert_tortoise_tpu import chain as chain_lib
from project_desert_tortoise_tpu.ops import agc as agc_ops
from project_desert_tortoise_tpu.ops import clock as clock_ops
from project_desert_tortoise_tpu.ops import fir as fir_ops
from project_desert_tortoise_tpu.ops import framer as framer_ops
from project_desert_tortoise_tpu.ops import manchester as man_ops
from project_desert_tortoise_tpu.ops import pll as pll_ops
from project_desert_tortoise_tpu.ops.framer import Frame


# host->device upload part count for the pipelined flat path (read once at
# import): each staged plane is split across a small pool of concurrent
# device_put calls.  Its effect on a PCIe-attached card is not measured.
_UPLOAD_STREAMS = max(1, int(os.environ.get("PDT_UPLOAD_STREAMS", "4")))


def _device_put_streamed(arr, k: int = 0):
    """device_put `arr` as k concurrent contiguous parts, reassembled on
    device with one concatenate (an HBM copy, negligible next to the
    transfer).  Exact: the same bytes land in the same order."""
    k = k or _UPLOAD_STREAMS
    n = arr.shape[0]
    if k <= 1 or n < 4 * k:
        return jnp.asarray(arr)
    import concurrent.futures as cf
    bounds = [n * i // k for i in range(k + 1)]
    parts = [arr[bounds[i]:bounds[i + 1]] for i in range(k)]
    with cf.ThreadPoolExecutor(k) as ex:
        devs = list(ex.map(jax.device_put, parts))
    return jnp.concatenate(devs, axis=0)


class BlockPlan(NamedTuple):
    core: int          # samples per block core
    head: int          # warm-up halo samples
    tail: int          # frame-completion halo samples
    max_frames: int    # frame capacity per block

    @property
    def total(self) -> int:
        return self.head + self.core + self.tail


def default_plan(mode_cfg, fs: float, core: Optional[int] = None,
                 align: int = 4096) -> BlockPlan:
    fr = mode_cfg.framer
    bit_rate = mode_cfg.gardner.baud / 2.0
    frame_s = (fr.payload_bits + fr.sync_len + 8) / bit_rate
    up = lambda v: -(-int(v) // align) * align
    tail = up(np.ceil(frame_s * fs) + 256)
    head = up(0.25 * fs)               # PLL/AGC/timing settle (>= 0.25 s)
    core = up(core or 2.0 * fs)        # 2 s default
    # all 4096-aligned so the windowed scans divide plan.total evenly
    max_frames = int(np.ceil((core + tail) / fs / (fr.payload_bits / bit_rate))) + 4
    return BlockPlan(core=core, head=head, tail=tail, max_frames=max_frames)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def coarse_carrier_est(zre, zim, fs: float, line_spacing_hz: float = 8320.0,
                       nfft: int = 8192):
    """Per-block data-aided carrier estimate from the BPSK squared spectrum.

    Squared Manchester BPSK carries spectral lines at 2*f0 + k*bitrate (the
    bit clock guarantees transitions), with magnitudes symmetric in k.  So:

    1. circular power centroid of the (noise-floor-subtracted, squared)
       line spectrum -> unbiased estimate of 2*f0;
    2. strongest line within half a line spacing of the centroid -> the k=0
       carrier line, at FFT-bin accuracy.

    Welch-averaged over all length-nfft segments of the block, so partial
    signal occupancy (pass start/end) is fine.  Returns Hz.
    """
    if zre.dtype == jnp.int16:      # int16-staged PCM planes (wave.c:117)
        s = jnp.float32(1.0 / 32768.0)
        zre = zre.astype(jnp.float32) * s
        zim = zim.astype(jnp.float32) * s
    n = zre.shape[-1]
    k = max(n // nfft, 1)
    re = zre[..., :k * nfft].reshape(zre.shape[:-1] + (k, nfft))
    im = zim[..., :k * nfft].reshape(zim.shape[:-1] + (k, nfft))
    if k > 4:   # cap the Welch average at 4 spread segments (27 -> ~8 ms)
        stride = k // 4
        re = re[..., ::stride, :][..., :4, :]
        im = im[..., ::stride, :][..., :4, :]
    z = re + 1j * im
    freqs = jnp.fft.fftfreq(nfft, 1.0 / fs)

    sq = jnp.sum(jnp.abs(jnp.fft.fft(z * z, axis=-1)), axis=-2)
    # noise floor via mean (a median costs a full sort; the mean is biased
    # high by the signal lines, which only sharpens the max(.,0) floor cut
    # for the centroid weights)
    w = jnp.maximum(sq - jnp.mean(sq, axis=-1, keepdims=True), 0.0) ** 2
    ph = jnp.exp(1j * (2 * np.pi / fs) * freqs)
    cen = jnp.angle(jnp.sum(w * ph, axis=-1)) * (fs / (2 * np.pi))

    d = jnp.mod(freqs - cen[..., None] + fs / 2, fs) - fs / 2
    masked = jnp.where(jnp.abs(d) < line_spacing_hz / 2.0, sq, 0.0)
    f0 = jnp.take(freqs, jnp.argmax(masked, axis=-1)) / 2.0
    return f0.astype(zre.dtype)


def _use_interpret() -> bool:
    """True when arrays land on the CPU (the default device, else the
    default backend): Pallas kernels then run through the interpreter.
    Anywhere else they compile for the device, and a failure raises."""
    d = jax.config.jax_default_device
    platform = d.platform if d is not None else jax.default_backend()
    return platform == "cpu"


def default_use_pallas():
    """The fast path's demod for this process's default device: the fused
    kernel on a GPU, the XLA scans on the CPU (where the kernel would only
    interpret)."""
    return False if _use_interpret() else "fused"


def _plan_caps(total: int, params, interp: int):
    n_i = total * interp
    max_syms = int(n_i / params.step_size * 1.02) + 16
    max_bits = max_syms // 2 + 8
    return n_i, max_syms, max_bits


@functools.partial(jax.jit, static_argnums=(0, 1, 4, 7, 8, 9))
def demod_blocks(params: chain_lib.ChainParams, total: int,
                 blocks_re, blocks_im, fs: float, freq_est, norm_gain,
                 window: int = 4096, use_pallas=False, interpret=None):
    """Demodulate (B, total) sample blocks -> compressed per-block bits.

    freq_est: (B,) coarse carrier estimate in Hz.
    window: chunk size of the XLA path's nested scans (total % window == 0
    when set; 0 = monolithic scans, only sensible for small blocks).
    use_pallas: False = XLA windowed scans; "fused" = the whole chain in
    one Pallas kernel (any lane count B); None = default_use_pallas().
    interpret: run the kernel through the Pallas interpreter; None = when
    the arrays land on the CPU.  Callers that know their placement (a
    mesh's devices) pass it.
    Returns (bits, bit_pos, n_bits, avg_phase): bit_pos is the block-local
    position of the input sample each bit was timed at, whose stage time
    is that of sample pos+1 for interpolating modes (LowPassFilter.c:68)
    and of sample pos otherwise (see local_bounds).

    blocks_re/blocks_im may be int16 PCM planes: converted on device with
    the exact /32768 normalization of ``common/wave.c:117`` (bit-identical
    to float staging, half the host->device bytes).
    """
    raw_re, raw_im = blocks_re, blocks_im    # int16 planes go to the fused
    if blocks_re.dtype == jnp.int16:         # kernel unconverted (it scales
        s = jnp.float32(1.0 / 32768.0)       # in-body; XLA DCEs this pass)
        blocks_re = blocks_re.astype(jnp.float32) * s
        blocks_im = blocks_im.astype(jnp.float32) * s
    dt = blocks_re.dtype
    B = blocks_re.shape[0]
    interp = params.interp
    taps = np.asarray(params.taps, dt)
    if window and total % window != 0:
        window = 0  # fall back for odd sizes

    if interpret is None:
        interpret = _use_interpret()
    if use_pallas is None:
        use_pallas = False if interpret else "fused"

    # warm PLL init: tracking bandwidth, frequency from the coarse estimate
    pll_state = pll_ops.init_state(params.pll, dt, (B,))
    pll_state = pll_state._replace(
        freq=(jnp.asarray(2.0 * np.pi / fs, dt) * freq_est),
        locked=jnp.ones((B,), bool),
    )
    if use_pallas == "fused":
        from project_desert_tortoise_tpu.ops.pallas.fused_kernel import (
            fused_demod_pallas as fused_fn)
        gain0 = jnp.full((B,), norm_gain, dt)
        bits_f, btimes_f, emit_f, avg_phase = fused_fn(
            params, pll_state, gain0, (raw_re, raw_im), interpret=interpret)
        # bit emissions are >= ~6 input samples apart (one per 2 Gardner
        # symbols), so a 4-sample chunk holds at most one -> cheap compaction
        max_bits = total // 4 + 8
        bits_c, times_c, n_bits = man_ops.compress_spaced(
            bits_f.astype(jnp.uint8), btimes_f, emit_f, max_bits,
            min_spacing=4)
        return bits_c, times_c, n_bits, avg_phase

    pll_state, soft, locksig = pll_ops.pll_scan(params.pll, pll_state,
                                                (blocks_re, blocks_im),
                                                window=window)
    if params.squelch_position == "after_pll":
        soft = agc_ops.squelch(soft, jnp.abs(locksig),
                               params.squelch_threshold)

    y = fir_ops.fir_interp(soft, taps, interp)
    agc_state = agc_ops.agc_init(norm_gain, dt, (B,))
    agc_state, y = agc_ops.agc_scan(agc_state, y, params.agc_attack,
                                    params.agc_decay,
                                    window=window * interp if window else 0)
    if params.squelch_position == "after_agc":
        # |locksig|: warm-started blocks may settle at the inverted BPSK
        # lock point (projection ~ -1); the 180-degree ambiguity is absorbed
        # by the framer's inverted-sync path, so the squelch indicator must
        # be polarity-invariant here (the exact chain keeps the reference's
        # signed compare — its sweep only ever declares lock on the positive
        # point)
        y = agc_ops.squelch(y, jnp.abs(locksig), params.squelch_threshold)

    pos = jnp.broadcast_to(jnp.arange(total, dtype=dt), (B, total))
    t_out = fir_ops.fir_out_times(pos, interp) if interp > 1 else pos

    n_i = total * interp
    g_state = clock_ops.gardner_init(dt, (B,))
    m_state = man_ops.manchester_init(dt, (B,))
    if window:
        g_state, m_state, bits, bit_times, bit_mask = \
            clock_ops.gardner_manchester_windowed(
                g_state, m_state, y, t_out, jnp.full((B,), n_i),
                params.step_size, params.gardner_err_limit,
                params.gardner_gain, params.resync_threshold,
                window=window * interp)
        max_bits = bits.shape[-1] // 2 + 8
    else:
        _, max_syms, max_bits = _plan_caps(total, params, interp)
        g_state, syms, sym_times, sym_valid, _ = clock_ops.gardner_scan(
            g_state, y, t_out, jnp.full((B,), n_i), params.step_size,
            params.gardner_err_limit, params.gardner_gain, max_syms)
        m_state, bits, bit_times, bit_mask = man_ops.manchester_scan(
            m_state, syms, sym_times, sym_valid, params.resync_threshold)

    bits_c, times_c, n_bits = man_ops.compress_sorted(
        bits, bit_times, bit_mask, max_bits)
    return bits_c, times_c, n_bits, pll_state.avg_phase


@functools.partial(jax.jit, static_argnums=(0, 1))
def extract_frames(framer_cfg, max_frames: int, bits_c, times_c, n_bits):
    return framer_ops.frame_extract(bits_c, times_c, n_bits, framer_cfg,
                                    max_frames)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def extract_stitch(framer_cfg, max_frames: int, cap: int,
                   bits_c, times_c, n_bits, bounds):
    """Frame extraction + device-side stitching on block-local positions
    (bounds from local_bounds) in one jit.

    Returns (positions, inverted, data, n, rows) packed in stream order,
    keyed by block row: the host touches one fetch per batch instead of
    looping over every candidate frame (frame_times)."""
    fb = framer_ops.frame_extract(bits_c, times_c, n_bits, framer_cfg,
                                  max_frames)
    return framer_ops.stitch_frames(fb, bounds, cap,
                                    chan=jnp.arange(bits_c.shape[0]))


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6))
def demod_frames(params: chain_lib.ChainParams, total: int, framer_cfg,
                 max_frames: int, fs: float, window: int, use_pallas,
                 blocks_re, blocks_im, freq_est, norm_gain, bounds):
    """demod_blocks + extract_stitch in ONE dispatch: a single round-trip
    per batch (fusing the framer into the demod graph removes two
    dispatch/fetch latencies per batch)."""
    bits_c, times_c, n_bits, _ = demod_blocks(
        params, total, blocks_re, blocks_im, fs, freq_est, norm_gain,
        window, use_pallas)
    return extract_stitch(framer_cfg, max_frames,
                          blocks_re.shape[0] * max_frames,
                          bits_c, times_c, n_bits, bounds)


def time_shift(params: chain_lib.ChainParams) -> int:
    """Offset from a block-local position to the sample whose stage time it
    carries: interpolating modes time sample i by sample i+1
    (LowPassFilter.c:68); the plain filter leaves the time axis alone."""
    return 1 if params.interp > 1 else 0


def local_bounds(plan: BlockPlan, n: int, blocks, shift: int):
    """Core intervals of ``blocks`` (core indices into a recording of ``n``
    samples) in block-local sample positions, and each block's first
    sample index.

    Frames are stitched on positions, not times: the reference's
    accumulated float32 time axis stops advancing after 2^9 s at 50 ksps
    (its ulp outgrows the sample step), so time intervals cannot tell
    blocks apart on a long pass.  A frame at local position i of the block
    starting at sample lo carries the stage time of sample lo + i + shift
    (``time_shift``); the bounds
    keep exactly the frames whose stage time lies in the block's core."""
    cs = np.asarray(blocks, np.int64) * plan.core
    ce = np.minimum(cs + plan.core, n)
    lo = cs - plan.head
    bounds = np.stack([np.full(len(cs), plan.head - shift),
                       plan.head + (ce - cs) - shift], axis=1)
    return lo, bounds


def frame_times(stitched, axes, lo, shift: int):
    """Fetch a stitched (positions, inverted, data, n, rows) batch and give
    each frame of block row r the stage time ``axes[r][lo[r] + position +
    shift]``: ``axes[r]`` is the row's time axis and ``lo[r]`` the index in
    it of the row's first sample (local_bounds).  Returns (row, Frame)
    pairs in stream order."""
    pos, inv, data, n, rows = (np.asarray(x) for x in stitched)
    out = []
    for j in range(int(n)):
        r = int(rows[j])
        k = int(lo[r]) + int(pos[j]) + shift
        out.append((r, Frame(float(axes[r][k]), bool(inv[j]),
                             data[j].copy(), True)))
    return out


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6, 11))
def demod_frames_flat(params: chain_lib.ChainParams, framer_cfg,
                      plan: BlockPlan, B: int, fs: float, window: int,
                      use_pallas, re_flat, im_flat, norm_gain, bounds,
                      pack_bits: int = 0):
    """Demod of B consecutive blocks from CONTIGUOUS device arrays — one
    upload, one dispatch, one frame fetch.

    Device-side staging: the host uploads the raw sample planes once
    (optionally still int16 straight from the PCM reader — conversion uses
    the exact /32768 normalization of ``common/wave.c:117`` on device,
    halving host->device bytes), and the overlapping [head | core | tail]
    block windows are cut on device: no host staging pass and no halo
    duplication in the transfer.

    re_flat/im_flat: (n,) float32 or int16 planes that START with the
    head region of block 0 (real neighbor samples, or zeros for the stream
    start): block b's window starts at sample b*core; samples past n read
    as zero.  bounds: (B, 2) from local_bounds.  Returns demod_frames'
    stitched (positions, inverted, data, n, rows).

    pack_bits > 0: re_flat/im_flat are (ng, pack_bits) uint32 bit-packed
    PCM planes (ops/bitpack.py) covering ng*32 samples — unpacked on
    device with static shift/masks, then converted exactly like int16
    (frame-identical: the reconstructed int16 values are bit-identical).
    """
    if pack_bits:
        from project_desert_tortoise_tpu.ops import bitpack
        ns = re_flat.shape[0] * bitpack.GROUP
        # unpacked values fit int16 by construction (pack_bits <= 16)
        re_flat = bitpack.unpack_jax(re_flat, pack_bits, ns).astype(jnp.int16)
        im_flat = bitpack.unpack_jax(im_flat, pack_bits, ns).astype(jnp.int16)
    # int16 planes stay int16 through the device-side windowing (half the
    # HBM copy traffic); demod_blocks / coarse_carrier_est apply the exact
    # /32768 conversion downstream (the fused kernel consumes int16
    # rows directly)
    total, core = plan.total, plan.core
    # window k of the padded stream is [k*core, k*core + total); cut all B
    # windows as ceil(total/core) column strips, each a non-overlapping
    # strided reshape at stride core, concatenated — a generic gather with
    # a (B, total) index matrix is far slower than these plain copies.  The
    # strip count handles any core/halo ratio.
    npieces = -(-total // core)
    plen = (npieces - 1) * core + B * core

    def pad_to(x):
        x = x[:plen]                  # samples beyond the last block's
        return jnp.concatenate(       # reach are unused
            [x, jnp.zeros((plen - x.shape[0],), x.dtype)])

    def cut(p):
        strips = []
        for j in range(npieces):
            w = min(core, total - j * core)
            strips.append(
                p[j * core:j * core + B * core].reshape(B, core)[:, :w])
        return jnp.concatenate(strips, axis=1)

    brs = cut(pad_to(re_flat))
    bis = cut(pad_to(im_flat))
    # bit rate from the chain params: step = fs*interp/baud, bits = baud/2
    line_spacing = fs * params.interp / (2.0 * params.step_size)
    fest = coarse_carrier_est(brs, bis, fs, line_spacing)
    return demod_frames(params, total, framer_cfg, plan.max_frames, fs,
                        window, use_pallas, brs, bis, fest, norm_gain,
                        bounds)


def demod_frames_flat_pipelined(params: chain_lib.ChainParams, framer_cfg,
                                plan: BlockPlan, B: int, fs: float,
                                window: int, use_pallas, re16, im16,
                                t_ext, norm_gain, n_slices: int = 4,
                                pack: int = 0) -> List[Frame]:
    """Sliced, transfer/compute-overlapped whole-file demod: the flat
    sample planes are cut into ``n_slices`` contiguous slices of
    B/n_slices blocks each and dispatched in sequence, so the host->device
    upload of slice k+1 rides under the device demod of slice k (the
    reference figure of merit is whole-file wall seconds,
    POESTIPdemod/main.c:500 — on a transfer-bound link the wall collapses
    to max(upload, compute) + one slice latency instead of upload+compute).

    Every slice ships the same [head | Bs*core + tail] window layout: the
    host prepends one zero lead for the stream start and slices overlap by
    head + tail samples (<1% duplication at production block sizes), so one
    compiled ``demod_frames_flat`` serves all slices.

    re16/im16: (n,) int16 (or float32) host planes; t_ext: (n+1,)
    accumulated time axis, read on the host to time the frames.  pack: -1
    = choose the minimal lossless bit width from the data (int16 planes
    only; stays unpacked when 16 bits are genuinely needed), w>0 = pack to
    w bits — cuts the upload bytes by 16/w more.
    Frame-identical for every slice count (test_blocked).
    """
    from project_desert_tortoise_tpu.ops import bitpack

    core, head = plan.core, plan.head
    if n_slices < 1 or B % n_slices != 0:
        raise ValueError(f"B={B} must divide into n_slices={n_slices}")
    Bs = B // n_slices
    span = (Bs - 1) * core + plan.total
    if pack and np.dtype(re16.dtype).kind != "i":
        pack = 0                      # packing is for PCM integer planes
    if pack == -1:
        pack = bitpack.pack_width(re16, im16)
    if pack >= 16:
        pack = 0                      # full-width data: ship int16 as-is
    zlead = np.zeros(head, re16.dtype)
    rr = np.concatenate([zlead, re16])
    ii = np.concatenate([zlead, im16])
    shift = time_shift(params)
    lo, bounds = local_bounds(plan, len(re16), range(B), shift)
    axes = [t_ext] * Bs

    def cut(a, s0):
        seg = a[s0:s0 + span]
        if len(seg) < span:
            seg = np.concatenate([seg, np.zeros(span - len(seg), a.dtype)])
        return _device_put_streamed(bitpack.pack(seg, pack) if pack else seg)

    frames: List[Frame] = []
    pending = None
    for k in range(n_slices):
        s0 = k * Bs * core
        sl = slice(k * Bs, (k + 1) * Bs)
        out = demod_frames_flat(
            params, framer_cfg, plan, Bs, fs, window, use_pallas,
            cut(rr, s0), cut(ii, s0), norm_gain,
            jnp.asarray(bounds[sl], np.float32), pack_bits=pack)
        # fetch slice k-1 only after dispatching slice k (upload/compute
        # overlap, the demodulate_blocked pattern)
        if pending is not None:
            frames.extend(f for _, f in frame_times(*pending, shift))
        pending = (out, axes, lo[sl])
    frames.extend(f for _, f in frame_times(*pending, shift))
    return frames


def _cut_windows(src, n_valid: int, lo0: int, stride: int, bn: int,
                 total: int, dt):
    """Gather bn windows [lo0 + k*stride, +total) of src into a (bn, total)
    array, zero-padding out-of-range samples.  Vectorized: a strided window
    view + one bulk copy instead of a per-block Python loop (host staging
    must not be the pipeline bottleneck).

    Only the first `n_valid` samples of src are real data; indices beyond
    (and below zero) read as 0.
    """
    src = np.ascontiguousarray(src)
    hi1 = lo0 + (bn - 1) * stride + total
    if lo0 >= 0 and hi1 <= n_valid:
        base = src[lo0:hi1]
    else:
        pad_l = max(0, -lo0)
        pad_r = max(0, hi1 - n_valid)
        base = np.concatenate([
            np.zeros(pad_l, src.dtype),
            src[max(lo0, 0):min(hi1, n_valid)],
            np.zeros(pad_r, src.dtype)])
    view = np.lib.stride_tricks.as_strided(
        base, shape=(bn, total),
        strides=(stride * base.itemsize, base.itemsize))
    out = np.empty((bn, total), dt)
    out[:] = view                     # one bulk memcpy/convert
    return out


def stage_blocks(re, im, plan: BlockPlan, b0: int, bn: int, dt):
    """Host-side: cut bn overlapping [head | core | tail] blocks starting
    at core index b0, as ``dt`` (int16 keeps raw PCM); samples outside the
    recording read as zero.  Returns (blocks_re, blocks_im)."""
    n = len(re)
    lo0 = b0 * plan.core - plan.head
    return tuple(_cut_windows(x, n, lo0, plan.core, bn, plan.total, dt)
                 for x in (re, im))


def demodulate_blocked(iq, t, fs, mode_cfg, norm_factor: Optional[float] = None,
                       plan: Optional[BlockPlan] = None,
                       batch_blocks: int = 64, dtype=np.float32,
                       window: int = 4096, use_pallas=None) -> List[Frame]:
    """Demodulate a whole recording via parallel blocks; returns complete
    frames in stream order.

    use_pallas None picks the demod for the default device (the fused
    kernel on a GPU, XLA scans on the CPU; see default_use_pallas).  Runs
    float32 regardless of the mode's exact-path dtype (the reference's
    ARGOS app is double, but frame-level parity holds in f32); pass
    dtype=np.float64 to match the exact path on CPU."""
    dt = np.dtype(dtype)
    params = chain_lib.make_params(mode_cfg, fs, quirks=False)
    plan = plan or default_plan(mode_cfg, fs)
    n = len(iq)
    if norm_factor is None:
        norm_factor = agc_ops.static_gain(iq[:min(n, mode_cfg.chunk_size)],
                                          mode_cfg.static_gain_level, dt)
    re = np.ascontiguousarray(np.real(iq), dt)
    im = np.ascontiguousarray(np.imag(iq), dt)
    ts = dt.type(1.0) / dt.type(fs)
    t_ext = np.concatenate([np.asarray(t, dt), [dt.type(t[-1] + ts)]]) if n \
        else np.zeros(1, dt)

    n_blocks = max(1, -(-n // plan.core))
    shift = time_shift(params)
    frames: List[Frame] = []
    pending = None
    for b0 in range(0, n_blocks, batch_blocks):
        bn = min(batch_blocks, n_blocks - b0)
        lo, bounds = local_bounds(plan, n, range(b0, b0 + bn), shift)
        jre, jim = (jnp.asarray(x)
                    for x in stage_blocks(re, im, plan, b0, bn, dt))
        fest = coarse_carrier_est(jre, jim, float(fs),
                                  mode_cfg.gardner.baud / 2.0)
        stitched = demod_frames(
            params, plan.total, mode_cfg.framer, plan.max_frames, float(fs),
            window, use_pallas, jre, jim, fest, float(norm_factor),
            jnp.asarray(bounds, dt))
        # fetch batch k-1 only after dispatching batch k: host staging of
        # the next batch overlaps device compute of the current one
        if pending is not None:
            frames.extend(f for _, f in frame_times(*pending, shift))
        pending = (stitched, [t_ext] * bn, lo)
    if pending is not None:
        frames.extend(f for _, f in frame_times(*pending, shift))
    return frames


def demodulate_many(iqs, t, fs, mode_cfg, norm_factor: Optional[float] = None,
                    plan: Optional[BlockPlan] = None,
                    batch_blocks: int = 64, dtype=np.float32,
                    use_pallas=None):
    """Multi-channel fast path: demodulate C recordings together.

    iqs: (C, N) complex (or list of equal-length recordings); all channels'
    blocks are staged into the same device batches, so small recordings still
    fill the lane dimension (the serving configuration: many satellites /
    frequencies per card).  use_pallas as in demod_blocks (None = the
    default device's demod).  Returns a list of per-channel frame lists.
    """
    iqs = np.asarray(iqs)
    C, n = iqs.shape
    dt = np.dtype(dtype)
    params = chain_lib.make_params(mode_cfg, fs, quirks=False)
    plan = plan or default_plan(mode_cfg, fs)
    if norm_factor is None:
        norm_factor = agc_ops.static_gain(iqs[0, :min(n, mode_cfg.chunk_size)],
                                          mode_cfg.static_gain_level, dt)
    ts = dt.type(1.0) / dt.type(fs)
    t_ext = np.concatenate([np.asarray(t, dt), [dt.type(t[-1] + ts)]])
    n_blocks = max(1, -(-n // plan.core))
    shift = time_shift(params)

    # hoist the per-channel plane conversion out of the staging loop
    res_planes = [np.ascontiguousarray(np.real(ch), dt) for ch in iqs]
    ims_planes = [np.ascontiguousarray(np.imag(ch), dt) for ch in iqs]

    # stage all (channel, block) pairs into one work list; frames are
    # stitched on block-local positions (local_bounds)
    work = [(c, b) for c in range(C) for b in range(n_blocks)]
    res = [[] for _ in range(C)]
    pending = None

    def _drain(stitched, chan, lo):
        for r, f in frame_times(stitched, [t_ext] * len(lo), lo, shift):
            res[int(chan[r])].append(f)

    for w0 in range(0, len(work), batch_blocks):
        batch = work[w0:w0 + batch_blocks]
        bn = len(batch)
        brs = np.empty((bn, plan.total), dt)
        bis = np.empty((bn, plan.total), dt)
        chan = np.array([c for c, _ in batch], np.int32)
        lo, bounds = local_bounds(plan, n, [b for _, b in batch], shift)
        # one vectorized cut per contiguous channel run — a per-(channel,
        # block) loop dominated host time
        k = 0
        for c, grp in itertools.groupby(batch, key=lambda w: w[0]):
            m = len(list(grp))
            for out, src in ((brs, res_planes[c]), (bis, ims_planes[c])):
                out[k:k + m] = _cut_windows(src, n, int(lo[k]), plan.core,
                                            m, plan.total, dt)
            k += m
        jre, jim = jnp.asarray(brs), jnp.asarray(bis)
        fest = coarse_carrier_est(jre, jim, float(fs),
                                  mode_cfg.gardner.baud / 2.0)
        stitched = demod_frames(
            params, plan.total, mode_cfg.framer, plan.max_frames, float(fs),
            4096, use_pallas, jre, jim, fest, float(norm_factor),
            jnp.asarray(bounds, dt))
        if pending is not None:
            _drain(*pending)          # overlap: fetch k-1 after dispatching k
        pending = (stitched, chan, lo)
    if pending is not None:
        _drain(*pending)
    return res
