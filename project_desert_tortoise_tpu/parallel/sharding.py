"""Device-mesh sharding for multi-card / multi-host demodulation.

Axes (SURVEY.md section 2.4):
- ``ch``  — channel parallelism: independent recordings/satellites
            (embarrassingly parallel, the reference's "4 separate apps" axis);
- ``blk`` — sequence parallelism over time blocks: the recording is sharded
            contiguously along time; each shard exchanges halo samples with
            its neighbors in time via ``lax.ppermute``, then runs the same
            block-parallel demod locally (warm-up head from the left
            neighbor, frame-completion tail from the right neighbor).

The mesh follows the algorithm: on cards joined all to all (NVLink) the
halo exchange costs the same between any two devices.  Multi-host: the same
code runs under ``jax.distributed.initialize`` with a global mesh.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from project_desert_tortoise_tpu import chain as chain_lib
from project_desert_tortoise_tpu.parallel import blocked as blocked_lib


def make_mesh(n_channel: int, n_block: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if len(devices) < n_channel * n_block:
        raise ValueError(f"need {n_channel * n_block} devices, "
                         f"have {len(devices)}")
    devs = np.asarray(devices[: n_channel * n_block]).reshape(
        n_channel, n_block)
    return Mesh(devs, ("ch", "blk"))


def _halo_exchange(x, head: int, tail: int, axis_name: str):
    """Build [left-halo | local | right-halo] along the last axis with a
    neighbor ppermute.  Edge shards receive zeros (stream boundary)."""
    n_shards = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    # my tail -> right neighbor's head halo
    right = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    left = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    from_left = jax.lax.ppermute(x[..., -head:], axis_name, right)
    from_right = jax.lax.ppermute(x[..., :tail], axis_name, left)
    from_left = jnp.where(idx == 0, jnp.zeros_like(from_left), from_left)
    from_right = jnp.where(idx == n_shards - 1,
                           jnp.zeros_like(from_right), from_right)
    return jnp.concatenate([from_left, x, from_right], axis=-1)


def sharded_demod_step(params: chain_lib.ChainParams, plan, framer_cfg,
                       mesh: Mesh, fs: float, use_pallas=None,
                       cap: int = 0, window: int = 4096):
    """Returns a jitted function: (re, im, bounds, norm) sharded over
    (ch, blk) -> stitched per-shard frames (positions, inverted, data, n,
    rows).

    re/im: (C, N) global arrays, sharded P('ch', 'blk'); each shard's local
    slice length must be a multiple of plan.core.  bounds: (NB, 2) per-block
    core intervals in block-local positions (blocked.local_bounds; NB = the
    global block count), sharded along NB.  Core-interval filtering and
    stream ordering happen device-side: each shard returns, per channel, a
    packed (cap,)-capacity frame buffer keyed by the shard's block row,
    plus its valid count, so the host fetches O(frames) bytes instead of
    the full per-block candidate grid.

    use_pallas as in blocked.demod_blocks; None = the fused kernel on a GPU
    mesh, the XLA scans on a CPU mesh.  window is the XLA scans' chunk.
    """
    # the kernel interprets only on a CPU mesh: placement follows the
    # mesh's devices, not the process default
    interpret = mesh.devices.flat[0].platform == "cpu"
    shard_map = functools.partial(jax.shard_map, check_vma=False)

    head, tail, core = plan.head, plan.tail, plan.core
    # step_size = Fs*interp/baud  =>  bit rate = baud/2
    bit_rate = fs * params.interp / params.step_size / 2.0
    total = plan.total

    def local_demod(re, im, bounds, norm):
        # re/im: (C_loc, N_loc) local contiguous slices
        re_h = _halo_exchange(re, head, tail, "blk")
        im_h = _halo_exchange(im, head, tail, "blk")

        c_loc, n_loc = re.shape
        b_loc = n_loc // core
        local_cap = cap or b_loc * plan.max_frames
        # cut overlapping blocks: block j covers [j*core, j*core + total)
        def cut(x):
            blocks = [jax.lax.dynamic_slice_in_dim(x, j * core, total, axis=-1)
                      for j in range(b_loc)]
            return jnp.stack(blocks, axis=1).reshape(c_loc * b_loc, total)

        bre, bim = cut(re_h), cut(im_h)
        fest = blocked_lib.coarse_carrier_est(bre, bim, fs, bit_rate)
        bits_c, times_c, n_bits, _ = blocked_lib.demod_blocks(
            params, total, bre, bim, fs, fest, norm[0, 0], window,
            use_pallas, interpret)
        # stitch per channel on device over (C_loc, B_loc, ...) grids
        per_ch = lambda a: a.reshape((c_loc, b_loc) + a.shape[1:])
        pos, inv, data, n, rows = jax.vmap(
            lambda b, t, nb: blocked_lib.extract_stitch(
                framer_cfg, plan.max_frames, local_cap, b, t, nb, bounds)
        )(per_ch(bits_c), per_ch(times_c), per_ch(n_bits))
        return pos, inv, data, n[:, None], rows

    fn = shard_map(
        local_demod, mesh=mesh,
        in_specs=(P("ch", "blk"), P("ch", "blk"), P("blk", None),
                  P(None, None)),
        out_specs=(P("ch", "blk"), P("ch", "blk"), P("ch", "blk", None),
                   P("ch", "blk"), P("ch", "blk")),
    )
    return jax.jit(fn)


def stage_global(iq, t, fs, mode_cfg, mesh: Mesh, plan=None,
                 norm_factor: Optional[float] = None):
    """Host staging shared by the single- and multi-process sharded paths:
    pad (C, N) recordings to a core-aligned global length, and build the
    per-block core bounds and first-sample indices (blocked.local_bounds),
    the accumulated time axis that times the frames, and the norm factor.

    Returns (params, plan, re, im, bounds, lo, t_ext, norm) as numpy
    arrays.
    """
    from project_desert_tortoise_tpu.ops import agc as agc_ops

    dt = np.dtype(np.float32) if mode_cfg.np_dtype().itemsize == 4 \
        else mode_cfg.np_dtype()
    params = chain_lib.make_params(mode_cfg, fs, quirks=False)
    C, N = iq.shape
    n_blk = mesh.shape["blk"]
    plan = plan or blocked_lib.default_plan(mode_cfg, fs)
    # shard-local length must be a multiple of plan.core
    loc = -(-N // n_blk)
    loc = -(-loc // plan.core) * plan.core
    Np = loc * n_blk
    re = np.zeros((C, Np), dt)
    im = np.zeros((C, Np), dt)
    re[:, :N] = np.real(iq)
    im[:, :N] = np.imag(iq)
    ts = dt.type(1.0) / dt.type(fs)
    t_ext = np.concatenate([np.asarray(t, dt), [dt.type(t[-1] + ts)]])
    if norm_factor is None:
        norm_factor = agc_ops.static_gain(
            iq[0, :min(N, mode_cfg.chunk_size)], mode_cfg.static_gain_level, dt)
    norm = np.full((1, 1), norm_factor, dt)
    # blocks past N get empty core intervals
    lo, bounds = blocked_lib.local_bounds(plan, N, range(Np // plan.core),
                                          blocked_lib.time_shift(params))
    return (params, plan, re, im, bounds.astype(np.float32), lo, t_ext,
            norm)


def shard_frames(stitched, col: int, t_ext, lo, shift: int, b_loc: int):
    """(channel, Frame) pairs, in stream order per channel, of one shard's
    fetched (positions, inverted, data, n, rows) outputs, each with a
    leading channel axis.  Shard column ``col`` of the blk axis holds the
    global blocks [col*b_loc, (col+1)*b_loc), whose first-sample indices
    into ``t_ext`` are in ``lo`` (stage_global)."""
    pos, inv, data, n, rows = stitched
    lo_s = lo[col * b_loc:(col + 1) * b_loc]
    axes = [t_ext] * b_loc
    out = []
    for c in range(pos.shape[0]):
        out += [(c, f) for _, f in blocked_lib.frame_times(
            (pos[c], inv[c], data[c], n[c, 0], rows[c]), axes, lo_s, shift)]
    return out


def demodulate_sharded(iq, t, fs, mode_cfg, mesh: Mesh,
                       norm_factor: Optional[float] = None,
                       plan=None, use_pallas=None):
    """Multi-channel, multi-shard demodulation of (C, N) recordings.

    iq: (C, N) complex, t: (N,) time axis (shared across channels).
    Returns a list of per-channel frame lists in stream order.
    """
    C = iq.shape[0]
    params, plan, re, im, bounds, lo, t_ext, norm = stage_global(
        iq, t, fs, mode_cfg, mesh, plan, norm_factor)

    sh = NamedSharding(mesh, P("ch", "blk"))
    step = sharded_demod_step(params, plan, mode_cfg.framer, mesh, float(fs),
                              use_pallas)
    out = step(jax.device_put(re, sh), jax.device_put(im, sh),
               jax.device_put(bounds, NamedSharding(mesh, P("blk", None))),
               jax.device_put(norm, NamedSharding(mesh, P(None, None))))

    # one fetch per array; shards are concatenated along the cap axis,
    # each shard segment already core-filtered and in stream order
    n_blk = mesh.shape["blk"]
    b_loc = re.shape[1] // n_blk // plan.core
    cols = [np.split(np.asarray(x), n_blk, axis=1) for x in out]
    results = [[] for _ in range(C)]
    for col in range(n_blk):
        for c, f in shard_frames([x[col] for x in cols], col, t_ext, lo,
                                 blocked_lib.time_shift(params), b_loc):
            results[c].append(f)
    return results
