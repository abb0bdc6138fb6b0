"""Multi-host orchestration (the N-host scaling configuration).

The demod workload has no cross-host model state — hosts cooperate only
through the ``blk`` halo exchange — so multi-host setup is just
`jax.distributed.initialize` plus a global mesh.

Typical launch on every host:

    from project_desert_tortoise_tpu.parallel import multihost as MH
    MH.init("host0:1234", 2, rank)  # coordinator, process count, id
    mesh = MH.global_mesh(n_channel=2)
    # feed each host its local shard of the recording(s):
    local = MH.local_time_slice(n_total_samples, mesh)
    ...
    results = demodulate_sharded(iq, t, fs, mode, mesh)

Process-0 gathers frames (frame outputs are tiny) via
`multihost_utils.process_allgather` when a global view is needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None):
    """`jax.distributed.initialize` wrapper.  Pass all three arguments on
    GPU hosts; with none, JAX discovers them from a cluster environment
    that provides them."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(n_channel: int = 1, devices=None) -> Mesh:
    """(ch, blk) mesh over all global devices; blk spans hosts so the halo
    ring crosses DCN exactly once per host boundary."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n % n_channel:
        raise ValueError(f"{n} devices not divisible by {n_channel} channels")
    arr = np.asarray(devices).reshape(n_channel, n // n_channel)
    return Mesh(arr, ("ch", "blk"))


def local_time_slice(n_samples: int, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi) sample range this process should load from the recording
    (each host only reads its own slice plus nothing — halos travel over
    the interconnect, not the filesystem).

    Requires this process's mesh columns to be contiguous (the natural
    layout from :func:`global_mesh`); raises otherwise rather than silently
    returning a range that spans other hosts' data."""
    n_blk = mesh.shape["blk"]
    per = -(-n_samples // n_blk)
    local_blk = [d for d in mesh.devices.flatten()
                 if d.process_index == jax.process_index()]
    cols = sorted({int(np.where(mesh.devices == d)[1][0]) for d in local_blk})
    if cols != list(range(cols[0], cols[-1] + 1)):
        raise ValueError(
            f"process {jax.process_index()} owns non-contiguous mesh "
            f"columns {cols}; local_time_slice needs a contiguous blk "
            f"layout (use multihost.global_mesh)")
    lo = cols[0] * per
    hi = min((cols[-1] + 1) * per, n_samples)
    return lo, hi


def demodulate_multihost(iq, t, fs, mode_cfg, mesh: Mesh,
                         norm_factor=None, plan=None, use_pallas=None):
    """Multi-process twin of `sharding.demodulate_sharded`.

    Every process calls this with the same (C, N) recording view (a file
    mmap is fine — only the process-local time slice is materialized onto
    devices, via `jax.make_array_from_process_local_data`).  Channel rows
    must not be split across processes.  Returns the per-channel frame
    lists, identical on every process (frames are all-gathered).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from project_desert_tortoise_tpu.parallel import blocked as BL
    from project_desert_tortoise_tpu.parallel import sharding as SH

    C = iq.shape[0]
    params, plan, re, im, bounds, lo_b, t_ext, norm = SH.stage_global(
        iq, t, fs, mode_cfg, mesh, plan, norm_factor)
    Np = re.shape[1]
    lo, hi = local_time_slice(Np, mesh)
    n_blk = mesh.shape["blk"]
    b_loc = Np // n_blk // plan.core
    col_lo = lo // (Np // n_blk)
    col_hi = hi // (Np // n_blk)

    sh = NamedSharding(mesh, P("ch", "blk"))
    mk = jax.make_array_from_process_local_data
    g_re = mk(sh, np.ascontiguousarray(re[:, lo:hi]), re.shape)
    g_im = mk(sh, np.ascontiguousarray(im[:, lo:hi]), im.shape)
    g_bd = mk(NamedSharding(mesh, P("blk", None)),
              np.ascontiguousarray(bounds[col_lo * b_loc:col_hi * b_loc]),
              bounds.shape)
    g_nm = mk(NamedSharding(mesh, P(None, None)), norm, norm.shape)

    step = SH.sharded_demod_step(params, plan, mode_cfg.framer, mesh,
                                 float(fs), use_pallas)
    out = step(g_re, g_im, g_bd, g_nm)

    # this process's shards, keyed by device so the outputs line up; a
    # shard's index into the global n (C, n_blk) gives its first channel
    # and its blk column
    by_dev = [{p.device: p for p in x.addressable_shards} for x in out]
    tagged = []            # (column, channel, Frame) from local shards
    for dev, n_part in by_dev[3].items():
        c0 = n_part.index[0].start or 0
        col = n_part.index[1].start or 0
        local = [np.asarray(d[dev].data) for d in by_dev]
        tagged += [(col, c0 + c, f) for c, f in SH.shard_frames(
            local, col, t_ext, lo_b, BL.time_shift(params), b_loc)]
    # stream order: by column, each shard's frames already in order
    all_tagged = sorted(gather_frames(tagged), key=lambda x: x[0])
    results = [[] for _ in range(C)]
    for _, c, f in all_tagged:
        results[c].append(f)
    return results


def gather_frames(frames):
    """All-gather per-host frame lists to process 0 (frames are tiny)."""
    from jax.experimental import multihost_utils
    import pickle
    blob = np.frombuffer(pickle.dumps(frames), np.uint8)
    # pad to a common size
    n = int(multihost_utils.process_allgather(np.array([len(blob)])).max())
    padded = np.zeros(n, np.uint8)
    padded[:len(blob)] = blob
    sizes = multihost_utils.process_allgather(np.array([len(blob)]))
    blobs = multihost_utils.process_allgather(padded)
    out = []
    for i in range(blobs.shape[0]):
        out.extend(pickle.loads(blobs[i, :int(sizes[i])].tobytes()))
    return out
