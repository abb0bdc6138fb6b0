#!/usr/bin/env python3
"""Dispatch-to-ready timing of each component of the fast demod path on
one device (host clock around work that ends in block_until_ready).

    python tools/profile_components.py [--b 128] [--core 98304]
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def timeit(fn, iters=4):
    import jax
    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--core", type=int, default=98304)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import bench
    from project_desert_tortoise_tpu import chain as chain_lib
    from project_desert_tortoise_tpu.parallel import blocked as BL
    from project_desert_tortoise_tpu.ops import manchester as man_ops
    from project_desert_tortoise_tpu.ops import pll as pll_ops
    from project_desert_tortoise_tpu.ops.pallas.fused_kernel import (
        fused_demod_pallas)
    from project_desert_tortoise_tpu.utils.config import POES_TIP

    fs = 50000.0
    dt = np.dtype(np.float32)
    params = chain_lib.make_params(POES_TIP, fs, quirks=False)
    plan = BL.BlockPlan(core=args.core, head=12288, tail=8192, max_frames=64)
    B = args.b
    use_pallas = BL.default_use_pallas()
    interpret = not use_pallas

    iq = bench.poes_input(fs)
    re = np.real(iq).astype(dt)
    im = np.imag(iq).astype(dt)
    reps = int(np.ceil((B * plan.core + plan.total) / len(re)))
    rr, ii = np.tile(re, reps), np.tile(im, reps)
    brs, bis = BL.stage_blocks(rr, ii, plan, 0, B, dt)
    total = plan.total
    n_samp = B * plan.core
    _, bounds = BL.local_bounds(plan, len(rr), range(B),
                                BL.time_shift(params))

    jre, jim = jnp.asarray(brs), jnp.asarray(bis)
    jb = jnp.asarray(bounds, dt)

    ms, fest = timeit(
        lambda: BL.coarse_carrier_est(jre, jim, float(fs), 8320.0))
    print(f"carrier_est    {ms*1e3:8.2f} ms")

    pll_state = pll_ops.init_state(params.pll, dt, (B,))
    pll_state = pll_state._replace(
        freq=(jnp.asarray(2.0 * np.pi / fs, dt) * fest),
        locked=jnp.ones((B,), bool))
    gain0 = jnp.full((B,), 17.58, dt)

    if use_pallas:
        ms, out_k = timeit(lambda: fused_demod_pallas(
            params, pll_state, gain0, (jre, jim), interpret=interpret))
        print(f"fused_kernel   {ms*1e3:8.2f} ms   -> "
              f"{n_samp/ms/1e6:8.1f} Msps")
        bits_f, btimes_f, emit_f, avgp = out_k
        max_bits = total // 4 + 8
        comp = jax.jit(lambda: man_ops.compress_spaced(
            bits_f.astype(jnp.uint8), btimes_f, emit_f, max_bits,
            min_spacing=4))
        ms, out_c = timeit(comp)
        print(f"compress       {ms*1e3:8.2f} ms")
        bits_c, times_c, n_bits = out_c
        ms, stitched = timeit(
            lambda: BL.extract_stitch(POES_TIP.framer, plan.max_frames,
                                      B * plan.max_frames, bits_c, times_c,
                                      n_bits, jb))
        print(f"extract+stitch {ms*1e3:8.2f} ms   "
              f"frames={int(np.asarray(stitched[3]))}")

    # end-to-end via demod_blocks for cross-check
    ms, _ = timeit(lambda: BL.demod_blocks(
        params, total, jre, jim, float(fs), fest, 17.58, 4096, use_pallas))
    print(f"demod_blocks({use_pallas}) {ms*1e3:8.2f} ms -> "
          f"{n_samp/ms/1e6:8.1f} Msps")

    # FULL single-dispatch path incl. framing + stitching
    ms, st = timeit(lambda: BL.demod_frames(
        params, total, POES_TIP.framer, plan.max_frames, float(fs), 4096,
        use_pallas, jre, jim, fest, 17.58, jb))
    print(f"demod_frames({use_pallas}) {ms*1e3:8.2f} ms -> "
          f"{n_samp/ms/1e6:8.1f} Msps  frames={int(np.asarray(st[3]))}")

    # host staging cost
    t0 = time.perf_counter()
    BL.stage_blocks(rr, ii, plan, 0, B, dt)
    print(f"host staging   {(time.perf_counter()-t0)*1e3:8.2f} ms")
    t0 = time.perf_counter()
    jax.device_put(brs).block_until_ready()
    print(f"device_put     {(time.perf_counter()-t0)*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
