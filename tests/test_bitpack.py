"""Lossless bit-packed staging (ops/bitpack.py, VERDICT r4 item 1)."""

import numpy as np
import pytest

from project_desert_tortoise_tpu.ops import bitpack
from project_desert_tortoise_tpu.utils.config import POES_TIP


@pytest.mark.parametrize("w", [2, 7, 11, 12, 13, 16])
def test_roundtrip_exact(w):
    rng = np.random.default_rng(w)
    lo, hi = -(1 << (w - 1)), (1 << (w - 1)) - 1
    for n in (32, 31, 65, 4096, 5000):
        x = rng.integers(lo, hi + 1, size=n).astype(np.int16)
        x[:3] = (lo, hi, 0)[: min(3, n)]
        p = bitpack.pack(x, w)
        assert p.dtype == np.uint32 and p.shape == (-(-n // 32), w)
        import jax

        y = np.asarray(jax.jit(
            bitpack.unpack_jax, static_argnums=(1, 2))(p, w, n))
        np.testing.assert_array_equal(y, x.astype(np.int32))


def test_pack_width():
    assert bitpack.pack_width(np.array([0, 1], np.int16)) == 2
    assert bitpack.pack_width(np.array([-2978, 100], np.int16)) == 13
    assert bitpack.pack_width(np.array([-32768], np.int16)) == 16
    assert bitpack.pack_width(np.array([2048], np.int16)) == 13
    assert bitpack.pack_width(np.array([2047], np.int16)) == 12
    # width covers the max over every plane passed
    assert bitpack.pack_width(np.array([1], np.int16),
                              np.array([-300], np.int16)) == 10


def test_flat_pipelined_packed_matches_unpacked(poes_synth):
    """The packed pipelined E2E path (the bench configuration) must be
    frame-identical to the int16 path over the same planes."""
    from project_desert_tortoise_tpu import chain as chain_lib
    from project_desert_tortoise_tpu.parallel.blocked import (
        BlockPlan, demod_frames_flat_pipelined)
    from project_desert_tortoise_tpu.utils import wav as W

    iq, t, fs = poes_synth
    plan = BlockPlan(core=8192, head=12288, tail=8192, max_frames=8)
    B = 32
    reps = -(-B * plan.core // len(iq))
    iq = np.tile(iq, reps)
    r16 = np.round(np.real(iq) * 32768.0).astype(np.int16)
    i16 = np.round(np.imag(iq) * 32768.0).astype(np.int16)
    t_ext = W.time_axis(len(iq) + 1, fs, np.float32)
    params = chain_lib.make_params(POES_TIP, fs, quirks=False)

    ref = demod_frames_flat_pipelined(
        params, POES_TIP.framer, plan, B, float(fs), 4096, False,
        r16, i16, t_ext, 17.58, n_slices=2)
    assert len(ref) > 20
    packed = demod_frames_flat_pipelined(
        params, POES_TIP.framer, plan, B, float(fs), 4096, False,
        r16, i16, t_ext, 17.58, n_slices=2, pack=-1)
    assert [f.hex_line() for f in packed] == [f.hex_line() for f in ref]

    # explicit width >= data width is also exact
    w = bitpack.pack_width(r16, i16)
    assert 2 < w < 16          # the golden clip does not fill 16 bits
    packed2 = demod_frames_flat_pipelined(
        params, POES_TIP.framer, plan, B, float(fs), 4096, False,
        r16, i16, t_ext, 17.58, n_slices=2, pack=min(w + 1, 15))
    assert [f.hex_line() for f in packed2] == [f.hex_line() for f in ref]
