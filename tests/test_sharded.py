"""Multi-device sharding: (channel x block) mesh with ppermute halo exchange,
on the 8-device virtual CPU mesh (SURVEY.md section 4.7)."""

import numpy as np
import jax
import pytest

from project_desert_tortoise_tpu.parallel.blocked import BlockPlan, default_plan
from project_desert_tortoise_tpu.parallel.sharding import (
    demodulate_sharded, make_mesh)
from project_desert_tortoise_tpu.utils.config import POES_TIP
from project_desert_tortoise_tpu.utils import synth, wav as W


@pytest.fixture(scope="module")
def cpu_devices():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs


def test_sharded_matches_oracle(poes_clip, oracle_frames, cpu_devices):
    iq, t, fs = poes_clip
    mesh = make_mesh(2, 4, cpu_devices)
    iq2 = np.stack([iq, iq])
    res = demodulate_sharded(iq2, t, fs, POES_TIP, mesh,
                             plan=default_plan(POES_TIP, fs, core=40000))
    assert len(res) == 2
    complete = [of for of in oracle_frames if len(of[2]) == 104]
    for ch in range(2):
        mine = {round(f.time, 5): f for f in res[ch]}
        missing = sum(1 for ot, _, _ in complete
                      if round(ot, 5) not in mine)
        assert missing == 0


def test_sharded_fused_kernel(cpu_devices, monkeypatch):
    """The fused Pallas kernel composes with the mesh:
    demodulate_sharded(use_pallas='fused') runs the kernel inside shard_map
    (interpret mode on a CPU mesh, lanes padded to whole tiles inside the
    kernel wrapper) and decodes the same payloads as the XLA scan path."""
    from project_desert_tortoise_tpu.ops.pallas import fused_kernel as FK

    calls = []
    real = FK.fused_demod_pallas

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(FK, "fused_demod_pallas", spy)

    fs = 50000.0
    iq, sent = synth.make_poes_recording(n_frames=4, fs=fs, snr_db=25.0)
    t = W.time_axis(len(iq), fs, np.float32)
    mesh = make_mesh(1, 2, cpu_devices)
    plan = BlockPlan(core=16384, head=8192, tail=6144, max_frames=8)
    res = demodulate_sharded(iq[None, :], t, fs, POES_TIP, mesh, plan=plan,
                             use_pallas="fused")
    assert calls, "fused kernel was not engaged under the mesh"
    sent_set = {x.tobytes() for x in sent}
    ok = sum(1 for f in res[0]
             if np.asarray(f.data, np.uint8).tobytes() in sent_set)
    assert ok >= len(sent) - 1
    # parity with the default sharded path over the same mesh
    base = demodulate_sharded(iq[None, :], t, fs, POES_TIP, mesh, plan=plan,
                              use_pallas=False)
    assert {round(f.time, 6) for f in res[0]} \
        >= {round(f.time, 6) for f in base[0]}


def test_sharded_synth_1d_mesh(cpu_devices):
    fs = 50000.0
    iq, sent = synth.make_poes_recording(n_frames=4, fs=fs, snr_db=25.0)
    t = W.time_axis(len(iq), fs, np.float32)
    mesh = make_mesh(1, 8, cpu_devices)
    plan = BlockPlan(core=8192, head=8192, tail=6144, max_frames=8)
    res = demodulate_sharded(iq[None, :], t, fs, POES_TIP, mesh, plan=plan)
    sent_set = {x.tobytes() for x in sent}
    ok = sum(1 for f in res[0]
             if np.asarray(f.data, np.uint8).tobytes() in sent_set)
    assert ok >= len(sent) - 1
