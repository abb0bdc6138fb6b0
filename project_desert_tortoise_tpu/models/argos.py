"""ARGOS platform-uplink demodulator (reference ARGOSdemod / ...PortAudio).

The reference file app runs in double precision (ARGOSdemod/config.h
USE_FLOATS=0); exact mode therefore requires jax x64 (enabled on import of
this module's `enable_x64` helper or by the CLI) and runs on CPU.  The fast
block-parallel path uses float32 (frame-level parity holds).
"""
import jax

from project_desert_tortoise_tpu.models.demodulator import (  # noqa: F401
    DemodResult, DemodSession, demodulate_wav)
from project_desert_tortoise_tpu.utils.config import ARGOS, ARGOS_REALTIME  # noqa: F401


def enable_x64():
    jax.config.update("jax_enable_x64", True)


def demodulate(path: str, annotate_quality: bool = True,
               **kw) -> DemodResult:
    """Demodulate an ARGOS recording; packets carry quality/SNR annotations
    (closing the reference's README.md:42 TODO) unless disabled."""
    if ARGOS.np_dtype().itemsize == 8 and not jax.config.jax_enable_x64:
        enable_x64()
    from project_desert_tortoise_tpu.utils import wav as W
    iq, t, fs, _ = W.load_iq_wav(path, ARGOS.np_dtype())
    sess = DemodSession(ARGOS, fs, annotate_quality=annotate_quality, **kw)
    return sess.run(iq, t)
