"""Project Desert Tortoise in JAX.

A from-scratch JAX/XLA/Pallas software-radio demodulation framework with the
capabilities of the C reference `nebarnix/Project-Desert-Tortoise`: NOAA POES
TIP telemetry and ARGOS platform-uplink demodulation from IQ recordings or
streaming block input.

Layout (mirrors SURVEY.md section 2's component inventory):

- ``utils``      — IQ ingest (wav/raw), time base, typed configs, metrics,
                   output writers, checkpointable stream state.
- ``ops``        — the DSP kernel library (reference ``common/``):
                   Costas PLL, dynamic windowed-sinc FIR + 1:N interpolator,
                   AGC/squelch, Gardner & M&M clock recovery, Manchester
                   decode, sync-word framers; the fused Pallas GPU
                   kernel in ``ops.pallas``.
- ``models``     — the demodulator "model families" (reference app drivers):
                   POES TIP file/realtime, ARGOS file/realtime.
- ``parallel``   — device-mesh sharding: block-parallel demodulation with
                   halo warm-up, channel parallelism, multi-host.
- ``telemetry``  — downstream minor-frame processing (reference MATLAB layer):
                   parity, day/time decode, spacecraft ID, TIP dissectors.
- ``apps``       — CLI entry points matching the four reference binaries.
"""

__version__ = "0.1.0"

from project_desert_tortoise_tpu.utils import config as config  # noqa: F401
