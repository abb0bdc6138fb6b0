"""The card a measurement runs on.

A measurement names its device and fails where there is no GPU: a number
taken on the CPU is never reported as a device number.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """JAX's devices; raises SystemExit when JAX finds no GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default platform is "
                         f"{devs[0].platform!r}")
    return devs


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()
