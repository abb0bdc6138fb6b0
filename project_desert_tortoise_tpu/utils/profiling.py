"""Tracing / profiling helpers (SURVEY.md section 5: first-class observability).

- `trace(dir)`: context manager around jax.profiler for TensorBoard traces of
  the demod pipeline;
- `StageTimer`: dispatch-to-fetch wall timing per stage with samples/s
  accounting (a small host fetch ends every timed stage).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    import jax
    with jax.profiler.trace(log_dir):
        yield


class StageTimer:
    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.samples: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, n_samples: int = 0, fetch=None):
        """Time a stage; `fetch` is a zero-arg callable returning a (small)
        device array to force completion."""
        t0 = time.perf_counter()
        yield
        if fetch is not None:
            np.asarray(fetch())
        dt = time.perf_counter() - t0
        self.times.setdefault(name, []).append(dt)
        self.samples[name] = self.samples.get(name, 0) + n_samples

    def report(self) -> str:
        rows = []
        for name, ts in self.times.items():
            med = float(np.median(ts))
            n = self.samples.get(name, 0)
            msps = n / sum(ts) / 1e6 if n else 0.0
            rows.append(f"{name:24s} n={len(ts):3d} med={med*1e3:8.2f} ms"
                        + (f"  {msps:9.2f} Msps" if n else ""))
        return "\n".join(rows)
