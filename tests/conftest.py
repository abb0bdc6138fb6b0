import os

# Tests run on the CPU backend with a virtual 8-device mesh so multi-device
# sharding paths are exercised without accelerator hardware (SURVEY.md
# section 4.7); Pallas kernels run through the interpreter there.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# pin the default device to the CPU: kernels interpret, results are
# deterministic.  (Tests marked `gpu` run on the card with
# JAX_PLATFORMS=cuda, where nothing is pinned.)
if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF = "/root/reference"
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TAPS = os.path.join(REPO, "oracle", "golden", "poes", "taps")


def _autobuild():
    """Build the C oracle, stage taps, and the native IO lib on first run.

    These artifacts are gitignored, so a fresh checkout builds them here
    (gcc/g++/make; idempotent, ~2 s).  Each step runs on its own: the
    oracle needs the reference checkout, the native IO lib does not, and a
    failed step must not skip the others.  Failures are non-fatal — the
    affected fixtures still skip with a reason.  A file lock keeps
    concurrent test workers from building (and loading) at the same time.
    """
    import fcntl
    import subprocess
    import sys

    build = os.path.join(REPO, "oracle", "build")
    clip = os.path.join(REF, "5sec_clip.wav")
    native = os.path.join(REPO, "project_desert_tortoise_tpu", "native")
    steps = [
        ("oracle", os.path.join(build, "tap_poes"),
         ["bash", os.path.join(REPO, "oracle", "build_oracle.sh")]),
        ("taps", os.path.join(TAPS, "frames.txt"),
         [os.path.join(build, "tap_poes"), clip, TAPS]),
        ("native", os.path.join(native, "libpdtwavio.so"),
         ["make", "-C", native]),
    ]
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, ".autobuild.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for name, product, cmd in steps:
            if os.path.exists(product):
                continue
            if name == "taps":
                if not (os.path.exists(clip) and os.path.exists(cmd[0])):
                    continue
                os.makedirs(TAPS, exist_ok=True)
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=300)
            except Exception as e:  # pragma: no cover - best effort
                print(f"[conftest] {name} autobuild failed: {e}",
                      file=sys.stderr)


_autobuild()


@pytest.fixture(scope="session")
def poes_synth():
    """A seeded 5.4 s synthesized POES pass (50 minor frames) quantized to
    16-bit PCM at a low level, like a recorded clip: (iq, t, fs)."""
    from project_desert_tortoise_tpu.utils import synth, wav as W
    fs = 50000.0
    iq, _ = synth.make_poes_recording(n_frames=50, fs=fs,
                                      rng=np.random.default_rng(5))
    iq = iq / np.abs(iq).max() * 0.05
    iq = (np.round(iq.real * 32768) + 1j * np.round(iq.imag * 32768)) / 32768
    return iq, W.time_axis(len(iq), fs, np.float32), fs


@pytest.fixture(scope="session")
def poes_clip():
    from project_desert_tortoise_tpu.utils import wav as W
    if not os.path.exists(f"{REF}/5sec_clip.wav"):
        pytest.skip("reference clip not available")
    iq, t, fs, hdr = W.load_iq_wav(f"{REF}/5sec_clip.wav")
    return iq, t, fs


@pytest.fixture(scope="session")
def taps_dir():
    if not os.path.isdir(TAPS):
        pytest.skip("C oracle taps not built (run oracle/build_oracle.sh + tap_poes)")
    return TAPS


def load_tap(name, dtype=np.float32):
    return np.fromfile(os.path.join(TAPS, name), dtype)


@pytest.fixture(scope="session")
def oracle_frames(taps_dir):
    """Parsed frames.txt from the local C oracle run."""
    out = []
    with open(os.path.join(taps_dir, "frames.txt")) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ts = parts[0]
            inv = ts.endswith("i")
            out.append((float(ts[:-1] if inv else ts), inv,
                        [int(x, 16) for x in parts[1:]]))
    return out
