import os
import subprocess
import sys
from pathlib import Path

# Tests run on the CPU, sharding on a virtual 8-device mesh; tests
# marked `gpu` take the `gpu` fixture and run on the card through
# `python chip_smoke.py`, which sets JAX_PLATFORMS=cuda.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# The full suite JIT-compiles thousands of kernel variants; the
# process accumulates ~50k+ memory maps (XLA CPU code pages) and the
# default vm.max_map_count=65530 is exhausted late in the run, at
# which point LLVM segfaults on a failed mmap.  Raise it (best-effort,
# needs root) before the first jax import.
try:
    with open("/proc/sys/vm/max_map_count", "r+") as _f:
        if int(_f.read()) < 1048576:
            _f.seek(0)
            _f.write("1048576")
except OSError:
    pass

import jax  # noqa: E402

from htscodecs_tpu._device import configure_cache  # noqa: E402

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else the
# checkout's .jax_cache/): reruns skip the dominant compile cost.
configure_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import pytest  # noqa: E402

REF = Path("/root/reference")
REFBUILD = REPO / ".refbuild"


def _ensure_ref_tools() -> Path | None:
    """Build the reference C test tools (conformance oracles) if the
    reference checkout and a compiler are available."""
    if not REF.exists():
        return None
    tool = REFBUILD / "rANS_static4x16pr_test"
    if tool.exists():
        return REFBUILD
    REFBUILD.mkdir(exist_ok=True)
    (REFBUILD / "config.h").write_text("")
    (REFBUILD / "version.h").write_text('#define HTSCODECS_VERSION_TEXT "1.1"\n')
    srcs = [
        str(REF / "htscodecs" / f)
        for f in (
            "rANS_static.c rANS_static4x16pr.c arith_dynamic.c "
            "fqzcomp_qual.c tokenise_name3.c pack.c rle.c htscodecs.c"
        ).split()
    ]
    for t in (
        "rANS_static rANS_static4x16pr arith_dynamic "
        "fqzcomp_qual tokenise_name3"
    ).split():
        r = subprocess.run(
            ["gcc", "-O2", f"-I{REFBUILD}", f"-I{REF}", f"-I{REF}/htscodecs",
             "-o", str(REFBUILD / f"{t}_test"), str(REF / "tests" / f"{t}_test.c"),
             *srcs, "-lm", "-lpthread"],
            capture_output=True,
        )
        if r.returncode:
            return None
    return REFBUILD


@pytest.fixture
def gpu():
    """For tests marked `gpu`: skip unless JAX's backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run `python chip_smoke.py` there)")


@pytest.fixture(scope="session")
def ref_tools():
    path = _ensure_ref_tools()
    if path is None:
        pytest.skip("reference C tools unavailable")
    return path


@pytest.fixture(scope="session")
def dat_dir():
    d = REF / "tests" / "dat"
    if not d.exists():
        pytest.skip("reference test data unavailable")
    return d


@pytest.fixture(scope="session")
def names_dir():
    d = REF / "tests" / "names"
    if not d.exists():
        pytest.skip("reference test data unavailable")
    return d


@pytest.fixture(scope="session")
def qdata(dat_dir):
    """First column of each q* fixture, newline-stripped (what the
    reference test scripts feed the codecs)."""
    out = {}
    for f in sorted(dat_dir.glob("q*")):
        if f.is_file():
            raw = b"".join(
                line.split(b"\t")[0]
                for line in f.read_bytes().split(b"\n")
            )
            out[f.name] = raw
    return out
