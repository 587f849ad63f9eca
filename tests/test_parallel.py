"""Mesh-sharded codec step tests.

Run in a subprocess with a scrubbed environment, so that the virtual
8-CPU mesh gets JAX_PLATFORMS=cpu and its own XLA_FLAGS.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys
sys.path.insert(0, "__REPO__")
import jax
assert len(jax.devices()) == 8, jax.devices()
import __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn)(*args)
g.dryrun_multichip(8)
g.dryrun_multichip(4)
print("SHARDING-OK")
"""


def test_dryrun_multichip_virtual_mesh():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT.replace("__REPO__", str(REPO))],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert "SHARDING-OK" in r.stdout, r.stdout + r.stderr
