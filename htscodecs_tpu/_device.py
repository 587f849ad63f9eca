"""Where compiled code is cached, and which device the card runs are on.

Shared by the tests, ``bench.py`` and ``chip_smoke.py``; imports JAX
only inside the functions that need it.
"""

from __future__ import annotations

import os
from pathlib import Path

# the checkout's cache directory, listed in .gitignore
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir(env=None) -> Path:
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's
    .jax_cache/."""
    env = os.environ if env is None else env
    return Path(env["JAX_COMPILATION_CACHE_DIR"]) \
        if env.get("JAX_COMPILATION_CACHE_DIR") else CACHE_DIR


def configure_cache() -> Path:
    import jax
    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", str(d))
    return d


def gpu_device(devices=None) -> dict:
    """JAX's first device as {"platform", "kind", "count"}; raises
    RuntimeError unless it is a GPU."""
    if devices is None:
        import jax
        devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {d.platform} "
                           f"({d.device_kind})")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}
