"""Device identity, the GPU requirement of measurement paths, and the
persistent compile cache shared by every entry point.

Measurement scripts (`bench.py`, `chip_smoke.py`, `benchmarks/*`) call
`require_gpu()` first: a timing taken on the CPU is not a device number,
so they fail instead of falling back.  Every entry point calls
`enable_compile_cache()` so that processes of one run share compiled code.
"""

import os
import subprocess
from pathlib import Path

#: fixed cache directory inside the checkout (listed in .gitignore); used
#: only when JAX_COMPILATION_CACHE_DIR is not set
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_time_secs: float = 0.25) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
    sets no other directory; otherwise the cache lives at `CACHE_DIR`."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CACHE_DIR)
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path


def require_gpu(devices=None):
    """Return the first JAX device; raise unless it is a GPU."""
    if devices is None:
        import jax
        devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"this measurement needs a GPU; JAX found '{dev.platform}' "
            f"({dev.device_kind})")
    return dev


def device_fields(devices=None) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    if devices is None:
        import jax
        devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def gpu_name_and_power() -> str:
    """The card's name and power limit as `nvidia-smi` reports them, one
    line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
