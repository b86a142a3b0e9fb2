"""Backend probing and the persistent compile cache.

The reference falls back to its CPU renderer when CUDA is absent
(``main.py:11-20``).  This package does not: a GPU render that silently ran
on the host would report host numbers under a device's name.  So
``probe_backend`` reports the platform JAX brought up and raises if the
backend fails to start, and ``require_gpu`` is the check the benchmark and
smoke scripts make before any work.  Only ``cpu_raytracer`` runs on the
host, by design (``models/whitted_oracle.py``).
"""
from __future__ import annotations

import os
from pathlib import Path

from .logging import log_event

# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def probe_backend() -> str:
    """Initialize JAX and return the default platform name.  A backend that
    fails to start raises; nothing switches to the CPU."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as exc:
        log_event("backend_probe_failed", error=f"{type(exc).__name__}: {exc}")
        raise RuntimeError(f"JAX backend failed to start: {exc}") from exc
    platform = devices[0].platform
    log_event(
        "backend_probe", platform=platform, device_count=len(devices),
        device=str(devices[0]),
    )
    return platform


def require_gpu(program: str) -> None:
    """Exit with status 2 unless JAX's default device is a GPU."""
    import sys

    try:
        platform = probe_backend()
    except RuntimeError as exc:
        print(f"{program}: {exc}", file=sys.stderr)
        raise SystemExit(2) from exc
    if platform != "gpu":
        print(f"{program}: needs a GPU, but JAX's default platform is "
              f"{platform!r}", file=sys.stderr)
        raise SystemExit(2)


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and return the directory.  Call before the first compile."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for the first card."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
