"""Platform selection, the compile cache and the card's identity.

The program's accelerator is an NVIDIA GPU.  Entry points call
``require_gpu`` and stop when JAX finds none; they run on the CPU only
when the user asks for it (``force_cpu``), never as a silent fallback.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

# Fixed, git-ignored cache location inside the checkout: the path is part of
# the cache key, so it must not move between runs.
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def force_cpu(n_devices: int = 1) -> None:
    """Pin JAX to the host CPU with ``n_devices`` virtual devices.

    Must be called before any JAX backend is initialized if ``n_devices > 1``
    (the XLA flag is read at backend init).
    """
    if n_devices > 1:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={n_devices}"
            ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def setup_compile_cache() -> Optional[Path]:
    """Turn on JAX's persistent compilation cache.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here (returns None).  Otherwise the cache goes to
    ``CACHE_DIR``.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return CACHE_DIR


def require_gpu(hint: str = "") -> list:
    """Return ``jax.devices()`` if they are GPUs; otherwise exit with an
    error naming the platform JAX found (and ``hint``, e.g. the flag that
    selects the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"error: no GPU found (JAX platform is {devs[0].platform!r})"
            + (f"; {hint}" if hint else "")
        )
    return devs


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (one line per card), or a note saying why they could not be read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    if r.returncode != 0:
        return f"nvidia-smi failed (exit {r.returncode})"
    return r.stdout.strip()
