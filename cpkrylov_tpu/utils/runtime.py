"""Process set-up shared by the repository's entry scripts."""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the directory: JAX reads
    it itself and nothing else is set here.  Otherwise the cache lives in
    ``<checkout>/.jax_cache`` — a fixed path, because the path is part of
    the cache key and a directory that moves between runs never hits.
    Call before the first compilation.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def nvidia_smi_name_power() -> str | None:
    """The GPU's name and power limit as ``nvidia-smi`` reports them, or
    None where there is no ``nvidia-smi``.  A card set below its maximum
    power limit runs slower under load, so every time measured on a GPU
    is reported beside this line."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except FileNotFoundError:
        return None
    return proc.stdout.strip()
