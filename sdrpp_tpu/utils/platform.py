"""What the current JAX backend can compile.

The one place that asks which platform the program runs on. Kernels ask
here whether they compile; a kernel that is asked for where it does not
compile raises, it does not fall back.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["pallas_gpu_supported", "card_name_and_power_limit"]


def pallas_gpu_supported() -> bool:
    """True where the repo's Pallas kernels (Triton route) compile: a GPU
    backend. Elsewhere they run only in interpret mode, by explicit
    argument."""
    return jax.default_backend() == "gpu"


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (one line per card). Raises where nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
