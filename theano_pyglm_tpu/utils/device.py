"""The device a measurement runs on.

Every timing this repository prints names the card it came from. A
measurement path that finds no GPU stops; it never falls back to the CPU,
whose times say nothing about the card.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["require_gpu", "nvidia_smi", "describe_gpu"]


def require_gpu(n_devices: int = 1) -> list:
    """JAX's devices, or SystemExit unless the first ``n_devices`` are GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"FAIL: no GPU: JAX's first device is on platform {devs[0].platform!r}"
        )
    if len(devs) < n_devices:
        raise SystemExit(f"FAIL: need {n_devices} GPUs, JAX sees {len(devs)}")
    return devs


def nvidia_smi(query: str = "name,power.limit") -> list[str] | None:
    """One line per card, as ``nvidia-smi --query-gpu=<query>
    --format=csv,noheader`` prints it, or None when it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines if out.returncode == 0 and lines else None


def describe_gpu(n_devices: int = 1, emit=print) -> str:
    """Require the GPUs, emit their description, and return the card label
    (``name, power limit``) to print beside every time."""
    devs = require_gpu(n_devices)
    emit(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
         f"count={len(devs)}")
    cards = nvidia_smi()
    if cards is None:
        emit("nvidia-smi --query-gpu=name,power.limit: could not be read")
        return f"{devs[0].device_kind}, power limit not read"
    emit("nvidia-smi --query-gpu=name,power.limit:")
    for line in cards:
        emit(line)
    return cards[0]
