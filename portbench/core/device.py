"""The card: whether the run may start, what it reports about the card."""

from __future__ import annotations

import subprocess
import sys

import torch

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_ann")


def chips_missing(chips: int) -> str:
    """Why the run may not start on this machine, or "" if it may."""
    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is false)"
    n = torch.cuda.device_count()
    if n < chips:
        return f"the cell needs {chips} CUDA devices, this machine has {n}"
    return ""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit(index: int = 0) -> str:
    """The card's power limit as nvidia-smi states it ("" if unread)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def describe(device: torch.device, chips: int, peak_bytes: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": device.type, "kind": device.type, "count": chips,
            "memory_peak_bytes": int(peak_bytes)}
