"""What the run reports of its device: the card's name, the count, the
peak of device memory on the fullest card and the power limit."""
import subprocess

import torch


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


def require(chips):
    """Raise NoDevice unless ``chips`` CUDA devices are visible."""
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices visible, "
                       f"the cell needs {chips}")


def power_limit():
    """The first card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def info(chips):
    """The result's ``device`` entry."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips)),
            "power_limit": power_limit()}
