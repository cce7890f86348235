"""Device pick for every entry point of the port.

Counterpart of `netobserv_tpu/utils/platform.py` (`maybe_force_cpu`): there
JAX is steered to the CPU by environment; here the caller names the device.
Entry points run on CUDA unless the caller passes ``device="cpu"``, and a
CUDA request on a box without CUDA raises instead of quietly using the CPU.
"""

from __future__ import annotations

import torch


def pick_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (None means CUDA) and check that it exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev
