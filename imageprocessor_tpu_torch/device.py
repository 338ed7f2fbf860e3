"""Device choice — the port's counterpart of config.apply_device_platform.

The JAX package forces a platform through jax.config before the first
device call. Here the engine is handed an explicit ``torch.device``:
CUDA by default, the CPU only when a caller asks for it by name (the
CPU tests). A CUDA request on a host without a usable card raises; no
path silently carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device | None = "cuda") -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> that card (raises when CUDA is
    unavailable); ``"cpu"`` -> the CPU, which runs every kernel's plain
    PyTorch version."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain "
            "PyTorch versions")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
