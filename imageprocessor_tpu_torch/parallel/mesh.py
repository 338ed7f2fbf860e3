"""The replicas of a data-parallel engine — the counterpart of
imageprocessor_tpu/parallel/mesh.py's ``make_mesh``."""

from __future__ import annotations

import torch

from imageprocessor_tpu_torch.device import resolve_device


def make_devices(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` local cards (all of them for None), one
    replica each."""
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n <= 0:
        raise ValueError(f"n_devices must be positive, got {n}")
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def replica_devices(device: str | torch.device | None,
                    data_axis: int | None) -> list[torch.device]:
    """The engine's replicas: each serves whole groups, one at a time.

    data_axis 0 or None is one replica, on ``device``; n > 1 on ``"cuda"``
    is the first n cards (make_devices), and on the CPU n replicas of the
    CPU device, as the reference's CPU tests use virtual devices. A named
    card (``"cuda:N"``) serves alone."""
    n = int(data_axis or 1)
    if n < 0:
        raise ValueError(f"data_axis must not be negative, got {n}")
    base = resolve_device(device)
    if base.type == "cuda" and n > 1:
        if device is not None and torch.device(device).index is not None:
            raise ValueError(f"data_axis={n} with the one card {base}: name "
                             "no card index to serve on several")
        return make_devices(n)
    return [base] * n
