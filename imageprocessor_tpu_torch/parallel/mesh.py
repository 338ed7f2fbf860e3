"""The replicas and strips of an engine — the counterpart of
imageprocessor_tpu/parallel/mesh.py's ``make_mesh`` (the (data, space)
grid), ``batch_sharding`` and ``shard_batch_arrays`` (the width split).

A replica serves whole groups, one at a time. With a space axis of s it
is s cards, and each group it runs is split into s column strips of its
bucket, strip k on card k (runtime/engine.py, models/strips.py)."""

from __future__ import annotations

import numpy as np
import torch

from imageprocessor_tpu_torch.device import resolve_device

# Strip bounds are multiples of 16, so that both B1's widest MCU (4:2:0,
# 4:2:2) and B3's 16x16 MCU line up with them
STRIP_ALIGN = 16
# Columns each strip holds past its own on each side: one MCU column
# covers the fancy upsample's chroma taps and a bilinear resample's
# right tap
HALO = 16


def make_devices(n_devices: int | None = None, space: int = 1) -> list[torch.device]:
    """The first ``n_devices`` local cards (all of them for None), as the
    reference's mesh takes its chips: ``space`` consecutive cards form one
    replica, so ``n_devices`` must be a multiple of ``space``."""
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n <= 0:
        raise ValueError(f"n_devices must be positive, got {n}")
    if space <= 0:
        raise ValueError(f"space must be positive, got {space}")
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if n % space:
        raise ValueError(f"n_devices={n} not divisible by space={space}")
    return [torch.device("cuda", i) for i in range(n)]


def replica_devices(device: str | torch.device | None, data_axis: int | None,
                    space_axis: int | None = 1) -> list[tuple[torch.device, ...]]:
    """The engine's replicas, each a tuple of its ``space_axis`` cards.

    data_axis 0 or None is one replica; space_axis 0 or None is 1. On
    ``"cuda"``, replica r takes cards r*s .. r*s+s-1 of make_devices(d*s,
    s); on the CPU every strip of every replica is the CPU device, as the
    reference's CPU tests use virtual devices. A named card (``"cuda:N"``)
    serves alone: one replica of one strip."""
    n = int(data_axis or 1)
    s = int(space_axis or 1)
    if n < 0:
        raise ValueError(f"data_axis must not be negative, got {n}")
    if s < 0:
        raise ValueError(f"space_axis must not be negative, got {s}")
    base = resolve_device(device)
    if base.type == "cuda" and n * s > 1:
        if device is not None and torch.device(device).index is not None:
            raise ValueError(f"data_axis={n} with the one card {base} "
                             f"(space_axis={s}): name no card index to serve "
                             "on several")
        cards = make_devices(n * s, space=s)
        return [tuple(cards[r * s:(r + 1) * s]) for r in range(n)]
    return [(base,) * s] * n


def strip_bounds(width: int, space: int) -> list[int]:
    """Column bounds x_0 = 0 < x_1 < ... < x_n = width of a bucket's
    strips: every inner bound a multiple of STRIP_ALIGN, the strips as
    even as whole STRIP_ALIGN-column units allow. n is ``space``, or fewer
    where the bucket has fewer units."""
    units = -(-width // STRIP_ALIGN)
    n = max(1, min(space, units))
    return [STRIP_ALIGN * (k * units // n) for k in range(n)] + [width]


def strip_halos(bounds: list[int]) -> list[tuple[int, int]]:
    """Each strip's columns with its halo, [x_k - HALO, x_{k+1} + HALO)
    clipped to the bucket: what its card holds."""
    width = bounds[-1]
    return [(max(lo - HALO, 0), min(hi + HALO, width))
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def owned_ranges(cols: np.ndarray, bounds: list[int]) -> np.ndarray:
    """(n, B, 2) [j0, j1) per strip and image: the output columns whose
    source column ``cols[i, j]`` lies in strip k's own columns. ``cols``:
    (B, w) source columns, non-decreasing along each row and inside the
    bucket, so each strip owns one contiguous range per image and the
    ranges of a row cover [0, w) once."""
    cols = np.asarray(cols)
    j = np.stack([(cols < x).sum(axis=1) for x in bounds])   # (n + 1, B)
    return np.stack([j[:-1], j[1:]], axis=-1)
