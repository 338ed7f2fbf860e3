"""The least time the card could take for the work of kernels B1 and B2.

Counted from each image's own extent, never from the program's bucket or
its pad rows, so that a change which stops decoding the padding shows as
a gain rather than shrinking its own bound. The byte rules are those the
repository's chip checks used (``b1_bound``, ``resample_bound``): each
input byte read once, each output byte written once, a resample's source
counted in the 32-byte sectors its taps touch. Peaks: NVIDIA's data
sheet for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

import functools

import numpy as np

HBM_BYTES_S = 3.35e12      # H100 SXM device memory, bytes/s
FP32_FLOP_S = 67e12        # H100 SXM FP32 outside the tensor cores
SECTOR = 32                # bytes the card's memory moves at once
THUMBNAIL = 200
RESIZE_W, RESIZE_H = 1024, 768


def bound_s(nbytes: float, flop: float) -> tuple[float, str]:
    """(seconds, what sets them) for work that moves ``nbytes`` and
    computes ``flop`` FP32 operations."""
    tb, tf = nbytes / HBM_BYTES_S, flop / FP32_FLOP_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def b1_work(h: int, w: int, fh: int = 2, fw: int = 2) -> tuple[float, float]:
    """(bytes, FP32 operations) of decoding one h x w JPEG with chroma
    subsampled fh x fw: the int16 coefficients of its MCU grid and its
    three float32 quantization tables read once, 3*h*w RGB bytes written
    once. Operations as ``b1_bound``: 20 per coefficient, the [0, 255]
    clamp of subsampled chroma (4 per chroma sample), and per pixel
    BT.601, rounding and the fancy upsample's taps."""
    gh = -(-h // (8 * fh)) * 8 * fh
    gw = -(-w // (8 * fw)) * 8 * fw
    chroma = (gh // fh) * (gw // fw)
    coefs = gh * gw + 2 * chroma
    nbytes = 2 * coefs + 3 * 64 * 4 + 3 * h * w
    up = 2 * ((2 / fw if fh == 2 else 0) + (2 if fw == 2 else 0))
    clamp = 4 * 2 * chroma if fh * fw > 1 else 0
    return float(nbytes), 20.0 * coefs + clamp + (19 + up) * h * w


def taps(src: int, dst: int, offset: int = 0) -> np.ndarray:
    """The source indices Go's xdraw.BiLinear reads for ``dst`` outputs
    from ``src`` inputs starting at ``offset``: both taps of each."""
    d = np.arange(dst, dtype=np.float64)
    s = np.clip((d + 0.5) * (src / dst) - 0.5, 0.0, src - 1.0)
    i0 = np.floor(s).astype(np.int64)
    return offset + np.unique(np.concatenate([i0, np.minimum(i0 + 1, src - 1)]))


def resize_dims(h: int, w: int) -> tuple[int, int]:
    """(h, w) of the 1024x768 keep-aspect resize."""
    ratio = min(RESIZE_W / w, RESIZE_H / h)
    return max(int(h * ratio), 1), max(int(w * ratio), 1)


@functools.lru_cache(maxsize=64)
def b2_work(h: int, w: int) -> tuple[float, float]:
    """(bytes, FP32 operations) of the thumbnail 200 crop-to-fit and the
    1024x768 keep-aspect resize of one h x w image in one pass: per
    source row, the 32-byte sectors of the columns that the outputs
    touching that row read, in each of 3 planes; both outputs written
    once; the tap tables (two int32 indices and a float32 weight per
    output row and column); 11 operations per output sample."""
    side = min(h, w)
    cy, cx = (h - side) // 2, (w - side) // 2
    rh, rw = resize_dims(h, w)
    grids = [(taps(side, THUMBNAIL, cy), taps(side, THUMBNAIL, cx)),
             (taps(h, rh), taps(w, rw))]
    members: dict[int, int] = {}
    for k, (rows, _cols) in enumerate(grids):
        for r in rows.tolist():
            members[r] = members.get(r, 0) | (1 << k)
    sectors = 0
    for mask in set(members.values()):
        n_rows = sum(1 for m in members.values() if m == mask)
        cols = np.unique(np.concatenate([c for k, (_r, c) in enumerate(grids)
                                         if mask >> k & 1]))
        sectors += n_rows * len(np.unique(cols // SECTOR))
    outs = 3 * (THUMBNAIL * THUMBNAIL + rh * rw)
    tables = 12 * (2 * THUMBNAIL + rh + rw)
    return 3.0 * SECTOR * sectors + outs + tables, 11.0 * outs
