"""The originals a cell uploads: photo-like images made from the seed.

A phone photo is smooth sky and walls, straight sharp edges, texture and
sensor noise. Its entropy scan costs with its bytes, so a gradient with
noise (some 0.16 bytes per pixel at q85) would understate the host's
work. Each image here sums four octaves of value noise (the scene),
low-frequency chroma, a dozen sharp straight edges and Gaussian sensor
noise, and is encoded as a q85 4:2:0 JPEG by OpenCV, as a camera or a
browser would hand it over.

The pixels are made on the device in a few large calls from a
``torch.Generator`` seeded with the run's seed, and only the JPEG bytes
leave this module: the program and the reference both start from them.
"""

from __future__ import annotations

import concurrent.futures
from dataclasses import dataclass

import cv2
import numpy as np
import torch
import torch.nn.functional as F

JPEG_QUALITY = 85
# (grid cell in px, amplitude) of the scene's octaves; the two finest are
# texture, which a low-frequency mask turns up in some regions (foliage,
# fabric) and down in others (sky)
OCTAVES = ((384, 40.0), (96, 20.0), (24, 16.0), (6, 28.0), (2, 40.0))
TEXTURE_OCTAVES = 2
EDGES = 12
NOISE_SIGMA = 6.0


@dataclass
class Original:
    kind: str        # the pool it belongs to, as the traffic file names it
    index: int       # its place in that pool
    jpeg: bytes
    h: int
    w: int
    path: str = ""   # where the store keeps it, once saved


def _value_noise(gen, n, c, h, w, cell, device):
    g = torch.rand((n, c, h // cell + 2, w // cell + 2), generator=gen,
                   device=device) * 2.0 - 1.0
    return F.interpolate(g, size=(h, w), mode="bicubic", align_corners=False)


def synthesize(gen: torch.Generator, n: int, h: int, w: int,
               device) -> np.ndarray:
    """(n, h, w, 3) uint8 RGB photo-like images."""
    lum = torch.zeros((n, 1, h, w), device=device)
    mask = 1.0 + 0.8 * _value_noise(gen, n, 1, h, w, 512, device)
    for k, (cell, amp) in enumerate(OCTAVES):
        octave = amp * _value_noise(gen, n, 1, h, w, cell, device)
        lum += octave * mask if k >= len(OCTAVES) - TEXTURE_OCTAVES else octave
    chroma = 20.0 * _value_noise(gen, n, 3, h, w, 256, device)
    # sharp straight edges: a step of random height along a random line
    yy = torch.linspace(-1.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(-1.0, 1.0, w, device=device)[None, :]
    p = torch.rand((n, EDGES, 4), generator=gen, device=device)
    for i in range(n):
        for k in range(EDGES):
            a, b, c, s = p[i, k]
            ang = a * 2 * np.pi
            d = torch.cos(ang) * xx + torch.sin(ang) * yy - (c * 1.6 - 0.8)
            lum[i, 0] += (s - 0.5) * 60.0 * torch.sigmoid(d * (h / 1.5))
    noise = NOISE_SIGMA * torch.randn((n, 3, h, w), generator=gen, device=device)
    rgb = (128.0 + lum + chroma + noise).clamp_(0, 255).round_().to(torch.uint8)
    return rgb.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def encode(rgb: np.ndarray) -> bytes:
    ok, out = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY])
    if not ok:
        raise RuntimeError("cv2 could not encode an original")
    return out.tobytes()


def make_pools(pools: dict, seed: int, device) -> dict[str, list[Original]]:
    """{kind: [Original]} for the traffic file's ``pools`` ({kind: {"h",
    "w", "count"}}), the same bytes for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    out: dict[str, list[Original]] = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        for kind in sorted(pools):
            p = pools[kind]
            h, w, count = int(p["h"]), int(p["w"]), int(p["count"])
            jpegs = []
            for start in range(0, count, 4):   # a few images per call
                rgb = synthesize(gen, min(4, count - start), h, w, device)
                jpegs += list(ex.map(encode, rgb))
            out[kind] = [Original(kind, i, j, h, w) for i, j in enumerate(jpegs)]
    return out
