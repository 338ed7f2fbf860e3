"""Seeded baseline JPEG streams for kernel B0's tests, and B0 over a group
of them (tests/test_torch_jpeg_entropy.py on the CPU, tests/test_torch_gpu.py
on the card).

Test files import it as the top-level module ``jpeg_streams`` (pytest puts
this directory on the path), not as ``tests.jpeg_streams``: on a host
where some installed package is named ``tests``, that package shadows this
directory."""

from __future__ import annotations

import cv2
import numpy as np
import torch

from imageprocessor_tpu_torch.ops import jpeg_entropy as je
from imageprocessor_tpu_torch.runtime import hostcodec

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "gray": None}
SIZES = [(8, 8), (17, 23), (255, 129), (640, 480)]


def jpeg(h, w, sampling="420", quality=85, restart=0, seed=0, progressive=False):
    """An OpenCV JPEG of a seeded gradient with noise."""
    rng = np.random.default_rng(seed)
    img = np.clip(np.linspace(0, 200, h)[:, None, None]
                  + np.linspace(0, 50, w)[None, :, None]
                  + rng.integers(0, 60, (h, w, 3)), 0, 255).astype(np.uint8)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if sampling == "gray":
        img = img[:, :, 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def entropy_span(blob):
    """(first byte of the entropy-coded data, the EOI's offset)."""
    start = blob.index(b"\xff\xda")
    start += 2 + int.from_bytes(blob[start + 2:start + 4], "big")
    return start, blob.rindex(b"\xff\xd9")


def cut(blob):
    """The entropy-coded data cut in half, the EOI kept."""
    start, eoi = entropy_span(blob)
    return blob[:start + (eoi - start) // 2] + b"\xff\xd9"


def bad_code(blob):
    """32 one bits (four stuffed FF bytes) in the middle of the entropy
    data: no Huffman code of the tables starts inside them."""
    start, eoi = entropy_span(blob)
    mid = (start + eoi) // 2
    while blob[mid - 1] == 0xFF or blob[mid] == 0xFF:
        mid += 1
    return blob[:mid] + b"\xff\x00" * 4 + blob[mid:]


def decode(blobs, device="cpu", subseq_bits=je.SUBSEQ_BITS, canvas_pad=(8, 16)):
    """B0 over ``blobs`` as one group on ``device`` (the plain version on
    the CPU), each in its own slot of canvases a little larger than the
    largest plane. -> (canvases on the CPU, status, rounds)."""
    streams = [je.stage(b) for b in blobs]
    shapes = [hostcodec.scan_jpeg_layout(b)[0] for b in blobs]
    canvases = [torch.zeros((len(blobs),
                             max(s[c][0] for s in shapes) + canvas_pad[0],
                             max(s[c][1] for s in shapes) + canvas_pad[1]),
                            dtype=torch.int16, device=device)
                for c in range(len(shapes[0]))]
    ops = je.upload(streams, list(range(len(blobs))), device, subseq_bits)
    status, rounds = je.decode(ops, canvases)
    return [c.cpu() for c in canvases], status, rounds


def assert_scans_equal(canvases, blobs):
    """Each slot of ``canvases`` holds its blob's host-scan planes and
    zeros around them."""
    for i, blob in enumerate(blobs):
        planes = hostcodec.scan_jpeg_coefficients(blob)[0]
        for c, p in zip(canvases, planes):
            got = c[i].numpy()
            assert np.array_equal(got[:p.shape[0], :p.shape[1]], p)
            assert not got[p.shape[0]:].any() and not got[:, p.shape[1]:].any()
