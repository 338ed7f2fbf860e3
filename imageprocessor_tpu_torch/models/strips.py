"""The space axis: a plan's ops on one packed group split into column
strips across the cards of a replica — the port's counterpart of the
reference's (data x space) path (imageprocessor_tpu/runtime/engine.py:
1079-1088), where XLA partitions the group's width with halo collectives
and the Pallas kernels are turned off. Here each strip is an ordinary
launch of the same kernels on narrower operands: no kernel changes, and
none is turned off.

Strip k owns bucket columns [x_k, x_{k+1}) (parallel/mesh.strip_bounds,
multiples of 16) and its card holds them with a 16-column halo each side
(strip_halos). Who computes what:

* B1 decodes the strip's coefficient columns with their halo
  (runtime/engine.py); the halo columns are decoded and never used;
* B2 and B4: output column j of image i belongs to the strip that holds
  its left tap c0[i, j]. c0 never decreases along j, so each strip owns
  one contiguous range of each image's output columns, and launches once
  on the tap tables of those columns, rebased into its slice (the right
  tap, at most c0 + 1, lies in the halo). The thumbnail's crop offsets
  are folded into c0, so the same rule serves it;
* crop: output column j reads source column cx_i + j and belongs to the
  strip that holds that column (the one-card crop's gather);
* grayscale, flip vertical and the watermark blend keep columns where
  they are: output strip k is source strip k. The blend anchors in the
  whole bucket and writes only the strip's own columns;
* flip horizontal: output strip k reads source columns [w_i - x_{k+1},
  w_i - x_k) of each image, copied across from the cards that own them;
* rotate: the output's columns come from source rows across every strip,
  so each image is gathered alone onto the replica's first card and
  rotated there by ops/extra.py's op: memory there is one image;
* B3 encodes each 16-aligned output strip of a full-bucket op
  (runtime/engine.py).

Every output pixel is computed by the same arithmetic as on one card, so
the artifacts are byte-identical to space_axis=1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from imageprocessor_tpu_torch.domain import OperationType
from imageprocessor_tpu_torch.models.pipeline import (
    OpOutputSpec,
    fused_pair,
    step_taps,
)
from imageprocessor_tpu_torch.ops.extra import (
    batched_flip,
    batched_grayscale_planar,
    batched_rotate,
    crop_indices,
    gather_planar,
)
from imageprocessor_tpu_torch.ops.fused_resample import Taps, fused_resample
from imageprocessor_tpu_torch.ops.planar_resample import planar_resample
from imageprocessor_tpu_torch.ops.watermark import (
    quantize_tile,
    rasterize_text,
    resolve_color,
    watermark_planar_,
)
from imageprocessor_tpu_torch.parallel.mesh import owned_ranges, strip_halos


class Strips:
    """A packed group as column strips: parts[k] is (B, 3, Hb, b_k - a_k)
    u8 on strip k's card, bucket columns [a_k, b_k) = halos[k], of which
    it owns [x_k, x_{k+1}) = bounds[k:k + 2]."""

    def __init__(self, parts: list[torch.Tensor], bounds: list[int], src_hw):
        self.parts = parts
        self.bounds = bounds
        self.halos = strip_halos(bounds)
        self.src_hw = np.asarray(src_hw)
        self.bucket = (int(parts[0].shape[2]), bounds[-1])

    def own(self, k: int) -> torch.Tensor:
        """Strip k's own columns (a view)."""
        a = self.halos[k][0]
        return self.parts[k][:, :, :, self.bounds[k] - a:self.bounds[k + 1] - a]

    def owned(self) -> np.ndarray:
        """(n, B, 2): every image's output columns [x_k, x_{k+1}) in strip
        k, for an op that keeps columns where they are."""
        b = self.src_hw.shape[0]
        return np.array([[(lo, hi)] * b for lo, hi in
                         zip(self.bounds[:-1], self.bounds[1:])], np.int64)


@dataclass
class StripOut:
    """One op's output over the strips, still on their cards: parts[k]
    (None where strip k owns no column) holds image i's output columns
    [j0, j1) = ranges[k, i] in its first j1 - j0 columns."""

    parts: list[torch.Tensor | None]
    ranges: np.ndarray     # (n, B, 2)
    canvas: tuple[int, int]

    @property
    def shape(self) -> tuple[int, int, int, int]:
        """(B, 3, h, w) of the whole output, as a tensor's."""
        return (self.ranges.shape[1], 3, *self.canvas)

    def to_host(self, h: int, w: int) -> np.ndarray:
        """The output's top-left (h, w) as one (B, 3, h, w) host array."""
        out = np.empty((self.ranges.shape[1], 3, h, w), np.uint8)
        for part, rng in zip(self.parts, self.ranges):
            j0, j1 = rng[:, 0], np.minimum(rng[:, 1], w)
            n = j1 - j0
            if part is None or n.max() <= 0:
                continue
            host = part[:, :, :h, :int(n.max())].cpu().numpy()
            if (j0 == j0[0]).all() and (j1 == j1[0]).all():
                out[:, :, :, j0[0]:j1[0]] = host
                continue
            for i in np.flatnonzero(n > 0):
                out[i, :, :, j0[i]:j1[i]] = host[i, :, :, :n[i]]
        return out


def _strip_cols(table: np.ndarray, rng: np.ndarray) -> np.ndarray | None:
    """Columns [j0, j1) = rng[i] of each row of ``table`` (B, w), from
    column 0 of a (B, max(j1 - j0)) table; a shorter row repeats its last
    column (a row with none, a clipped column j0). None where no row has
    any."""
    j0, j1 = rng[:, 0], rng[:, 1]
    wk = int((j1 - j0).max())
    if wk <= 0:
        return None
    idx = np.minimum(j0[:, None] + np.arange(wk), np.maximum(j1 - 1, j0)[:, None])
    return np.take_along_axis(table, np.minimum(idx, table.shape[1] - 1), axis=1)


def _strip_taps(t: Taps, rng: np.ndarray, halo: tuple[int, int],
                device: torch.device) -> Taps | None:
    """The tap tables of the output columns one strip owns, the column
    taps rebased into its halo'd slice [a, b); the row tables whole."""
    c0 = _strip_cols(t.c0.numpy(), rng)
    if c0 is None:
        return None
    a, b = halo
    c1, fx = (_strip_cols(x.numpy(), rng) for x in (t.c1, t.fx))
    c0, c1 = (np.clip(c - a, 0, b - a - 1).astype(np.int32) for c in (c0, c1))
    return Taps(t.r0, t.r1, t.fy,
                *(torch.from_numpy(np.ascontiguousarray(x)) for x in (c0, c1, fx))
                ).to(device)


def _mirror(strips: Strips, k: int) -> torch.Tensor:
    """Output strip k of a horizontal flip, on strip k's card: output
    column j < w_i reads source column w_i - 1 - j, copied from the card
    that owns it; j >= w_i reads column 0 (batched_flip's clamp)."""
    x0, x1 = strips.bounds[k], strips.bounds[k + 1]
    dev = strips.parts[k].device
    b, hb = strips.src_hw.shape[0], strips.bucket[0]
    out = torch.empty((b, 3, hb, x1 - x0), dtype=torch.uint8, device=dev)
    for i, w in enumerate(int(v) for v in strips.src_hw[:, 1]):
        for m, (a, _b) in enumerate(strips.halos):
            lo = max(w - x1, strips.bounds[m])
            hi = min(w - x0, strips.bounds[m + 1])
            if lo < hi:
                piece = strips.parts[m][i, :, :, lo - a:hi - a].to(dev)
                out[i, :, :, w - hi - x0:w - lo - x0] = piece.flip(-1)
        if x1 > max(w, x0):
            out[i, :, :, max(w, x0) - x0:] = strips.parts[0][i, :, :, :1].to(dev)
    return out


def _rotate(strips: Strips, angle: float, crop: tuple[int, int]) -> np.ndarray:
    """A rotate's output on the host, cropped to ``crop``: each image
    gathered alone onto the first strip's card and rotated there."""
    dev = strips.parts[0].device
    n = len(strips.parts)
    outs = []
    for i in range(strips.src_hw.shape[0]):
        img = torch.cat([strips.own(k)[i:i + 1].to(dev) for k in range(n)], dim=3)
        rot = batched_rotate(img, strips.src_hw[i:i + 1], angle)
        outs.append(rot[0, :, :crop[0], :crop[1]].cpu().numpy())
    return np.stack(outs)


def step_strips(strips: Strips, out_hws: dict[int, np.ndarray],
                specs: tuple[OpOutputSpec, ...],
                crops: dict[int, tuple[int, int]]) -> list:
    """A plan's ops on the strips of one group, as models/pipeline.step_chw
    runs them on one card: B2 for the fused pair and B4 for the other
    resamples, once per strip; the tensor ops of ops/extra.py; then the
    watermarks into the strips in place.

    out_hws: op index -> (B, 2) valid output dims; specs:
    plan_output_specs of the plan; crops: op index -> the (h, w) a
    rotate's output is cropped to before it leaves the card. Returns per
    op, in plan order, a StripOut, or for a rotate the (B, 3, h, w) host
    array."""
    src_hw = strips.src_hw
    bh, bw = strips.bucket
    bounds, n = strips.bounds, len(strips.parts)
    outs: list = [None] * len(specs)
    # the resamples: host tap tables of the whole bucket, split by c0
    taps = step_taps(strips.bucket, src_hw, out_hws, specs, torch.device("cpu"))
    ranges = {i: owned_ranges(t.c0.numpy(), bounds) for i, t in taps.items()}
    parts: dict[int, list] = {i: [None] * n for i in taps}
    pair = fused_pair(specs)
    for k, src in enumerate(strips.parts):
        tk = {i: _strip_taps(t, ranges[i][k], strips.halos[k], src.device)
              for i, t in taps.items()}
        if pair is not None and (tk[pair[0]] is not None or tk[pair[1]] is not None):
            parts[pair[0]][k], parts[pair[1]][k] = fused_resample(
                src, tk[pair[0]], tk[pair[1]])
        for i, t in tk.items():
            if t is not None and (pair is None or i not in pair):
                parts[i][k] = planar_resample(src, t)
    for i in taps:
        outs[i] = StripOut(parts[i], ranges[i], specs[i].canvas)
    owned = strips.owned()
    for i, spec in enumerate(specs):
        op = spec.op
        if op.type is OperationType.GRAYSCALE:
            outs[i] = StripOut([batched_grayscale_planar(strips.own(k))
                                for k in range(n)], owned, strips.bucket)
        elif op.type is OperationType.FLIP:
            outs[i] = StripOut([
                _mirror(strips, k) if op.direction != "vertical"
                else batched_flip(strips.own(k), src_hw, "vertical")
                for k in range(n)], owned, strips.bucket)
        elif op.type is OperationType.CROP:
            ry, rx = crop_indices(src_hw, op.x, op.y, min(op.width, bw),
                                  min(op.height, bh), bh, bw)
            rng = owned_ranges(rx, bounds)
            crop_parts = []
            for k, src in enumerate(strips.parts):
                cols = _strip_cols(rx, rng[k])
                crop_parts.append(None if cols is None else gather_planar(
                    src, torch.from_numpy(ry).to(src.device),
                    torch.from_numpy(cols - strips.halos[k][0]).to(src.device)))
            outs[i] = StripOut(crop_parts, rng, (ry.shape[1], rx.shape[1]))
        elif op.type is OperationType.ROTATE:
            outs[i] = _rotate(strips, op.angle, crops[i])
    marks = [i for i, s in enumerate(specs) if s.op.type is OperationType.WATERMARK]
    for m, i in enumerate(marks):
        op = specs[i].op
        tile = quantize_tile(rasterize_text(op.text, op.font_size))
        r, g, b, a = resolve_color(op.font_color, op.opacity)
        wm_parts = []
        for k in range(n):
            canvas = strips.parts[k] if m == len(marks) - 1 else strips.parts[k].clone()
            base = strips.halos[k][0]
            watermark_planar_(canvas, src_hw, tile, (r, g, b), a / 255.0,
                              op.position, strip=(base, bounds[k], bounds[k + 1], bw))
            wm_parts.append(canvas[:, :, :, bounds[k] - base:bounds[k + 1] - base])
        outs[i] = StripOut(wm_parts, owned, strips.bucket)
    return outs
