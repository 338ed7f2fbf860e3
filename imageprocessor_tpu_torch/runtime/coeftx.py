"""Lossless coefficient-domain flip / rotate / crop (jpegtran-style).

The reference declares crop/rotate/flip operation types but rejects them
at dispatch (reference: internal/domain/image.go:42-50,
internal/worker/image_processor.go:118-120); this framework implements
them on-device (ops/extra.py). For JPEG sources with JPEG outputs, the
90-degree rotations, both mirrors, and MCU-aligned crops are *exactly*
expressible as permutations of the quantized coefficient blocks — the
classic jpegtran transforms:

* flip_h: reverse each plane's block columns; negate odd horizontal
  frequencies within every block (mirroring samples n -> 7-n maps the
  DCT-II basis cos((2n+1)v*pi/16) to (-1)^v times itself);
* flip_v: the transpose of that argument on rows;
* transpose: transpose the block grid AND each 8x8 block (the 2-D DCT
  of a transposed tile is the transposed coefficient tile); sampling
  factors and image dims swap;
* rot90ccw = transpose(flip_h(.)), rot270 = transpose(flip_v(.)),
  rot180 = flip_h(flip_v(.)) — matching np.rot90's CCW convention used
  by ops/extra.rotate_image;
* crop: drop whole MCU rows/columns when the origin is MCU-aligned
  (the right/bottom edges may cut mid-block because JPEG dims already
  do); UNALIGNED origins go through the same banded-shift machinery as
  the `_rs` mirrors (_crop_shift_axis) — each component shifts by its
  exact subsample-area map and requantizes once, both axes composed
  before the single requant, with per-component alignment detection
  (x % 8 == 0 keeps luma lossless even when chroma shifts).

Serving these from the coefficient stream skips the pixel decode AND
the re-encode entirely: decoded output pixels are bit-identical to
running the pixel op on the decoded source (the transforms commute with
the IDCT/upsample exactly), with zero generation loss — strictly more
faithful than the pixel path's q85 re-encode, the same (documented)
fidelity divergence as the watermark splice (PARITY.md).

Expressibility starts from jpegtran's "perfect transform" rules: a
mirror is LOSSLESS only when the axis it folds is a whole number of
MCUs (else the partial edge block lands on the leading edge, which the
JFIF block grid cannot represent). The `_rs` extension widens that to
any axis where the fold is still an exact sample SELECTION per
component (dim a multiple of every component's subsample factor):
misaligned components mirror by an exact DCT-domain shift and pay ONE
requantization with their own source table (see _mirror_prim /
_shift_mirror) — 1080-class dims keep luma bit-exact, 1366-class even
dims shift luma too. Odd dims on a subsampled axis, where the mirrored
chroma lattice falls between source samples, use the exact
subsample-area two-tap mirror (_shift_mirror frac=r/f) — so every
mirror/rotation dim is expressible. Ineligible geometry (odd rotation
angles, unaligned crop origins) falls back to the pixel path — never a
trimmed or shifted output.
"""

from __future__ import annotations

import os

import numpy as np

from imageprocessor_tpu_torch.domain import OperationType
from imageprocessor_tpu_torch.runtime import splice
from imageprocessor_tpu_torch.runtime.hostcodec import JpegSpliceContext

#: op types this module can serve (watermark is runtime/splice.py's job)
TX_TYPES = frozenset(
    {OperationType.CROP, OperationType.ROTATE, OperationType.FLIP})

_SIGN8 = np.array([1, -1, 1, -1, 1, -1, 1, -1], dtype=np.int16)


def _flip_h_plane(p: np.ndarray) -> np.ndarray:
    hp, wp = p.shape
    v = p.reshape(hp, wp // 8, 8)[:, ::-1, :] * _SIGN8[None, None, :]
    return v.reshape(hp, wp)


def _flip_v_plane(p: np.ndarray) -> np.ndarray:
    hp, wp = p.shape
    v = p.reshape(hp // 8, 8, wp)[::-1] * _SIGN8[None, :, None]
    return v.reshape(hp, wp)


def rs_enabled() -> bool:
    """Shift (`_rs`) mirrors are a FIDELITY-vs-host-ms tradeoff:
    block-aligned components stay bit-exact, shifted ones pay a single
    source-table requant, but the path measured ~2.4x the host cost of
    the SIMD pixel path (PERF.md "Half-MCU mirrors") — the scan+emit
    pair alone costs what libjpeg-turbo's whole decode+encode does.
    Default on (the framework is fidelity-first, like the splice
    quantization choice); IMAGEPROCESSOR_COEF_RS=0 reverts those
    shapes to the pixel path."""
    return os.environ.get("IMAGEPROCESSOR_COEF_RS", "1").lower() \
        not in ("0", "false", "no")


def _mirror_prim(dim: int, factors: list) -> str | None:
    """Mirror primitive for folding an axis of `dim` pixels, given each
    component's subsample factor along that axis: the exact block
    mirror when every component's sample extent is block-aligned;
    otherwise the `_rs` variant, valid whenever the fold is still an
    exact sample SELECTION for every component — i.e. `dim` is a
    multiple of each factor. Components whose extent stays 8-aligned
    mirror bit-exact; misaligned ones mirror by a DCT-domain shift (two
    fixed 8x8 matrices mixing adjacent blocks, _shift_mirror) and
    requantize ONCE with their own source table. This expresses
    1920x1080 (chroma shift only, luma bit-exact — 1080 % 16 == 8) and
    1366/1334-class even dims (luma shifts too — 1366 % 8 == 6), plus
    ANY dim on axes where nothing is subsampled (4:4:4 both axes,
    4:2:2 vertically, grayscale). When a subsampled component's
    lattice does not divide `dim` (odd dim at 4:2:0), the mirrored
    chroma sample covers a SPLIT of two source samples — still an
    exact banded linear map (the subsample-area two-tap mirror,
    _shift_mirror frac=r/f), so every dim is expressible; measured
    fidelity still beats the pixel path (tests, PERF.md). None only
    when rs is disabled by knob."""
    if all(dim % (8 * f) == 0 for f in factors):
        return ""
    if rs_enabled():
        return "_rs"
    return None


def _axis_factors(sampling, axis: int) -> list:
    """Per-component subsample factor along `axis` (0 = vertical fold,
    1 = horizontal fold) relative to luma."""
    hy, vy = sampling[0]
    return [(vy // vc) if axis == 0 else (hy // hc)
            for (hc, vc) in sampling]


def eligible_prims(op, size, sampling) -> list | None:
    """Primitive list expressing `op` on an image of `size` (w, h) with
    luma `sampling[0]`, or None when inexpressible (odd rotation
    angles; with IMAGEPROCESSOR_COEF_RS=0, also non-MCU-aligned
    mirrors and crop origins). Pure geometry — callers still gate the
    stream itself via splice.coef_reencodable."""
    w, h = size
    hy, vy = sampling[0]
    mw, mh = 8 * hy, 8 * vy
    fw, fh = _axis_factors(sampling, 1), _axis_factors(sampling, 0)
    t = op.type
    if t is OperationType.FLIP:
        if op.direction == "vertical":
            sv = _mirror_prim(h, fh)
            return None if sv is None else ["flip_v" + sv]
        sh = _mirror_prim(w, fw)
        return None if sh is None else ["flip_h" + sh]
    if t is OperationType.ROTATE:
        a = op.angle % 360.0
        if a == 0.0:
            return []
        if a == 90.0:
            sh = _mirror_prim(w, fw)
            return None if sh is None else ["flip_h" + sh, "transpose"]
        if a == 180.0:
            sh, sv = _mirror_prim(w, fw), _mirror_prim(h, fh)
            return (None if sh is None or sv is None
                    else ["flip_h" + sh, "flip_v" + sv])
        if a == 270.0:
            sv = _mirror_prim(h, fh)
            return None if sv is None else ["flip_v" + sv, "transpose"]
        return None
    if t is OperationType.CROP:
        # Same clamping as ops/extra.crop_image, so the coefficient
        # rendition matches the pixel path's output dims exactly.
        x = min(max(op.x, 0), w - 1)
        y = min(max(op.y, 0), h - 1)
        cw = max(1, min(op.width, w - x))
        ch = max(1, min(op.height, h - y))
        if (x % mw or y % mh) and not rs_enabled():
            # unaligned origin: servable only through the rs shift path
            return None
        return [("crop", x, y, cw, ch)]
    return None


def _mirror_blocks(p: np.ndarray, extent: int, axis: int) -> np.ndarray:
    """Exact block mirror of only the VALID blocks along one axis
    (extent % 8 == 0); padding blocks beyond the extent zero out (they
    decode to discarded samples, and zero blocks cost the least to
    re-symbolize). Distinct from _flip_h/_flip_v_plane, which mirror
    the WHOLE plane and are only correct when it carries no padding
    blocks on that axis."""
    nb = extent // 8
    out = np.zeros_like(p)
    if axis == 0:
        v = p.reshape(-1, 8, p.shape[1])
        out.reshape(-1, 8, p.shape[1])[:nb] = \
            v[:nb][::-1] * _SIGN8[None, :, None]
    else:
        v = p.reshape(p.shape[0], -1, 8)
        out.reshape(p.shape[0], -1, 8)[:, :nb] = \
            v[:, :nb][:, ::-1] * _SIGN8[None, None, :]
    return out


def _shift_mirror(plane: np.ndarray, qtab: np.ndarray, extent: int,
                  axis: int, frac: float = 1.0) -> np.ndarray:
    """Mirror a component whose sample extent is NOT block-aligned
    entirely in the DCT domain. The sample-domain mirror
        out[i] = frac * in[(extent-1)-i] + (1-frac) * in[(extent-2)-i]
    (frac == 1: the pure selection for axes the component's lattice
    divides; frac == r/f: the EXACT subsample-area mirror of a
    component subsampled by f on an axis of f*m+r luma pixels — each
    mirrored output chroma sample covers r source pixels of in[m-i]
    and f-r of in[m-1-i]) makes each output block a fixed row-map of
    TWO adjacent input blocks (split at a = (extent-1) % 8);
    conjugating those banded matrices with the orthonormal DCT basis
    gives two 8x8 matrices A, B such that
        out_coef[J] = A @ dq[bh(J)] + B @ dq[bh(J)-1]
    — two batched matmuls over the whole plane, then ONE
    requantization with the component's own table (the only loss; the
    map itself is exact). Output blocks past the extent (padding) zero
    out; input padding samples are never read (the taps stop at the
    last partial block's valid rows), and the single sample whose
    second tap would read in[-1] (i = extent-1, present only when
    frac < 1) clamps to in[0] — which IS its exact value: the r luma
    pixels it covers all fall inside source chroma sample 0."""
    d = splice._dct_basis()
    q = np.asarray(qtab, dtype=np.float64).reshape(8, 8)
    hp, wp = plane.shape
    x = plane.reshape(hp // 8, 8, wp // 8, 8).astype(np.float64) \
        * q[None, :, None, :]
    a = (extent - 1) % 8
    m1 = np.zeros((8, 8))
    m2 = np.zeros((8, 8))
    for u in range(8):
        for tap, wgt in ((0, frac), (1, 1.0 - frac)):
            if wgt == 0.0:
                continue
            r = a - u - tap
            if r >= 0:
                m1[u, r] += wgt
            else:
                m2[u, 8 + r] += wgt
    A = d @ m1 @ d.T
    B = d @ m2 @ d.T
    nv = -(-extent // 8)
    out = np.zeros_like(x)
    # bh(J) = (extent-1-8J)//8 decreases by exactly 1 per J, so the
    # "gathers" are reversed slices (views) and the J with bh-1 < 0 is
    # only the last — a zero pad block instead of an np.where over the
    # whole plane; matmul batches the 8x8 maps through BLAS (the
    # equivalent einsum runs ~5x slower as a generic loop)
    if axis == 0:
        c1 = x[nv - 1::-1]
        c2 = np.zeros((nv,) + x.shape[1:])
        if nv > 1:
            c2[:nv - 1] = x[nv - 2::-1]
        v = np.matmul(A, c1.reshape(nv, 8, -1)) \
            + np.matmul(B, c2.reshape(nv, 8, -1))
        out[:nv] = v.reshape((nv,) + x.shape[1:])
    else:
        c1 = x[:, :, nv - 1::-1]
        c2 = np.zeros(x.shape[:2] + (nv, 8))
        if nv > 1:
            c2[:, :, :nv - 1] = x[:, :, nv - 2::-1]
        out[:, :, :nv] = np.matmul(c1, A.T) + np.matmul(c2, B.T)
    if frac < 1.0:
        # the i = extent-1 clamp: re-map the last valid block's row a
        # with the (1-frac) weight folded onto in[0] (block bh == 0,
        # whose m2 term the where() above zeroed)
        m1c = m1.copy()
        m1c[a, 0] += 1.0 - frac
        Ac = d @ m1c @ d.T
        jl = nv - 1
        if axis == 0:
            out[jl] = np.tensordot(Ac, x[0], axes=([1], [0]))
        else:
            out[:, :, jl] = np.tensordot(x[:, :, 0], Ac.T,
                                         axes=([2], [0]))
    res = np.clip(np.round(out / q[None, :, None, :]), -1023, 1023)
    return res.astype(np.int16).reshape(hp, wp)


def _crop_shift_axis(xf: np.ndarray, q0: int, frac: float, ext_out: int,
                     ext_src: int, nbout: int, axis: int) -> np.ndarray:
    """Banded crop shift along one axis of a DEQUANTIZED block tensor
    (shape (H8, 8, W8, 8), float64):
        out[i] = (1-frac) * in[q0+i] + frac * in[q0+i+1]
    — the exact subsample-area map of cropping a component at sample
    offset q0 + frac (frac = (x % f)/f for a component subsampled by
    f; frac == 0 is the pure selection). Same construction as
    _shift_mirror: per output block J the taps read input blocks
    b0+J and b0+J+1 through two fixed 8x8 basis-conjugated matrices.
    Output blocks are padded/truncated to `nbout` (the cropped image's
    MCU grid); the single output sample whose second tap would read
    source PADDING (q0+ext_out == ext_src, crop reaching the image
    edge mid-straddle) clamps that tap onto its first — replicating
    the final valid sample, exactly what the crop's own edge padding
    region calls for. Returns floats — the caller requantizes ONCE
    after composing both axes."""
    a0, b0 = q0 % 8, q0 // 8
    nbin = xf.shape[0 if axis == 0 else 2]
    nv = -(-ext_out // 8)
    sh = list(xf.shape)
    sh[0 if axis == 0 else 2] = nbout
    out = np.zeros(sh)
    if frac == 0.0 and a0 == 0:
        take = min(nv, nbin - b0)
        if axis == 0:
            out[:take] = xf[b0:b0 + take]
        else:
            out[:, :, :take] = xf[:, :, b0:b0 + take]
        return out
    d = splice._dct_basis()
    m1 = np.zeros((8, 8))
    m2 = np.zeros((8, 8))
    for u in range(8):
        for tap, wgt in ((0, 1.0 - frac), (1, frac)):
            if wgt == 0.0:
                continue
            r = a0 + u + tap
            (m1 if r < 8 else m2)[u, r % 8] += wgt
    A = d @ m1 @ d.T
    B = d @ m2 @ d.T
    # contiguous block windows instead of fancy-index gathers (b0+J and
    # b0+J+1 are plain slices; clamped/missing tail blocks come from a
    # zero pad) — the gathers + np.where copies dominated the runtime
    # on 12 MP planes before this
    t1 = min(nv, nbin - b0)
    t2 = min(nv, nbin - b0 - 1)
    if axis == 0:
        c1 = np.zeros((nv,) + xf.shape[1:])
        c1[:t1] = xf[b0:b0 + t1]
        c2 = np.zeros((nv,) + xf.shape[1:])
        if t2 > 0:
            c2[:t2] = xf[b0 + 1:b0 + 1 + t2]
        v = np.matmul(A, c1.reshape(nv, 8, -1)) \
            + np.matmul(B, c2.reshape(nv, 8, -1))
        out[:nv] = v.reshape((nv,) + xf.shape[1:])
    else:
        c1 = np.zeros(xf.shape[:2] + (nv, 8))
        c1[:, :, :t1] = xf[:, :, b0:b0 + t1]
        c2 = np.zeros(xf.shape[:2] + (nv, 8))
        if t2 > 0:
            c2[:, :, :t2] = xf[:, :, b0 + 1:b0 + 1 + t2]
        out[:, :, :nv] = np.matmul(c1, A.T) + np.matmul(c2, B.T)
    if frac > 0.0 and q0 + ext_out >= ext_src:
        # the i = ext_out-1 clamp (see docstring)
        u_l = (ext_out - 1) % 8
        m1c, m2c = m1.copy(), m2.copy()
        r1 = a0 + u_l + 1
        (m1c if r1 < 8 else m2c)[u_l, r1 % 8] -= frac
        r0 = a0 + u_l
        (m1c if r0 < 8 else m2c)[u_l, r0 % 8] += frac
        Ac = d @ m1c @ d.T
        Bc = d @ m2c @ d.T
        jl = nv - 1
        bAj = min(b0 + jl, nbin - 1)
        bBj = min(b0 + jl + 1, nbin - 1)
        okB = b0 + jl + 1 <= nbin - 1
        if axis == 0:
            c2b = xf[bBj] if okB else np.zeros_like(xf[bAj])
            out[jl] = (np.tensordot(Ac, xf[bAj], axes=([1], [0]))
                       + np.tensordot(Bc, c2b, axes=([1], [0])))
        else:
            c2b = xf[:, :, bBj] if okB else np.zeros_like(xf[:, :, bAj])
            out[:, :, jl] = (
                np.tensordot(xf[:, :, bAj], Ac.T, axes=([2], [0]))
                + np.tensordot(c2b, Bc.T, axes=([2], [0])))
    return out


def _mirror_rs(planes, qtabs, size, sampling, axis: int) -> list:
    """Per-component mirror for the `_rs` primitives: components whose
    sample extent is block-aligned AND whose lattice divides the axis
    take the exact integer mirror; misaligned ones take the DCT-domain
    shift mirror + one requantization (pure selection when the lattice
    divides the axis, the exact subsample-area two-tap map when it
    does not — odd dims at 4:2:0)."""
    w, h = size
    hy, vy = sampling[0]
    dim = h if axis == 0 else w
    out = []
    qt = np.asarray(qtabs).reshape(-1, 8, 8)
    for c, (hc, vc) in enumerate(sampling):
        f = (vy // vc) if axis == 0 else (hy // hc)
        r = dim % f
        ext = -(-dim // f)
        if r == 0 and ext % 8 == 0:
            out.append(_mirror_blocks(planes[c], ext, axis))
        elif r == 0:
            out.append(_shift_mirror(planes[c], qt[c], ext, axis))
        else:
            out.append(_shift_mirror(planes[c], qt[c], ext, axis,
                                     frac=r / f))
    return out


def _rot_native(planes, mode: str) -> list | None:
    """The reference fuses a mirror+transpose pair onto a native blocked
    kernel of its libjpeg shim; the port's host library is built without
    libjpeg and has no such kernel, so ``apply`` always takes the numpy
    path below."""
    return None


def apply(ctx: JpegSpliceContext, prims: list) -> JpegSpliceContext:
    """Apply primitives to a context's coefficient planes, returning a
    fresh PSEUDO context (no bit offsets — block order changed, so
    nothing can be bit-copied; the caller re-symbolizes via
    splice.reencode). Never mutates `ctx`. Mirror+transpose pairs fuse
    onto one native blocked pass when the library provides it; the pure
    numpy path below stays as the behavioral reference (the tests run
    both)."""
    planes = list(ctx.planes)
    qtabs = np.asarray(ctx.qtabs)
    w, h = ctx.size
    sampling = [tuple(s) for s in ctx.sampling]
    i = 0
    while i < len(prims):
        pr = prims[i]
        fuse = (prims[i + 1] if pr in ("flip_h", "flip_v")
                and i + 1 < len(prims) else None)
        if fuse == "transpose":
            fused = _rot_native(planes,
                                "rot90" if pr == "flip_h" else "rot270")
            if fused is not None:
                planes = fused
                qtabs = np.ascontiguousarray(np.swapaxes(
                    np.asarray(qtabs).reshape(-1, 8, 8), -1, -2))
                w, h = h, w
                sampling = [(v, u) for (u, v) in sampling]
                i += 2
                continue
        if pr == "flip_h":
            planes = [_flip_h_plane(p) for p in planes]
        elif pr == "flip_v":
            planes = [_flip_v_plane(p) for p in planes]
        elif pr == "flip_h_rs":
            planes = _mirror_rs(planes, qtabs, (w, h), sampling, axis=1)
        elif pr == "flip_v_rs":
            planes = _mirror_rs(planes, qtabs, (w, h), sampling, axis=0)
        elif pr == "transpose":
            planes = [np.ascontiguousarray(p.T) for p in planes]
            # The stored coefficients are QUANTIZED: position (u, v) of
            # a transposed block holds C[v,u]/Q[v,u], so the emitted
            # stream must declare the TRANSPOSED quant tables for the
            # dequantize to multiply the right step back (jpegtran does
            # the same table transpose).
            qtabs = np.ascontiguousarray(np.swapaxes(
                np.asarray(qtabs).reshape(-1, 8, 8), -1, -2))
            w, h = h, w
            sampling = [(v, u) for (u, v) in sampling]
        else:
            _tag, x, y, cw, ch = pr
            hy, vy = sampling[0]
            new_mx = -(-cw // (8 * hy))
            new_my = -(-ch // (8 * vy))
            qt3 = np.asarray(qtabs).reshape(-1, 8, 8)
            out = []
            for c, (hc, vc) in enumerate(sampling):
                fx, fy = hy // hc, vy // vc
                ox, rx = divmod(x, fx)
                oy, ry = divmod(y, fy)
                wb, hb = new_mx * hc, new_my * vc
                if rx == 0 and ry == 0 and ox % 8 == 0 and oy % 8 == 0:
                    # MCU-aligned origin for this component: lossless
                    # integer block slice (the jpegtran-exact path)
                    out.append(np.ascontiguousarray(
                        planes[c][oy:oy + hb * 8, ox:ox + wb * 8]))
                    continue
                # unaligned origin: compose the banded shifts of both
                # axes on the dequantized tensor, requantize ONCE.
                # Dequantize only the input block WINDOW the output
                # reads (output blocks + one tap-B block per axis) —
                # a small crop of a 12 MP source costs its own size,
                # not the source's.
                p = planes[c]
                nbh, nbw = p.shape[0] // 8, p.shape[1] // 8
                bx0, by0 = ox // 8, oy // 8
                ext_w, ext_h = -(-cw // fx), -(-ch // fy)
                tx = min(nbw, bx0 + (-(-ext_w // 8)) + 1) - bx0
                ty = min(nbh, by0 + (-(-ext_h // 8)) + 1) - by0
                win = p[8 * by0:8 * (by0 + ty), 8 * bx0:8 * (bx0 + tx)]
                xf = (win.reshape(ty, 8, tx, 8).astype(np.float64)
                      * qt3[c][None, :, None, :])
                xf = _crop_shift_axis(
                    xf, ox - 8 * bx0, rx / fx, ext_w,
                    -(-w // fx) - 8 * bx0, wb, axis=1)
                xf = _crop_shift_axis(
                    xf, oy - 8 * by0, ry / fy, ext_h,
                    -(-h // fy) - 8 * by0, hb, axis=0)
                res = np.clip(
                    np.round(xf / qt3[c][None, :, None, :]), -1023, 1023)
                out.append(res.astype(np.int16).reshape(hb * 8, wb * 8))
            planes = out
            w, h = cw, ch
        i += 1
    return splice.coef_context(planes, qtabs, (w, h), sampling)
