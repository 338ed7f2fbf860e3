"""ops/extra.py of the port (crop, rotate, flip, grayscale) against the
reference's ops/extra.py on the same seeded arrays, and against numpy.

Limits:

* crop, flip and rotation by 0, 90, 180 and 270 degrees: 0 LSB, against
  the reference and against numpy slices, ``[::-1]`` and ``np.rot90``;
* grayscale: target 0 LSB, limit 1 against the reference (both sum
  ``299 r + 587 g + 114 b + 500`` on 16-bit channels in float32, where the
  sum passes 2**24), and limit 1 against Go's integer formula in int64;
* rotation by any other angle: <= 1 LSB against the reference, except at
  pixels whose source coordinate (float64) lies within 1e-3 of the
  +-0.5 validity boundary: cos and sin come from two float32 libraries
  and may differ by an ulp, which can flip the mask there (black against
  a border pixel). Those pixels are counted and must stay few.

The batched functions take the port's planar (B, 3, Hb, Wb) bucket; the
reference's take its HWC bucket, so the same bucket goes to each in its
own layout. Groups have mixed valid dims, pad rows with valid (1, 1), an
odd-sized image and a crop rect that passes the bucket's edge.
"""

import numpy as np
import pytest
import torch

from imageprocessor_tpu.ops import extra as ref
from imageprocessor_tpu_torch.ops import extra as port
from imageprocessor_tpu_torch.ops import jpeg_kernels
from imageprocessor_tpu_torch.ops.jpeg_encode import encode_420_plain

BUCKET = (96, 128)
# three real images (one odd-sized, one filling the bucket) and a pad row
DIMS = [(80, 100), (96, 128), (37, 53), (1, 1)]
ANGLES = (30.0, 45.0, 123.4, 200.0, 359.0)


def image(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def group(seed=5):
    """HWC bucket (B, Hb, Wb, 3), each image in its top-left corner over
    nonzero padding (so padding that leaks into view is seen), its valid
    dims, and the images alone."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(1, 256, (len(DIMS), *BUCKET, 3), dtype=np.uint8)
    srcs = []
    for i, (h, w) in enumerate(DIMS):
        srcs.append(image(h, w, seed * 10 + i))
        imgs[i, :h, :w] = srcs[i]
    return imgs, np.array(DIMS, np.int32), srcs


def planar(imgs_hwc):
    return torch.from_numpy(np.ascontiguousarray(imgs_hwc.transpose(0, 3, 1, 2)))


def hwc(out_planar):
    return out_planar.numpy().transpose(0, 2, 3, 1)


def go_gray(img):
    """color.GrayModel on 16-bit channels, in int64."""
    x = img[..., :3].astype(np.int64) * 257
    y16 = (299 * x[..., 0] + 587 * x[..., 1] + 114 * x[..., 2] + 500) // 1000
    return (y16 >> 8).astype(np.uint8)


def near_boundary(h, w, canvas_hw, angle, eps=1e-3):
    """Pixels of the canvas whose float64 source coordinate lies within
    eps of the validity boundary (-0.5 or dim - 0.5) of an (h, w) image
    rotated about its centre."""
    th = np.deg2rad(np.float64(angle))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy = np.arange(canvas_hw[0], dtype=np.float64)[:, None] - cy
    dx = np.arange(canvas_hw[1], dtype=np.float64)[None, :] - cx
    sx = np.cos(th) * dx - np.sin(th) * dy + cx
    sy = np.sin(th) * dx + np.cos(th) * dy + cy
    return ((np.abs(sx + 0.5) < eps) | (np.abs(sx - (w - 0.5)) < eps)
            | (np.abs(sy + 0.5) < eps) | (np.abs(sy - (h - 0.5)) < eps))


def assert_rotation_close(got, want, mask):
    """<= 1 LSB off the boundary pixels; those are few."""
    diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
    assert diff[~mask].max(initial=0) <= 1
    assert mask.sum() <= 4 + mask.size // 100


# --- single image ------------------------------------------------------------

@pytest.mark.parametrize("rect", [(10, 20, 50, 40), (150, 110, 500, 500),
                                  (0, 0, 160, 120), (-5, -7, 30, 20),
                                  (400, 300, 10, 10), (159, 119, 1, 1)])
@pytest.mark.parametrize("hw", [(120, 160), (37, 53)])
def test_crop_image(rect, hw):
    im = image(*hw, seed=1)
    got = port.crop_image(torch.from_numpy(im), *rect).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.crop_image(im, *rect)))
    x, y, w, h = rect
    x, y = max(0, min(x, hw[1] - 1)), max(0, min(y, hw[0] - 1))
    np.testing.assert_array_equal(got, im[y:y + max(h, 1), x:x + max(w, 1)])


@pytest.mark.parametrize("angle", [0, 90, 180, 270, 360, -90, 450])
@pytest.mark.parametrize("hw", [(120, 160), (37, 53)])
def test_rotate_image_by_90s(angle, hw):
    im = image(*hw, seed=2)
    got = port.rotate_image(torch.from_numpy(im), angle).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.rotate_image(im, angle)))
    np.testing.assert_array_equal(got, np.rot90(im, (angle // 90) % 4))


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("hw", [(64, 80), (37, 53), (101, 101)])
def test_rotate_image_arbitrary(angle, hw):
    im = image(*hw, seed=3)
    got = port.rotate_image(torch.from_numpy(im), angle).numpy()
    want = np.asarray(ref.rotate_image(im, angle))
    assert got.shape == want.shape == im.shape
    assert_rotation_close(got, want, near_boundary(*hw, hw, angle))


def test_rotate_image_arbitrary_keeps_centre_and_blacks_corners():
    im = np.zeros((101, 101, 3), dtype=np.uint8)
    im[45:56, 45:56] = 200
    out = port.rotate_image(torch.from_numpy(im), 45).numpy()
    assert out[50, 50, 0] > 150
    assert out[:10, :10].max() == 0


@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
@pytest.mark.parametrize("hw", [(120, 160), (37, 53)])
def test_flip_image(direction, hw):
    im = image(*hw, seed=4)
    got = port.flip_image(torch.from_numpy(im), direction).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.flip_image(im, direction)))
    np.testing.assert_array_equal(
        got, im[::-1] if direction == "vertical" else im[:, ::-1])


def gray_inputs():
    """Seeded noise, every gray level, the saturated primaries, and
    channel triples near the reference's float32 rounding (the sum
    passes 2**24 from about level 65 up)."""
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None, None], 3, axis=2)
    prim = np.array([[[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 255],
                      [0, 0, 0], [255, 255, 0], [1, 1, 1], [254, 255, 254]]],
                    dtype=np.uint8)
    return {"noise": image(120, 160, seed=6), "odd": image(37, 53, seed=7),
            "ramp": ramp, "primaries": prim,
            "bright": 200 + image(64, 64, seed=8) % 56}


@pytest.mark.parametrize("name", sorted(gray_inputs()))
def test_grayscale_image(name):
    im = gray_inputs()[name]
    got = port.grayscale_image(torch.from_numpy(im)).numpy()
    want = np.asarray(ref.grayscale_image(im))
    assert got.shape == want.shape == im.shape
    assert got.dtype == np.uint8
    d_ref = np.abs(got.astype(int) - want.astype(int)).max()
    d_go = np.abs(got[..., 0].astype(int) - go_gray(im).astype(int)).max()
    assert d_ref == 0, f"differs from the reference by {d_ref} LSB (limit 1)"
    assert d_go <= 1
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()


def test_grayscale_image_keeps_alpha():
    im = image(50, 50, seed=9, c=4)
    got = port.grayscale_image(torch.from_numpy(im)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.grayscale_image(im)))
    np.testing.assert_array_equal(got[..., 3], im[..., 3])


# --- batched -----------------------------------------------------------------

def test_batched_grayscale_planar():
    imgs, _, _ = group()
    got = port.batched_grayscale_planar(planar(imgs))
    want = np.asarray(ref.batched_grayscale_planar(imgs.transpose(0, 3, 1, 2)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(got.numpy()[:, 0].astype(int) - go_gray(imgs).astype(int)).max() <= 1


def test_batched_grayscale_feeds_the_encoder_in_place():
    """The gray bucket is three written planes, not a broadcast view with
    a channel stride of 0: kernel B3's wrapper reads it where it lies,
    also through the top-left slice the engine takes."""
    imgs, hw, _ = group()
    got = port.batched_grayscale_planar(planar(imgs))
    assert got.is_contiguous() and got.stride(1) == BUCKET[0] * BUCKET[1]
    view = got[:, :, :80, :112]
    assert jpeg_kernels._aligned_rgb(view) is view
    vh = torch.from_numpy(np.minimum(hw, (80, 112)).astype(np.int32))
    qt = torch.full((2, 8, 8), 4.0)
    for a, b in zip(jpeg_kernels.encode_420(view, vh, qt),
                    encode_420_plain(view.contiguous(), vh, qt)):
        assert torch.equal(a, b)
    # a broadcast view, had one been returned, is also served
    bcast = got[:, :1].expand(-1, 3, -1, -1)[:, :, :80, :112]
    for a, b in zip(jpeg_kernels.encode_420(bcast, vh, qt),
                    encode_420_plain(view.contiguous(), vh, qt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
def test_batched_flip(direction):
    imgs, hw, srcs = group()
    got = hwc(port.batched_flip(planar(imgs), hw, direction))
    want = np.asarray(ref.batched_flip(imgs, hw, direction=direction))
    np.testing.assert_array_equal(got, want)
    for i, ((h, w), im) in enumerate(zip(DIMS, srcs)):
        np.testing.assert_array_equal(
            got[i, :h, :w], im[::-1] if direction == "vertical" else im[:, ::-1])


@pytest.mark.parametrize("rect", [(20, 30, 60, 50), (0, 0, 128, 96),
                                  (16, 16, 33, 23), (90, 70, 60, 50),
                                  (40, 20, 128, 96), (500, 500, 8, 8),
                                  (-3, -4, 20, 10)],
                         ids=["inside", "whole", "odd", "past_images",
                              "past_bucket", "origin_outside", "negative"])
def test_batched_crop(rect):
    """The rect may pass an image's extent and the bucket's edge: the
    origin still clamps per image, never sliding with the bucket."""
    imgs, hw, srcs = group()
    x, y, w, h = rect
    got = hwc(port.batched_crop(planar(imgs), hw, x, y, width=w, height=h))
    want = np.asarray(ref.batched_crop(imgs, hw, x=x, y=y, width=w, height=h))
    assert got.shape == (len(DIMS), h, w, 3)
    np.testing.assert_array_equal(got, want)
    for i, im in enumerate(srcs):
        one = port.crop_image(torch.from_numpy(im), x, y, w, h).numpy()
        np.testing.assert_array_equal(got[i, :one.shape[0], :one.shape[1]], one)


@pytest.mark.parametrize("angle", [0, 90, 180, 270])
def test_batched_rotate_by_90s(angle):
    imgs, hw, srcs = group()
    src = planar(imgs)
    out = port.batched_rotate(src, hw, angle)
    assert out.data_ptr() != src.data_ptr()   # a new tensor, also at 0
    got = hwc(out)
    np.testing.assert_array_equal(
        got, np.asarray(ref.batched_rotate(imgs, hw, angle)))
    canvas = BUCKET[::-1] if angle in (90, 270) else BUCKET
    assert got.shape[1:3] == canvas
    for i, im in enumerate(srcs):
        want = np.rot90(im, angle // 90)
        np.testing.assert_array_equal(got[i, :want.shape[0], :want.shape[1]], want)


@pytest.mark.parametrize("angle", ANGLES)
def test_batched_rotate_arbitrary(angle):
    """Each image about its own centre on the bucket canvas: against the
    reference's batched op on the whole canvas, and against the
    single-image op on each valid region."""
    imgs, hw, srcs = group()
    got = hwc(port.batched_rotate(planar(imgs), hw, angle))
    want = np.asarray(ref.batched_rotate(imgs, hw, angle))
    assert got.shape == want.shape
    for i, ((h, w), im) in enumerate(zip(DIMS, srcs)):
        mask = near_boundary(h, w, BUCKET, angle)
        assert_rotation_close(got[i], want[i], mask)
        one = port.rotate_image(torch.from_numpy(im), angle).numpy()
        np.testing.assert_array_equal(got[i, :h, :w], one)
