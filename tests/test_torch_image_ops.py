"""The training augmentations' cv2 ops in ``kuzu_torch.data.image_io``, held
byte for byte against cv2 on seeded images: HSV both ways, LUT, the
rotation matrix, the affine and perspective warps, the reflecting remap,
filter2D, and ``image_size`` against PIL."""

from __future__ import annotations

import cv2
import numpy as np
import pytest
from PIL import Image

from kuzu_torch.data import image_io as io


def _img(rng, h, w, ch=3):
    return rng.integers(0, 256, (h, w, ch) if ch == 3 else (h, w), dtype=np.uint8)


@pytest.mark.parametrize("w", [1, 7, 31, 32, 33, 65, 641])
def test_hsv_both_ways_match_cv2(w):
    rng = np.random.default_rng(w)
    img = _img(rng, 9, w)
    assert np.array_equal(io.rgb_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    hsv = img.copy()
    hsv[..., 0] %= 180
    for x in (hsv, img):  # hue in 0-179, and the whole byte range
        assert np.array_equal(io.hsv_to_rgb_u8(x), cv2.cvtColor(x, cv2.COLOR_HSV2RGB))


def test_hsv_exhaustive_on_a_vector_and_a_scalar_row():
    """Every (h, s, v) with h < 180 in rows of 4096 (cv2's vector code) and of
    one pixel (its scalar code): exact, no differing byte."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8)
    wide = hsv.reshape(-1, 4096, 3)
    assert np.array_equal(io.hsv_to_rgb_u8(wide), cv2.cvtColor(wide, cv2.COLOR_HSV2RGB))
    narrow = hsv.reshape(-1, 1, 3)
    assert np.array_equal(io.hsv_to_rgb_u8(narrow), cv2.cvtColor(narrow, cv2.COLOR_HSV2RGB))
    rgb = hsv.reshape(-1, 4096, 3)
    assert np.array_equal(io.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


def test_lut_and_rotation_matrix_match_cv2():
    rng = np.random.default_rng(0)
    img = _img(rng, 40, 33)
    table = rng.integers(0, 256, 256).astype(np.uint8)
    assert np.array_equal(io.lut_u8(img, table), cv2.LUT(img, table))
    assert np.array_equal(io.lut_u8(img[..., 0], table), cv2.LUT(img[..., 0], table))
    for center, angle, scale in [((10.0, 20.0), 17.3, 0.8), ((0, 0), -33.1, 1.7),
                                 ((101.5, 3.25), 180.0, 1.0), ((0.1, 0.2), 1e-3, 0.5)]:
        assert np.array_equal(io.rotation_matrix_2d(center, angle, scale),
                              cv2.getRotationMatrix2D(center, angle, scale))


def _matrices(rng, h, w):
    """Scale + translate, a downscale by 2 (the mosaic's 2S -> S), a rotation
    with shear, an upscale; the perspective ones add a projective row."""
    scale = np.array([[0.73, 0, 11.5], [0, 0.73, -7.25]])
    half = np.array([[0.5, 0, 3.0], [0, 0.5, 1.0]])
    rot = io.rotation_matrix_2d((w / 2, h / 2), float(rng.uniform(-180, 180)), 1.1)
    rot[0, 1] += 0.2
    up = np.array([[2.3, 0.1, -20.0], [-0.05, 1.9, -5.0]])
    return [scale, half, rot, up]


@pytest.mark.parametrize("ch", [3, 1])
@pytest.mark.parametrize("shape,size", [((97, 131), (64, 48)), ((200, 150), (129, 96)),
                                        ((33, 17), (32, 160))])
def test_warps_match_cv2(ch, shape, size):
    rng = np.random.default_rng(shape[0] * 7 + ch)
    img = _img(rng, *shape, ch)
    for i, m in enumerate(_matrices(rng, *shape)):
        border = (114,) * 3 if i % 2 else (int(rng.integers(256)), 7, 250)
        ref = cv2.warpAffine(img, m, size, borderValue=border)
        assert np.array_equal(io.warp_affine_u8(img, m, size, border_value=border), ref)
        p = np.eye(3)
        p[:2] = m
        p[2, :2] = rng.uniform(-2e-3, 2e-3, 2)
        ref = cv2.warpPerspective(img, p, size, borderValue=border)
        assert np.array_equal(io.warp_perspective_u8(img, p, size, border_value=border), ref)


def test_warp_fault_is_caught(monkeypatch):
    """A planted fault, the source coordinates on the 1/32-pixel grid of
    cv2's older fixed-point warp, differs from cv2."""
    rng = np.random.default_rng(3)
    img = _img(rng, 120, 90)
    m = io.rotation_matrix_2d((45, 60), 23.0, 0.9)
    ref = cv2.warpAffine(img, m, (80, 100), borderValue=(114,) * 3)
    assert np.array_equal(io.warp_affine_u8(img, m, (80, 100), border_value=(114,) * 3), ref)
    exact = io._bilinear_u8
    monkeypatch.setattr(io, "_bilinear_u8", lambda x, sx, sy, *a: exact(
        x, (sx * 32).floor() / 32, (sy * 32).floor() / 32, *a))
    assert not np.array_equal(io.warp_affine_u8(img, m, (80, 100), border_value=(114,) * 3), ref)


@pytest.mark.parametrize("ch", [3, 1])
def test_remap_reflect_matches_cv2(ch):
    rng = np.random.default_rng(ch)
    for h, w in [(37, 51), (1, 9), (120, 64)]:
        img = _img(rng, h, w, ch)
        mx = rng.uniform(-25, w + 25, (h + 3, w)).astype(np.float32)
        my = rng.uniform(-25, h + 25, (h + 3, w)).astype(np.float32)
        ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
        assert np.array_equal(io.remap_linear_u8(img, mx, my), ref)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("ch", [3, 1])
def test_filter2d_line_kernels_match_cv2(k, ch):
    rng = np.random.default_rng(k + ch)
    img = _img(rng, 45, 67, ch)
    for axis in (0, 1):
        kernel = np.zeros((k, k), np.float32)
        if axis:
            kernel[k // 2, :] = 1.0 / k
        else:
            kernel[:, k // 2] = 1.0 / k
        assert np.array_equal(io.filter2d_u8(img, kernel), cv2.filter2D(img, -1, kernel))


def test_image_size_matches_pil(tmp_path):
    rng = np.random.default_rng(0)
    img = _img(rng, 23, 41)
    files = [io.write_png(tmp_path / "a.png", img)]
    for ext in ("bmp", "ppm", "pgm", "jpg"):
        path = tmp_path / f"a.{ext}"
        cv2.imwrite(str(path), img[..., 0] if ext == "pgm" else img)
        files.append(path)
    for path in files:
        with Image.open(path) as im:
            assert io.image_size(path) == im.size
