"""The port's image layer against cv2, PIL and the JAX package on the CPU, bit
for bit: ``kuzu_torch.data.image_io``'s resizes, colour conversion and
decoder, and what is built on them (``letterbox_np``, ``load_letterboxed``,
``tile_image``, ``rewrite_boxes_for_tile``, ``pack_yc``; ``unpack_yc``
within JAX's rounding, as ``_resize_u8`` in tests/test_torch_cascade.py)."""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from kuzu_torch.data import image_io as io

REPO = Path(__file__).resolve().parent.parent

# (source (H, W), destination (H, W)): up, down, identity, non-integer
# ratios, one-pixel sides, a page to the 1280 letterbox, column crops
RESIZE_GRID = [
    ((200, 150), (640, 480)), ((40, 7), (1024, 179)), ((5, 3), (640, 384)),
    ((64, 64), (32, 32)), ((100, 100), (37, 53)), ((77, 31), (77, 31)),
    ((1, 1), (10, 10)), ((1, 5), (7, 1)), ((10, 10), (1, 1)), ((33, 1), (1024, 64)),
    ((300, 200), (299, 201)), ((967, 605), (1280, 801)), ((512, 300), (256, 150)),
]


def _ids(grid):
    return [f"{s[0]}x{s[1]}-{d[0]}x{d[1]}" for s, d in grid]


def _noise(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("src,dst", RESIZE_GRID, ids=_ids(RESIZE_GRID))
def test_resize_linear_matches_cv2(src, dst):
    img = _noise((*src, 3))
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = io.resize_linear_u8(img, dst)
    np.testing.assert_array_equal(got, want)
    # a batch of tensors gives the same bytes
    batch = io.resize_linear_u8(torch.from_numpy(np.stack([img, img[::-1].copy()])), dst)
    np.testing.assert_array_equal(batch[0].numpy(), want)


def test_resize_linear_vertical_fault_is_caught(monkeypatch):
    """A planted fault: the vertical fraction clamped at the borders like the
    horizontal one gives other first and last rows on an upscale."""
    img = _noise((40, 7, 3))
    want = cv2.resize(img, (179, 1024), interpolation=cv2.INTER_LINEAR)
    table = io._cv2_linear_table
    monkeypatch.setattr(io, "_cv2_linear_table", lambda s, d, clamp: table(s, d, True))
    got = io.resize_linear_u8(img, (1024, 179))
    rows = np.nonzero((got != want).any((1, 2)))[0]
    assert len(rows) > 0 and rows.min() == 0 and rows.max() == 1023


@pytest.mark.parametrize("src,dst", RESIZE_GRID, ids=_ids(RESIZE_GRID))
def test_resize_pil_bilinear_matches_pil(src, dst):
    img = _noise((*src, 3), seed=1)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(io.resize_pil_bilinear_u8(img, dst), want)


def test_rgb_to_ycrcb_matches_cv2():
    """Every colour of a 64-level cube and noise."""
    lv = np.arange(0, 256, 4, dtype=np.uint8)
    cube = np.stack(np.meshgrid(lv, lv, lv, indexing="ij"), -1).reshape(64, -1, 3)
    for img in (cube, _noise((37, 53, 3))):
        want = cv2.cvtColor(np.ascontiguousarray(img), cv2.COLOR_RGB2YCrCb)
        np.testing.assert_array_equal(io.rgb_to_ycrcb_u8(img), want)


@pytest.mark.parametrize("factor", [2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_resize_area_matches_cv2(factor, channels):
    img = _noise((48, 96, channels), seed=factor)
    want = cv2.resize(img, (96 // factor, 48 // factor), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(io.resize_area_u8(img, factor).reshape(want.shape), want)


# -------------------------------------------------------------- decoding


def _cv2_read(path) -> np.ndarray:
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _image_files(root: Path) -> dict[str, Path]:
    """Files cv2 and PIL write: PNG at every compression level and filter
    strategy, gray, 16-bit colour and gray, RGBA, gray + alpha, palette at
    1-8 bits, 1-bit; the port's own Sub and Paeth PNGs; BMP (24 and 32 bit,
    gray palette), PPM and PGM."""
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    ramp = (np.add.outer(np.arange(37), np.arange(53))[..., None] * [1, 2, 3] % 256)
    files = {}
    for name, arr in (("noise", noise), ("ramp", ramp.astype(np.uint8))):
        bgr = np.ascontiguousarray(arr[..., ::-1])
        pil = Image.fromarray(arr)

        def put(key, writer):
            files[f"{name}-{key}"] = path = root / f"{name}-{key}"
            writer(str(path))

        for level in (0, 1, 9):
            put(f"level{level}.png",
                lambda p, lv=level: cv2.imwrite(p, bgr, [cv2.IMWRITE_PNG_COMPRESSION, lv]))
        for strategy in range(5):
            put(f"strategy{strategy}.png",
                lambda p, s=strategy: cv2.imwrite(p, bgr, [cv2.IMWRITE_PNG_STRATEGY, s]))
        put("gray.png", lambda p: cv2.imwrite(p, arr[..., 0]))
        wide = arr.astype(np.uint16) * 257 + rng.integers(0, 256, arr.shape).astype(np.uint16)
        put("rgb16.png", lambda p: cv2.imwrite(p, wide[..., ::-1].copy()))
        put("gray16.png", lambda p: cv2.imwrite(p, wide[..., 0].copy()))
        put("rgba.png", lambda p: cv2.imwrite(p, np.concatenate([bgr, arr[..., :1]], 2)))
        for mode in ("RGBA", "LA", "L", "1"):
            put(f"pil-{mode}.png", lambda p, m=mode: pil.convert(m).save(p))
        put("pil-P8.png", lambda p: pil.quantize(200).save(p))
        for bits in (1, 2, 4):
            put(f"pil-P{bits}.png", lambda p, b=bits: pil.quantize(2**b).save(p, bits=b))
        for flt in ("sub", "paeth"):
            put(f"port-{flt}.png", lambda p, f=flt: io.write_png(p, arr, filter=f))
            put(f"port-gray-{flt}.png", lambda p, f=flt: io.write_png(p, arr[..., 1], filter=f))
        put("bgr.bmp", lambda p: cv2.imwrite(p, bgr))
        put("gray.bmp", lambda p: cv2.imwrite(p, arr[..., 0]))
        put("pil-rgba.bmp", lambda p: pil.convert("RGBA").save(p))
        put("bgr.ppm", lambda p: cv2.imwrite(p, bgr))
        put("gray.pgm", lambda p: cv2.imwrite(p, arr[..., 0]))
    return files


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    return _image_files(tmp_path_factory.mktemp("image_files"))


FILE_KINDS = ["level0.png", "level1.png", "level9.png"] + [
    f"strategy{s}.png" for s in range(5)] + [
    "gray.png", "rgb16.png", "gray16.png", "rgba.png", "pil-RGBA.png", "pil-LA.png",
    "pil-L.png", "pil-1.png", "pil-P8.png", "pil-P1.png", "pil-P2.png", "pil-P4.png",
    "port-sub.png", "port-paeth.png", "port-gray-sub.png", "port-gray-paeth.png",
    "bgr.bmp", "gray.bmp", "pil-rgba.bmp", "bgr.ppm", "gray.pgm"]


@pytest.mark.parametrize("kind", FILE_KINDS)
def test_imread_matches_cv2(image_files, kind):
    for name in ("noise", "ramp"):
        path = image_files[f"{name}-{kind}"]
        got = io.imread_rgb(path)
        assert got.dtype == np.uint8 and got.flags.writeable
        np.testing.assert_array_equal(got, _cv2_read(path))


def test_imread_pil_backend_matches_pil(image_files):
    """``backend="pil"``: PIL's ``convert("RGB")``, 16-bit gray clipped."""
    for key, path in image_files.items():
        if key.endswith(".png"):
            want = np.asarray(Image.open(path).convert("RGB"))
            np.testing.assert_array_equal(io.imread_rgb(path, backend="pil"), want, key)


def test_write_png_roundtrips_and_paeth_page(tmp_path):
    """The port's PNGs decode to the pixels written, by cv2 and by the port;
    a page every row of which is Paeth-filtered takes the anti-diagonal
    decoder across its row blocks."""
    from kuzu_torch.testing import column_pages

    page = column_pages(1, 320, seed=2)[0][:, :200]
    page = np.ascontiguousarray(np.repeat(page, 4, axis=0))  # 1280 rows: two blocks
    for flt in ("sub", "paeth"):
        path = io.write_png(tmp_path / f"{flt}.png", page, filter=flt)
        np.testing.assert_array_equal(io.imread_rgb(path), page)
        np.testing.assert_array_equal(_cv2_read(path), page)
    with pytest.raises(ValueError, match="filter"):
        io.write_png(tmp_path / "x.png", page, filter="avg")


def test_imread_npy_and_missing(tmp_path):
    rgb = _noise((9, 11, 3))
    np.save(tmp_path / "page.npy", rgb)
    np.save(tmp_path / "gray.npy", rgb[..., 0])
    np.testing.assert_array_equal(io.imread_rgb(tmp_path / "page.npy"), rgb)
    np.testing.assert_array_equal(io.imread_rgb(tmp_path / "gray.npy"),
                                  np.repeat(rgb[..., :1], 3, axis=2))
    np.save(tmp_path / "f.npy", rgb.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        io.imread_rgb(tmp_path / "f.npy")
    with pytest.raises(FileNotFoundError):
        io.imread_rgb(tmp_path / "none.png")


def test_jpeg_decodes_through_its_backend_or_raises(tmp_path, monkeypatch):
    """A JPEG goes to cv2 (or PIL with ``backend="pil"``): their bytes. With
    both blocked, an ImportError names the format and the package."""
    img = _noise((24, 32, 3))
    path = tmp_path / "page.jpg"
    cv2.imwrite(str(path), img)
    np.testing.assert_array_equal(io.imread_rgb(path), _cv2_read(path))
    np.testing.assert_array_equal(io.imread_rgb(path, backend="pil"),
                                  np.asarray(Image.open(path).convert("RGB")))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG.*cv2"):
        io.imread_rgb(path)
    with pytest.raises(ImportError, match="JPEG.*PIL"):
        io.imread_rgb(path, backend="pil")


def test_port_imports_with_cv2_and_pil_blocked():
    """Every module of the port imports with cv2 and PIL unimportable (they
    are imported only inside the decoding of the formats that need them)."""
    files = sorted((REPO / "kuzu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in files if p.name != "__init__.py"]
    code = ("import sys\n"
            "for m in ('cv2', 'PIL', 'jax', 'kuzu'): sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("shape,size", [((300, 200), 128), ((90, 400), 256),
                                        ((64, 64), 64), ((967, 605), (320, 200))])
def test_letterbox_np_matches_jax(shape, size):
    from kuzu.data.yolo_dataset import letterbox_np as jax_letterbox

    from kuzu_torch.data.yolo_dataset import letterbox_np

    img = _noise((*shape, 3), seed=3)
    want, wgain, wpad = jax_letterbox(img, size)
    got, gain, pad = letterbox_np(img, size)
    assert (gain, pad) == (wgain, wpad)
    np.testing.assert_array_equal(got, want)
    on_tensor, _, _ = letterbox_np(torch.from_numpy(img), size)
    np.testing.assert_array_equal(on_tensor.numpy(), want)


@pytest.mark.parametrize("jitter", [False, True])
def test_load_letterboxed_matches_jax(tmp_path, jitter):
    """Crops of several aspects, from PNG files, at [160, 40] and [1024, 64],
    with and without the rng's geometric jitter; an unreadable file gives the
    blank canvas on both sides."""
    from kuzu.data.ocr_datasets import load_letterboxed as jax_load

    from kuzu_torch.data.ocr_datasets import load_letterboxed

    paths = []
    for i, shape in enumerate([(300, 40), (50, 200), (1000, 70), (12, 12)]):
        paths.append(io.write_png(tmp_path / f"crop{i}.png", _noise((*shape, 3), seed=i)))
    (tmp_path / "bad.png").write_bytes(b"not an image")
    paths.append(tmp_path / "bad.png")
    for size in ((160, 40), (1024, 64)):
        for p in paths:
            kw = [dict(rng=np.random.default_rng(7)), dict(rng=np.random.default_rng(7))] \
                if jitter else [{}, {}]
            want = jax_load(p, *size, **kw[0])
            got = load_letterboxed(p, *size, **kw[1])
            np.testing.assert_array_equal(got, want, str(p))
            if jitter:  # the same numpy draws, in the same order
                assert kw[0]["rng"].integers(1 << 30) == kw[1]["rng"].integers(1 << 30)
    arr = _noise((80, 20, 3), seed=9)
    np.testing.assert_array_equal(load_letterboxed(arr, 160, 40),
                                  jax_load(Image.fromarray(arr), 160, 40))


@pytest.mark.parametrize("grid", [2, 3])
def test_tile_image_matches_jax(grid):
    from kuzu.pipeline.tiling import rewrite_boxes_for_tile as jax_rewrite
    from kuzu.pipeline.tiling import tile_image as jax_tile

    from kuzu_torch.pipeline.tiling import rewrite_boxes_for_tile, tile_image

    page = _noise((301, 217, 3), seed=grid)
    want, wmetas = jax_tile(page, grid=grid, overlap=0.15, tile_size=96)
    got, metas = tile_image(page, grid=grid, overlap=0.15, tile_size=96)
    assert metas == wmetas
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tile_image(torch.from_numpy(page), grid, 0.15, 96)[0].numpy(),
                                  want)
    rng = np.random.default_rng(grid)
    xy = rng.uniform(0, 200, (50, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(2, 60, (50, 2)).astype(np.float32)], 1)
    for bound in [(0, 0, 120, 170), (90, 130, 217, 301)]:
        for contained in (True, False):
            for a, b in zip(rewrite_boxes_for_tile(boxes, bound, contained),
                            jax_rewrite(boxes, bound, contained)):
                np.testing.assert_array_equal(a, b)


def test_pack_yc_matches_jax_and_unpack_within_rounding():
    """``pack_yc`` bit for bit; ``unpack_yc`` (F.interpolate against
    jax.image.resize, then the f32 inverse) within one level, at least 99.9%
    of pixels exact, on ink pages and on noise."""
    import jax
    import jax.numpy as jnp
    from kuzu.pipeline.device_pages import pack_yc as jax_pack
    from kuzu.pipeline.device_pages import unpack_yc as jax_unpack

    from kuzu_torch.pipeline.device_pages import pack_yc, unpack_yc
    from kuzu_torch.testing import column_pages

    for pages in (column_pages(2, 128, seed=4), _noise((2, 64, 96, 3), seed=5)):
        wy, wc = jax_pack(pages)
        y, c = pack_yc(torch.from_numpy(pages))
        np.testing.assert_array_equal(y.numpy(), wy)
        np.testing.assert_array_equal(c.numpy(), wc)
        want = np.asarray(jax.jit(jax_unpack)(jnp.asarray(wy), jnp.asarray(wc))).astype(int)
        diff = np.abs(unpack_yc(y, c).numpy().astype(int) - want)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())
    with pytest.raises(ValueError, match="multiple"):
        pack_yc(torch.zeros((1, 30, 32, 3), dtype=torch.uint8))


def test_masks_full_matches_cv2():
    """``Masks.full``: cv2's INTER_NEAREST index arithmetic, up and down."""
    from kuzu_torch.api.results import Masks

    rng = np.random.default_rng(0)
    for proto, orig in (((40, 30), (333, 197)), ((64, 64), (50, 21)), ((7, 9), (7, 9))):
        data = rng.random((3, *proto)) > 0.5
        want = np.stack([cv2.resize(m.astype(np.uint8), orig[::-1],
                                    interpolation=cv2.INTER_NEAREST).astype(bool) for m in data])
        np.testing.assert_array_equal(Masks(data, orig).full(), want)
    assert Masks(np.zeros((0, 4, 4), bool), (8, 8)).full().shape == (0, 8, 8)
