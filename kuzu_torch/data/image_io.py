"""Image decoding and resizing without cv2 or PIL: the port's counterparts of
the cv2 / PIL calls on the JAX package's serving path, each giving the bytes
that library gives.

The GPU machine has neither cv2 nor PIL, and its torch has no image
decoder, so the port reads and resizes images itself:

- :func:`resize_linear_u8` is ``cv2.resize(..., INTER_LINEAR)`` on uint8,
  :func:`resize_pil_bilinear_u8` PIL's ``Image.resize(..., BILINEAR)``,
  :func:`rgb_to_ycrcb_u8` ``cv2.cvtColor(..., COLOR_RGB2YCrCb)`` and
  :func:`resize_area_u8` ``cv2.resize(..., INTER_AREA)`` at an integer
  factor. Each repeats its library's fixed-point arithmetic in torch
  integers (int32 gathers and sums over the taps; CUDA has no integer
  matmul), so it gives the same bytes on the CPU and on the card. The tap
  tables are built on the host in numpy's IEEE float32 / float64, as the
  libraries build theirs.
- :func:`imread_rgb` is ``cv2.cvtColor(cv2.imread(p), COLOR_BGR2RGB)``
  (``backend="cv2"``) or ``np.asarray(Image.open(p).convert("RGB"))``
  (``backend="pil"``). PNG (every filter, 1-16 bits, gray, gray + alpha,
  RGB, RGBA, palette; alpha dropped as ``IMREAD_COLOR`` drops it; 16 bits
  taken as their high byte, but 16-bit gray clipped to 255 under PIL),
  uncompressed BMP, binary PPM / PGM and ``.npy`` are read here with zlib
  and numpy. Other formats (JPEG, TIFF, WebP,
  interlaced PNG) need a codec: the backend's library decodes them where it
  imports, else an ``ImportError`` names the format and the package. Two
  JPEG decoders may differ by a level, so the backend is the caller's
  choice and never switched quietly.
- :func:`write_png` writes an RGB or gray uint8 image as PNG (filter Sub on
  every row, or Paeth), for tests and the GPU smoke run.
- The training augmentations' cv2 calls: :func:`rgb_to_hsv_u8` /
  :func:`hsv_to_rgb_u8` (``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB``),
  :func:`lut_u8` (``cv2.LUT``), :func:`rotation_matrix_2d`
  (``getRotationMatrix2D``), :func:`warp_affine_u8` /
  :func:`warp_perspective_u8` (``INTER_LINEAR``, ``BORDER_CONSTANT``),
  :func:`remap_linear_u8` (float maps, ``BORDER_REFLECT``) and
  :func:`filter2d_u8` (``ddepth=-1``, ``BORDER_REFLECT_101``), each the bytes
  of the cv2 (5.0, x86-64, AVX2 dispatch) the JAX package runs on.
  Where cv2 computes in float32, so do these, in cv2's order; its fused
  multiply-adds are taken in float64 and rounded once to float32, which is
  the fused result wherever the exact sum fits float64's 53 bits (every
  input the tests and the datasets give). cv2 runs some of these ops on
  blocks of pixels with vector code and the rest of a row with scalar code
  that rounds or contracts otherwise; the ops repeat that split by column.
- :func:`image_size` reads (width, height) from an image file's header.

cv2 and PIL are imported only inside the decoding of the formats above.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

# ------------------------------------------------------------------ resizes


def _np_in(img) -> tuple[torch.Tensor, bool]:
    """(``img`` as a tensor, whether it was a numpy array)."""
    is_np = isinstance(img, np.ndarray)
    return (torch.from_numpy(np.ascontiguousarray(img)) if is_np else img), is_np


def _as_tensor(img) -> tuple[torch.Tensor, bool]:
    """(uint8 tensor with a batch axis, whether ``img`` was a numpy array)."""
    t, is_np = _np_in(img)
    if t.dtype != torch.uint8 or t.dim() not in (3, 4):
        raise ValueError(f"expected uint8 (H, W, C) or (B, H, W, C), got {tuple(t.shape)} "
                         f"{t.dtype}")
    return t, is_np


def _like(out: torch.Tensor, batched: bool, is_np: bool):
    out = out if batched else out[0]
    return out.numpy() if is_np else out


def _taps_along(x: torch.Tensor, axis: int, idx: np.ndarray, coef: np.ndarray) -> torch.Tensor:
    """sum_k x[..., idx[:, k], ...] * coef[:, k] along ``axis`` of int32 ``x``,
    one tap at a time (no (..., n, K, ...) gather)."""
    dev = x.device
    acc = None
    for k in range(idx.shape[1]):
        i = torch.from_numpy(np.ascontiguousarray(idx[:, k], np.int64)).to(dev)
        c = torch.from_numpy(np.ascontiguousarray(coef[:, k], np.int32)).to(dev)
        shape = [1] * x.dim()
        shape[axis] = -1
        term = x.index_select(axis, i) * c.view(shape)
        acc = term if acc is None else acc.add_(term)
    return acc


def _cv2_linear_table(ssize: int, dsize: int, clamp: bool):
    """cv2's INTER_LINEAR source index and fraction per destination index:
    ``f = float32((d + 0.5) * scale - 0.5)`` with ``scale = 1 / (dsize /
    ssize)`` in double, ``s = floor(f)``, ``f -= s``; horizontally (``clamp``)
    a source index past either border takes that border with fraction 0."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        lo, hi = s < 0, s >= ssize - 1
        f[lo | hi] = 0
        s[lo] = 0
        s[hi] = ssize - 1
    # saturate_cast<short>(cbuf[k] * 2048): round half to even in float32
    a0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    a1 = np.rint(f * np.float32(2048)).astype(np.int32)
    idx = np.stack([np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1)], 1)
    return idx, np.stack([a0, a1], 1)


def resize_linear_u8(img, size: tuple[int, int]):
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` on uint8
    (H, W, C) or (B, H, W, C), a tensor (on any device) or an ndarray; returns
    the same kind. Fixed point as cv2's: 11-bit taps; the horizontal pass
    ``H = I[s] a0 + I[s+1] a1`` in int32 with the source index clamped at
    the borders (fraction 0 there); the vertical pass with its fraction not
    clamped (only the two row indices are), ``(((b0 (H0 >> 4)) >> 16) +
    ((b1 (H1 >> 4)) >> 16) + 2) >> 2``. An unchanged size returns a copy."""
    t, is_np = _as_tensor(img)
    batched = t.dim() == 4
    x = t if batched else t[None]
    nh, nw = int(size[0]), int(size[1])
    h, w = x.shape[1], x.shape[2]
    if (nh, nw) == (h, w):
        return _like(x.clone(), batched, is_np)
    xi, xa = _cv2_linear_table(w, nw, clamp=True)
    yi, yb = _cv2_linear_table(h, nh, clamp=False)
    dev = x.device
    rows = np.unique(yi)  # the horizontal pass on the rows the vertical taps read
    if len(rows) < h:
        x = x.index_select(1, torch.from_numpy(rows).to(dev))
        yi = np.searchsorted(rows, yi)
    horiz = _taps_along(x.to(torch.int32), 2, xi, xa) >> 4  # (B, rows, nw, C)
    r0 = horiz.index_select(1, torch.from_numpy(yi[:, 0]).to(dev))
    r1 = horiz.index_select(1, torch.from_numpy(yi[:, 1]).to(dev))
    b0 = torch.from_numpy(yb[:, 0]).to(dev).view(1, -1, 1, 1)
    b1 = torch.from_numpy(yb[:, 1]).to(dev).view(1, -1, 1, 1)
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return _like(out.clamp_(0, 255).to(torch.uint8), batched, is_np)


PIL_PRECISION_BITS = 22  # PIL's 8-bit resample: 32 - 8 - 2


def _pil_bilinear_table(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` for the bilinear (triangle) filter in
    double, normalised, then ``normalize_coeffs_8bpc``'s 22-bit fixed point:
    ``trunc(+-0.5 + w 2^22)``. Returns (source index (out, K) clamped,
    int32 taps (out, K), 0 past each output's support)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):  # in PIL's order: ww sums the taps left to right
        arg = np.abs((x + xmin - center + 0.5) * ss)
        wx = np.where((x < xmax) & (arg < 1.0), 1.0 - arg, 0.0)
        k[:, x] = wx
        ww = ww + wx
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    one = float(1 << PIL_PRECISION_BITS)
    fixed = np.where(k < 0, -0.5 + k * one, 0.5 + k * one).astype(np.int64).astype(np.int32)
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)
    return idx, fixed


def _pil_pass(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    idx, coef = _pil_bilinear_table(x.shape[axis], out_size)
    acc = _taps_along(x.to(torch.int32), axis, idx, coef)
    acc += 1 << (PIL_PRECISION_BITS - 1)
    return (acc >> PIL_PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def resize_pil_bilinear_u8(img, size: tuple[int, int]):
    """PIL's ``Image.resize((nw, nh), Image.BILINEAR)`` on uint8 RGB (H, W, 3)
    or (B, H, W, 3), a tensor or an ndarray: the antialiased triangle
    filter (support scaled by max(in / out, 1)), 22-bit fixed-point taps,
    the horizontal pass first, each pass rounded (+2^21, >> 22) and clipped
    to uint8. An unchanged size returns a copy."""
    t, is_np = _as_tensor(img)
    batched = t.dim() == 4
    x = t if batched else t[None]
    nh, nw = int(size[0]), int(size[1])
    if (nh, nw) == tuple(x.shape[1:3]):
        return _like(x.clone(), batched, is_np)
    if nw != x.shape[2]:
        x = _pil_pass(x, 2, nw)
    if nh != x.shape[1]:
        x = _pil_pass(x, 1, nh)
    return _like(x, batched, is_np)


# cv2's RGB2YCrCb_i for 8 bits: 14-bit coefficients of Y = 0.299 R + 0.587 G
# + 0.114 B, Cr = 0.713 (R - Y) + 128, Cb = 0.564 (B - Y) + 128
YCC_SHIFT = 14
YCC_COEFFS = (4899, 9617, 1868, 11682, 9241)


def rgb_to_ycrcb_u8(img):
    """``cv2.cvtColor(img, cv2.COLOR_RGB2YCrCb)`` on uint8 (..., 3), a tensor
    or an ndarray: ``Y = (R c0 + G c1 + B c2 + 2^13) >> 14``, ``Cr = ((R - Y)
    c3 + 128 2^14 + 2^13) >> 14``, ``Cb`` likewise from B, saturated."""
    t, is_np = _np_in(img)
    x = t.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    c0, c1, c2, c3, c4 = YCC_COEFFS
    half = 1 << (YCC_SHIFT - 1)
    delta = 128 << YCC_SHIFT
    y = (r * c0 + g * c1 + b * c2 + half) >> YCC_SHIFT
    cr = ((r - y) * c3 + delta + half) >> YCC_SHIFT
    cb = ((b - y) * c4 + delta + half) >> YCC_SHIFT
    out = torch.stack([y, cr, cb], -1).clamp_(0, 255).to(torch.uint8)
    return out.numpy() if is_np else out


def resize_area_u8(img, factor: int):
    """``cv2.resize(img, (W / f, H / f), interpolation=cv2.INTER_AREA)`` on
    uint8 (H, W, C) or (B, H, W, C) with H and W multiples of the integer
    ``f``: each f x f block's sum in int32, times float32(1 / f^2), rounded
    half to even (cv2's fast area path); at f = 2 on other than 2 channels,
    cv2's vector path, ``(sum + 2) >> 2``."""
    t, is_np = _as_tensor(img)
    batched = t.dim() == 4
    x = t if batched else t[None]
    b, h, w, c = x.shape
    f = int(factor)
    if h % f or w % f:
        raise ValueError(f"({h}, {w}) is not a multiple of the factor {f}")
    s = x.to(torch.int32).reshape(b, h // f, f, w // f, f, c).sum((2, 4), dtype=torch.int32)
    if f == 2 and c != 2:
        out = (s + 2) >> 2
    else:
        out = torch.round(s.to(torch.float32) * torch.tensor(1.0 / (f * f), dtype=torch.float32))
    return _like(out.clamp_(0, 255).to(torch.uint8), batched, is_np)


# -------------------------------------------------------------------- PNG

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
PNG_FILTERS = {"none": 0, "sub": 1, "up": 2, "avg": 3, "paeth": 4}
WAVEFRONT_ROWS = 1024  # rows of one skewed block in the Avg / Paeth unfilter


def _paeth_or_avg(a, b, c, filt):
    """PNG's Avg (3) or Paeth (4) predictor of int16 neighbours left ``a``,
    up ``b`` and up-left ``c``, chosen per row by ``filt``."""
    avg = (a + b) >> 1
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return np.where(filt == 3, avg, paeth)


def _unfilter_wavefront(raw: np.ndarray, filt: np.ndarray, prev: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Avg / Paeth rows (n, row bytes) after the decoded row ``prev``.

    A pixel depends on its left, upper and upper-left neighbours, so every
    anti-diagonal of pixels decodes at once from the two before it. The
    block is held skewed, ``q[i + j, i] = out[i - 1, j - 1]`` with row 0 the
    previous row and column 0 zero, so each diagonal's neighbours are
    slices: left ``q[e - 1, i]``, up ``q[e - 1, i - 1]``, up-left
    ``q[e - 2, i - 1]``."""
    n = raw.shape[0]
    p = raw.shape[1] // bpp
    q = np.zeros((n + p + 1, n + 1, bpp), np.int16)
    q[1:p + 1, 0] = prev.reshape(p, bpp)
    rs = np.zeros((n + p + 1, n + 1, bpp), np.int16)
    i = np.arange(n)[:, None]
    j = np.arange(p)[None, :]
    rs[i + j + 2, i + 1] = raw.reshape(n, p, bpp)
    f = np.concatenate([[0], filt]).astype(np.int16)[:, None]
    for e in range(2, n + p + 1):
        lo, hi = max(1, e - p), min(n, e - 1)
        a = q[e - 1, lo:hi + 1]
        b = q[e - 1, lo - 1:hi]
        c = q[e - 2, lo - 1:hi]
        q[e, lo:hi + 1] = (rs[e, lo:hi + 1] + _paeth_or_avg(a, b, c, f[lo:hi + 1])) & 255
    return q[i + j + 2, i + 1].reshape(n, p * bpp).astype(np.uint8)


def png_unfilter(data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters: ``data`` (rows, 1 + row bytes) with each
    row's filter byte first, ``bpp`` bytes a pixel (1 below 8 bits).
    None, Sub (a running sum mod 256) and Up rows are vectorised along the
    row; runs of Avg / Paeth rows decode by anti-diagonals
    (:func:`_unfilter_wavefront`), in blocks of ``WAVEFRONT_ROWS``."""
    h, n = data.shape[0], data.shape[1] - 1
    filt, raw = data[:, 0], data[:, 1:]
    if int(filt.max(initial=0)) > 4:
        raise ValueError(f"PNG filter type {int(filt.max())} is not 0-4")
    out = np.empty((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    r = 0
    while r < h:
        ft = int(filt[r])
        if ft >= 3:
            e = r + 1
            while e < h and filt[e] >= 3 and e - r < WAVEFRONT_ROWS:
                e += 1
            out[r:e] = _unfilter_wavefront(raw[r:e], filt[r:e], prev, bpp)
            r = e
        else:
            if ft == 0:
                out[r] = raw[r]
            elif ft == 1:
                out[r] = np.cumsum(raw[r].reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)
            else:
                out[r] = raw[r] + prev
            r += 1
        prev = out[r - 1]
    return out


def _png_chunks(buf: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        yield kind, buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


class _NeedsCodec(Exception):
    """A file this module does not decode itself (its format's name)."""


def _read_png(buf: bytes, backend: str) -> np.ndarray:
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise _NeedsCodec("interlaced PNG")
    ch = _PNG_CHANNELS[ctype]
    bits = depth * ch
    bpp = max(bits // 8, 1)
    row = (w * bits + 7) // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[:h * (row + 1)]
    px = png_unfilter(data.reshape(h, row + 1), bpp)
    if depth == 16 and ctype == 0 and backend == "pil":  # PIL's "I;16" -> "RGB" clips
        samples = np.minimum(px.reshape(h, w, 1, 2).view(">u2")[..., 0], 255).astype(np.uint8)
    elif depth == 16:
        samples = px.reshape(h, w, ch, 2)[..., 0]  # the high byte, as cv2's 8-bit read
    elif depth == 8:
        samples = px.reshape(h, w, ch)
    else:  # 1, 2 or 4 bits, one sample a pixel (gray or palette)
        bitsplit = np.unpackbits(px, axis=1).reshape(h, -1, depth)[:, :w]
        samples = (bitsplit * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(np.uint8)
        if ctype == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        samples = samples[..., None]
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[samples[..., 0]]
    if ctype in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def write_png(path: str | Path, img: np.ndarray, filter: str = "sub") -> Path:
    """Write uint8 (H, W, 3) RGB or (H, W) gray as an 8-bit PNG, every row
    with the same filter (``"sub"`` or ``"paeth"``; zlib level 6)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W, 3) or (H, W), got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    x = img.reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    if filter == "sub":
        filtered = x - a
    elif filter == "paeth":
        b = np.zeros_like(x)
        b[1:] = x[:-1]
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        filtered = x - _paeth_or_avg(a, b, c, np.int16(4))
    else:
        raise ValueError(f"filter {filter!r}: 'sub' or 'paeth'")
    rows = np.empty((h, w * bpp + 1), np.uint8)
    rows[:, 0] = PNG_FILTERS[filter]
    rows[:, 1:] = (filtered & 255).astype(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if bpp == 3 else 0, 0, 0, 0)
    path = Path(path)
    path.write_bytes(PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))
    return path


# ---------------------------------------------------------- BMP, PNM, npy


def _read_bmp(buf: bytes) -> np.ndarray:
    offset = struct.unpack("<I", buf[10:14])[0]
    hsize = struct.unpack("<I", buf[14:18])[0]
    if hsize < 40:
        raise _NeedsCodec("BMP with a core header")
    w, h, _, bits, comp = struct.unpack("<iiHHI", buf[18:34])
    if comp != 0 or bits not in (8, 24, 32):
        raise _NeedsCodec(f"BMP ({bits} bits, compression {comp})")
    top_down, h = h < 0, abs(h)
    stride = (w * bits // 8 + 3) & ~3
    rows = np.frombuffer(buf, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        ncolors = struct.unpack("<I", buf[46:50])[0] or 256
        table = np.frombuffer(buf, np.uint8, 4 * ncolors, 14 + hsize).reshape(-1, 4)
        bgr = table[rows[:, :w], :3]
    else:
        bgr = rows[:, :w * bits // 8].reshape(h, w, bits // 8)[..., :3]
    return np.ascontiguousarray(bgr[..., ::-1])


def _read_pnm(buf: bytes) -> np.ndarray:
    fields, pos = [], 2
    while len(fields) < 3:  # width, height, maxval, skipping comments
        while buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":
            pos = buf.index(b"\n", pos)
            continue
        end = pos
        while not buf[end:end + 1].isspace():
            end += 1
        fields.append(int(buf[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise _NeedsCodec(f"PNM with maxval {maxval}")
    ch = 3 if buf[:2] == b"P6" else 1
    px = np.frombuffer(buf, np.uint8, w * h * ch, pos + 1).reshape(h, w, ch)
    return np.repeat(px, 3, axis=2) if ch == 1 else px.copy()


def _read_npy(path: Path) -> np.ndarray:
    arr = np.load(path, allow_pickle=False)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3
                                                          and arr.shape[2] != 3):
        raise ValueError(f"{path}: an image .npy is uint8 (H, W, 3) RGB or (H, W), got "
                         f"{arr.shape} {arr.dtype}")
    return np.repeat(arr[..., None], 3, axis=2) if arr.ndim == 2 else arr


def _codec_name(buf: bytes, path: Path) -> str:
    if buf[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if buf[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if buf[:4] == b"RIFF" and buf[8:12] == b"WEBP":
        return "WebP"
    return path.suffix.lstrip(".").upper() or "unknown"


def _decode_with(backend: str, path: Path, fmt: str) -> np.ndarray:
    """Decode through cv2 or PIL, or raise ImportError naming ``fmt``."""
    if backend == "pil":
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"{path}: decoding {fmt} needs PIL (Pillow), which is not "
                              "installed") from e
        try:
            with Image.open(path) as im:
                return np.array(im.convert("RGB"))
        except OSError as e:
            raise FileNotFoundError(f"cannot read image: {path}") from e
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: decoding {fmt} needs cv2 (opencv-python), which is not "
                          "installed") from e
    img = cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imread_rgb(path: str | Path, backend: str = "cv2") -> np.ndarray:
    """An image file as uint8 (H, W, 3) RGB, as ``cv2.imread`` + BGR2RGB
    gives it (``backend="cv2"``) or PIL's ``convert("RGB")``
    (``backend="pil"``). PNG, uncompressed BMP, binary PPM / PGM (maxval
    255) and ``.npy`` (uint8 (H, W, 3) RGB or (H, W) gray) decode here;
    other formats go to the backend's library, and raise ImportError naming
    the format where it is not installed. A missing file raises
    FileNotFoundError."""
    if backend not in ("cv2", "pil"):
        raise ValueError(f"backend {backend!r}: 'cv2' or 'pil'")
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"cannot read image: {path}")
    buf = path.read_bytes()
    try:
        if buf[:8] == PNG_SIGNATURE:
            return _read_png(buf, backend)
        if buf[:2] == b"BM":
            return _read_bmp(buf)
        if buf[:2] in (b"P5", b"P6"):
            return _read_pnm(buf)
        if buf[:6] == b"\x93NUMPY":
            return _read_npy(path)
        fmt = _codec_name(buf, path)
    except _NeedsCodec as e:
        fmt = str(e)
    return _decode_with(backend, path, fmt)


# ------------------------------------------------------- training augmentations

HSV_SHIFT = 12  # cv2's RGB2HSV_b fixed point
CV2_HSV_BLOCK = 32  # HSV2RGB_b's vector step: 4 x 8 float lanes (AVX2)
CV2_WARP_LANES = 16  # the warps' vector step: 2 x 8 float lanes (AVX2)
_HSV_SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (cv2's ``v_fma`` / a contracted
    scalar expression): the product and the sum in float64, one rounding."""
    return (a.double() * (b.double() if torch.is_tensor(b) else float(b))
            + (c.double() if torch.is_tensor(c) else float(c))).float()


def _f32(v) -> float:
    return float(np.float32(v))


def rgb_to_hsv_u8(img):
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` on uint8 (..., 3), a tensor or
    an ndarray: cv2's integer path, V = max, S = (diff sdiv[V] + 2^11) >> 12,
    H from the max channel's difference times hdiv[diff] (12-bit tables
    ``round(255 2^12 / i)`` and ``round(180 2^12 / (6 i))``), hue in 0-179."""
    t, is_np = _np_in(img)
    dev = t.device
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << HSV_SHIFT) / (6.0 * i))
    sdiv_t, hdiv_t = torch.from_numpy(sdiv).to(dev), torch.from_numpy(hdiv).to(dev)
    x = t.long()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * sdiv_t[v] + half) >> HSV_SHIFT
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv_t[diff] + half) >> HSV_SHIFT
    h = h + (h < 0).long() * 180
    out = torch.stack([h, s, v], -1).to(torch.uint8)
    return out.numpy() if is_np else out


def _hsv_tabs(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """HSV2RGB's four candidate values v, v(1 - s), v(1 - s h), v(1 - s (1 -
    h)) in float32, the two inner terms fused as cv2's contracted code."""
    one = torch.ones_like(s)
    return torch.stack([v, v * (one - s), v * _fma(-s, h, 1.0), v * _fma(-s, one - h, 1.0)], -1)


def hsv_to_rgb_u8(img):
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` on uint8 (H, W, 3) or (B, H,
    W, 3), a tensor or an ndarray: float32 as cv2's HSV2RGB_b, S and V times
    float32(1 / 255), H times float32(6 / 180), the sector's values times 255.
    Per row, the first ``W // 32 * 32`` pixels take cv2's vector code (sector
    from trunc, values truncated to bytes) and the rest its scalar code
    (``fmod``, ``floor``, S = 0 gives V, values rounded half to even)."""
    t, is_np = _np_in(img)
    nvec = t.shape[-2] // CV2_HSV_BLOCK * CV2_HSV_BLOCK
    sd = torch.tensor(_HSV_SECTORS, dtype=torch.long, device=t.device)
    parts = []
    for x, vector in ((t[..., :nvec, :], True), (t[..., nvec:, :], False)):
        if x.shape[-2] == 0:
            continue
        x = x.float()
        h, s, v = x[..., 0], x[..., 1] * _f32(1 / 255), x[..., 2] * _f32(1 / 255)
        hh = h * _f32(6 / 180)
        if vector:
            pre = torch.trunc(hh)
            sec = (pre - torch.trunc(pre * _f32(1 / 6)) * 6.0).long().clamp(0, 5)
            rgb = torch.gather(_hsv_tabs(hh - pre, s, v), -1, sd[sec]) * 255.0
            parts.append(torch.trunc(rgb).clamp(0, 255))
            continue
        hm = torch.fmod(hh, 6.0)
        fl = torch.floor(hm)
        bad = (fl < 0) | (fl >= 6)
        fr = torch.where(bad, torch.zeros_like(hm), hm - fl)
        sec = torch.where(bad, torch.zeros_like(fl), fl).long()
        rgb = torch.gather(_hsv_tabs(fr, s, v), -1, sd[sec])
        rgb = torch.where((s == 0)[..., None], v[..., None].expand_as(rgb), rgb)
        parts.append(torch.round(rgb * 255.0).clamp(0, 255))
    out = torch.cat(parts, -2).flip(-1).to(torch.uint8)
    return out.numpy() if is_np else out


def lut_u8(img, table):
    """``cv2.LUT(img, table)``: each byte replaced by ``table[byte]`` (a 256
    uint8 table, or one per channel as (256, C))."""
    t, is_np = _np_in(img)
    tab = torch.as_tensor(np.ascontiguousarray(table, np.uint8)).to(t.device)
    idx = t.long()
    out = tab[idx] if tab.dim() == 1 else tab[idx, torch.arange(tab.shape[1], device=t.device)]
    return out.numpy() if is_np else out


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)`` in float64: the
    centre as float32 (cv2's ``Point2f``), cos and sin from the C library."""
    import math

    cx, cy = _f32(center[0]), _f32(center[1])
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _bilinear_u8(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, border: str,
                 value=None) -> torch.Tensor:
    """cv2's float INTER_LINEAR at float32 source coordinates (oh, ow) over a
    uint8 (H, W, C) tensor: ``ix = floor(sx)``, ``a = sx - ix``; the four
    neighbours (``border``: ``"constant"`` with ``value`` a channel, or
    ``"reflect"``); ``v0 = fma(a, p01 - p00, p00)``, ``v1`` likewise,
    ``fma(b, v1 - v0, v0)``, rounded half to even and saturated."""
    h, w, c = x.shape
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    big = float(1 << 30)
    ix = fx.clamp(-big, big).long()
    iy = fy.clamp(-big, big).long()
    flat = x.reshape(h * w, c).float()

    def pixel(yy, xx):
        if border == "reflect":
            yy, xx = _reflect(yy, h), _reflect(xx, w)
            return flat[yy * w + xx]
        inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        p = flat[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))]
        return torch.where(inside, p, value)

    p00, p01 = pixel(iy, ix), pixel(iy, ix + 1)
    p10, p11 = pixel(iy + 1, ix), pixel(iy + 1, ix + 1)
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    v = _fma(b, v1 - v0, v0)
    return torch.round(v).clamp_(0, 255).to(torch.uint8)


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """cv2's ``BORDER_REFLECT`` index (``fedcba|abcdefgh|hgfedcb``)."""
    if n == 1:
        return torch.zeros_like(i)
    p = torch.remainder(i, 2 * n)
    return torch.where(p >= n, 2 * n - 1 - p, p)


def _border_value(value, c: int, dev) -> torch.Tensor:
    vals = [value] * c if np.isscalar(value) else list(value)[:c]
    vals += [0] * (c - len(vals))
    return torch.tensor([float(np.clip(np.rint(v), 0, 255)) for v in vals], device=dev)


def _warp(img, size, coords, border_value):
    t, is_np = _np_in(img)
    if t.dtype != torch.uint8 or t.dim() not in (2, 3):
        raise ValueError(f"expected uint8 (H, W, C) or (H, W), got {tuple(t.shape)} {t.dtype}")
    x = t if t.dim() == 3 else t[..., None]
    ow, oh = int(size[0]), int(size[1])
    dev = t.device
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    sx, sy = coords(xs, ys, ow)
    out = _bilinear_u8(x, sx, sy, "constant", _border_value(border_value, x.shape[2], dev))
    out = out if t.dim() == 3 else out[..., 0]
    return out.numpy() if is_np else out


def _affine_inverse(m: np.ndarray) -> list[float]:
    """cv2 ``warpAffine``'s inversion of the forward 2 x 3 matrix, in double."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine_u8(img, m, size: tuple[int, int], border_value=0):
    """``cv2.warpAffine(img, m, (w, h), borderValue=...)`` with INTER_LINEAR and
    BORDER_CONSTANT on uint8 (H, W, C) or (H, W), a tensor (any device) or an
    ndarray. cv2 inverts ``m`` in double and takes it as float32; per row the
    first ``w // 16 * 16`` columns (its vector steps) map by ``fma(M0, x,
    float32(y M1 + M2))``, the rest by the scalar ``float32(fma(x, M0, y M1)
    + M2)``; then :func:`_bilinear_u8`."""
    mi = [_f32(v) for v in _affine_inverse(m)]

    def coords(xs, ys, ow):
        vec = xs < ow // CV2_WARP_LANES * CV2_WARP_LANES
        out = []
        for r in (0, 3):
            row = ys * mi[r + 1] + mi[r + 2]
            v = _fma(xs.expand(len(ys), -1), mi[r], row.expand(-1, ow))
            s = _fma(xs.expand(len(ys), -1), mi[r], (ys * mi[r + 1]).expand(-1, ow)) + mi[r + 2]
            out.append(torch.where(vec, v, s))
        return out

    return _warp(img, size, coords, border_value)


def _invert3(m: np.ndarray) -> list[float]:
    """cv2 ``invert`` of a 3 x 3 double matrix (DECOMP_LU takes its explicit
    cofactor formula at n <= 3)."""
    s = np.asarray(m, np.float64).reshape(3, 3).tolist()
    d = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
         - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
         + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    d = 1.0 / d if d != 0 else 0.0
    return [(s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d, (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
            (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d, (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
            (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d, (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
            (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d, (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
            (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d]


def warp_perspective_u8(img, m, size: tuple[int, int], border_value=0):
    """``cv2.warpPerspective(img, m, (w, h), borderValue=...)`` with
    INTER_LINEAR and BORDER_CONSTANT on uint8 (H, W, C) or (H, W). cv2
    inverts ``m`` (double, cofactors) and takes it as float32; per row the
    first ``w // 16 * 16`` columns map by ``fma(M0, x, float32(y M1 + M2))``
    over ``fma(M6, x, float32(y M7 + M8))``, the rest by the scalar
    ``float32(fma(x, M0, y M1) + M2)`` over its ``w``; float32 division."""
    mi = [_f32(v) for v in _invert3(m)]

    def coords(xs, ys, ow):
        vec = xs < ow // CV2_WARP_LANES * CV2_WARP_LANES
        xe = xs.expand(len(ys), -1)

        def rows(r):
            v = _fma(xe, mi[r], (ys * mi[r + 1] + mi[r + 2]).expand(-1, ow))
            s = _fma(xe, mi[r], (ys * mi[r + 1]).expand(-1, ow)) + mi[r + 2]
            return torch.where(vec, v, s)

        w = rows(6)
        return rows(0) / w, rows(3) / w

    return _warp(img, size, coords, border_value)


def remap_linear_u8(img, map_x, map_y):
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REFLECT)`` with float32 maps (oh, ow) on uint8
    (H, W, C) or (H, W): :func:`_bilinear_u8` at the maps' coordinates."""
    t, is_np = _np_in(img)
    x = t if t.dim() == 3 else t[..., None]
    mx = torch.as_tensor(np.ascontiguousarray(map_x, np.float32)).to(t.device)
    my = torch.as_tensor(np.ascontiguousarray(map_y, np.float32)).to(t.device)
    out = _bilinear_u8(x, mx, my, "reflect")
    out = out if t.dim() == 3 else out[..., 0]
    return out.numpy() if is_np else out


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """cv2's ``BORDER_REFLECT_101`` index (``gfedcb|abcdefgh|gfedcba``)."""
    if n == 1:
        return torch.zeros_like(i)
    p = torch.remainder(i, 2 * n - 2)
    return torch.where(p >= n, 2 * n - 2 - p, p)


def filter2d_u8(img, kernel):
    """``cv2.filter2D(img, -1, kernel)`` on uint8 (H, W, C) or (H, W) with a
    float32 k x k kernel (anchor at the centre, BORDER_REFLECT_101): cv2's
    direct filter, the nonzero coefficients in row-major order, each
    accumulated into a float32 sum from 0 by a fused multiply-add, the sum
    rounded half to even and saturated."""
    t, is_np = _np_in(img)
    x = t if t.dim() == 3 else t[..., None]
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    h, w, _ = x.shape
    dev = t.device
    xf = x.float()
    acc = torch.zeros_like(xf)
    for i, j in zip(*np.nonzero(k)):
        rows = _reflect101(torch.arange(h, device=dev) + int(i) - kh // 2, h)
        cols = _reflect101(torch.arange(w, device=dev) + int(j) - kw // 2, w)
        acc = _fma(xf.index_select(0, rows).index_select(1, cols), float(k[i, j]), acc)
    out = torch.round(acc).clamp_(0, 255).to(torch.uint8)
    out = out if t.dim() == 3 else out[..., 0]
    return out.numpy() if is_np else out


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) of an image file from its header: PNG, BMP, PPM /
    PGM and JPEG (its first start-of-frame marker) here, other formats
    through PIL where it imports (an ``ImportError`` naming the format where
    it does not)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
    if head[:8] == PNG_SIGNATURE:
        return struct.unpack(">II", head[16:24])
    if head[:2] == b"BM":
        w, h = struct.unpack("<ii", head[18:26])
        return w, abs(h)
    if head[:2] in (b"P5", b"P6"):
        fields, pos = [], 2
        while len(fields) < 2:
            while head[pos:pos + 1].isspace():
                pos += 1
            if head[pos:pos + 1] == b"#":
                pos = head.index(b"\n", pos)
                continue
            end = pos
            while not head[end:end + 1].isspace():
                end += 1
            fields.append(int(head[pos:end]))
            pos = end
        return fields[0], fields[1]
    if head[:3] == b"\xff\xd8\xff":
        buf = path.read_bytes()
        pos = 2
        while pos + 9 < len(buf):
            if buf[pos] != 0xFF:
                pos += 1
                continue
            marker = buf[pos + 1]
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7 or marker == 0xFF:
                pos += 1 if marker == 0xFF else 2
                continue
            seg = struct.unpack(">H", buf[pos + 2:pos + 4])[0]
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                h, w = struct.unpack(">HH", buf[pos + 5:pos + 9])
                return w, h
            pos += 2 + seg
        raise ValueError(f"{path}: JPEG without a start-of-frame marker")
    fmt = _codec_name(head, path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading the size of {fmt} needs PIL (Pillow), which is "
                          "not installed") from e
    with Image.open(path) as im:
        return im.size


# ------------------------------------------------------------ masks and luma

XY_SHIFT = 16  # cv2's drawing fixed point
XY_ONE = 1 << XY_SHIFT
_INT_MAX = 2**31 - 1
_INT64_MAX = 2**63 - 1


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1: list[int], p2: list[int]) -> bool:
    """cv2's ``clipLine(Size(w, h), pt1, pt2)``: the segment clipped to the
    image in place (int64 ends, the intersections in double, truncated);
    False where it lies wholly outside."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _line8(img: np.ndarray, p1: list[int], p2: list[int], color) -> None:
    """cv2's ``Line`` at 8-connectivity: ``LineIterator(img, p1, p2, 8,
    leftToRight=true)`` (clipped to the image first), Bresenham with the
    error ``dx - 2 dy``, a diagonal step while it is negative."""
    h, w = img.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        if not clip_line(w, h, p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    x, y = p1
    for _ in range(major + 1):
        img[y, x] = color
        step = err < 0
        err += -2 * minor + (2 * major if step else 0)
        if vert:
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_edges(img: np.ndarray, pts: np.ndarray, color, edges: list) -> None:
    """cv2 5's ``CollectPolyEdges`` at LINE_8, shift 0: each edge drawn as
    an 8-connected line, and the non-horizontal ones collected in 16.16
    fixed point. An edge with an end outside the image takes the x of its
    clipped ends (and their rows, unless the clipped segment is level: then
    it runs vertically over its own rows), extrapolated back to its first
    row."""
    h, w = img.shape[:2]
    n = len(pts)
    pt0 = [int(pts[-1][0]) << XY_SHIFT, int(pts[-1][1])]
    for i in range(n):
        pt1 = [int(pts[i][0]) << XY_SHIFT, int(pts[i][1])]
        pt0c, pt1c = list(pt0), list(pt1)
        t0 = [(pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1]]
        t1 = [(pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1]]
        _line8(img, t0, t1, color)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                pt0c[1], pt1c[1] = t0[1], t1[1]
            pt0c[0], pt1c[0] = t0[0] << XY_SHIFT, t1[0] << XY_SHIFT
        if pt0[1] != pt1[1]:
            dx = _trunc_div(pt1c[0] - pt0c[0], pt1c[1] - pt0c[1])
            if pt0[1] < pt1[1]:
                edges.append(_Edge(pt0[1], pt1[1], pt0c[0] + (pt0[1] - pt0c[1]) * dx, dx))
            else:
                edges.append(_Edge(pt1[1], pt0[1], pt1c[0] + (pt1[1] - pt1c[1]) * dx, dx))
        pt0 = pt1


def _fill_edges(img: np.ndarray, edges: list, color) -> None:
    """cv2 5's ``FillEdgeCollection`` at LINE_8: the active-edge scan, each
    row filled between pairs of edges from ``ceil(x)`` to ``floor(x)``
    (16.16 fixed point) inclusive, clipped to the image, the active list
    bubble-sorted by x after each row."""
    h, w = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_max, y_min = -_INT_MAX - 1, _INT_MAX
    x_max, x_min = -1, _INT64_MAX
    for e1 in edges:
        x1 = e1.x + (e1.y1 - e1.y0) * e1.dx
        y_min, y_max = min(y_min, e1.y0), max(y_max, e1.y1)
        x_min, x_max = min(x_min, e1.x, x1), max(x_max, e1.x, x1)
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge(_INT_MAX))  # sentinel
    head = _Edge()
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    y = e.y0
    while y < y_max:
        draw = False
        clipline = y < 0
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:  # the edge ends on this row
                prelast.next = last.next
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:  # an edge starts on this row
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clipline:
                    if keep_prelast.x > prelast.x:
                        x1, x2 = (prelast.x + XY_ONE - 1) >> XY_SHIFT, keep_prelast.x >> XY_SHIFT
                    else:
                        x1, x2 = (keep_prelast.x + XY_ONE - 1) >> XY_SHIFT, prelast.x >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = color
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        keep_prelast = None  # bubble sort of the active list by x
        while True:
            prelast, last = head, head.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is head.next or keep_prelast is head:
                break
        y += 1


def fill_poly(img: np.ndarray, polys, color) -> np.ndarray:
    """``cv2.fillPoly(img, polys, color)`` (LINE_8, shift 0) in place on a
    2-D integer image: each polygon's edges drawn as 8-connected lines,
    then the interior of all of them filled by cv2's even-odd scan-line
    rule; ``polys`` lists (N, 2) integer vertex arrays (x, y). Pixel for
    pixel cv2 5.0's, out-of-frame, concave, self-intersecting and
    degenerate polygons included."""
    edges: list = []
    for p in polys:
        p = np.asarray(p).reshape(-1, 2)
        if len(p):
            _collect_edges(img, p, color, edges)
    _fill_edges(img, edges, color)
    return img


# PIL's ``convert("L")`` from RGB: ITU-R 601-2 luma, 16-bit weights, rounded
L24 = (19595, 38470, 7471)


def rgb_to_l_u8(img: np.ndarray) -> np.ndarray:
    """PIL's ``Image.convert("L")`` of uint8 (H, W, 3) RGB: ``(R 19595 + G
    38470 + B 7471 + 2^15) >> 16``, (H, W) uint8."""
    x = np.asarray(img).astype(np.uint32)
    y = x[..., 0] * L24[0] + x[..., 1] * L24[1] + x[..., 2] * L24[2] + 0x8000
    return (y >> 16).astype(np.uint8)
