"""Ship-once pages: a page batch goes to the device once as raw uint8, and the
column-stage letterbox, the char-stage overlap tiles and the recognizer's
crop letterboxes all derive there (counterpart of
``kuzu/pipeline/device_pages.py``).

Geometry is the reference's to the integer: the same gain, pad and origin
arithmetic. Pixels agree to the resize kernel's rounding: ``_resize_u8`` is
``F.interpolate`` bilinear (half-pixel centres, edges replicated, no
antialias), where JAX sums weight matrices, so after rounding a pixel may
differ by one level; ``device_crops`` repeats JAX's two-gather lerp in its
arithmetic order. The chroma-subsampled transport: ``pack_yc`` on the host
side is cv2's colour conversion and area pooling to the byte
(``data.image_io``); ``unpack_yc`` on the device is JAX's bilinear chroma
upsample (``F.interpolate``, pixels within a level) and cv2's full-range
inverse.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kuzu_torch.data.image_io import resize_area_u8, rgb_to_ycrcb_u8
from kuzu_torch.pipeline.tiling import grid_bounds


def _resize_u8(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Bilinear resize of a uint8 batch (B, h, w, 3) -> (B, nh, nw, 3), no
    antialias, rounded half to even back to uint8."""
    b, h, w, c = x.shape
    if (nh, nw) == (h, w):
        return x
    r = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=False)
    return r.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def device_letterbox(pages: torch.Tensor, size, fill: int = 114):
    """``letterbox_np`` on the device: (B, H, W, 3) uint8 -> ((B, th, tw, 3)
    uint8, gain, (pad_x, pad_y))."""
    th, tw = (size, size) if isinstance(size, int) else (int(size[0]), int(size[1]))
    b, h, w, _ = pages.shape
    gain = min(th / h, tw / w)
    nw, nh = max(int(round(w * gain)), 1), max(int(round(h * gain)), 1)
    r = _resize_u8(pages, nh, nw)
    px, py = (tw - nw) // 2, (th - nh) // 2
    if (nh, nw) == (th, tw):
        return r, gain, (px, py)
    canvas = torch.full((b, th, tw, 3), fill, dtype=torch.uint8, device=pages.device)
    canvas[:, py:py + nh, px:px + nw] = r
    return canvas, gain, (px, py)


def pack_yc(pages, stride: int = 4):
    """Host side of the chroma-subsampled transport: RGB uint8 (B, H, W, 3)
    (an ndarray or a tensor) -> (Y (B, H, W, 1), CrCb (B, H / s, W / s, 2))
    uint8 of the input's kind: cv2's RGB2YCrCb, the chroma mean-pooled over
    s x s blocks (cv2's INTER_AREA), each to the byte. Full-resolution luma
    and 4x-subsampled chroma carry a page in (1 + 2 / s^2) / 3 of the
    bytes."""
    b, h, w, _ = pages.shape
    if h % stride or w % stride:
        raise ValueError(f"page ({h}, {w}) is not a multiple of the stride {stride}")
    ycc = rgb_to_ycrcb_u8(pages)
    return ycc[..., :1], resize_area_u8(ycc[..., 1:], stride)


def unpack_yc(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Device side: (Y, CrCb) uint8 -> RGB uint8 (B, H, W, 3): the chroma
    upsampled bilinearly (no antialias, as JAX's ``jax.image.resize``), then
    cv2's full-range YCrCb inverse in f32, rounded half to even."""
    b, h, w, _ = y.shape
    cf = F.interpolate(c.permute(0, 3, 1, 2).float(), size=(h, w), mode="bilinear",
                       align_corners=False, antialias=False).permute(0, 2, 3, 1)
    yf = y.float()[..., 0]
    cr = cf[..., 0] - 128.0
    cb = cf[..., 1] - 128.0
    rgb = torch.stack([yf + 1.403 * cr, yf - 0.714 * cr - 0.344 * cb, yf + 1.773 * cb], -1)
    return rgb.round_().clamp_(0, 255).to(torch.uint8)


def tile_bounds_px(h: int, w: int, grid: int, overlap: float):
    """Pixel tile bounds, the same ints as the reference's ``tile_image``."""
    return [
        (int(x1 * w), int(y1 * h), int(x2 * w), int(y2 * h))
        for x1, y1, x2, y2 in grid_bounds(grid, overlap)
    ]


def device_tiles(pages: torch.Tensor, grid: int, overlap: float, tile_size: int):
    """Overlap tiles of a page batch on the device: (B, H, W, 3) uint8 ->
    (tiles (B*T, S, S, 3) uint8 page-major, the per-tile metas of one page;
    all pages share the geometry)."""
    b, h, w, _ = pages.shape
    outs, metas = [], []
    for px1, py1, px2, py2 in tile_bounds_px(h, w, grid, overlap):
        canvas, gain, (pad_x, pad_y) = device_letterbox(pages[:, py1:py2, px1:px2], tile_size)
        outs.append(canvas)
        metas.append({"origin": (px1, py1), "gain": gain, "pad": (pad_x, pad_y)})
    t = len(outs)
    tiles = torch.stack(outs, dim=1).reshape(b * t, tile_size, tile_size, 3)
    return tiles, metas


def device_crops(
    pages: torch.Tensor,  # (B, H, W, 3) uint8
    page_idx: torch.Tensor,  # (N,) int
    boxes: torch.Tensor,  # (N, 4) f32 xyxy page pixels (margin-expanded, clipped)
    out_h: int = 1024,
    out_w: int = 64,
    fill: int = 255,
    chunk: int = 64,
) -> torch.Tensor:
    """The recognizer's crop letterbox on the device with dynamic windows:
    each crop resamples its page window to (out_h, out_w) with gain =
    min(out_h / ch, out_w / cw), content at the top-left, ``fill``
    elsewhere. Bilinear sampling gathers the four taps of every output pixel
    straight from the page (no (out_h, W, 3) row copy), ``chunk`` crops at a
    time. The arithmetic is JAX's, op for op, in f32. Returns (N, out_h,
    out_w, 3) uint8."""
    n = page_idx.shape[0]
    h, w = pages.shape[1], pages.shape[2]
    dev = pages.device
    out = torch.empty((n, out_h, out_w, 3), dtype=torch.uint8, device=dev)
    ar_h = torch.arange(out_h, dtype=torch.float32, device=dev)
    ar_w = torch.arange(out_w, dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        pidx = page_idx[lo:lo + chunk].to(device=dev, dtype=torch.long)
        box = boxes[lo:lo + chunk].to(device=dev, dtype=torch.float32)
        x1, y1, x2, y2 = (box[:, i:i + 1] for i in range(4))
        ch = torch.clamp(torch.floor(y2) - torch.floor(y1), min=1.0)
        cw = torch.clamp(torch.floor(x2) - torch.floor(x1), min=1.0)
        x1, y1 = torch.floor(x1), torch.floor(y1)
        y2, x2 = y1 + ch, x1 + cw
        # a true f32 division: ``scalar / tensor`` is ``reciprocal() * scalar``
        # in torch, an ulp off, which can move floor(c * gain) by a pixel
        gain = torch.minimum(torch.full_like(ch, out_h) / ch, torch.full_like(cw, out_w) / cw)
        # the host letterbox truncates the content size to int(c * gain) and
        # stretches the crop to exactly that, so the scale is c / n
        nh = torch.clamp(torch.floor(ch * gain), min=1.0)
        nw = torch.clamp(torch.floor(cw * gain), min=1.0)
        ys = y1 + (ar_h + 0.5) * (ch / nh) - 0.5
        xs = x1 + (ar_w + 0.5) * (cw / nw) - 0.5
        ys = torch.minimum(torch.maximum(ys, y1), y2 - 1.0)
        xs = torch.minimum(torch.maximum(xs, x1), x2 - 1.0)
        y0 = torch.floor(ys).clamp(0, h - 1).to(torch.long)
        x0 = torch.floor(xs).clamp(0, w - 1).to(torch.long)
        y1i = (y0 + 1).clamp(max=h - 1)
        x1i = (x0 + 1).clamp(max=w - 1)
        fy = (ys - y0.float())[:, :, None, None]
        fx = (xs - x0.float())[:, None, :, None]
        p = pidx[:, None, None]

        def tap(yi, xi):
            return pages[p, yi[:, :, None], xi[:, None, :]].float()

        top = tap(y0, x0) * (1 - fx) + tap(y0, x1i) * fx
        bot = tap(y1i, x0) * (1 - fx) + tap(y1i, x1i) * fx
        res = top * (1 - fy) + bot * fy
        inside = (ar_h[None, :, None, None] < nh[:, :, None, None]) & (
            ar_w[None, None, :, None] < nw[:, :, None, None])
        res = torch.where(inside, res, torch.full_like(res, float(fill)))
        out[lo:lo + chunk] = res.round_().clamp_(0, 255).to(torch.uint8)
    return out
