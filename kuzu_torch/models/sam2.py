"""SAM2-lite: memory-conditioned (video) segmentation (counterpart of
``kuzu/models/sam2.py``): prompt an object on the first frame, then
propagate its mask through the clip by conditioning each frame's features
on a memory bank of past frames' mask-fused features and object-pointer
tokens.

The bank is a dict of fixed-shape tensors, as JAX's: ``(B, M, N, mem_dim)``
memories and ``(B, K, dim)`` object pointers with validity masks and the
frame each slot was written at, absent slots masked out of the memory
cross-attention. JAX carries it through one ``lax.scan``; here
:meth:`SAM2.track` loops over the frames in Python, and the ring positions
(``idx % mem_frames``, ``idx % max_ptrs``) are Python ints, so no frame
reads a value back from the device. Objects are batch lanes.

Module and parameter names are the flax tree's (``memory_encoder/down0``,
``memory_attention/layer0/cross_attn``, ``obj_ptr_proj``, ``ptr_to_mem``,
``no_mem_embed`` ...): ``kuzu_torch.bridge`` carries the variables of JAX's
``track`` init across. As flax computes them:

- the memory encoder's stride-2 3 x 3 convolutions pad ``'SAME'``, which
  on the even stride-4 mask is no row before and one after
  (``tiny_encoder.conv_same``), not one on each side;
- on the first frame no slot is valid: the memory attention runs over a
  fully masked row (scores filled with the finite ``layers.NEG``, so the
  softmax stays finite) and ``where`` keeps the features plus
  ``no_mem_embed`` instead.

``attn_impl`` goes to SAM's ViT encoder as in JAX: ``"flash"`` runs K3 at
eval, ``"flash_train"`` K3 and K4 in ``forward(train=True)``; the TinyViT
encoder ignores it. The memory attention is the einsum route always.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from kuzu_torch.models.layers import (
    Dense,
    Mlp,
    MultiHeadAttention,
    dtype_products,
    gelu,
    layer_norm,
    sincos_2d_pos_embed,
)
from kuzu_torch.models.sam import PAD, MaskDecoder, PromptEncoder, SAMImageEncoder, init_sam_
from kuzu_torch.models.tiny_encoder import conv_same
from kuzu_torch.models.yolo.detector import resolve_device


def sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """Sincos embedding of integer positions -> (..., dim) f32: sin then cos
    over ``dim / 2`` log-spaced frequencies."""
    half = dim // 2
    ar = torch.arange(half, device=pos.device, dtype=torch.float32)
    freqs = torch.exp(ar * -math.log(10000.0) / max(half - 1, 1))
    ang = pos[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class MemoryEncoder(nn.Module):
    """A frame's features fused with its predicted mask into a compact
    memory: the stride-4 mask through two stride-2 convolutions (LayerNorm,
    GELU) to the stride-16 grid, added to the projected features.
    (B, N, dim), (B, H4, W4) -> (B, N, mem_dim) f32."""

    def __init__(self, dim: int, mem_dim: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mem_dim, self.dtype = mem_dim, dtype
        cin = 1
        for i, ch in enumerate((mem_dim // 2, mem_dim)):
            self.add_module(f"down{i}", nn.Conv2d(cin, ch, 3, stride=2))
            self.add_module(f"norm{i}", layer_norm(ch, dtype))
            cin = ch
        self.fuse = Dense(dim, mem_dim, dtype)
        self.proj = Dense(mem_dim, mem_dim, dtype)

    def forward(self, feat: torch.Tensor, mask_logits: torch.Tensor,
                grid_hw: tuple[int, int]) -> torch.Tensor:
        hg, wg = grid_hw
        m = torch.sigmoid(mask_logits)[..., None]  # (B, H4, W4, 1)
        for i in range(2):
            m = gelu(getattr(self, f"norm{i}")(conv_same(getattr(self, f"down{i}"), m,
                                                         self.dtype)))
        m = m.reshape(m.shape[0], hg * wg, self.mem_dim)
        return self.proj(gelu(m + self.fuse(feat))).float()


class MemoryAttentionLayer(nn.Module):
    """Pre-norm self-attention, cross-attention over the memory (keys and
    values projected from ``mem_dim``), MLP."""

    def __init__(self, dim: int, mem_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = layer_norm(dim, dtype)
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype=dtype)
        self.norm2 = layer_norm(dim, dtype)
        self.cross_attn = MultiHeadAttention(dim, num_heads, dtype=dtype, kv_dim=mem_dim)
        self.norm3 = layer_norm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, mem_kv, mem_mask):
        x = x + self.self_attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), kv=mem_kv, mask=mem_mask)
        return x + self.mlp(self.norm3(x))


class MemoryAttention(nn.Module):
    """A stack of :class:`MemoryAttentionLayer` and a final LayerNorm."""

    def __init__(self, dim: int, mem_dim: int, depth: int = 2, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer{i}", MemoryAttentionLayer(dim, mem_dim, num_heads,
                                                              dtype=dtype))
        self.norm = layer_norm(dim, dtype)

    def forward(self, x, mem_kv, mem_mask):
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, mem_kv, mem_mask)
        return self.norm(x)


class SAM2(nn.Module):
    """Promptable image and video segmentation with a ring-buffer memory.

    ``track(frames, points, labels)`` propagates the frame-0 prompt through
    the clip; ``forward`` is single-frame promptable segmentation with
    ``SAM``'s contract. Coordinates are normalized to [0, 1]."""

    def __init__(self, img_size: int = 256, dim: int = 256, mem_dim: int = 64,
                 enc_depth: int = 6, enc_heads: int = 8, dec_heads: int = 8,
                 mem_depth: int = 2, num_masks: int = 3, mem_frames: int = 4,
                 max_ptrs: int = 4, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "einsum", encoder_kind: str = "vit"):
        super().__init__()
        self.img_size, self.dim, self.mem_dim, self.dtype = img_size, dim, mem_dim, dtype
        self.mem_frames, self.max_ptrs = mem_frames, max_ptrs
        if encoder_kind == "tiny":
            from kuzu_torch.models.tiny_encoder import TinyViTEncoder

            self.encoder = TinyViTEncoder(img_size, dim, dtype=dtype, attn_impl=attn_impl)
        else:
            self.encoder = SAMImageEncoder(img_size, 16, dim, enc_depth, enc_heads, dtype=dtype,
                                           attn_impl=attn_impl)
        self.prompt_encoder = PromptEncoder(dim)
        self.decoder = MaskDecoder(dim, dec_heads, num_masks=num_masks, dtype=dtype,
                                   return_tokens=True)
        self.memory_encoder = MemoryEncoder(dim, mem_dim, dtype=dtype)
        self.memory_attention = MemoryAttention(dim, mem_dim, mem_depth, enc_heads, dtype=dtype)
        self.obj_ptr_proj = Dense(dim, dim)  # f32
        self.ptr_to_mem = Dense(dim, mem_dim)  # f32
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, dim))
        g = self.grid
        self.register_buffer("img_pe", torch.from_numpy(sincos_2d_pos_embed(dim, g, g))[None],
                             persistent=False)

    @property
    def grid(self) -> int:
        return self.img_size // 16

    def empty_bank(self, batch: int) -> dict:
        """Fixed-shape zero bank: M memory slots and K pointer slots, all
        invalid; ``idx`` (a Python int) counts the frames written."""
        n, dev = self.grid * self.grid, self.no_mem_embed.device
        m, k = self.mem_frames, self.max_ptrs
        return {
            "mem": torch.zeros((batch, m, n, self.mem_dim), device=dev),
            "mem_valid": torch.zeros((batch, m), dtype=torch.bool, device=dev),
            "mem_t": torch.zeros((batch, m), dtype=torch.int32, device=dev),
            "ptr": torch.zeros((batch, k, self.dim), device=dev),
            "ptr_valid": torch.zeros((batch, k), dtype=torch.bool, device=dev),
            "ptr_t": torch.zeros((batch, k), dtype=torch.int32, device=dev),
            "idx": 0,
        }

    def condition(self, feat: torch.Tensor, bank: dict, t: int) -> torch.Tensor:
        """Memory-conditioned features of frame ``t``."""
        b, n, _ = feat.shape
        temb = sincos_1d(self.mem_dim, torch.clamp(t - bank["mem_t"], 0, 1024))  # (B, M, mem)
        mem = (bank["mem"] + temb[:, :, None, :]).reshape(b, self.mem_frames * n, self.mem_dim)
        mem_ok = bank["mem_valid"].repeat_interleave(n, dim=1)  # (B, M N)
        ptr = self.ptr_to_mem(bank["ptr"]) + sincos_1d(
            self.mem_dim, torch.clamp(t - bank["ptr_t"], 0, 1024))
        kv = torch.cat([mem, ptr], dim=1)
        ok = torch.cat([mem_ok, bank["ptr_valid"]], dim=1)
        attended = self.memory_attention(feat, kv.to(feat.dtype), ok[:, None, None, :])
        any_mem = ok.any(dim=1)[:, None, None]
        return torch.where(any_mem, attended, feat + self.no_mem_embed.to(feat.dtype))

    def decode(self, feat: torch.Tensor, points: torch.Tensor, labels: torch.Tensor):
        """(mask logits (B, K, S / 4, S / 4), IoU (B, K), mask tokens (B, K, dim))."""
        g = self.grid
        prompts = self.prompt_encoder(points, labels)
        return self.decoder(feat, self.img_pe.to(feat.dtype), prompts, (g, g))

    def track_step(self, bank: dict, frame: torch.Tensor, points: torch.Tensor,
                   labels: torch.Tensor, t: int):
        """One frame: encode, condition on the memory, decode, write the
        memory. Returns (the new bank, (best mask logits (B, S/4, S/4),
        its IoU (B,)))."""
        feat = self.encoder(frame, train=False)
        cond = self.condition(feat, bank, t)
        masks, iou, mask_toks = self.decode(cond, points, labels)
        best = iou.argmax(dim=1)
        lanes = torch.arange(len(best), device=best.device)
        best_mask, best_tok = masks[lanes, best], mask_toks[lanes, best]
        new_mem = self.memory_encoder(feat, best_mask, (self.grid, self.grid))
        obj_ptr = self.obj_ptr_proj(best_tok.float())
        mi, pi = bank["idx"] % self.mem_frames, bank["idx"] % self.max_ptrs
        out = {k: v.clone() for k, v in bank.items() if k != "idx"}
        out["mem"][:, mi] = new_mem
        out["mem_valid"][:, mi] = True
        out["mem_t"][:, mi] = t
        out["ptr"][:, pi] = obj_ptr
        out["ptr_valid"][:, pi] = True
        out["ptr_t"][:, pi] = t
        out["idx"] = bank["idx"] + 1
        return out, (best_mask, iou.amax(dim=1))

    def track(self, frames: torch.Tensor, points: torch.Tensor, labels: torch.Tensor):
        """Propagate the frame-0 prompt ``points`` (B, P, 2), ``labels``
        (B, P) through ``frames`` (B, T, S, S, 3); from frame 1 on every
        label is PAD. Returns (mask logits (B, T, S/4, S/4), IoU (B, T))."""
        bank = self.empty_bank(frames.shape[0])
        pad = torch.full_like(labels, PAD)
        masks, ious = [], []
        with dtype_products(self.dtype):
            for t in range(frames.shape[1]):
                bank, (m, i) = self.track_step(bank, frames[:, t], points,
                                               labels if t == 0 else pad, t)
                masks.append(m)
                ious.append(i)
        return torch.stack(masks, dim=1), torch.stack(ious, dim=1)

    def forward(self, images, points, labels, train: bool = False):
        """Single-frame promptable segmentation (``SAM``'s contract):
        (mask logits (B, K, S/4, S/4), IoU (B, K))."""
        with dtype_products(self.dtype):
            masks, iou, _ = self.decode(self.encoder(images, train=train), points, labels)
        return masks, iou


@torch.no_grad()
def init_sam2_(model: SAM2, generator: torch.Generator) -> SAM2:
    """Seeded init with flax's distributions (``sam.init_sam_``, and
    ``no_mem_embed`` normal(0.02)). Returns ``model``."""
    init_sam_(model, generator)
    model.no_mem_embed.normal_(0.0, 0.02, generator=generator)
    return model


class SAM2VideoPredictor:
    """The reference predictor's surface: build once, then
    ``predict(frames, points, labels)`` -> per-frame masks and IoU, on the
    model's device (inputs are moved there)."""

    def __init__(self, model: SAM2):
        self.model = model.eval()

    @classmethod
    def create(cls, model: SAM2, seed: int = 0,
               device: torch.device | str | None = None) -> "SAM2VideoPredictor":
        """Seeded weights (:func:`init_sam2_`, drawn on the CPU) on
        ``device`` (the card when None)."""
        dev = resolve_device(device)
        return cls(init_sam2_(model, torch.Generator().manual_seed(seed)).to(dev))

    @torch.no_grad()
    def predict(self, frames, points, labels):
        dev = self.model.no_mem_embed.device
        return self.model.track(*(torch.as_tensor(a).to(dev) for a in (frames, points, labels)))
