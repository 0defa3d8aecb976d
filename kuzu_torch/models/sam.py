"""SAM-lite: promptable segmentation (counterpart of ``kuzu/models/sam.py``):
a ViT image encoder (or the TinyViT of ``tiny_encoder.py``), a point / box
prompt encoder with random-Fourier positions and a two-way transformer
mask decoder with IoU prediction and several masks a prompt.

Module and parameter names are the flax tree's (``encoder``,
``prompt_encoder``, ``decoder``; ``pe/gauss``, ``type_embed``,
``not_a_point``, ``output_tokens``, ``block{i}``, ``up1`` ...), so
``kuzu_torch.bridge`` maps a flax checkpoint one to one. What differs from
torch's habits, as flax computes it:

- ``FourierPE.gauss`` is a parameter behind ``stop_gradient``: its
  gradient is zero, not absent, so AdamW still decays it (it has ndim 2,
  in the decayed group) exactly as optax does;
- the decoder's 2 x 2 stride-2 upsamplers are flax ``ConvTranspose``
  layers, whose kernel is not flipped: the bridge flips it into torch's
  ``ConvTranspose2d``;
- LayerNorm eps 1e-6, GELU the tanh approximation (``layers``); the mask
  product accumulates in f32, the IoU head's last Dense is f32, masks come
  back in f32; the prompt encoder is f32 whatever ``dtype``.

The encoder's self-attention takes ``attn_impl`` as ``models/layers.py``'s
``MultiHeadAttention`` does: ``"flash"`` runs K3 at eval, ``"flash_train"``
K3 with its row statistics and K4 for the gradient; the decoder's
attentions (cross-attention, and a few tokens) are always the einsum
route, as in JAX. An f32 model computes with TF32 off (``f32_products``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.models.layers import (
    Dense,
    EncoderBlock,
    Mlp,
    MultiHeadAttention,
    PatchEmbed,
    conv_transpose_init_,
    dtype_products,
    flax_init_,
    gelu,
    layer_norm,
    sincos_2d_pos_embed,
)
from kuzu_torch.ops.images import from_uint8

# prompt label convention (the reference PromptEncoder's point labels)
PAD, BG, FG, BOX_TL, BOX_BR = -1, 0, 1, 2, 3


class _ZeroGradient(torch.autograd.Function):
    """``jax.lax.stop_gradient`` for a parameter: the value passes, the
    gradient is zeros (so the parameter has a gradient, as under JAX)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


class FourierPE(nn.Module):
    """Random-Fourier positional encoding of normalized [0, 1] coordinates:
    (..., 2) -> (..., dim) f32, sin then cos."""

    def __init__(self, dim: int, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.gauss = nn.Parameter(torch.zeros(2, dim // 2))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        x = (2.0 * coords - 1.0) @ _ZeroGradient.apply(self.gauss)
        x = x * (2 * math.pi)
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class PromptEncoder(nn.Module):
    """Points and boxes -> prompt tokens (f32). A box arrives as two
    labelled corner points (BOX_TL / BOX_BR), padding as label PAD."""

    def __init__(self, dim: int):
        super().__init__()
        self.pe = FourierPE(dim)
        self.type_embed = nn.Parameter(torch.zeros(5, dim))
        self.not_a_point = nn.Parameter(torch.zeros(dim))

    def forward(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        labels = labels.long()
        tok = self.pe(points) + self.type_embed[torch.clamp(labels + 1, 0, 4)]
        return torch.where((labels == PAD)[..., None], self.not_a_point, tok)


class TwoWayBlock(nn.Module):
    """One decoder block: token self-attention, token -> image
    cross-attention, MLP, image -> token cross-attention."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, skip_first_pe: bool = False):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        for name in ("self_attn", "t2i", "i2t"):
            self.add_module(name, MultiHeadAttention(dim, num_heads, dtype=dtype))
        for i in range(1, 5):
            self.add_module(f"norm{i}", layer_norm(dim, dtype))
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, tokens, img, tok_pe, img_pe):
        q = tokens if self.skip_first_pe else tokens + tok_pe
        tokens = self.norm1(tokens + self.self_attn(q))
        tokens = self.norm2(tokens + self.t2i(tokens + tok_pe, kv=img + img_pe))
        tokens = self.norm3(tokens + self.mlp(tokens))
        img = self.norm4(img + self.i2t(img + img_pe, kv=tokens + tok_pe))
        return tokens, img


def conv_transpose_2x(m: nn.ConvTranspose2d, x: torch.Tensor, dtype: torch.dtype):
    """flax ``ConvTranspose(kernel 2, stride 2, dtype)`` on an NHWC tensor:
    input, kernel and bias in ``dtype``, the bias added after the product."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dtype), m.weight.to(dtype), None,
                           stride=m.stride)
    return y.permute(0, 2, 3, 1) + m.bias.to(dtype)


class MaskDecoder(nn.Module):
    """Two-way transformer -> (mask logits (B, K, 4 Hg, 4 Wg) f32, IoU
    predictions (B, K) f32), and with ``return_tokens`` the mask tokens
    (B, K, dim) as well (SAM2 derives its object pointers from them)."""

    def __init__(self, dim: int, num_heads: int = 8, depth: int = 2, num_masks: int = 3,
                 dtype: torch.dtype = torch.float32, return_tokens: bool = False):
        super().__init__()
        self.dim, self.depth, self.num_masks = dim, depth, num_masks
        self.dtype, self.return_tokens = dtype, return_tokens
        self.output_tokens = nn.Parameter(torch.zeros(1 + num_masks, dim))  # [iou, masks]
        for i in range(depth):
            self.add_module(f"block{i}", TwoWayBlock(dim, num_heads, dtype=dtype,
                                                     skip_first_pe=(i == 0)))
        self.final_t2i = MultiHeadAttention(dim, num_heads, dtype=dtype)
        self.final_norm = layer_norm(dim, dtype)
        self.up1 = nn.ConvTranspose2d(dim, dim // 4, 2, stride=2)
        self.up_norm = layer_norm(dim // 4, dtype)
        self.up2 = nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2)
        for i in range(num_masks):
            for j in range(2):
                self.add_module(f"hyper{i}_{j}", Dense(dim, dim, dtype))
            self.add_module(f"hyper{i}_out", Dense(dim, dim // 8, dtype))
        for j in range(2):
            self.add_module(f"iou{j}", Dense(dim, dim, dtype))
        self.iou_out = Dense(dim, num_masks)  # f32

    def forward(self, img: torch.Tensor, img_pe: torch.Tensor, prompts: torch.Tensor,
                grid_hw: tuple[int, int]):
        b, d, dt = img.shape[0], self.dim, self.dtype
        tokens = torch.cat([self.output_tokens[None].expand(b, -1, -1), prompts], dim=1)
        tok_pe = torch.zeros_like(tokens)
        for i in range(self.depth):
            tokens, img = getattr(self, f"block{i}")(tokens, img, tok_pe, img_pe)
        tokens = self.final_norm(tokens + self.final_t2i(tokens, kv=img + img_pe))
        hg, wg = grid_hw
        src = conv_transpose_2x(self.up1, img.reshape(b, hg, wg, d), dt)  # stride 16 -> 8
        src = gelu(self.up_norm(src))
        src = gelu(conv_transpose_2x(self.up2, src, dt))  # (B, 4 Hg, 4 Wg, D / 8)
        iou_tok = tokens[:, 0]
        mask_toks = tokens[:, 1:1 + self.num_masks]
        hyper = []
        for i in range(self.num_masks):
            h = mask_toks[:, i]
            for j in range(2):
                h = F.relu(getattr(self, f"hyper{i}_{j}")(h))
            hyper.append(getattr(self, f"hyper{i}_out")(h))
        hyper = torch.stack(hyper, dim=1)  # (B, K, D / 8)
        masks = torch.einsum("bkc,bhwc->bkhw", hyper.float(), src.float())
        iou = iou_tok
        for j in range(2):
            iou = F.relu(getattr(self, f"iou{j}")(iou))
        iou = self.iou_out(iou)
        if self.return_tokens:
            return masks, iou, mask_toks
        return masks, iou


class SAMImageEncoder(nn.Module):
    """Plain ViT over square images: patch 16, sin-cos positions, the
    ``EncoderBlock`` stack with ``attn_impl``, LayerNorm.
    (B, S, S, 3) -> (B, (S / 16)^2, dim)."""

    def __init__(self, img_size: int = 256, patch: int = 16, dim: int = 256, depth: int = 6,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "einsum"):
        super().__init__()
        self.depth = depth
        self.PatchEmbed_0 = PatchEmbed(dim, (patch, patch), dtype=dtype)
        g = img_size // patch
        self.register_buffer("pos", torch.from_numpy(sincos_2d_pos_embed(dim, g, g)),
                             persistent=False)
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(dim, num_heads, 4.0, attn_impl, 0.0,
                                                      dtype))
        self.norm = layer_norm(dim, dtype)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.PatchEmbed_0(from_uint8(images))
        x = x + self.pos[None].to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, train=train)
        return self.norm(x)


class SAM(nn.Module):
    """Promptable segmentation: encode once, decode a prompt set.

    ``forward(images, points, labels)`` -> (mask logits (B, K, S / 4, S / 4)
    f32, IoU predictions (B, K) f32); coordinates normalized to [0, 1].
    ``encoder_kind`` is ``"vit"`` or ``"tiny"`` (MobileSAM's TinyViT)."""

    def __init__(self, img_size: int = 256, dim: int = 256, enc_depth: int = 6,
                 enc_heads: int = 8, dec_heads: int = 8, num_masks: int = 3,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "einsum",
                 encoder_kind: str = "vit"):
        super().__init__()
        self.img_size, self.dtype = img_size, dtype
        if encoder_kind == "tiny":
            from kuzu_torch.models.tiny_encoder import TinyViTEncoder

            self.encoder = TinyViTEncoder(img_size, dim, dtype=dtype, attn_impl=attn_impl)
        else:
            self.encoder = SAMImageEncoder(img_size, 16, dim, enc_depth, enc_heads, dtype=dtype,
                                           attn_impl=attn_impl)
        self.prompt_encoder = PromptEncoder(dim)
        self.decoder = MaskDecoder(dim, dec_heads, num_masks=num_masks, dtype=dtype)
        g = img_size // 16
        self.register_buffer("img_pe", torch.from_numpy(sincos_2d_pos_embed(dim, g, g))[None],
                             persistent=False)

    def encode(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, S, S, 3) images (uint8, or float in [0, 1]) -> the memory."""
        with dtype_products(self.dtype):
            return self.encoder(images, train=train)

    def decode(self, memory: torch.Tensor, points: torch.Tensor, labels: torch.Tensor):
        """Masks and IoU predictions of prompts over encoded memory."""
        g = self.img_size // 16
        with dtype_products(self.dtype):
            prompts = self.prompt_encoder(points, labels)
            return self.decoder(memory, self.img_pe.to(memory.dtype), prompts, (g, g))

    def forward(self, images, points, labels, train: bool = False):
        return self.decode(self.encode(images, train=train), points, labels)


@torch.no_grad()
def init_sam_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with flax's distributions (``layers.flax_init_``, the
    transposed convolutions' lecun normal over their ``kh kw cin`` fan-in,
    ``gauss`` a standard normal times the scale, the embeddings and output
    tokens normal(0.02)). Returns ``model``."""
    flax_init_(model, generator)
    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):
            conv_transpose_init_(m, generator)
        elif isinstance(m, FourierPE):
            m.gauss.normal_(0.0, 1.0, generator=generator).mul_(m.scale)
        elif isinstance(m, PromptEncoder):
            m.type_embed.normal_(0.0, 0.02, generator=generator)
            m.not_a_point.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, MaskDecoder):
            m.output_tokens.normal_(0.0, 0.02, generator=generator)
    return model


def box_to_prompt(box_xyxy: np.ndarray, img_size: int) -> tuple[np.ndarray, np.ndarray]:
    """A box prompt as two labelled corner points (normalized)."""
    b = np.asarray(box_xyxy, np.float32) / img_size
    pts = np.stack([b[..., [0, 1]], b[..., [2, 3]]], axis=-2)
    lbl = np.broadcast_to(np.array([BOX_TL, BOX_BR], np.int32), pts.shape[:-1]).copy()
    return pts, lbl
