"""SimpleViT single-glyph classifier (counterpart of
``kuzu/models/simple_vit.py``): patch embedding, 2-D sin-cos positions, a
transformer encoder stack (einsum attention, as JAX's), LayerNorm, the mean
over tokens and an f32 Dense head. The classify task's default model.

``dtype`` has flax's meaning (``models/layers.py``); an f32 forward runs
with TF32 off (``f32_products``).
"""

from __future__ import annotations

import torch
from torch import nn

from kuzu_torch.models.layers import (
    Dense,
    EncoderBlock,
    PatchEmbed,
    dtype_products,
    layer_norm,
    sincos_2d_pos_embed,
)
from kuzu_torch.ops.images import from_uint8


class SimpleViT(nn.Module):
    """(B, H, W, C) images (uint8, or float in [0, 1]) -> (B, num_classes)
    f32 logits. ``channels`` is the images' C (flax reads it off the init
    input)."""

    def __init__(self, num_classes: int, image_size=(128, 128), patch_size=(16, 16),
                 dim: int = 256, depth: int = 6, num_heads: int = 8, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, channels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size, self.patch_size = tuple(image_size), tuple(patch_size)
        self.depth, self.dtype = depth, dtype
        self.PatchEmbed_0 = PatchEmbed(dim, patch_size, cin=channels, dtype=dtype)
        gh, gw = image_size[0] // patch_size[0], image_size[1] // patch_size[1]
        self.register_buffer("pos", torch.from_numpy(sincos_2d_pos_embed(dim, gh, gw)),
                             persistent=False)
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(dim, num_heads, mlp_ratio,
                                                      dropout=dropout, dtype=dtype))
        self.norm = layer_norm(dim, dtype)
        self.head = Dense(dim, num_classes)  # f32, as the reference's

    def forward(self, images: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        with dtype_products(self.dtype):
            x = self.PatchEmbed_0(from_uint8(images))
            x = x + self.pos[None].to(x.dtype)
            for i in range(self.depth):
                x = getattr(self, f"block{i}")(x, train=train, rng=rng)
            return self.head(self.norm(x).mean(dim=1))
