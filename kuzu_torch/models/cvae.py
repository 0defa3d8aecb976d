"""Conditional VAE for single-glyph generation and reconstruction
(counterpart of ``kuzu/models/cvae.py``): a strided convolutional encoder
to a latent (mu, logvar) with one-hot class conditioning, a transposed-
convolution decoder conditioned the same way, BCE + beta KL loss,
reparameterized sampling.

Images are NHWC at the interface, as JAX's; the layers compute NCHW.
flax's layouts, as they bear on the port:

- the encoder's flatten of its (B, 4, 4, 512) map and the decoder's
  reshape of ``fc`` to (B, 4, 4, 512) are in NHWC order, so the port
  permutes to NHWC before the flatten and from it after the reshape (the
  ``fc_mu`` / ``fc_var`` / ``fc`` weights line up with flax's);
- the decoder's ``ConvTranspose((4, 4), strides=(2, 2), padding="SAME")``
  is ``conv_transpose2d(stride=2, padding=1)`` with the spatially flipped
  kernel, which the bridge's ``conv_transpose`` layout gives.

The reparameterization noise comes in as ``noise`` or is drawn from the
``generator`` passed in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.models.layers import (
    Dense,
    conv_transpose_init_,
    dtype_products,
    flax_init_,
    leaky_relu,
)
from kuzu_torch.ops.conv import conv2d
from kuzu_torch.ops.losses import sigmoid_binary_cross_entropy

ENC_CH = (32, 64, 128, 256, 512)
DEC_CH = (256, 128, 64, 32)


def conv_transpose_same(m: nn.ConvTranspose2d, x: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """flax ``ConvTranspose(kernel 4, stride 2, padding "SAME", dtype)`` on
    NCHW: input and (bridge-flipped) kernel in ``dtype``, the bias added in
    ``dtype`` after the product; doubles H and W."""
    y = F.conv_transpose2d(x.to(dtype), m.weight.to(dtype), None, stride=2, padding=1)
    return y + m.bias.to(dtype)[:, None, None]


def _one_hot(labels: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return F.one_hot(labels.long(), n).to(dtype)


class ConvVAEEncoder(nn.Module):
    """(B, 128, 128, C), (B,) -> (mu, logvar), each (B, latent) f32."""

    def __init__(self, latent_dim: int, num_classes: int, channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        cin = channels
        for i, ch in enumerate(ENC_CH):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 4, stride=2, padding=1))
            cin = ch
        self.fc_mu = Dense(4 * 4 * 512 + num_classes, latent_dim)  # f32
        self.fc_var = Dense(4 * 4 * 512 + num_classes, latent_dim)  # f32

    def forward(self, x: torch.Tensor, labels: torch.Tensor):
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)
        for i in range(len(ENC_CH)):
            c = getattr(self, f"conv{i}")
            y = conv2d(x.to(dt), c.weight.to(dt), None, 2, 1) + c.bias.to(dt)[:, None, None]
            x = leaky_relu(y, 0.2)
        h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC flatten
        hc = torch.cat([h, _one_hot(labels, self.num_classes, h.dtype)], dim=-1)
        return self.fc_mu(hc), self.fc_var(hc)


class ConvVAEDecoder(nn.Module):
    """(B, latent), (B,) -> (B, 128, 128, C) logits f32."""

    def __init__(self, latent_dim: int, num_classes: int, out_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.fc = Dense(latent_dim + num_classes, 4 * 4 * 512, dtype)
        cin = 512
        for i, ch in enumerate(DEC_CH):
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(cin, ch, 4, stride=2, padding=1))
            cin = ch
        self.out = nn.ConvTranspose2d(cin, out_channels, 4, stride=2, padding=1)

    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        h = self.fc(torch.cat([z, _one_hot(labels, self.num_classes, z.dtype)], dim=-1))
        x = h.reshape(-1, 4, 4, 512).permute(0, 3, 1, 2)  # flax's NHWC reshape
        for i in range(len(DEC_CH)):
            x = F.relu(conv_transpose_same(getattr(self, f"deconv{i}"), x, self.dtype))
        return conv_transpose_same(self.out, x, torch.float32).permute(0, 2, 3, 1)


class CVAE(nn.Module):
    """``forward(images, labels, noise=None, generator=None)`` -> (recon
    logits (B, 128, 128, C), mu, logvar); ``generate(z, labels)`` -> images
    in [0, 1]."""

    def __init__(self, num_classes: int, latent_dim: int = 100, channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ConvVAEEncoder(latent_dim, num_classes, channels, dtype)
        self.decoder = ConvVAEDecoder(latent_dim, num_classes, channels, dtype)

    def forward(self, images: torch.Tensor, labels: torch.Tensor,
                noise: torch.Tensor | None = None, generator: torch.Generator | None = None):
        with dtype_products(self.dtype):
            mu, logvar = self.encoder(images, labels)
            if noise is None:  # drawn where the generator lives, else beside mu
                noise = torch.randn(mu.shape, generator=generator,
                                    device=generator.device if generator else mu.device)
            z = mu + torch.exp(0.5 * logvar) * noise.to(mu.device)
            return self.decoder(z, labels), mu, logvar

    def generate(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with dtype_products(self.dtype):
            return torch.sigmoid(self.decoder(z, labels))


def cvae_loss(recon_logits: torch.Tensor, images: torch.Tensor, mu: torch.Tensor,
              logvar: torch.Tensor, beta: float = 1.0) -> tuple[torch.Tensor, dict]:
    """BCE reconstruction (summed over pixels) + beta * KL, batch mean."""
    bce = sigmoid_binary_cross_entropy(recon_logits, images).sum(dim=(1, 2, 3))
    kl = -0.5 * (1 + logvar - mu**2 - torch.exp(logvar)).sum(dim=-1)
    return (bce + beta * kl).mean(), {"bce": bce.mean(), "kl": kl.mean()}


@torch.no_grad()
def init_cvae_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with flax's distributions (``layers.flax_init_``, the
    transposed convolutions' lecun normal over their ``kh kw cin``
    fan-in). Returns ``model``."""
    flax_init_(model, generator)
    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):
            conv_transpose_init_(m, generator)
    return model
