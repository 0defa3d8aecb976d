"""StackGAN-v2-style multi-stage conditional GAN with balanced consistency
regularization (counterpart of ``kuzu/models/stackgan.py``): a generator
whose stages share one trunk and emit 32, 64 and 128 px glyphs, one
projection-conditional discriminator a stage, hinge losses, and bCR (the
discriminator's logits held invariant to one shift and flip applied to
real and fake batches alike).

Images are NHWC at the interface, as JAX's; the layers compute NCHW.
Module and parameter names are the flax tree's, flax's automatic ones
included (``s{stage}_up{i}/Conv_0``, ``GroupNorm_0``, the
discriminators' ``Conv_{i}``). As flax computes them: ``'SAME'`` padding
(``tiny_encoder.same_pad``; 1 on each side for the 3 x 3 convolutions and
for the 4 x 4 stride-2 ones over even sizes), ``GroupNorm`` eps 1e-6 with
the fast variance, the generator's ``fc`` reshaped to (B, 4, 4, ch) in
NHWC order, and ``multiscale_targets`` resizing with an antialiased
bilinear filter (``jax.image.resize`` antialiases when it downsamples).

The random draws (z, and each stage's shift and flip) come in as arguments
or from a ``torch.Generator`` on the CPU (:func:`gan_draws`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.core.train import Optimizer, global_norm
from kuzu_torch.models.layers import Dense, Embed, dtype_products, leaky_relu
from kuzu_torch.models.tiny_encoder import same_pad
from kuzu_torch.models.unet_transformer import GroupNorm
from kuzu_torch.ops.conv import conv2d

STAGE_SIZES = (32, 64, 128)


def conv_same(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(..., padding="SAME", dtype)`` on NCHW: input and kernel
    in ``dtype``, the bias added in ``dtype`` after the product."""
    (kh, kw), (sh, sw) = m.kernel_size, m.stride
    (t, b), (lft, r) = same_pad(x.shape[2], kh, sh), same_pad(x.shape[3], kw, sw)
    x = x.to(dtype)
    if (t, lft) == (b, r):
        y = conv2d(x, m.weight.to(dtype), None, m.stride, (t, lft))
    else:
        y = conv2d(F.pad(x, (lft, r, t, b)), m.weight.to(dtype), None, m.stride)
    return y + m.bias.to(dtype)[:, None, None]


class _GBlock(nn.Module):
    """Nearest 2x, a 3 x 3 convolution, GroupNorm (``min(8, ch)`` groups),
    leaky ReLU 0.2."""

    def __init__(self, cin: int, ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(cin, ch, 3)
        self.GroupNorm_0 = GroupNorm(min(8, ch), ch, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return leaky_relu(self.GroupNorm_0(conv_same(self.Conv_0, x, self.dtype)), 0.2)


class StackGenerator(nn.Module):
    """z (B, latent) and classes (B,) -> [(B, 32, 32, C), (B, 64, 64, C),
    (B, 128, 128, C)] in [-1, 1]."""

    def __init__(self, num_classes: int, latent_dim: int = 100, base_ch: int = 256,
                 channels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_dim, self.base_ch, self.dtype = latent_dim, base_ch, dtype
        self.cls_embed = Embed(num_classes, 64, dtype)
        self.fc = Dense(latent_dim + 64, 4 * 4 * base_ch, dtype)
        self.ups = (3, 1, 1)  # 4 -> 32, 32 -> 64, 64 -> 128
        ch = base_ch
        for stage, n_up in enumerate(self.ups):
            for i in range(n_up):
                cin, ch = ch, max(ch // 2, 32)
                self.add_module(f"s{stage}_up{i}", _GBlock(cin, ch, dtype))
            self.add_module(f"s{stage}_rgb", nn.Conv2d(ch, channels, 3))  # f32

    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> list[torch.Tensor]:
        with dtype_products(self.dtype):
            c = self.cls_embed(labels.long())
            h = self.fc(torch.cat([z.to(c.dtype), c], dim=-1))
            x = leaky_relu(h.reshape(-1, 4, 4, self.base_ch), 0.2).permute(0, 3, 1, 2)
            outs = []
            for stage, n_up in enumerate(self.ups):
                for i in range(n_up):
                    x = getattr(self, f"s{stage}_up{i}")(x)
                rgb = conv_same(getattr(self, f"s{stage}_rgb"), x, torch.float32)
                outs.append(torch.tanh(rgb).permute(0, 2, 3, 1))
        return outs


class StageDiscriminator(nn.Module):
    """Projection-conditional discriminator for ``img_size`` px: 4 x 4
    stride-2 convolutions down to 4 px, the spatial mean, a linear head
    plus the class embedding's dot product with the features.
    (B, S, S, C), (B,) -> (B,) f32 logits."""

    def __init__(self, num_classes: int, img_size: int, channels: int = 1, base_ch: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_conv = 0
        cin, ch, s = channels, base_ch, img_size
        while s > 4:
            self.add_module(f"Conv_{self.n_conv}", nn.Conv2d(cin, ch, 4, stride=2))
            self.n_conv += 1
            cin, ch, s = ch, min(ch * 2, 512), -(-s // 2)
        self.head = Dense(cin, 1)  # f32
        self.proj = Embed(num_classes, cin, dtype)

    def forward(self, img: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with dtype_products(self.dtype):
            x = img.permute(0, 3, 1, 2)
            for i in range(self.n_conv):
                x = leaky_relu(conv_same(getattr(self, f"Conv_{i}"), x, self.dtype), 0.2)
            feat = x.mean(dim=(2, 3))
            out = self.head(feat)[:, 0]
            return out + (feat * self.proj(labels.long())).sum(-1).float()


def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return F.relu(1.0 - real_logits).mean() + F.relu(1.0 + fake_logits).mean()


def hinge_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return -fake_logits.mean()


def bcr_augment(imgs: torch.Tensor, shift: tuple[int, int], flip: bool) -> torch.Tensor:
    """bCR's augmentation of NHWC images: rolled by ``shift`` (dy, dx) and,
    with ``flip``, mirrored left to right."""
    out = torch.roll(imgs, tuple(int(s) for s in shift), dims=(1, 2))
    return out.flip(2) if flip else out


def bcr_draw(generator: torch.Generator, max_shift: int = 4) -> tuple[tuple[int, int], bool]:
    """One (shift (dy, dx), flip) of :func:`bcr_augment` from a CPU generator."""
    d = torch.randint(-max_shift, max_shift + 1, (2,), generator=generator).tolist()
    return (d[0], d[1]), bool(torch.rand((), generator=generator) < 0.5)


def bcr_loss(disc: nn.Module, imgs: torch.Tensor, labels: torch.Tensor,
             aug: tuple[tuple[int, int], bool], weight: float = 10.0) -> torch.Tensor:
    """Balanced consistency: ``weight * mean((D(x) - D(aug(x)))^2)``."""
    logits = disc(imgs, labels)
    return weight * ((logits - disc(bcr_augment(imgs, *aug), labels)) ** 2).mean()


def multiscale_targets(imgs: torch.Tensor) -> list[torch.Tensor]:
    """A full-resolution NHWC batch in [-1, 1] -> the stages' targets at
    32, 64 and 128 px (bilinear, antialiased where it downsamples)."""
    x = imgs.permute(0, 3, 1, 2).float()
    return [F.interpolate(x, size=(s, s), mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1) for s in STAGE_SIZES]


def gan_draws(generator: torch.Generator, batch: int, latent_dim: int, stages: int = 0,
              max_shift: int = 4) -> dict:
    """The draws of one step from a CPU generator: ``z`` (batch, latent)
    and, for a discriminator step, one bCR ``aug`` a stage."""
    z = torch.randn((batch, latent_dim), generator=generator)
    return {"z": z, "aug": [bcr_draw(generator, max_shift) for _ in range(stages)]}


def _apply(opt: Optimizer, params: list[torch.Tensor], grads, count: int) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    norm = global_norm(list(grads)) if opt.grad_clip > 0 else torch.zeros(())
    opt.step(count, norm)
    opt.zero_grad()


def make_gan_steps(gen: StackGenerator, discs: Sequence[StageDiscriminator], g_opt: Optimizer,
                   d_opts: Sequence[Optimizer], bcr_weight: float = 10.0):
    """Alternating steps over every stage: ``d_step(batch, draws)`` (each
    discriminator on its own optimizer: hinge loss plus bCR on the real
    and the fake batch with that stage's one augmentation) and
    ``g_step(batch, z)`` (the mean hinge loss of the discriminators on the
    fakes). ``batch`` holds ``image`` (B, 128, 128, C) in [-1, 1] and
    ``label`` (B,); ``draws`` is :func:`gan_draws`' dict. Each returns the
    step's loss (the stages' mean for ``d_step``); ``count`` is the
    optimizers' step for their schedules."""
    d_params = [[p for p in d.parameters()] for d in discs]
    g_params = list(gen.parameters())

    def d_step(batch: dict, draws: dict, count: int = 0) -> torch.Tensor:
        labels = batch["label"]
        with torch.no_grad():
            fakes = gen(draws["z"].to(labels.device), labels)
        reals = multiscale_targets(batch["image"])
        losses = []
        for i, disc in enumerate(discs):
            loss = hinge_d_loss(disc(reals[i], labels), disc(fakes[i], labels))
            loss = loss + bcr_loss(disc, reals[i], labels, draws["aug"][i], bcr_weight)
            loss = loss + bcr_loss(disc, fakes[i], labels, draws["aug"][i], bcr_weight)
            _apply(d_opts[i], d_params[i], torch.autograd.grad(loss, d_params[i]), count)
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def g_step(batch: dict, z: torch.Tensor, count: int = 0) -> torch.Tensor:
        labels = batch["label"]
        fakes = gen(z.to(labels.device), labels)
        loss = sum(hinge_g_loss(d(f, labels)) for d, f in zip(discs, fakes)) / len(discs)
        _apply(g_opt, g_params, torch.autograd.grad(loss, g_params), count)
        return loss.detach()

    return d_step, g_step
