"""TrOCR-style recognizer: non-square ViT encoder + autoregressive
transformer decoder (counterpart of ``kuzu/models/trocr.py``).

f32 as ``RecognizePredictor`` builds it, or ``dtype`` (bf16) as the
recognize trainer builds it from ``cfg.dtype``, with flax's meaning
(``models/layers.py``); every f32 product with TF32 off
(``layers.f32_products``). The encoder's self-attention takes K3
(:func:`kuzu_torch.ops.flash_attention.area_attention`) on the card, in the
compute dtype, where the reference's gate holds (``attn_impl="auto"``); in
training K3 with its row statistics and K4 as one autograd pair
(``area_attention_trainable``).

Generation is a Python loop over steps with a KV cache, and stops when
every row is done: the reference's ``lax.while_loop`` exit, the same
output. Each step's "all done" test reads one flag from the device.

One departure in where work happens, not in what is computed: the
reference re-runs ``memory_proj`` and every cross-attention's K/V Dense on
the fixed encoder memory at each decode step; here they run once per
generate call (:meth:`ARDecoder.start`), the same arithmetic on the same
input. A beam's hypotheses share their row's memory keys and values
instead of K copies of them. Nothing else of the loop's arithmetic
changes.

The ``unet`` and ``csa`` encoders (``models/unet_transformer.py``,
``models/csa_vit.py``) run the einsum attention, as JAX's: the reference
routes them to no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn
from torch.profiler import record_function

from kuzu_torch.models.csa_vit import CSAViTEncoder
from kuzu_torch.models.layers import (
    NEG,
    DecoderBlock,
    Dense,
    Embed,
    EncoderBlock,
    PatchEmbed,
    causal_mask,
    f32_products,
    layer_norm,
    sincos_2d_pos_embed,
)
from kuzu_torch.models.unet_transformer import UNetTransformerEncoder
from kuzu_torch.ops.images import from_uint8


class ViTEncoder(nn.Module):
    """Non-square ViT encoder (default 1024x64 / patch 16 -> 64x4 grid)."""

    def __init__(self, image_size=(1024, 64), patch_size=(16, 16), dim: int = 384,
                 depth: int = 6, num_heads: int = 6, mlp_ratio: float = 4.0,
                 attn_impl: str = "einsum", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.PatchEmbed_0 = PatchEmbed(dim, patch_size, dtype=dtype)
        gh, gw = image_size[0] // patch_size[0], image_size[1] // patch_size[1]
        self.register_buffer("pos", torch.from_numpy(sincos_2d_pos_embed(dim, gh, gw)),
                             persistent=False)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(dim, num_heads, mlp_ratio, attn_impl,
                                                      dropout, dtype))
        self.norm = layer_norm(dim, dtype)

    def forward(self, images: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = self.PatchEmbed_0(images)
        x = x + self.pos[None].to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, train=train, rng=rng)
        return self.norm(x)


@dataclass
class DecodeState:
    """What the cached decode steps carry: per block the self-attention KV
    cache (``{"k": (B, h, hd, max_len), "v": (B, h, max_len, hd)}``, zeros
    past the step) and the cross-attention's keys and values of the memory
    (``MultiHeadAttention.kv_heads``, batch B' = B / the hypotheses per
    row)."""

    cache: list[dict]
    memory_kv: list[tuple[torch.Tensor, torch.Tensor]] = field(default_factory=list)

    def reorder(self, rows: torch.Tensor) -> None:
        """Each row of the caches taken from row ``rows[i]`` (beams
        reordered within their batch row; the memory is shared)."""
        for c in self.cache:
            c["k"], c["v"] = c["k"][rows], c["v"][rows]


class ARDecoder(nn.Module):
    """Causal transformer decoder with cross-attention and a KV cache."""

    def __init__(self, vocab_size: int, max_len: int = 128, dim: int = 256, depth: int = 4,
                 num_heads: int = 8, mlp_ratio: float = 4.0, enc_dim: int = 384,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_len, self.depth, self.num_heads = max_len, depth, num_heads
        self.embed = Embed(vocab_size, dim, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, dim))
        self.memory_proj = Dense(enc_dim, dim, dtype)
        for i in range(depth):
            self.add_module(f"block{i}", DecoderBlock(dim, num_heads, mlp_ratio, dropout, dtype))
        self.norm = layer_norm(dim, dtype)
        self.lm_head = Dense(dim, vocab_size)  # f32, as the reference's

    def _blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def forward(self, tokens: torch.Tensor, memory: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced logits (B, T, V) for tokens (B, T) over the memory."""
        t = tokens.shape[1]
        x = self.embed(tokens)
        x = x + self.pos_embed[None, :t].to(x.dtype)
        mem = self.memory_proj(memory)
        mask = causal_mask(t, tokens.device)
        for blk in self._blocks():
            x = blk(x, mem, self_mask=mask, train=train, rng=rng)
        return self.lm_head(self.norm(x))

    def start(self, memory: torch.Tensor, batch: int) -> DecodeState:
        """An empty cache for ``batch`` rows (a multiple of the memory's)
        and the cross-attention keys and values of ``memory``."""
        mem = self.memory_proj(memory)
        h = self.num_heads
        hd = self.pos_embed.shape[1] // h
        cache = [{"k": mem.new_zeros((batch, h, hd, self.max_len)),
                  "v": mem.new_zeros((batch, h, self.max_len, hd))} for _ in self._blocks()]
        return DecodeState(cache, [blk.cross_attn.kv_heads(mem) for blk in self._blocks()])

    def step(self, tokens: torch.Tensor, step: int, state: DecodeState) -> torch.Tensor:
        """One cached decode step: tokens (B, 1) at position ``step`` ->
        logits (B, 1, V); the cache gains this step's keys and values."""
        x = self.embed(tokens)
        x = x + self.pos_embed[step][None, None].to(x.dtype)
        for blk, cache, mkv in zip(self._blocks(), state.cache, state.memory_kv):
            x = blk(x, cache=cache, step=step, memory_kv=mkv)
        return self.lm_head(self.norm(x))


class TrOCR(nn.Module):
    """Encoder + decoder; with ``ctc_head`` the auxiliary CTC projection
    over the encoder memory that checkpoints trained with ``ctc_weight > 0``
    carry (f32, as the reference's). ``encoder_type`` is ``"vit"`` (the
    kernel route of ``attn_impl``), ``"unet"`` (``UNetTransformerEncoder``)
    or ``"csa"`` (``CSAViTEncoder``, its default structure and context
    layers); the last two take JAX's einsum attention."""

    def __init__(self, vocab_size: int, image_size=(1024, 64), patch_size=(16, 16),
                 enc_dim: int = 384, enc_depth: int = 6, enc_heads: int = 6,
                 dec_dim: int = 256, dec_depth: int = 4, dec_heads: int = 8,
                 max_len: int = 128, encoder_type: str = "vit", ctc_head: bool = False,
                 attn_impl: str = "auto", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size, self.patch_size = tuple(image_size), tuple(patch_size)
        self.max_len, self.dec_dim = max_len, dec_dim
        if encoder_type == "unet":
            self.encoder = UNetTransformerEncoder(image_size, out_dim=enc_dim, depth=enc_depth,
                                                  num_heads=enc_heads, dropout=dropout,
                                                  dtype=dtype)
        elif encoder_type == "csa":
            self.encoder = CSAViTEncoder(image_size, patch_size, enc_dim, enc_depth, enc_heads,
                                         dropout=dropout, dtype=dtype)
        else:  # "vit", and any other name, as JAX's
            self.encoder = ViTEncoder(image_size, patch_size, enc_dim, enc_depth, enc_heads,
                                      attn_impl=attn_impl, dropout=dropout, dtype=dtype)
        self.decoder = ARDecoder(vocab_size, max_len, dec_dim, dec_depth, dec_heads,
                                 enc_dim=enc_dim, dropout=dropout, dtype=dtype)
        self.ctc_proj = Dense(enc_dim, vocab_size) if ctc_head else None

    @staticmethod
    def _norm(images: torch.Tensor) -> torch.Tensor:
        """uint8 pixels -> (x/255 - 0.5)/0.5, the TrOCR input convention;
        float input passes through."""
        return from_uint8(images, mean=0.5, std=0.5)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced logits (B, T, V) for input tokens."""
        return self.decode_tokens(tokens, self.encode_train(images, train, rng), train, rng)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> memory (B, gh * gw, enc_dim), deterministic."""
        return self.encode_train(images, train=False)

    def encode_train(self, images: torch.Tensor, train: bool = True,
                     rng: torch.Generator | None = None) -> torch.Tensor:
        """The encoder with dropout active (``train``, drawing from
        ``rng``): the trainer encodes once and runs the decoder twice
        (scheduled sampling)."""
        with f32_products():
            return self.encoder(self._norm(images), train, rng)

    def decode_tokens(self, tokens: torch.Tensor, memory: torch.Tensor, train: bool = True,
                      rng: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced decoder logits over a precomputed memory; dropout
        active with ``train`` (the reference's default), drawing from
        ``rng``."""
        with f32_products():
            return self.decoder(tokens, memory, train, rng)

    def ctc_logits(self, memory: torch.Tensor) -> torch.Tensor:
        """Auxiliary CTC logits (B, gh, V): the patch-grid memory averaged
        over the width axis (time = the vertical reading order), then
        projected. Only with ``ctc_head``."""
        gh = self.image_size[0] // self.patch_size[0]
        gw = self.image_size[1] // self.patch_size[1]
        with f32_products():
            return self.ctc_proj(memory.reshape(memory.shape[0], gh, gw, -1).mean(2))

    def start_decode(self, memory: torch.Tensor, batch: int | None = None) -> DecodeState:
        with f32_products():
            return self.decoder.start(memory, memory.shape[0] if batch is None else batch)

    def decode_step(self, tokens: torch.Tensor, state: DecodeState, step: int) -> torch.Tensor:
        """One cached decode step: tokens (B, 1) -> logits (B, 1, V)."""
        with f32_products():
            return self.decoder.step(tokens, step, state)


def graft_lm_decoder(decoder_sd: dict[str, torch.Tensor],
                     lm_sd: dict[str, torch.Tensor]) -> tuple[dict, int, int]:
    """The AR decoder initialised from a pretrained ``CharMLM``'s state
    dict, as ``kuzu/models/trocr.py::graft_lm_decoder``: the LM's
    transferable submodules renamed into the decoder's namespace and
    grafted by name and shape (:func:`kuzu_torch.core.checkpoint.
    partial_load`)::

        CharMLM           ARDecoder
        embed             embed
        block{i}.norm1    block{i}.norm1
        block{i}.attn     block{i}.self_attn
        block{i}.norm2    block{i}.norm3  (the pre-MLP norm)
        block{i}.mlp      block{i}.mlp
        norm, lm_head     norm, lm_head

    pos_embed, memory_proj, the cross-attention and its norm2 keep their
    fresh values. Returns ``(state dict, n_loaded, n_decoder_total)``."""
    from kuzu_torch.core.checkpoint import partial_load

    renamed = {}
    for key, value in lm_sd.items():
        top, _, rest = key.partition(".")
        if top.startswith("block"):
            sub, _, leaf = rest.partition(".")
            sub = {"norm1": "norm1", "attn": "self_attn", "norm2": "norm3",
                   "mlp": "mlp"}.get(sub)
            if sub is not None:
                renamed[f"{top}.{sub}.{leaf}"] = value
        elif top in ("embed", "norm", "lm_head"):
            renamed[key] = value
    return partial_load(decoder_sd, renamed)


# ------------------------------------------------------------- generation


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, the lower index first
    among equal values, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among ties; beam search meets exact ties where dead
    beams sit at -1e30)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def greedy_generate(model: TrOCR, images: torch.Tensor, max_len: int = 128, bos_id: int = 2,
                    eos_id: int = 3) -> torch.Tensor:
    """Batched greedy decoding. Returns (B, max_len) int32 tokens, 0 after
    a row's EOS. Stops when every row has emitted EOS; the steps taken are
    in ``greedy_generate.steps``."""
    with record_function("trocr/encode"):
        memory = model.encode(images)
    b = images.shape[0]
    dev = memory.device
    with record_function("trocr/decode"):
        state = model.start_decode(memory)
        tok = torch.full((b, 1), bos_id, dtype=torch.long, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        out = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
        step = 0
        while step < max_len and not bool(done.all()):
            logits = model.decode_step(tok, state, step)
            nxt = logits[:, -1].argmax(-1)
            nxt = torch.where(done, 0, nxt)
            done = done | (nxt == eos_id)
            out[:, step] = nxt.to(torch.int32)
            tok = nxt[:, None]
            step += 1
    greedy_generate.steps = step
    return out


greedy_generate.steps = 0


@torch.no_grad()
def beam_generate(model: TrOCR, images: torch.Tensor, max_len: int = 128, bos_id: int = 2,
                  eos_id: int = 3, num_beams: int = 4, length_penalty: float = 1.0,
                  return_nbest: bool = False):
    """Batched beam search, beams folded into the batch ((B*K, ...)): the
    KV cache is gathered when beams reorder. Returns the best sequences
    (B, max_len), or with ``return_nbest`` every hypothesis ((B, K,
    max_len) tokens) and its length-normalised score ((B, K) f32) for
    external rescoring. The steps taken are in ``beam_generate.steps``."""
    b, k = images.shape[0], num_beams
    with record_function("trocr/encode"):
        memory = model.encode(images)
    dev = memory.device
    with record_function("trocr/decode"):
        state = model.start_decode(memory, b * k)
        scores = torch.full((b, k), NEG, dtype=torch.float32, device=dev)  # dead beams
        scores[:, 0] = 0.0  # beam 0 alive, the others dead: first candidates differ
        tokens = torch.zeros((b, k, max_len), dtype=torch.int32, device=dev)
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        tok = torch.full((b * k, 1), bos_id, dtype=torch.long, device=dev)
        base = torch.arange(b, device=dev)[:, None] * k
        step = 0
        while step < max_len and not bool(done.all()):
            logits = model.decode_step(tok, state, step)
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            v = logp.shape[-1]
            logp = logp.reshape(b, k, v)
            # finished beams: only PAD, at zero cost, so their score freezes
            pad_only = torch.full((v,), NEG, dtype=torch.float32, device=dev)
            pad_only[0] = 0.0
            logp = torch.where(done[..., None], pad_only, logp)
            cand = (scores[..., None] + logp).reshape(b, k * v)
            scores, flat = top_k_stable(cand, k)
            beam_idx, tok_idx = flat // v, (flat % v).to(torch.int32)
            state.reorder((beam_idx + base).reshape(-1))
            tokens = torch.take_along_dim(tokens, beam_idx[..., None], dim=1)
            done = torch.take_along_dim(done, beam_idx, dim=1)
            tokens[:, :, step] = torch.where(done, 0, tok_idx)
            done = done | (tok_idx == eos_id)
            tok = torch.where(done, 0, tok_idx).reshape(b * k, 1).long()
            step += 1
    beam_generate.steps = step
    lengths = (tokens != 0).sum(-1).float()
    norm = scores / lengths.clamp(min=1.0) ** length_penalty
    if return_nbest:
        return tokens, norm
    best = norm.argmax(-1)
    return torch.take_along_dim(tokens, best[:, None, None], dim=1)[:, 0]


beam_generate.steps = 0


def generate(model: TrOCR, images: torch.Tensor, max_len: int = 128, bos_id: int = 2,
             eos_id: int = 3, decode: str = "greedy", num_beams: int = 4,
             length_penalty: float = 1.0) -> torch.Tensor:
    """``decode='beam'`` runs beam search, anything else greedy."""
    if decode == "beam" and num_beams > 1:
        return beam_generate(model, images, max_len=max_len, bos_id=bos_id, eos_id=eos_id,
                             num_beams=num_beams, length_penalty=length_penalty)
    return greedy_generate(model, images, max_len=max_len, bos_id=bos_id, eos_id=eos_id)
