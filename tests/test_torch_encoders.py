"""The TrOCR's ``unet`` and ``csa`` encoders, ``CSAViT`` and ``SimpleViT``
in the port against the JAX package on the CPU, f32, at narrow widths.

- ``TrOCR(encoder_type="unet" | "csa")`` at ``TROCR_KW``'s widths (2
  encoder layers; csa: the structure module on layer 0, the context module
  on layer 1): the port's seeded weights handed to flax, the decoder
  scaled as ``jax_trocr_variables`` scales JAX's (tokens that depend on
  the crop), crops of dark blocks on a light page; the encoder memory
  within 1e-5 of its largest entry (unet: 1e-4, flax's GroupNorm takes the
  fast variance, which cancels over flat regions in either package), the
  greedy tokens (and the texts) identical and not the same for every crop;
- ``CSAViT`` with the ``graph`` structure module (3 layers: structure on
  0 and 2, context on 1): the ``ctc`` head's logits and the ``ar`` head's
  teacher-forced logits within 1e-5 of their largest entry, the CTC
  greedy paths identical; ``grad_checkpoint`` leaves the values and the
  gradients as they are (dropout on, its masks replayed);
- ``SimpleViT`` (2 blocks, dim 64, 32 px, one channel): logits within 1e-5
  of the largest, top-1 identical; one f32 classify loss on SimpleViT
  with dropout off against JAX's (1e-5), and the task's default model
  through ``Model(..., task="classify")``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TROCR_KW, flax_variables

REL = 1e-5  # of the largest value of the compared tensor
B = 6


def _close(got, want, rel=REL) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _decoder_margins(variables: dict) -> dict:
    """``jax_trocr_variables``' scaling of a seeded decoder: lm_head x10,
    pos_embed x5, memory_proj x10, EOS's lm_head column a copy of token
    18's with its bias 0.5 above."""
    dec = variables["params"]["decoder"]
    dec["pos_embed"] = dec["pos_embed"] * 5
    dec["memory_proj"]["kernel"] = dec["memory_proj"]["kernel"] * 10
    kernel, bias = dec["lm_head"]["kernel"] * 10, dec["lm_head"]["bias"].copy()
    kernel[:, 3], bias[3] = kernel[:, 18], bias[18] + 0.5
    dec["lm_head"]["kernel"], dec["lm_head"]["bias"] = kernel, bias
    return variables


def _crops(n: int, seed: int = 0) -> np.ndarray:
    """(n, 128, 32, 3) uint8 crops: a light page with 2-5 dark blocks of
    random place, size and colour (uniform noise would average out in the
    16 x 16 patches, and every crop decode alike)."""
    rng = np.random.default_rng(seed)
    out = np.full((n, 128, 32, 3), 235, np.uint8)
    for i in range(n):
        for _ in range(rng.integers(2, 6)):
            y, h = rng.integers(0, 112), rng.integers(6, 40)
            x, w = rng.integers(0, 20), rng.integers(6, 24)
            out[i, y:y + h, x:x + w] = rng.integers(0, 90, 3)
    return out


@pytest.mark.parametrize("encoder", ["unet", "csa"])
def test_trocr_encoder_memory_and_greedy_texts_match(encoder):
    from kuzu.models.trocr import TrOCR as JaxTrOCR
    from kuzu.models.trocr import greedy_generate as jax_greedy

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.layers import flax_init_
    from kuzu_torch.models.trocr import TrOCR, greedy_generate

    port = flax_init_(TrOCR(**TROCR_KW, encoder_type=encoder),
                      torch.Generator().manual_seed(0))
    variables = _decoder_margins(flax_variables(port))
    from_flax(port, variables).eval()
    images = _crops(B)
    jm = JaxTrOCR(**TROCR_KW, encoder_type=encoder)
    jimg = jnp.asarray(images)
    jmem = jax.jit(lambda v, x: jm.apply(v, x, method=JaxTrOCR.encode))(variables, jimg)
    jtok = np.asarray(jax_greedy(jm, variables["params"], jimg, max_len=16))
    with torch.no_grad():
        mem = port.encode(torch.from_numpy(images))
    assert mem.shape == jmem.shape == (B, 64 if encoder == "unet" else 16, 64)
    # unet: flax's GroupNorm takes the fast variance E[x^2] - E[x]^2, which
    # cancels over the crops' flat page regions in either package: 1e-4
    _close(mem.numpy(), jmem, 1e-4 if encoder == "unet" else REL)
    out = greedy_generate(port, torch.from_numpy(images), max_len=16).numpy()
    np.testing.assert_array_equal(out, jtok)
    assert len({tuple(row) for row in out}) > 1  # the tokens depend on the crop
    tok = CharTokenizer.train(["abcdefghijklmnopqrstuvwxyzABCDEFGHI"])
    assert tok.batch_decode(out) == tok.batch_decode(jtok)


@pytest.fixture(scope="module")
def csa_pair():
    """The port's seeded ``CSAViT`` (graph structure) with each head, its
    flax variables, and JAX's outputs on one batch."""
    from kuzu.models.csa_vit import CSAViT as JaxCSAViT

    from kuzu_torch.models.csa_vit import CSAViT
    from kuzu_torch.models.layers import flax_init_

    kw = dict(vocab_size=40, image_size=(64, 32), patch_size=(16, 16), dim=64, depth=3,
              num_heads=2, structure="graph", max_len=12, dec_depth=1)
    rng = np.random.default_rng(1)
    images = rng.random((2, 64, 32, 3)).astype(np.float32)
    tokens = rng.integers(0, 40, (2, 12)).astype(np.int32)
    out = dict(images=images, tokens=tokens, kw=kw)
    for head in ("ctc", "ar"):
        port = flax_init_(CSAViT(**kw, head=head), torch.Generator().manual_seed(2))
        variables = flax_variables(port)
        jm = JaxCSAViT(**kw, head=head)
        args = (jnp.asarray(images),) if head == "ctc" else (jnp.asarray(images),
                                                              jnp.asarray(tokens))
        out[head] = (port.eval(), variables, np.asarray(jax.jit(jm.apply)(variables, *args)))
    return out


def test_csa_vit_heads_match(csa_pair):
    from kuzu.ops.ctc import ctc_greedy_decode as jax_ctc_decode

    x = torch.from_numpy(csa_pair["images"])
    port, _, want = csa_pair["ctc"]
    with torch.no_grad():
        logits = port(x)
    assert logits.shape == (2, 4, 40) and logits.dtype == torch.float32
    _close(logits.numpy(), want)
    got_paths = logits.argmax(-1).numpy()
    np.testing.assert_array_equal(got_paths, np.asarray(want).argmax(-1))
    jax_ctc_decode(jnp.asarray(want))  # JAX's decode takes the head's logits
    port, _, want = csa_pair["ar"]
    with torch.no_grad():
        logits = port(x, torch.from_numpy(csa_pair["tokens"]).long())
    assert logits.shape == (2, 12, 40)
    _close(logits.numpy(), want)


def test_csa_vit_grad_checkpoint_keeps_values_and_gradients(csa_pair):
    """The checkpointed encoder in train mode with dropout: the same values
    and gradients as without, the masks drawn once per layer and replayed
    in the recompute (the generator advanced as without checkpoints)."""
    from kuzu_torch.models.csa_vit import CSAViT

    kw = csa_pair["kw"]
    port = csa_pair["ctc"][0]
    grads, outs, states = [], [], []
    for ckpt in (False, True):
        m = CSAViT(**kw, head="ctc", grad_checkpoint=ckpt)
        m.load_state_dict(port.state_dict())
        for layer in m.encoder.modules():
            if hasattr(layer, "dropout") and isinstance(layer.dropout, float):
                layer.dropout = 0.1
        g = torch.Generator().manual_seed(5)
        y = m(torch.from_numpy(csa_pair["images"]), train=True, rng=g)
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
        states.append(g.get_state())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    assert torch.equal(states[0], states[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7, msg=n)


@pytest.fixture(scope="module")
def vit_pair():
    from kuzu.models.simple_vit import SimpleViT as JaxSimpleViT

    from kuzu_torch.models.layers import flax_init_
    from kuzu_torch.models.simple_vit import SimpleViT

    kw = dict(num_classes=7, image_size=(32, 32), patch_size=(8, 8), dim=64, depth=2,
              num_heads=4)
    port = flax_init_(SimpleViT(**kw, channels=1), torch.Generator().manual_seed(3))
    variables = flax_variables(port)
    images = np.random.default_rng(4).integers(0, 256, (8, 32, 32, 1), dtype=np.uint8)
    jm = JaxSimpleViT(**kw)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(images)))
    return dict(port=port.eval(), variables=variables, images=images, want=want, jm=jm)


def test_simple_vit_logits_and_top1_match(vit_pair):
    with torch.no_grad():
        logits = vit_pair["port"](torch.from_numpy(vit_pair["images"]))
    assert logits.shape == (8, 7) and logits.dtype == torch.float32
    _close(logits.numpy(), vit_pair["want"])
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), vit_pair["want"].argmax(-1))
    assert len(set(vit_pair["want"].argmax(-1).tolist())) > 1


def test_simple_vit_classify_loss_matches(vit_pair):
    """``ClassifyTrainer.loss_fn`` on the port's SimpleViT (label smoothing
    0.1, dropout off) against JAX's on the same weights and batch."""
    from kuzu.tasks.classify import ClassifyTrainer as JaxClassifyTrainer
    from torch_heads import jax_trainer, port_trainer

    from kuzu_torch.tasks.classify import ClassifyTrainer

    labels = np.arange(8, dtype=np.int32) % 7
    batch = {"image": vit_pair["images"], "label": labels}
    cfg = {"label_smoothing": 0.1}
    jt = jax_trainer(JaxClassifyTrainer, cfg, model=vit_pair["jm"], _model_state=None)
    jloss, jm = jax.jit(jt.loss_fn)(vit_pair["variables"]["params"],
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.key(0))
    tt = port_trainer(ClassifyTrainer, cfg)
    model = vit_pair["port"].train()
    try:
        loss, metrics = tt.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   torch.Generator().manual_seed(0))
    finally:
        model.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["acc"]), float(jm["acc"]), rtol=0)


def test_simple_vit_is_the_classify_default(tmp_path):
    """A model name without ``-cls`` trains the SimpleViT route (grayscale
    glyphs, the config's widths) through the facade, and its run dir
    validates and predicts."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.models.simple_vit import SimpleViT
    from kuzu_torch.testing import write_glyph_folder

    data = write_glyph_folder(tmp_path / "g", {"train": 2, "val": 1}, n_classes=3)
    kw = dict(imgsz=32, patch=8, dim=32, depth=1, heads=2, batch=4, epochs=1, workers=0)
    m = Model("simplevit", task="classify", device="cpu")
    final = m.train(data=str(data), project=str(tmp_path / "runs"), name="v", exist_ok=True,
                    verbose=False, **kw)
    assert np.isfinite(final["loss"]) and 0 <= final["acc"] <= 1
    run = tmp_path / "runs" / "classify" / "v"
    got = Model(str(run), device="cpu").val(data=str(data))
    assert got["acc"] == final["acc"]
    files = sorted((data / "val").rglob("*.png"))
    loaded = Model(str(run), device="cpu")
    res = loaded.predict([str(p) for p in files])
    assert isinstance(loaded._predictor.model, SimpleViT)
    assert loaded._predictor.model.PatchEmbed_0.proj.in_channels == 1
    assert len(res) == len(files) and all(0 <= r["class"] < 3 for r in res)
