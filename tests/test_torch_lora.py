"""The port's LoRA (``kuzu_torch/core/lora.py`` and ``BaseTrainer``'s
``lora_rank``) against the JAX package's ``kuzu/core/lora.py`` on the CPU:
the adapted kernels (names, shapes, counts) of the TrOCR, the CharMLM and
the CRNN; the merge (identity at init, ``W + (alpha / r) a @ b`` through the
bridge's slots, an LSTM gate's adapter into its own rows); one LoRA
recognize step against JAX's ``RecognizeTrainer.loss_fn`` on
``merge_lora(stop_gradient(base), lora, alpha)`` (JAX's adapters handed
over); a LoRA CTC run dir that loads merged and resumes.

Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import LM_KW, TOKEN_CHARS, TROCR_KW, flax_variables, jax_trocr_variables

RANK = 4


def _models(name):
    """(JAX model's params shapes, port model) of the tiny TrOCR, CharMLM or
    CRNN (``jax.eval_shape``: no JAX compile)."""
    if name == "trocr":
        from kuzu.models.trocr import TrOCR as JaxTrOCR

        from kuzu_torch.models.trocr import TrOCR

        jm = JaxTrOCR(**TROCR_KW, ctc_head=True)

        def init(m, images, tokens):
            mem = m.encode(images)
            return m.decode_tokens(tokens, mem, train=False), m.ctc_logits(mem)

        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.key(0), jnp.zeros((1, 128, 32, 3), jnp.uint8),
            jnp.zeros((1, 8), jnp.int32), method=init))
        return shapes["params"], TrOCR(**TROCR_KW, ctc_head=True)
    if name == "charmlm":
        from kuzu.models.lm import CharMLM as JaxCharMLM

        from kuzu_torch.models.lm import CharMLM

        shapes = jax.eval_shape(lambda: JaxCharMLM(**LM_KW).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
        return shapes["params"], CharMLM(**LM_KW)
    from kuzu.models.crnn import CRNN as JaxCRNN

    from kuzu_torch.models.crnn import CRNN

    kw = dict(dims=(8, 16, 16, 16), lstm_hidden=16, max_boxes=3)
    shapes = jax.eval_shape(lambda: JaxCRNN(21, **kw).init(
        jax.random.key(0), jnp.zeros((1, 64, 16, 3), jnp.float32)))
    return shapes["params"], CRNN(21, **kw)


@pytest.mark.parametrize("name,targets,count", [
    ("trocr", None, None), ("charmlm", None, None), ("crnn", None, 2 * 8 + 3),
    ("trocr", r"(^|\.)(q|v)\.kernel$", None), ("crnn", r"OptimizedLSTMCell_1\.h", None)])
def test_adapted_kernels_match_jax(name, targets, count):
    """``init_lora`` adapts the same flax paths with the same ``a`` / ``b``
    shapes as JAX's, under the default regex (every 2-D ``kernel``: Dense
    layers and each LSTM gate, no embedding, no conv) and a custom one; the
    CRNN has 8 gate kernels a direction plus the head and the two box
    layers."""
    from kuzu.core.lora import init_lora as jax_init_lora

    from kuzu_torch.core.lora import init_lora

    shapes, model = _models(name)
    want = jax_init_lora(jax.random.key(0), shapes, RANK, targets=targets)
    got = init_lora(torch.Generator().manual_seed(0), model, RANK, targets=targets)
    assert sorted(got) == sorted(want) and len(got) > 0
    for path, ab in want.items():
        assert tuple(got[path]["a"].shape) == ab["a"].shape
        assert tuple(got[path]["b"].shape) == ab["b"].shape
        assert float(got[path]["b"].abs().max()) == 0.0
    if count is not None:
        assert len(got) == count
    with pytest.raises(ValueError, match="no parameters matched"):
        init_lora(torch.Generator(), model, RANK, targets="nothing_is_named_so")


def test_merge_matches_jax():
    """On the CRNN's weights (the port's seeded init as a flax tree, no JAX
    init): JAX's ``init_lora`` adapters merge to the base exactly (b = 0);
    with ``b`` drawn at random, the port's ``merge_lora`` through the
    bridge's slots (Dense kernels transposed, each LSTM gate into its rows)
    equals JAX's ``merge_lora``, 1e-6 of each leaf's largest value;
    ``maybe_merge`` of a ``LoRAModel``'s state dict gives the same."""
    from kuzu.core.lora import init_lora as jax_init_lora
    from kuzu.core.lora import merge_lora as jax_merge

    from kuzu_torch.bridge import lora_from_flax
    from kuzu_torch.core.config import Config
    from kuzu_torch.core.lora import combine, lora_slots, maybe_merge, merge_lora
    from kuzu_torch.models.crnn import CRNN

    model = CRNN(21, dims=(8, 16, 16, 16), lstm_hidden=16, max_boxes=3)
    model.reset_parameters(torch.Generator().manual_seed(2))
    tree = flax_variables(model)
    params = jax.tree.map(jnp.asarray, tree["params"])
    adapters = jax_init_lora(jax.random.key(3), params, RANK)
    alpha = 2.0 * RANK
    slots = lora_slots(model)
    sd = model.state_dict()
    same = merge_lora(sd, lora_from_flax(jax.tree.map(np.asarray, adapters)), alpha, slots)
    for k, v in sd.items():
        assert torch.equal(same[k], v), k
    rng = np.random.default_rng(4)
    adapters = {p: {"a": np.asarray(ab["a"]),
                    "b": rng.normal(0, 0.3, ab["b"].shape).astype(np.float32)}
                for p, ab in adapters.items()}
    want = jax.tree.map(np.asarray, jax_merge(params, adapters, alpha))
    port = lora_from_flax(adapters)
    merged = merge_lora(sd, port, alpha, slots)
    got = flax_variables(model, merged)["params"]
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=str(path))
    changed = sum(not torch.equal(merged[k], sd[k]) for k in sd)
    assert changed == 2 * 2 + 3  # weight_ih, weight_hh a direction; head, box_fc, box_out
    wrapped = combine(model, port, alpha, slots)
    back = maybe_merge(wrapped.state_dict(), Config(lora_alpha=alpha))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], merged[k]), k


REC_CFG = dict(
    task="recognize", imgsz=[128, 32], patch=16, enc_dim=64, enc_depth=2, enc_heads=2,
    dec_dim=64, dec_depth=2, dec_heads=4, max_label_length=16, ctc_weight=0.3, ss_prob=0.0,
    augment=False, dropout=0.0, dtype="float32", optimizer="adamw", lr0=1e-3,
    weight_decay=0.05, grad_clip=1.0, warmup_epochs=0.0, epochs=1, seed=0, lora_rank=RANK,
    lora_alpha=4.0)


def test_lora_recognize_step_matches_jax(tmp_path):
    """One LoRA step of the recognize trainer: JAX's loss on
    ``merge_lora(stop_gradient(base), lora, alpha)`` under ``value_and_grad``
    in the adapters, the port's ``BaseTrainer.wrap_lora`` (JAX's adapters
    handed over, ``b`` nonzero so that both halves have gradients) and
    ``lora_loss``: the loss 1e-5 relative; the adapters' gradients 1e-4 of
    each leaf's largest entry plus 1e-3 of each entry, their global norm
    (the clip's) 1e-5 relative; the optimizer holds the adapters only; every
    base weight is bit-equal after the step and every adapter moved."""
    from kuzu.core.config import load_config as j_load_config
    from kuzu.core.lora import init_lora as jax_init_lora
    from kuzu.core.lora import merge_lora as jax_merge
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.trocr import TrOCR as JaxTrOCR
    from kuzu.tasks.recognize import RecognizeTrainer as JaxTrainer

    from kuzu_torch.bridge import from_flax, lora_from_flax
    from kuzu_torch.core import lora
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.tasks.recognize import RecognizeTrainer

    variables = jax_trocr_variables()
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (4, 128, 32, 3), dtype=np.uint8)
    jtok = JaxTokenizer.train([TOKEN_CHARS])
    tokens = np.stack([jtok.encode(t, max_length=16) for t in ["abc", "aabbc", "defg", "h"]])
    adapters = jax.tree.map(np.asarray, jax_init_lora(jax.random.key(7), variables["params"],
                                                      RANK))
    adapters = {p: {"a": ab["a"], "b": rng.normal(0, 0.05, ab["b"].shape).astype(np.float32)}
                for p, ab in adapters.items()}
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.cfg = j_load_config(overrides=REC_CFG)
    jt.tokenizer = jtok
    jt.model = JaxTrOCR(**TROCR_KW, ctc_head=True, attn_impl="einsum")
    base = variables["params"]
    batch = {"image": jnp.asarray(images), "tokens": jnp.asarray(tokens)}

    def jloss(ad):
        merged = jax_merge(jax.lax.stop_gradient(base), ad, REC_CFG["lora_alpha"])
        return jt.loss_fn(merged, batch, jax.random.key(1))

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(adapters)
    jgrads = jax.tree.map(np.asarray, jgrads)

    cfg = load_config(overrides={**REC_CFG, "project": str(tmp_path), "name": "lora"})
    trainer = RecognizeTrainer(cfg, device="cpu")
    trainer.tokenizer = CharTokenizer.train([TOKEN_CHARS])
    model = from_flax(trainer.build_model(), variables)
    trainer.init_adapters = lambda m, rank: lora_from_flax(adapters)
    wrapped = trainer.wrap_lora(model)
    tx = build_optimizer(cfg, wrapped, 1)
    assert set(map(id, tx.params())) == {id(p) for ad in wrapped.adapters().values()
                                         for p in ad.values()}
    assert set(lora.label_tree(wrapped).values()) == {"train", "freeze"}
    state = TrainState(wrapped, tx)
    base0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    ad0 = {p: {k: v.detach().clone() for k, v in ab.items()}
           for p, ab in wrapped.adapters().items()}
    grads = {}
    inner = tx.step

    def snapshot_then_step(count, grad_norm):
        grads.update({(p, k): v.grad.detach().clone()
                      for p, ab in wrapped.adapters().items() for k, v in ab.items()})
        inner(count, grad_norm)

    tx.step = snapshot_then_step
    tbatch = {"image": torch.from_numpy(images), "tokens": torch.from_numpy(tokens)}
    metrics = make_train_step(lora.lora_loss(trainer.loss_fn), tx)(state, tbatch,
                                                                   torch.Generator())
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
    jnorm = np.sqrt(sum(float((g ** 2).sum()) for ab in jgrads.values() for g in ab.values()))
    np.testing.assert_allclose(float(metrics["grad_norm"]), jnorm, rtol=1e-5)
    for (path, k), g in grads.items():
        want = jgrads[path][k]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f"{path} {k}")
    assert len(grads) == 2 * len(adapters)
    for n, p in model.named_parameters():
        assert torch.equal(p, base0[n]), n
        assert p.grad is None
    for path, ab in wrapped.adapters().items():
        for k, v in ab.items():
            assert not torch.equal(v, ad0[path][k]), (path, k)


def test_lora_run_dir_loads_merged_and_resumes(tmp_path, monkeypatch):
    """A CTC run with ``lora_rank`` on the CPU (2 steps, box head, the
    CRNN's encoder narrowed to (8, 16, 16, 16)): the run
    dir's checkpoint holds base and adapters; ``CTCPredictor`` over it
    builds a plain CRNN with the adapters fused (equal to the train state's
    merged EMA); the base's weights never moved while its BatchNorm
    statistics did; ``resume`` restores base and adapters and continues."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.lora import LoRAModel
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.tasks.ctc import CTCPredictor, trainer_for
    from kuzu_torch.testing import SyntheticLineDataset, synthetic_texts

    monkeypatch.setattr("kuzu_torch.tasks.ctc.DIMS", (8, 16, 16, 16))
    chars = "abcdefgh"
    tok = CharTokenizer.train([chars])
    train = SyntheticLineDataset(synthetic_texts(8, chars, 6, seed=1), tok, (64, 16), 16,
                                 max_boxes=2)
    over = dict(task="ctc", imgsz=[64, 16], lstm_hidden=16, max_boxes=2, max_label_length=16,
                dtype="float32", epochs=1, batch=4, workers=0, lora_rank=RANK,
                warmup_epochs=0.0, project=str(tmp_path), name="lora", exist_ok=True,
                verbose=False)
    cls = trainer_for((train, train, tok))
    trainer = cls(load_config(overrides=over), device="cpu")
    fresh = {}
    trainer.callbacks.add("on_train_start", lambda t: fresh.update(
        {k: v.clone() for k, v in t.state.model.base.state_dict().items()}))
    trainer.train()
    model = trainer.state.model
    assert isinstance(model, LoRAModel) and trainer.state.step == 2
    for name, t in model.base.named_parameters():
        assert torch.equal(t, fresh[name]), name
    assert not torch.equal(model.base.state_dict()["encoder.bn0.running_var"],
                           fresh["encoder.bn0.running_var"])
    raw = torch.load(trainer.save_dir / "weights" / "last" / "state.pt", weights_only=True)
    assert any(k.startswith("lora.") for k in raw["model"]) and "ema" in raw
    pred = CTCPredictor(load_config(overrides={"model": str(trainer.save_dir)}), device="cpu")
    pred._setup()
    want = trainer.state.ema_state_dict()
    got = pred.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["head.weight"], fresh["head.weight"])
    again = cls(load_config(overrides={**over, "epochs": 2, "resume": True}), device="cpu")
    again.train()
    assert again.state.step == 4 and isinstance(again.state.model, LoRAModel)
    for name, t in again.state.model.base.named_parameters():
        assert torch.equal(t, fresh[name]), name
