"""The port's char-LM training against the JAX package on the CPU, and the
recognizer-family training flow end to end:

- one f32 ``LMTrainer`` step against JAX's ``LMTrainer.loss_fn`` under one
  ``jax.value_and_grad`` and one optax AdamW update, the MLM draws taken
  from JAX's key and handed to the port;
- ``apply_mlm_masking``: the same tokens from the same draws, and its
  statistics from the port's own generator (15%, 80/10/10, specials and
  padding untouched);
- the adam/adamw branch of ``build_optimizer`` against optax over several
  steps with warmup, decay, weight decay and clipping;
- the LM trainer -> ``decoder_init`` graft -> recognize trainer -> run
  dirs -> ``LMPredictor`` / ``RecognizePredictor`` / the cascade, at tiny
  widths, port only.

Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import LM_KW, TOKEN_CHARS, jax_lm_variables

# one f32 step through 2 layers: the loss to 1e-5 relative; each gradient
# leaf to 1e-4 of its largest entry plus 1e-3 of each entry, a leaf whose
# gradient is zero but for rounding (the attention's key biases) to 1e-6 of
# the largest gradient
GRAD_REL, GRAD_ENTRY, GRAD_ZERO = 1e-4, 1e-3, 1e-6
TEXTS = ["abcdefghij", "klmnop", "qrstuvwxyzABCDEFGHI", "aabbccdd", "hello world", "xyz"]
STEP_CFG = dict(task="lm", max_length=32, dim=64, depth=2, heads=4, dropout=0.0,
                dtype="float32", optimizer="adamw", lr0=1e-3, weight_decay=0.05,
                grad_clip=1.0, warmup_epochs=0.0, epochs=1, seed=0, mlm_prob=0.3)


def _flax_layout(arr, layout):
    return arr.T if layout == "dense" else arr


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def lm_step(tmp_path_factory):
    """One f32 step of both LM trainers from the same weights, tokens and
    MLM draws (``mlm_prob`` 0.3, so every row has masked positions)."""
    from kuzu.core.config import load_config as j_load_config
    from kuzu.core.train import build_optimizer as j_build_optimizer
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.lm import CharMLM as JaxCharMLM
    from kuzu.tasks.lm import LMTrainer as JaxTrainer

    from kuzu_torch.bridge import _targets, from_flax
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.tasks.lm import LMTrainer

    variables = jax_lm_variables()
    jtok = JaxTokenizer.train([TOKEN_CHARS])
    tokens = np.stack([jtok.encode(t, max_length=32) for t in TEXTS])
    mask = (tokens != 0).astype(np.float32)
    key = jax.random.key(5)
    # JAX's draws: mask_rng = split(key)[0], then split(mask_rng, 3)
    r_sel, r_kind, r_rand = jax.random.split(jax.random.split(key)[0], 3)
    draws = (np.asarray(jax.random.uniform(r_sel, tokens.shape)),
             np.asarray(jax.random.uniform(r_kind, tokens.shape)),
             np.asarray(jax.random.randint(r_rand, tokens.shape, 5, 40)))

    jt = JaxTrainer.__new__(JaxTrainer)
    jt.cfg = j_load_config(overrides=STEP_CFG)
    jt.tokenizer = jtok
    jt.model = JaxCharMLM(**LM_KW)
    batch = {"tokens": jnp.asarray(tokens), "attention_mask": jnp.asarray(mask)}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        variables["params"], batch, key)
    jtx = j_build_optimizer(jt.cfg, 1)
    jnew = jax.jit(lambda g, p: optax.apply_updates(p, jtx.update(g, jtx.init(p), p)[0]))(
        jgrads, variables["params"])
    jmasked, jlabels = jt._mlm(jnp.asarray(tokens), jax.random.split(key)[0])

    cfg = load_config(overrides={**STEP_CFG, "project": str(tmp_path_factory.mktemp("lm")),
                                 "name": "step", "exist_ok": True})
    trainer = LMTrainer(cfg, device="cpu")
    trainer.tokenizer = CharTokenizer.train([TOKEN_CHARS])
    model = from_flax(trainer.build_model(), variables)
    trainer.mlm_draws = lambda toks, _rng: tuple(torch.from_numpy(d.copy()) for d in draws)
    tx = build_optimizer(cfg, model, steps_per_epoch=1)
    state = TrainState(model, tx, use_ema=True)
    tgrads = {}
    step_inner = tx.step

    def snapshot_then_step(count, grad_norm):  # clipping scales .grad in place
        tgrads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        step_inner(count, grad_norm)

    tx.step = snapshot_then_step
    targets = list(_targets(model))
    tbatch = {"tokens": torch.from_numpy(tokens), "attention_mask": torch.from_numpy(mask)}
    tmetrics = make_train_step(trainer.loss_fn, tx)(state, tbatch, torch.Generator())
    return dict(jloss=float(jloss), jacc=float(jmetrics["masked_acc"]),
                jnorm=float(optax.global_norm(jgrads)), jgrads=jax.tree.map(np.asarray, jgrads),
                jnew=jax.tree.map(np.asarray, jnew), jparams=variables["params"],
                jmasked=np.asarray(jmasked), jlabels=np.asarray(jlabels),
                tmetrics={k: float(v) for k, v in tmetrics.items()}, tgrads=tgrads,
                targets=targets, names={id(p): n for n, p in model.named_parameters()},
                trainer=trainer, tokens=tokens, draws=draws)


def test_lm_step_masking_loss_and_metrics_match(lm_step):
    """The masked tokens and labels from the same draws: identical; the
    loss and the gradient norm 1e-5 relative, the masked accuracy equal."""
    from kuzu_torch.models.lm import mask_from_draws

    masked, labels = mask_from_draws(
        torch.from_numpy(lm_step["tokens"]).long(),
        *(torch.from_numpy(d.copy()) for d in lm_step["draws"]), mask_id=4, mlm_prob=0.3)
    np.testing.assert_array_equal(masked.numpy(), lm_step["jmasked"])
    np.testing.assert_array_equal(labels.numpy(), lm_step["jlabels"])
    tm = lm_step["tmetrics"]
    np.testing.assert_allclose(tm["loss"], lm_step["jloss"], rtol=1e-5)
    np.testing.assert_allclose(tm["masked_acc"], lm_step["jacc"], rtol=1e-6)
    np.testing.assert_allclose(tm["grad_norm"], lm_step["jnorm"], rtol=1e-5)
    assert tm["grad_norm"] > STEP_CFG["grad_clip"]


def test_lm_step_every_gradient_and_the_update_match(lm_step):
    """Every gradient leaf (tolerances above), and the weights after the
    AdamW step where its direction is decided (the clipped gradient plus
    the decay term |g| >= 1e-4, as in ``test_torch_recognize_train.py``):
    1e-5 of the lr plus 1e-6 of each weight, elsewhere within 2 lr."""
    top = max(np.abs(g).max() for g in jax.tree.leaves(lm_step["jgrads"]))
    lr = STEP_CFG["lr0"]
    factor = min(1.0, STEP_CFG["grad_clip"] / lm_step["jnorm"])
    for path, tensor, layout in lm_step["targets"]:
        got = _flax_layout(lm_step["tgrads"][lm_step["names"][id(tensor)]].numpy(), layout)
        want = _leaf(lm_step["jgrads"], path[1:])
        zero = np.abs(want).max() < GRAD_ZERO * top
        np.testing.assert_allclose(got, want, rtol=0 if zero else GRAD_ENTRY,
                                   atol=GRAD_ZERO * top if zero else GRAD_REL * np.abs(want).max(),
                                   err_msg="/".join(path))
        p0 = _leaf(lm_step["jparams"], path[1:])
        g = want * factor + (STEP_CFG["weight_decay"] * p0 if p0.ndim >= 2 else 0.0)
        ok = np.abs(g) >= 1e-4
        new = _flax_layout(tensor.detach().numpy(), layout)
        ref = _leaf(lm_step["jnew"], path[1:])
        np.testing.assert_allclose(new[ok], ref[ok], rtol=1e-6, atol=1e-5 * lr,
                                   err_msg="/".join(path))
        assert np.abs(new - ref).max() <= 2 * lr * (1 + 1e-6)


def test_mlm_masking_statistics():
    """From the port's generator on 64 x 128 tokens (ids >= 5, a padded tail
    and a BOS/EOS per row): about 15% of the maskable positions selected,
    of those about 80% [MASK], 10% a random character (ids >= 5), 10%
    unchanged; specials and padding never selected (bounds: 5 standard
    deviations of the binomial counts)."""
    from kuzu_torch.models.lm import apply_mlm_masking

    rng = np.random.default_rng(0)
    tokens = rng.integers(5, 40, (64, 128))
    tokens[:, 0], tokens[:, 100] = 2, 3
    tokens[:, 101:] = 0
    t = torch.from_numpy(tokens)
    masked, labels = apply_mlm_masking(t, torch.Generator().manual_seed(1), mask_id=4,
                                       vocab_size=40)
    sel = labels >= 0
    maskable = t >= 5
    n, k = int(maskable.sum()), int(sel.sum())
    assert not bool((sel & ~maskable).any())
    assert bool((masked[~sel] == t[~sel]).all())
    assert abs(k - 0.15 * n) < 5 * np.sqrt(n * 0.15 * 0.85)
    assert bool((labels[sel] == t[sel]).all())
    to_mask = int((masked[sel] == 4).sum())
    kept = int((masked[sel] == t[sel]).sum())
    assert abs(to_mask - 0.8 * k) < 5 * np.sqrt(k * 0.8 * 0.2)
    # a random replacement may draw the original id (1 in 35)
    assert abs(kept - (0.1 + 0.1 / 35) * k) < 5 * np.sqrt(k * 0.1 * 0.9)
    assert int(masked[sel].min()) >= 4


def test_dropout_draws_from_the_given_generator():
    """flax's dropout: in train mode each entry kept with probability
    1 - rate (5 standard deviations of the binomial count) and scaled by
    1 / (1 - rate), the rest 0; the same generator state gives the same
    mask; without ``train`` (or at rate 0) the input itself; in train mode
    without a generator it raises."""
    from kuzu_torch.models.layers import dropout

    x = torch.ones((64, 256))
    a = dropout(x, 0.1, True, torch.Generator().manual_seed(3))
    b = dropout(x, 0.1, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.9) < 5 * np.sqrt(0.9 * 0.1 / x.numel())
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.9))
    assert dropout(x, 0.1, False, None) is x and dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.1, True, None)


def test_adamw_matches_optax_over_steps():
    """``build_optimizer(optimizer="adamw")`` (clip, weight decay on the
    ndim >= 2 parameters, Adam) against ``kuzu.core.train.build_optimizer``
    over four updates of fixed gradients: warmup over the first two (the
    first lr 0), linear decay to lr0 * lrf after them, the clip active on
    some steps and not others. Each step's weights: 1e-6 relative plus
    1e-7 of lr0."""
    from kuzu.core.config import load_config as j_load_config
    from kuzu.core.train import build_optimizer as j_build_optimizer

    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import build_optimizer

    over = dict(optimizer="adamw", lr0=0.01, lrf=0.1, epochs=2, warmup_epochs=1.0,
                weight_decay=0.1, grad_clip=1.0, momentum=0.9)
    rng = np.random.default_rng(3)
    w0 = {"kernel": rng.normal(0, 1, (4, 3)).astype(np.float32),
          "bias": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: (rng.normal(0, s, v.shape)).astype(np.float32) for k, v in w0.items()}
             for s in (2.0, 0.1, 3.0, 0.05)]
    jtx = j_build_optimizer(j_load_config(overrides=over), 2)
    jp = jax.tree.map(jnp.asarray, w0)
    jstate = jtx.init(jp)
    module = torch.nn.Module()
    module.kernel = torch.nn.Parameter(torch.from_numpy(w0["kernel"].copy()))
    module.bias = torch.nn.Parameter(torch.from_numpy(w0["bias"].copy()))
    tx = build_optimizer(load_config(overrides=over), module, steps_per_epoch=2)
    for step, g in enumerate(grads):
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(g[name].copy())
        norm = torch.linalg.vector_norm(torch.cat([p.grad.flatten()
                                                   for p in module.parameters()]))
        tx.step(step, norm)
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[name]), rtol=1e-6,
                                       atol=1e-7 * over["lr0"], err_msg=f"{name} step {step}")
        if step == 0:  # warmup: lr 0, nothing moves
            np.testing.assert_array_equal(module.kernel.detach().numpy(), w0["kernel"])


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """LMTrainer (2 epochs, dropout on) -> RecognizeTrainer with
    ``decoder_init`` (2 epochs, augment, scheduled sampling, joint CTC,
    dropout) on seeded crops, the encoder's attention through the training
    route's plain versions; both run dirs on disk."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.tasks.lm import LMTrainer
    from kuzu_torch.tasks.recognize import trainer_for
    from kuzu_torch.testing import SyntheticLineDataset, synthetic_texts

    root = tmp_path_factory.mktemp("flow")
    chars = "abcdefghij"
    tok = CharTokenizer.train([chars])
    tok.save(root / "tokenizer.json")
    (root / "corpus").mkdir()
    (root / "corpus" / "train.txt").write_text("\n".join(synthetic_texts(48, chars, 12, seed=1)))
    (root / "corpus" / "val.txt").write_text("\n".join(synthetic_texts(8, chars, 12, seed=2)))
    lm_cfg = load_config(overrides=dict(
        task="lm", data=str(root / "corpus"), tokenizer=str(root / "tokenizer.json"), epochs=2,
        batch=8, max_length=16, dim=32, depth=1, heads=2, dtype="float32", dropout=0.1,
        warmup_epochs=0.0, project=str(root / "runs"), name="lm", exist_ok=True, workers=0,
        verbose=False))
    lm = LMTrainer(lm_cfg, device="cpu")
    lm_final = lm.train()
    texts = synthetic_texts(12, chars, 6, seed=3)
    train = SyntheticLineDataset(texts, tok, (128, 32), 16)
    val = SyntheticLineDataset(synthetic_texts(6, chars, 6, seed=4), tok, (128, 32), 16, seed=1)
    rec_cfg = load_config(overrides=dict(
        task="recognize", imgsz=[128, 32], patch=16, enc_dim=32, enc_depth=1, enc_heads=2,
        dec_dim=32, dec_depth=1, dec_heads=2, max_label_length=16, epochs=2, batch=6,
        dtype="float32", ctc_weight=0.3, ss_prob=0.25, augment=True, dropout=0.1,
        decoder_init=str(lm.save_dir), warmup_epochs=0.0, project=str(root / "runs"),
        name="rec", exist_ok=True, workers=0, verbose=False))
    rec = trainer_for((train, val, tok))(rec_cfg, device="cpu")
    rec_final = rec.train()
    return dict(lm=lm, rec=rec, lm_final=lm_final, rec_final=rec_final, tok=tok, val=val,
                root=root)


def test_flow_trains_and_grafts(flow):
    """Both trainers run their epochs with finite metrics and write run dirs
    (args.yaml, tokenizer.json, weights/best and last); the recognize run
    started from the LM's EMA weights: at build time its decoder's embed,
    self-attention, pre-MLP norm and lm_head were the LM's."""
    from kuzu_torch.tasks.recognize import RecognizeTrainer

    for name in ("lm", "rec"):
        final = flow[f"{name}_final"]
        assert all(np.isfinite(v) for v in final.values()), final
        d = flow[name].save_dir
        for f in ("args.yaml", "tokenizer.json", "weights/best/state.pt",
                  "weights/last/state.pt"):
            assert (d / f).exists(), (d, f)
    assert {"ctc_loss", "token_acc", "cer", "tf_acc"} <= set(flow["rec_final"])
    assert {"masked_acc", "loss"} <= set(flow["lm_final"])
    lm_sd = _best_ema(flow["lm"].save_dir)
    fresh = RecognizeTrainer.__new__(RecognizeTrainer)
    fresh.cfg, fresh.tokenizer, fresh.device = flow["rec"].cfg, flow["tok"], torch.device("cpu")
    model = fresh.build_model()
    dec = model.decoder.state_dict()
    for name in ("embed.weight", "block0.self_attn.q.weight", "block0.norm3.weight",
                 "lm_head.weight", "norm.bias"):
        src = name.replace("self_attn", "attn").replace("norm3", "norm2")
        np.testing.assert_array_equal(dec[name].numpy(), lm_sd[src].numpy(), err_msg=name)
    n, total = fresh._graft_decoder(model, flow["lm"].save_dir)
    assert 0 < n < total == len(dec)


def _best_ema(run_dir) -> dict:
    """A run's ``best`` checkpoint, the EMA over the live parameters,
    read with ``torch.load``."""
    sd = torch.load(run_dir / "weights" / "best" / "state.pt", weights_only=True)
    return {**sd["model"], **sd["ema"]}


def test_flow_pretrained_and_mismatch(flow, tmp_path):
    """``pretrained=`` grafts every tensor of a recognize run of the same
    widths; ``decoder_init`` with an LM whose width differs raises before
    transferring anything."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.recognize import RecognizeTrainer

    over = dict(flow["rec"].cfg)
    over.update(pretrained=str(flow["rec"].save_dir), decoder_init=None,
                project=str(tmp_path), name="pre")
    trainer = RecognizeTrainer(load_config(overrides=over), device="cpu")
    trainer.tokenizer = flow["tok"]
    model = trainer.build_model()
    want = _best_ema(flow["rec"].save_dir)
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy(), err_msg=name)
    over.update(pretrained=None, decoder_init=str(flow["lm"].save_dir), dec_dim=64,
                name="mismatch")
    trainer = RecognizeTrainer(load_config(overrides=over), device="cpu")
    trainer.tokenizer = flow["tok"]
    with pytest.raises(ValueError, match="does not match decoder embedding"):
        trainer.build_model()


def test_flow_run_dirs_load_into_predictors_and_the_cascade(flow):
    """The two run dirs load into ``LMPredictor`` and ``RecognizePredictor``
    (EMA weights, best before last) and into ``KuzushijiPipeline`` as paths:
    the same tokens, restorations and cascade texts (with the LM's
    annotation) as the runs' best EMA weights built in memory."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.models.lm import CharMLM
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.tasks.lm import LMPredictor
    from kuzu_torch.tasks.recognize import RecognizePredictor, build_trocr
    from kuzu_torch.testing import column_pages

    tok = flow["tok"]
    rec_dir, lm_dir = flow["rec"].save_dir, flow["lm"].save_dir
    trocr = build_trocr(flow["rec"].cfg, len(tok))
    trocr.load_state_dict(_best_ema(rec_dir))
    lm = CharMLM(len(tok), max_len=16, dim=32, depth=1, num_heads=2)
    lm.load_state_dict(_best_ema(lm_dir))
    mem_rec = RecognizePredictor.from_model(trocr, tok, (128, 32), device="cpu")
    mem_lm = LMPredictor.from_model(lm, tok, max_len=16, device="cpu")
    run_rec = RecognizePredictor(load_config(overrides={"model": str(rec_dir)}), device="cpu")
    run_lm = LMPredictor(load_config(overrides={"model": str(lm_dir)}), device="cpu")
    crops = torch.from_numpy(np.stack([flow["val"][i]["image"] for i in range(6)]))
    for decode in ("greedy", "beam"):
        np.testing.assert_array_equal(run_rec._fwd(crops, decode=decode).numpy(),
                                      mem_rec._fwd(crops, decode=decode).numpy())
    assert run_rec.image_size == (128, 32) and run_rec.model.ctc_proj is not None
    masked = ["ab〓d", "〓〓cde"]
    assert run_lm(masked) == mem_lm(masked) and all("〓" not in t for t in run_lm(masked))

    det = DetectPredictor.from_detector(
        YoloDetector("yolov12n", nc=1, imgsz=64, device="cpu").init(0), conf=0.001)
    pages = column_pages(1, 96, seed=0)
    texts = {}
    for label, rec, lm_ in (("run dirs", rec_dir, lm_dir), ("memory", mem_rec, mem_lm)):
        pipe = KuzushijiPipeline(column_model=det, char_model=det, recognizer=rec, lm=lm_,
                                 tile_grid=2, device="cpu")
        res = pipe.process_pages(pages)
        texts[label] = [(c["text"], c["lm_score"]) for r in res for c in r["columns"]]
        assert pipe.rec_task == "recognize"
    assert len(texts["memory"]) > 0 and texts["run dirs"] == texts["memory"]
