"""The port's CTC recognizer training against the JAX package on the CPU:
the CRNN's train-mode forward and running statistics against flax (f32 and
bf16); one f32 ``CTCTrainer`` step with the box head and photometric
jitter (JAX's draws handed to the port) against JAX's
``CTCTrainer.loss_fn`` under one ``jax.value_and_grad`` and one optax AdamW
update; a batch with a label that has no alignment (the reference's
recursion: loss 1e30 and its gradient); ``validate``'s CER; the run dir
through ``CTCPredictor`` and the cascade; ``BigramTokenizer``.

Sizes are tiny: CRNN dims (8, 16, 16, 16) (the trainer's ``DIMS`` narrowed
for the module), hidden 16, 64 x 16 crops (16 CTC frames), 21 classes,
batch 4; one jitted JAX step shared by the step and the no-alignment batch. Tolerances are stated at each comparison: f32 on
both sides is the same arithmetic up to the order of sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import flax_variables, numpy_tree

CHARS = "abcdefghijklmnop"  # 16 characters + the 5 specials: 21 classes
CROP = (64, 16)  # T = 64 / 4 = 16 CTC frames
DIMS, HIDDEN, BOXES, MAXLEN = (8, 16, 16, 16), 16, 3, 16
B = 4
TEXTS = ["abc", "aabbc", "ponmlkjihg", "dd"]  # every label has an alignment in 16 frames
NO_ALIGN = ["abc", "aaaaaaaaaa", "dcba", "bb"]  # row 1: 10 characters + 9 repeats > 16
STEP_CFG = dict(
    task="ctc", imgsz=list(CROP), lstm_hidden=HIDDEN, max_boxes=BOXES,
    max_label_length=MAXLEN, augment=True, box=1.0, dtype="float32", optimizer="adamw",
    lr0=1e-3, weight_decay=0.05, grad_clip=1.0, warmup_epochs=0.0, epochs=1, seed=0)
REL = 1e-5  # f32 values: of the largest value of the compared tensor
# gradients: 1e-4 of a leaf's largest entry plus 1e-3 of each entry (convs,
# BatchNorm in train mode, 2 x 16 LSTM steps and the CTC recursion)
GRAD_REL, GRAD_ENTRY = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def narrow_crnn():
    """The trainer and the predictor build the CRNN at the production widths
    (``kuzu_torch.tasks.ctc.DIMS``): narrowed to ``DIMS`` here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("kuzu_torch.tasks.ctc.DIMS", DIMS)
        yield


def _jax_crnn(dtype=jnp.float32, time_axis="height"):
    from kuzu.models.crnn import CRNN as JaxCRNN

    return JaxCRNN(num_classes=len(CHARS) + 5, dims=DIMS, lstm_hidden=HIDDEN,
                   time_axis=time_axis, max_boxes=BOXES, dtype=dtype)


def _port_crnn(variables, dtype=torch.float32, time_axis="height"):
    from kuzu_torch.bridge import crnn_from_flax
    from kuzu_torch.models.crnn import CRNN

    return crnn_from_flax(CRNN(len(CHARS) + 5, dims=DIMS, lstm_hidden=HIDDEN,
                               time_axis=time_axis, max_boxes=BOXES, dtype=dtype), variables)


def _variables(model, seed=0):
    shape = (1, *CROP, 3) if model.time_axis == "height" else (1, CROP[1], CROP[0], 3)
    return numpy_tree(jax.jit(lambda r: model.init(r, jnp.zeros(shape, jnp.float32)))(
        jax.random.key(seed)))


def _batch(texts, seed=0):
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.testing import SyntheticLineDataset

    tok = CharTokenizer.train([CHARS])
    ds = SyntheticLineDataset(texts, tok, CROP, MAXLEN, seed=seed, max_boxes=BOXES)
    return tok, default_collate([ds[i] for i in range(len(texts))])


def _close(got, want, rel=REL) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dtype,time_axis", [("float32", "height"), ("bfloat16", "width")])
def test_crnn_train_forward_and_statistics_match_flax(dtype, time_axis):
    """The CRNN in training mode against flax's ``apply(train=True,
    mutable=["batch_stats"])`` on the same weights and crops: logits, boxes
    and every BatchNorm's moved running mean and variance (momentum 0.97,
    the biased batch variance). f32: 1e-5 of the largest value. bf16 (the
    encoder in bf16 over f32 parameters, f32 statistics; the time axis on
    the width): both sides round each conv, BatchNorm and SiLU output to
    bf16, in orders that differ (torch's SiLU rounds once, XLA's sigmoid and
    product twice): the logits and boxes no farther from JAX's bf16 ones (as
    a share of the largest) than JAX's bf16 logits are from its f32 logits
    on the same weights (measured 0.020 against 0.025); the port's bf16
    logits as far from its own f32 logits as JAX's are, within a factor 2
    (measured 0.021, so the bf16 path runs: an f32 port would read 0); the
    statistics within 1e-2 of the largest (measured 0.0052; JAX's bf16 from
    its f32 0.0043)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    model = _jax_crnn(jdt, time_axis)
    variables = _variables(model)
    images = np.random.default_rng(1).integers(0, 256, (B, *CROP, 3), dtype=np.uint8)
    if time_axis == "width":
        images = images.transpose(0, 2, 1, 3).copy()
    (jlogits, jboxes), mutated = model.apply(variables, jnp.asarray(images), train=True,
                                             mutable=["batch_stats"])
    port = _port_crnn(variables, getattr(torch, dtype), time_axis).train()
    with torch.no_grad():
        logits, boxes = port(torch.from_numpy(images))
    tol = REL
    if dtype == "bfloat16":  # the rounding scale: JAX's bf16 against its own f32
        (flogits, _), _ = _jax_crnn(jnp.float32, time_axis).apply(
            variables, jnp.asarray(images), train=True, mutable=["batch_stats"])
        tol = float(np.abs(np.asarray(jlogits, np.float32) - np.asarray(flogits)).max()
                    / np.abs(np.asarray(flogits)).max())
        assert 1e-3 < tol < 0.1
        with torch.no_grad():
            own, _ = _port_crnn(variables, torch.float32, time_axis).train()(
                torch.from_numpy(images))
        gap = float((logits - own).abs().max() / own.abs().max())
        assert tol / 2 < gap < 2 * tol, (gap, tol)
    assert logits.dtype == torch.float32 and boxes.shape == (B, BOXES, 4)
    _close(logits.numpy(), jlogits, tol)
    _close(boxes.numpy(), jboxes, tol)
    stats = numpy_tree(mutated)["batch_stats"]["encoder"]
    sd = port.state_dict()
    n = 0
    for name, bn in stats.items():
        prefix = f"encoder.{name}.bn" if "conv" in name else f"encoder.{name}"
        for key, ours in (("mean", "running_mean"), ("var", "running_var")):
            leaf = bn["bn"][key] if "conv" in name else bn[key]
            _close(sd[f"{prefix}.{ours}"].numpy(), leaf, REL if dtype == "float32" else 1e-2)
            n += 1
    assert n == 4 * 2 * 2


@pytest.fixture(scope="module")
def jax_step():
    """JAX's ``CTCTrainer.loss_fn`` under one jitted ``value_and_grad``
    (shared by both batches) and the optax chain of ``build_optimizer``."""
    from kuzu.core.config import load_config as j_load_config
    from kuzu.core.train import build_optimizer as j_build_optimizer
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.tasks.ctc import CTCTrainer as JaxTrainer

    jt = JaxTrainer.__new__(JaxTrainer)
    jt.cfg = j_load_config(overrides=STEP_CFG)
    jt.tokenizer = JaxTokenizer.train([CHARS])
    jt.model = _jax_crnn()
    variables = _variables(jt.model)
    vg = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))
    jtx = j_build_optimizer(jt.cfg, 1)
    update = jax.jit(lambda g, p: optax.apply_updates(p, jtx.update(g, jtx.init(p), p)[0]))
    return dict(jt=jt, variables=variables, vg=vg, update=update)


def _draws(key):
    """The jitter's draws JAX's loss_fn takes from ``key`` (its second
    split, then ``photometric_aug``'s three)."""
    k1, k2, k3 = jax.random.split(jax.random.split(key)[1], 3)
    shp = (B, 1, 1, 1)
    return (np.asarray(jax.random.uniform(k1, shp, jnp.float32, 0.85, 1.15)),
            np.asarray(jax.random.uniform(k2, shp, jnp.float32, -0.12, 0.12)),
            np.asarray(jax.random.normal(k3, (B, *CROP, 3), jnp.float32) * 0.04))


def _run_pair(jax_step, texts, tmp_path):
    """One step of both trainers from the same weights and batch."""
    from kuzu_torch.bridge import crnn_from_flax, param_slots
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.ops.images import from_uint8, photometric_from_draws
    from kuzu_torch.tasks.ctc import CTCTrainer

    tok, batch = _batch(texts)
    key = jax.random.key(7)
    params = jax_step["variables"]["params"]
    ms = {"batch_stats": jax_step["variables"]["batch_stats"]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jmetrics, jmut)), jgrads = jax_step["vg"](params, ms, jbatch, key)
    draws = [torch.from_numpy(d) for d in _draws(key)]
    cfg = load_config(overrides={**STEP_CFG, "project": str(tmp_path), "name": "step",
                                 "exist_ok": True})
    trainer = CTCTrainer(cfg, device="cpu")
    trainer.tokenizer = tok
    model = crnn_from_flax(trainer.build_model(), jax_step["variables"])
    trainer.aug_images = lambda images, rng: (
        photometric_from_draws(from_uint8(images), *draws) - 0.5) / 0.5
    tx = build_optimizer(cfg, model, 1)
    state = TrainState(model, tx)
    grads = {}
    inner = tx.step

    def snapshot_then_step(count, grad_norm):  # clipping scales .grad in place
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        inner(count, grad_norm)

    tx.step = snapshot_then_step
    slots = param_slots(model)
    tbatch = {k: torch.from_numpy(v) for k, v in trainer.preprocess_batch(batch).items()}
    metrics = make_train_step(trainer.loss_fn, tx)(state, tbatch, torch.Generator())
    return dict(jloss=float(jloss), jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=numpy_tree(jgrads), jmut=numpy_tree(jmut), params=numpy_tree(params),
                jnew=numpy_tree(jax_step["update"](jgrads, params)), grads=grads, slots=slots,
                metrics={k: float(v) for k, v in metrics.items()}, model=model,
                trainer=trainer, state=state, batch=batch, marked="ctc_unaligned" in tbatch,
                jnorm=float(optax.global_norm(jgrads)))


@pytest.fixture(scope="module")
def ctc_step(jax_step, tmp_path_factory):
    return _run_pair(jax_step, TEXTS, tmp_path_factory.mktemp("ctc"))


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _check_grads(step) -> int:
    got = flax_variables(step["model"], step["grads"], ("params",))["params"]
    n = 0
    for path in step["slots"]:
        want = _leaf(step["jgrads"], path)
        np.testing.assert_allclose(_leaf(got, path), want, rtol=GRAD_ENTRY,
                                   atol=GRAD_REL * np.abs(want).max() + 1e-12,
                                   err_msg=".".join(path))
        n += 1
    return n


def test_ctc_step_loss_box_term_and_gradients_match(ctc_step):
    """Loss, box term and gradient norm 1e-5 relative; every flax gradient
    leaf (the LSTM's eight gate kernels a direction read out of the stacked
    weights through the bridge's packing) to 1e-4 of its largest entry plus
    1e-3 of each entry; the LSTM's second bias (torch's ``bias_ih``, which
    flax lacks) is frozen at zero."""
    m, jm = ctc_step["metrics"], ctc_step["jmetrics"]
    np.testing.assert_allclose(m["loss"], ctc_step["jloss"], rtol=1e-5)
    np.testing.assert_allclose(m["box_loss"], jm["box_loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], ctc_step["jnorm"], rtol=1e-5)
    assert m["grad_norm"] > STEP_CFG["grad_clip"]  # the clip is active
    assert _check_grads(ctc_step) == len(jax.tree.leaves(ctc_step["jgrads"]))
    lstm = ctc_step["model"].lstm
    assert not lstm.bias_ih_l0.requires_grad and float(lstm.bias_ih_l0.abs().max()) == 0.0
    assert set(ctc_step["grads"]) == {s.param for s in ctc_step["slots"].values()}


def test_ctc_step_batch_statistics_and_adamw_update_match(ctc_step):
    """The BatchNorm statistics after the step (1e-5 of the largest) and the
    weights after clipping, the decay on the kernels and Adam's first step:
    where the step has a direction (the clipped gradient plus the decay
    term |g| >= 1e-4) 1e-5 of the lr plus 1e-6 of each weight, elsewhere
    within 2 lr (Adam's first step is lr sign(g))."""
    tree = flax_variables(ctc_step["model"])
    stats = jax.tree_util.tree_flatten_with_path(tree["batch_stats"])[0]
    assert len(stats) == 4 * 2 * 2
    for path, got in stats:
        _close(got, _leaf(ctc_step["jmut"]["batch_stats"], [k.key for k in path]))
    lr, factor = STEP_CFG["lr0"], min(1.0, STEP_CFG["grad_clip"] / ctc_step["jnorm"])
    undecided = total = 0
    for path in ctc_step["slots"]:
        p0 = _leaf(ctc_step["params"], path)
        g = _leaf(ctc_step["jgrads"], path) * factor
        if p0.ndim >= 2:
            g = g + STEP_CFG["weight_decay"] * p0
        ok = np.abs(g) >= 1e-4
        got, want = _leaf(tree["params"], path), _leaf(ctc_step["jnew"], path)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=1e-5 * lr,
                                   err_msg=".".join(path))
        assert np.abs(got - want).max() <= 2 * lr * (1 + 1e-6)
        undecided += int((~ok).sum())
        total += ok.size
    assert undecided < 0.05 * total, undecided


def test_ctc_row_without_alignment_matches_jax(jax_step, tmp_path):
    """A batch with a label that has no alignment in its 16 frames: JAX's
    trainer masks nothing, its recursion gives that row a loss of exactly
    1e30 and a gradient that is not zero (``jnp.logaddexp``'s gradient is 1
    to both of two equal inputs at -1e30). The port's step takes that row
    through the same recursion (``ctc_loss_recursion``), so the loss
    (1e-6 relative) and every gradient leaf match JAX's as in the feasible
    step; ``F.ctc_loss`` alone would give the row 0 and no gradient. The
    trainer marks such rows on the host (``preprocess_batch``), before the
    step; the feasible batch carries no mark."""
    from kuzu_torch.ops.ctc import ctc_alignable, ctc_loss, pack_labels

    step = _run_pair(jax_step, NO_ALIGN, tmp_path)
    assert step["marked"] and not _run_pair(jax_step, TEXTS, tmp_path)["marked"]
    labels, lens = pack_labels(torch.from_numpy(step["batch"]["tokens"]).long())
    t = torch.full_like(lens, CROP[0] // 4)
    assert ctc_alignable(labels, lens, t).tolist() == [True, False, True, True]
    assert step["jloss"] > 1e28
    np.testing.assert_allclose(step["metrics"]["loss"], step["jloss"], rtol=1e-6)
    assert _check_grads(step) == len(jax.tree.leaves(step["jgrads"]))
    logits = torch.zeros((1, 16, len(CHARS) + 5))
    assert float(ctc_loss(logits, labels[1:2], t[1:2], lens[1:2], reduction="none")) == 0.0


def test_validate_cer_matches_jax(ctc_step):
    """``validate`` on the stepped weights (EMA and BatchNorm statistics)
    over two batches, the second padded (``sample_mask``), against JAX's
    ``CTCTrainer.validate`` on the same weights: the same CER."""
    from kuzu.tasks.ctc import CTCTrainer as JaxTrainer

    from kuzu_torch.testing import synthetic_texts

    trainer, state = ctc_step["trainer"], ctc_step["state"]
    tok, first = _batch(synthetic_texts(B, CHARS, 8, seed=5), seed=3)
    _, second = _batch(synthetic_texts(B, CHARS, 8, seed=6), seed=4)
    second["sample_mask"] = np.array([1, 1, 0, 0], np.float32)
    batches = [first, second]
    trainer.val_loader = batches
    got = trainer.validate(state)
    tree = flax_variables(trainer._val_model, state.ema_state_dict())
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.cfg, jt.tokenizer, jt.model = trainer.cfg, tok, _jax_crnn()
    jt.val_loader = batches

    class State:
        ema_params, params = tree["params"], None
        model_state = {"batch_stats": tree["batch_stats"]}

    want = jt.validate(State())
    assert got["cer"] == pytest.approx(want["cer"], abs=1e-12) and 0 < got["cer"]
    assert got["fitness"] == pytest.approx(1 - got["cer"])


@pytest.fixture(scope="module")
def ctc_run(tmp_path_factory):
    """A CTCTrainer run on the CPU: 2 epochs of 2 steps over seeded crops
    (augment on, box head), then validation; its run dir on disk."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.tasks.ctc import trainer_for
    from kuzu_torch.testing import SyntheticLineDataset, synthetic_texts

    root = tmp_path_factory.mktemp("run")
    tok = CharTokenizer.train([CHARS])
    train = SyntheticLineDataset(synthetic_texts(8, CHARS, 8, seed=1), tok, CROP, MAXLEN,
                                 max_boxes=BOXES)
    val = SyntheticLineDataset(synthetic_texts(6, CHARS, 8, seed=2), tok, CROP, MAXLEN, seed=1,
                               max_boxes=BOXES)
    cfg = load_config(overrides={**STEP_CFG, "epochs": 2, "batch": 4, "workers": 0,
                                 "project": str(root), "name": "ctc", "exist_ok": True,
                                 "verbose": False})
    trainer = trainer_for((train, val, tok))(cfg, device="cpu")
    final = trainer.train()
    return dict(trainer=trainer, final=final, tok=tok, val=val)


def test_ctc_run_dir_loads_into_the_predictor_and_the_cascade(ctc_run):
    """The run writes args.yaml, tokenizer.json and weights; ``CTCPredictor``
    over the run dir builds the f32 CRNN with the run's EMA weights and
    decodes crops as ``from_model`` over the same weights; the cascade with
    ``recognizer=<run dir>`` gives the texts of the cascade with the
    predictor in memory."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.ctc import CTCPredictor, build_crnn
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.testing import column_pages

    trainer, final = ctc_run["trainer"], ctc_run["final"]
    assert trainer.state.step == 4 and {"loss", "box_loss", "cer", "fitness"} <= set(final)
    assert all(np.isfinite(v) for v in final.values())
    run = trainer.save_dir
    for f in ("args.yaml", "tokenizer.json", "weights/best/state.pt", "weights/last/state.pt"):
        assert (run / f).exists(), f
    crnn = build_crnn(trainer.cfg, len(ctc_run["tok"]))
    crnn.load_state_dict(trainer.state.ema_state_dict())
    mem = CTCPredictor.from_model(crnn, ctc_run["tok"], CROP, device="cpu")
    loaded = CTCPredictor(load_config(overrides={"model": str(run)}), device="cpu")
    crops = torch.from_numpy(np.stack([ctc_run["val"][i]["image"] for i in range(6)]))
    (seqs, lens), boxes = loaded._fwd(crops)
    (mseqs, mlens), mboxes = mem._fwd(crops)
    assert loaded.image_size == CROP and loaded.model.dtype == torch.float32
    assert torch.equal(seqs, mseqs) and torch.equal(lens, mlens) and torch.equal(boxes, mboxes)
    det = DetectPredictor.from_detector(
        YoloDetector("yolov12n", nc=1, imgsz=64, device="cpu").init(0), conf=0.001)
    pages = column_pages(1, 96, seed=0)
    texts = {}
    for label, rec in (("run dir", run), ("memory", mem)):
        pipe = KuzushijiPipeline(column_model=det, char_model=det, recognizer=rec, tile_grid=2,
                                 device="cpu")
        texts[label] = [c["text"] for r in pipe.process_pages(pages) for c in r["columns"]]
        assert pipe.rec_task == "ctc"
    assert len(texts["memory"]) > 0 and texts["run dir"] == texts["memory"]


def test_bigram_tokenizer_matches_jax(tmp_path):
    """``BigramTokenizer.train`` (characters by frequency, then bigrams seen
    twice or more, capped) and its greedy longest-match ``encode`` against
    the JAX package's: the same vocab and ids; save / load round-trips."""
    from kuzu.data.tokenizer import BigramTokenizer as JaxBigram

    from kuzu_torch.data.tokenizer import BigramTokenizer

    texts = ["ＡＢab abab", "abcab", "bcbcx", "くずし字くずし"]
    for kw in ({}, {"min_freq": 1, "max_vocab": 30}):
        j, t = JaxBigram.train(texts, **kw), BigramTokenizer.train(texts, **kw)
        assert t.vocab == j.vocab
        for s in texts + ["zab", "", "くず字"]:
            for ml in (None, 6):
                np.testing.assert_array_equal(t.encode(s, max_length=ml),
                                              j.encode(s, max_length=ml))
    t.save(tmp_path / "tok.json")
    back = BigramTokenizer.load(tmp_path / "tok.json")
    assert back.vocab == t.vocab and isinstance(back, BigramTokenizer)
    np.testing.assert_array_equal(back.encode("abcab"), t.encode("abcab"))
