"""The port's recognizer training against the JAX package on the CPU:
``area_attention_trainable`` (K3 with its row statistics forward, K4
backward: their plain versions here) against JAX's Pallas pair in
interpret mode; one f32 ``RecognizeTrainer`` step against JAX's
``RecognizeTrainer.loss_fn`` under one ``jax.value_and_grad`` and one optax
AdamW update, with scheduled sampling (its replacement draws taken from
JAX's key and handed to the port) and the joint CTC loss on a batch with an
infeasible label of each kind; ``ctc_loss``, ``photometric_aug`` (the same
draws), the corpus CER, and ``graft_lm_decoder`` / ``partial_load``.

Weights come across with ``kuzu_torch.bridge.from_flax``; inputs and draws
are made with numpy or JAX's key and handed to both sides. Tolerances are
stated at each comparison: f32 on both sides is the same arithmetic up to
the order of sums.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import LM_KW, TOKEN_CHARS, TROCR_KW, jax_lm_variables, jax_trocr_variables

t_fa = importlib.import_module("kuzu_torch.ops.flash_attention")

REL = 1e-5  # f32 values: of the largest value of the compared tensor
# one f32 step: scores, softmax, CE and the CTC recursion through 2 + 2
# layers, and the backward through them: the loss terms to 1e-5 relative;
# each gradient leaf to 1e-4 of its largest entry plus 1e-3 of each entry.
# The attention's key biases have gradients that are zero but for rounding
# (a softmax does not see a constant added to a row's scores): a leaf whose
# largest entry is under 1e-6 of the largest gradient is held to that
# absolute term instead.
GRAD_REL, GRAD_ENTRY, GRAD_ZERO = 1e-4, 1e-3, 1e-6
B, T_CTC = 4, 8  # crops; CTC frames (a 128 x 32 crop at patch 16 has 8 rows)
# the texts of the step's batch: a repeat needs a frame more; "abcdefghij"
# (10 > 8 frames) and "aaaaa" (5 + 4 repeats > 8) have no CTC alignment
TEXTS = ["abc", "aabbc", "abcdefghij", "aaaaa"]
STEP_CFG = dict(
    task="recognize", imgsz=[128, 32], patch=16, enc_dim=64, enc_depth=2, enc_heads=2,
    dec_dim=64, dec_depth=2, dec_heads=4, max_label_length=16, ctc_weight=0.3, ss_prob=0.5,
    augment=False, dropout=0.0, dtype="float32", optimizer="adamw", lr0=1e-3,
    weight_decay=0.05, grad_clip=1.0, warmup_epochs=0.0, epochs=1, seed=0)


def _close(got, want, rel=REL) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_area_attention_trainable_matches_jax(dtype):
    """Output and the gradients of q, k, v (separate tensors, as the TrOCR
    encoder's three Dense layers give them) at G=2, N=32, 2 heads of 32,
    against ``jax.vjp`` through JAX's ``area_attention_trainable`` in
    interpret mode. f32: 1e-5 of the largest value; bf16: both sides compute
    in f32 and round once (the port's D from the output in two bf16 parts,
    its P from the forward's lse), held to the kernels' own tolerances
    (``ATTN_TOL`` for the output, ``BWD_TOL`` for each gradient)."""
    from kuzu.ops.flash_attention import area_attention_trainable as jax_trainable

    from kuzu_torch.testing import attention_over, bwd_over

    rng = np.random.default_rng(5)
    g, n, heads, c = 2, 32, 2, 64
    arrs = [rng.normal(0, 1, (g, n, c)).astype(np.float32) for _ in range(4)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrs)
    jout, vjp = jax.vjp(lambda q, k, v: jax_trainable(q, k, v, heads, True), jq, jk, jv)
    jgrads = vjp(jdo)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in arrs[:3])
    before = (t_fa.area_attention.plain_calls, t_fa.area_attention_bwd.plain_calls)
    out = t_fa.area_attention_trainable(tq, tk, tv, heads)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(arrs[3]).to(tdt))
    assert (t_fa.area_attention.plain_calls, t_fa.area_attention_bwd.plain_calls) == (
        before[0] + 1, before[1] + 1)
    pairs = [(out, jout)] + list(zip(grads, jgrads))
    for got, want in pairs:
        assert got.dtype == tdt and tuple(got.shape) == (g, n, c)
    if dtype == "float32":
        for got, want in pairs:
            _close(got.detach().numpy(), want)
        return
    want = [torch.from_numpy(np.asarray(w, np.float32)) for _, w in pairs]
    assert attention_over(out.detach(), want[0])[1] == 0
    for got, w in zip(grads, want[1:]):
        assert bwd_over(got, w)[1] == 0


def _flax_layout(arr: np.ndarray, layout) -> np.ndarray:
    if layout == "conv":
        return arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return arr.T if layout == "dense" else arr


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def rec_step(tmp_path_factory):
    """One f32 step of both trainers from the same weights and batch: JAX's
    ``RecognizeTrainer.loss_fn`` (einsum attention, its CPU route) under
    ``jax.value_and_grad`` and the optax AdamW of ``build_optimizer``; the
    port's ``RecognizeTrainer`` with ``make_train_step``, the encoder's
    attention on the kernel route (``area_attention_trainable``, the
    card's route, its plain versions here), the scheduled-sampling draws
    JAX's."""
    from kuzu.core.config import load_config as j_load_config
    from kuzu.core.train import build_optimizer as j_build_optimizer
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.trocr import TrOCR as JaxTrOCR
    from kuzu.tasks.recognize import RecognizeTrainer as JaxTrainer

    from kuzu_torch.bridge import _targets, from_flax
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.layers import MultiHeadAttention
    from kuzu_torch.tasks.recognize import RecognizeTrainer

    variables = jax_trocr_variables()
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (B, 128, 32, 3), dtype=np.uint8)
    jtok = JaxTokenizer.train([TOKEN_CHARS])
    tokens = np.stack([jtok.encode(t, max_length=16) for t in TEXTS])
    key = jax.random.key(7)
    # the replacement mask's draws: JAX's srng (augment off: no split for it)
    ss = np.asarray(jax.random.uniform(jax.random.split(key, 3)[2], (B, 15)))

    jt = JaxTrainer.__new__(JaxTrainer)
    jt.cfg = j_load_config(overrides=STEP_CFG)
    jt.tokenizer = jtok
    jt.model = JaxTrOCR(**TROCR_KW, ctc_head=True, attn_impl="einsum")
    batch = {"image": jnp.asarray(images), "tokens": jnp.asarray(tokens)}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        variables["params"], batch, key)
    jtx = j_build_optimizer(jt.cfg, 1)
    j_update = jax.jit(lambda g, p: optax.apply_updates(p, jtx.update(g, jtx.init(p), p)[0]))
    jnew = j_update(jgrads, variables["params"])

    cfg = load_config(overrides={**STEP_CFG, "project": str(tmp_path_factory.mktemp("rec")),
                                 "name": "step", "exist_ok": True})
    trainer = RecognizeTrainer(cfg, device="cpu")
    trainer.tokenizer = CharTokenizer.train([TOKEN_CHARS])
    model = from_flax(trainer.build_model(), variables)
    for m in model.encoder.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = "flash_interpret"
    trainer.ss_draws = lambda shape, _rng: torch.from_numpy(ss.copy())
    tx = build_optimizer(cfg, model, steps_per_epoch=1)
    state = TrainState(model, tx, use_ema=True)
    tgrads = {}
    step_inner = tx.step

    def snapshot_then_step(count, grad_norm):  # clipping scales .grad in place
        tgrads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        step_inner(count, grad_norm)

    tx.step = snapshot_then_step
    targets = list(_targets(model))  # before the step: the initial weights' paths
    before = t_fa.area_attention_bwd.plain_calls
    tbatch = {"image": torch.from_numpy(images), "tokens": torch.from_numpy(tokens)}
    tmetrics = make_train_step(trainer.loss_fn, tx)(state, tbatch, torch.Generator())
    names = {id(p): n for n, p in model.named_parameters()}
    # optax's update (JAX's chain) of the port's own gradients
    ported = {}
    for path, tensor, layout in targets:
        node = ported
        for key_ in path[1:-1]:
            node = node.setdefault(key_, {})
        node[path[-1]] = jnp.asarray(_flax_layout(tgrads[names[id(tensor)]].numpy(), layout))
    optax_new = j_update(ported, variables["params"])
    return dict(jloss=float(jloss), optax_new=jax.tree.map(np.asarray, optax_new),
                jparams=variables["params"], jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=jax.tree.map(np.asarray, jgrads), jnew=jax.tree.map(np.asarray, jnew),
                tmetrics={k: float(v) for k, v in tmetrics.items()}, tgrads=tgrads,
                targets=targets, names=names, model=model, trainer=trainer,
                images=images, tokens=tokens, ss=ss,
                bwd_calls=t_fa.area_attention_bwd.plain_calls - before,
                jnorm=float(optax.global_norm(jgrads)))


def test_recognize_step_loss_and_metrics_match(rec_step):
    """Loss, token accuracy, the CTC term (the infeasible rows masked on
    both sides) and the gradient norm: 1e-5 relative; the encoder's two
    layers took K4's plain version once each."""
    tm, jm = rec_step["tmetrics"], rec_step["jmetrics"]
    assert rec_step["bwd_calls"] == 2
    np.testing.assert_allclose(tm["loss"], rec_step["jloss"], rtol=1e-5)
    np.testing.assert_allclose(tm["token_acc"], jm["token_acc"], rtol=1e-6)
    np.testing.assert_allclose(tm["ctc_loss"], jm["ctc_loss"], rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"], rec_step["jnorm"], rtol=1e-5)
    assert tm["grad_norm"] > STEP_CFG["grad_clip"]  # the clip is active
    assert 0 < tm["token_acc"] < 1 and np.isfinite(tm["ctc_loss"])


def test_scheduled_sampling_is_decided_with_margins(rec_step):
    """The replaced inputs are the model's own argmax predictions: each
    leads its runner-up by far more than the logits' tolerance, so both
    sides replace with the same tokens (and some positions are replaced)."""
    model, ss, tokens = rec_step["model"], rec_step["ss"], rec_step["tokens"]
    inputs = torch.from_numpy(tokens[:, :-1]).long()
    with torch.no_grad():
        logits = model.decode_tokens(inputs, model.encode(torch.from_numpy(rec_step["images"])),
                                     train=False)
    replace = (ss < STEP_CFG["ss_prob"]) & (np.arange(15)[None] > 0) & (tokens[:, :-1] != 0)
    top2 = logits.topk(2, dim=-1).values.numpy()
    margin = (top2[..., 0] - top2[..., 1])[:, :-1][replace[:, 1:]].min()
    assert replace.sum() > 5
    assert margin > 100 * REL * np.abs(logits.numpy()).max(), margin


def _rounding_only(step: dict) -> set:
    """Paths of the leaves whose gradient is zero but for rounding."""
    top = max(np.abs(g).max() for g in jax.tree.leaves(step["jgrads"]))
    return {path for path, _, _ in step["targets"]
            if np.abs(_leaf(step["jgrads"], path[1:])).max() < GRAD_ZERO * top}


def test_recognize_step_every_gradient_matches(rec_step):
    """Every parameter's gradient, mapped through the bridge's layouts."""
    top = max(np.abs(g).max() for g in jax.tree.leaves(rec_step["jgrads"]))
    zero = _rounding_only(rec_step)
    assert {p[-2] for p in zero} <= {"k"}  # key biases only
    n = 0
    for path, tensor, layout in rec_step["targets"]:
        got = _flax_layout(rec_step["tgrads"][rec_step["names"][id(tensor)]].numpy(), layout)
        want = _leaf(rec_step["jgrads"], path[1:])
        atol = GRAD_ZERO * top if path in zero else GRAD_REL * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0 if path in zero else GRAD_ENTRY,
                                   atol=atol, err_msg="/".join(path))
        n += 1
    assert n == len(rec_step["tgrads"])


def _decided(step: dict, path, layout) -> np.ndarray:
    """Where Adam's first step has a direction: the clipped gradient plus
    the decay term (kernels only), |g| >= 1e-4. Its step is lr g / (|g| +
    1e-8), whose derivative in g is lr 1e-8 / (|g| + 1e-8)^2: under 1e-4 an
    f32 rounding of g (the decay term cancelling the gradient) can swing it
    by up to 2 lr."""
    factor = min(1.0, STEP_CFG["grad_clip"] / step["jnorm"])
    p0 = _leaf(step["jparams"], path[1:])
    g = _leaf(step["jgrads"], path[1:]) * factor
    if p0.ndim >= 2:
        g = g + STEP_CFG["weight_decay"] * p0
    return np.abs(g) >= 1e-4


def test_recognize_step_adamw_update_matches(rec_step):
    """The weights after clipping, weight decay on the kernels and Adam's
    first step, against optax's chain (``kuzu.core.train.build_optimizer``)
    applied to the port's own gradients and against JAX's whole step:
    where the step has a direction (:func:`_decided`, 98% of the entries
    here) 1e-5 of the lr plus 1e-6 of each weight, elsewhere within 2 lr."""
    lr, undecided, total = STEP_CFG["lr0"], 0, 0
    for path, tensor, layout in rec_step["targets"]:
        got = _flax_layout(tensor.detach().numpy(), layout)
        ok = _decided(rec_step, path, layout)
        undecided += int((~ok).sum())
        total += ok.size
        for ref in ("optax_new", "jnew"):
            want = _leaf(rec_step[ref], path[1:])
            np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=1e-5 * lr,
                                       err_msg=f"{ref} {'/'.join(path)}")
            assert np.abs(got - want).max() <= 2 * lr * (1 + 1e-6)
    assert undecided < 0.05 * total, undecided


def test_ctc_loss_matches_jax():
    """``ctc_loss`` (``F.ctc_loss`` after a log-softmax) against
    ``kuzu/ops/ctc.py::ctc_loss`` (its ``lax.scan``) per sample and in mean
    reduction, with the gradient of the feasible rows' sum: 1e-5 relative.
    A label with no alignment in T frames gives 0 and a zero gradient here
    (JAX: ~1e30), which callers mask."""
    from kuzu.ops.ctc import ctc_loss as jax_ctc

    from kuzu_torch.ops.ctc import ctc_loss

    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (4, 8, 7)).astype(np.float32)
    labels = np.array([[1, 2, 3, 0, 0, 0], [4, 4, 5, 0, 0, 0], [2, 0, 0, 0, 0, 0],
                       [3, 3, 3, 3, 3, 0]], np.int32)
    lens = np.array([3, 3, 1, 5], np.int32)  # row 3: 5 + 4 repeats > 8 frames
    feasible = np.array([1, 1, 1, 0], np.float32)
    t_len = np.full((4,), 8, np.int32)

    def jfn(lg):
        per = jax_ctc(lg, labels, t_len, lens, reduction="none")
        return (per * feasible).sum(), per

    (_, jper), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(logits))
    jmean = jax_ctc(jnp.asarray(logits[:3]), labels[:3], t_len[:3], lens[:3])
    tl = torch.from_numpy(logits).requires_grad_()
    per = ctc_loss(tl, torch.from_numpy(labels), torch.from_numpy(t_len), torch.from_numpy(lens),
                   reduction="none")
    (tgrad,) = torch.autograd.grad((per * torch.from_numpy(feasible)).sum(), tl)
    np.testing.assert_allclose(per.detach().numpy()[:3], np.asarray(jper)[:3], rtol=1e-5)
    assert float(per[3].detach()) == 0.0 and np.asarray(jper)[3] > 1e6
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-6)
    tmean = ctc_loss(tl[:3], torch.from_numpy(labels[:3]), torch.from_numpy(t_len[:3]),
                     torch.from_numpy(lens[:3]))
    np.testing.assert_allclose(float(tmean.detach()), float(jmean), rtol=1e-5)


def test_photometric_aug_matches_jax_on_the_same_draws():
    """JAX's ``photometric_aug`` with a key, and the port's arithmetic on
    the draws that key gives (contrast, brightness, noise, split as JAX
    splits it): 1e-6 absolute on [0, 1] pixels; the port's generator draws
    land in the same ranges."""
    from kuzu.ops.images import photometric_aug as jax_aug

    from kuzu_torch.ops.images import from_uint8, photometric_draws, photometric_from_draws

    x = np.random.default_rng(4).integers(0, 256, (3, 16, 8, 3), dtype=np.uint8)
    xf = np.asarray(x, np.float32) / 255.0
    key = jax.random.key(3)
    want = np.asarray(jax_aug(jnp.asarray(xf), key))
    k1, k2, k3 = jax.random.split(key, 3)
    shp = (3, 1, 1, 1)
    c = jax.random.uniform(k1, shp, jnp.float32, 0.85, 1.15)
    t = jax.random.uniform(k2, shp, jnp.float32, -0.12, 0.12)
    n = jax.random.normal(k3, xf.shape, jnp.float32) * 0.04
    xt = from_uint8(torch.from_numpy(x))
    got = photometric_from_draws(xt, *(torch.from_numpy(np.array(a)) for a in (c, t, n)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    c, t, n = photometric_draws(xt, torch.Generator().manual_seed(0))
    assert c.shape == shp and bool(((c >= 0.85) & (c < 1.15)).all())
    assert bool(((t >= -0.12) & (t < 0.12)).all()) and n.shape == xt.shape
    assert 0.03 < float(n.std()) < 0.05


def test_character_error_rate_matches_jax():
    from kuzu.core.metrics import character_error_rate as jax_cer
    from kuzu.core.metrics import levenshtein as jax_lev

    from kuzu_torch.core.metrics import character_error_rate, levenshtein

    preds, refs = ["abc", "", "kitten", "abd"], ["abd", "xy", "sitting", ""]
    assert character_error_rate(preds, refs) == jax_cer(preds, refs)
    assert [levenshtein(p, r) for p, r in zip(preds, refs)] == [
        jax_lev(p, r) for p, r in zip(preds, refs)]


def test_graft_lm_decoder_matches_jax():
    """JAX's ``graft_lm_decoder`` on the tiny TrOCR and CharMLM of
    ``torch_parity`` (the LM's widths are the decoder's; its positions
    differ, so pos_embed does not graft) and the port's on the same weights:
    the same ``(n_loaded, n_total)`` and, after the graft, the same decoder
    tensors; ``partial_load`` skips a shape mismatch and counts as JAX's."""
    from kuzu.core.checkpoint import partial_load as jax_partial_load
    from kuzu.models.trocr import graft_lm_decoder as jax_graft

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.core.checkpoint import partial_load
    from kuzu_torch.models.lm import CharMLM
    from kuzu_torch.models.trocr import TrOCR, graft_lm_decoder

    trocr, lm = jax_trocr_variables(), jax_lm_variables(seed=1)
    jparams, jn, jtotal = jax_graft(trocr["params"], lm["params"])
    model = from_flax(TrOCR(**TROCR_KW, ctc_head=True), trocr)
    port_lm = from_flax(CharMLM(**LM_KW), lm)
    sd, n, total = graft_lm_decoder(model.decoder.state_dict(), port_lm.state_dict())
    assert (n, total) == (jn, jtotal) and 0 < n < total
    model.decoder.load_state_dict(sd)
    want = from_flax(TrOCR(**TROCR_KW, ctc_head=True), {"params": jparams})
    for (name, got), (_, ref) in zip(model.state_dict().items(), want.state_dict().items()):
        np.testing.assert_array_equal(got.numpy(), ref.numpy(), err_msg=name)
    np.testing.assert_array_equal(model.decoder.embed.weight.detach().numpy(),
                                  lm["params"]["embed"]["embedding"])
    src = {"a": np.ones((2, 3), np.float32), "b": np.ones((4,), np.float32)}
    tgt = {"a": np.zeros((2, 3), np.float32), "b": np.zeros((5,), np.float32),
           "c": np.zeros((1,), np.float32)}
    _, jn, jt = jax_partial_load(tgt, src, verbose=False)
    out, n, t = partial_load({k: torch.from_numpy(v) for k, v in tgt.items()},
                             {k: torch.from_numpy(v) for k, v in src.items()})
    assert (n, t) == (jn, jt) == (1, 3)
    assert float(out["a"].sum()) == 6.0 and float(out["b"].sum()) == 0.0


def test_detect_pretrained_graft_matches_jax_counts(tmp_path):
    """``DetectTrainer``'s ``pretrained=`` (a port weights dir) grafts the
    source's live parameters by name and shape through ``partial_load``:
    yolov12n nc=1 onto yolov12n nc=2 loads every tensor but the class
    convs', the same ``(n, total)`` as JAX's ``partial_load`` over the two
    graphs' flax params; the BatchNorm statistics stay the target's."""
    from kuzu.core.checkpoint import partial_load as jax_partial_load

    from kuzu_torch.core.checkpoint import CheckpointManager
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer
    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec
    from kuzu_torch.tasks.detect import DetectTrainer
    from torch_parity import flax_variables

    path, scale = resolve_model_spec("yolov12n")
    src = YoloGraph(parse_model_yaml(path, scale=scale, nc=1))
    src.reset_parameters(torch.Generator().manual_seed(5))
    cfg = load_config(overrides={"project": str(tmp_path), "name": "src"})
    CheckpointManager(tmp_path / "src_weights").save(
        TrainState(src, build_optimizer(cfg, src)), fitness=1.0)
    cfg = load_config(overrides={"project": str(tmp_path), "name": "dst", "model": "yolov12n",
                                 "imgsz": 64, "pretrained": str(tmp_path / "src_weights")})
    trainer = DetectTrainer(cfg, device="cpu")
    trainer.data_spec = {"nc": 2, "names": {0: "a", 1: "b"}}
    graph = trainer.build_model()
    fresh = YoloGraph(parse_model_yaml(path, scale=scale, nc=2))
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    _, jn, jtotal = jax_partial_load(flax_variables(fresh)["params"],
                                     flax_variables(src)["params"], verbose=False)
    srcp = dict(src.named_parameters())
    same = sum(torch.equal(p, srcp[n]) for n, p in graph.named_parameters()
               if n in srcp and srcp[n].shape == p.shape)
    assert same == jn and 0 < jn < jtotal == len(list(graph.parameters()))
    for (name, got), want in zip(graph.named_buffers(), fresh.buffers()):
        assert torch.equal(got, want), name
