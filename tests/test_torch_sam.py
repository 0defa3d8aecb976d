"""The SAM family in the port against the JAX package on the CPU: SAM-lite
at 64 px, dim 32, a 2-layer ViT encoder with 2 heads, 2 decoder heads,
3 masks; the TinyViT encoder at its default widths on 64 px (every stride-2
convolution over an even size, where flax's ``'SAME'`` pads (0, 1)).

- modules: flax's ``ConvTranspose`` against the bridge's flipped
  ``ConvTranspose2d`` (an asymmetric kernel), ``FourierPE``,
  ``PromptEncoder``, ``TwoWayBlock``, ``MaskDecoder`` (and its
  ``return_tokens``), both image encoders and the whole ``SAM`` in f32
  within 1e-5 of the largest entry, the JAX weights loaded through
  ``bridge.from_flax``;
- the kernel route on the CPU's plain versions: ``attn_impl="flash_train"``
  forward and backward against einsum;
- the task: ``SAMPromptDataset`` sample for sample equal to JAX's; one f32
  ``SAMTrainer`` step against JAX's loss under ``value_and_grad`` and
  optax's AdamW (loss, metrics, every gradient, the weights after the
  update with ``gauss``'s decay); the validation's ``miou``;
  ``SAMPredictor.__call__`` and ``everything`` over a run dir the port
  trained (through ``Model(task="sam").train``) against JAX's predictor on
  the same weights;
- FastSAM: ``adjust_boxes_to_border``, and ``prompt`` on the same segment
  results, JAX's and the port's selections identical; the facade resolves
  ``sam`` and ``fastsam`` to the port's classes.

JAX functions are jitted once each and shared between cases.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import flax_variables, numpy_tree

SAM_KW = dict(img_size=64, dim=32, enc_depth=2, enc_heads=2, dec_heads=2, num_masks=3)
REL = 1e-5
TRAIN_CFG = dict(task="sam", imgsz=64, dim=32, enc_depth=2, enc_heads=2, num_masks=3,
                 dtype="float32", optimizer="adamw", lr0=3e-4, weight_decay=0.0005,
                 grad_clip=10.0, warmup_epochs=0.0, epochs=1, seed=0, augment=False)
LOGIT_MARGIN = 1e-4  # predictor masks may differ only where |logit| < this


def _close(got, want, rel=REL, what="") -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _grad_close(got, want, top: float, what: str) -> None:
    """A gradient leaf within 1e-4 of its largest entry; an attention key
    bias (its true gradient is zero: the softmax does not see a shift of
    all scores) within 1e-6 of the largest gradient entry of the model."""
    if what.endswith(("k.bias", "k/bias")):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6 * top,
                                   err_msg=what)
    else:
        _close(got, want, rel=1e-4, what=what)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _init(kind: str):
    """(JAX SAM, its variables as numpy, port SAM with them)."""
    from kuzu.models.sam import PAD
    from kuzu.models.sam import SAM as JaxSAM

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.sam import SAM

    jm = JaxSAM(**SAM_KW, encoder_kind=kind)
    v = numpy_tree(jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, 64, 64, 3), jnp.float32), jnp.zeros((1, 4, 2), jnp.float32),
        jnp.full((1, 4), PAD, jnp.int32)))(jax.random.key(0 if kind == "vit" else 1)))
    return jm, v, from_flax(SAM(**SAM_KW, encoder_kind=kind), v).eval()


@pytest.fixture(scope="module")
def vit():
    return _init("vit")


@pytest.fixture(scope="module")
def tiny():
    return _init("tiny")


def _prompts(n: int = 3, seed: int = 4):
    """(points (n, 4, 2) in [0, 1], labels covering every kind)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 4, 2)).astype(np.float32)
    lbl = np.array([[1, 2, 3, -1], [0, 1, -1, -1], [2, 3, 0, 1]], np.int32)[:n]
    return pts, lbl


def _images(n: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)


def test_conv_transpose_flip_matches_flax():
    """flax's ConvTranspose does not flip its kernel: on [[0, 1], [2, 3]]
    and a one-hot pixel it writes [[3, 2], [1, 0]]; the bridge's flipped
    ConvTranspose2d gives the same, and agrees on a random asymmetric
    multi-channel kernel."""
    from flax import linen as fnn

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.sam import conv_transpose_2x

    one = fnn.ConvTranspose(1, (2, 2), strides=(2, 2))
    v = {"params": {"kernel": np.arange(4, dtype=np.float32).reshape(2, 2, 1, 1),
                    "bias": np.zeros(1, np.float32)}}
    x = np.ones((1, 1, 1, 1), np.float32)
    want = np.asarray(one.apply(v, jnp.asarray(x)))[0, :, :, 0]
    np.testing.assert_array_equal(want, [[3, 2], [1, 0]])
    m = from_flax(torch.nn.ConvTranspose2d(1, 1, 2, stride=2), v)
    np.testing.assert_array_equal(conv_transpose_2x(m, _t(x), torch.float32)[0, :, :, 0]
                                  .detach().numpy(), want)
    mod = fnn.ConvTranspose(5, (2, 2), strides=(2, 2))
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 6)).astype(np.float32)
    v = numpy_tree(mod.init(jax.random.key(0), jnp.asarray(x)))
    v["params"]["bias"] = np.linspace(-1, 1, 5).astype(np.float32)
    m = from_flax(torch.nn.ConvTranspose2d(6, 5, 2, stride=2), v)
    _close(conv_transpose_2x(m, _t(x), torch.float32).detach(), mod.apply(v, jnp.asarray(x)),
           what="ConvTranspose")
    # and the inverse bridge gives flax's kernel back
    back = flax_variables(m)["params"]["kernel"]
    np.testing.assert_array_equal(back, v["params"]["kernel"])


def test_prompt_encoder_matches_jax(vit):
    """``FourierPE`` and ``PromptEncoder`` (every label kind) within 1e-5;
    ``box_to_prompt`` exact."""
    from kuzu.models.sam import FourierPE as JaxFourierPE

    jm, v, port = vit
    pts, lbl = _prompts()
    jtok = jax.jit(lambda v, p, l: jm.apply(
        v, p, l, method=lambda m, p, l: m.prompt_encoder(p, l)))(v, pts, lbl)
    pe = v["params"]["prompt_encoder"]["pe"]
    jpe = jax.jit(lambda p, x: JaxFourierPE(32).apply({"params": p}, x))(pe, pts)
    with torch.no_grad():
        _close(port.prompt_encoder.pe(_t(pts)), jpe, what="FourierPE")
        _close(port.prompt_encoder(_t(pts), _t(lbl)), jtok, what="PromptEncoder")
    from kuzu.models.sam import box_to_prompt as j_box

    from kuzu_torch.models.sam import box_to_prompt

    boxes = np.array([[3, 5, 40, 60], [10.5, 0, 64, 33]], np.float32)
    for got, want in zip(box_to_prompt(boxes, 64), j_box(boxes, 64)):
        np.testing.assert_array_equal(got, want)


def test_two_way_block_and_mask_decoder_match_jax(vit):
    """Block 0 and block 1 (the skipped first PE and the full one) and the
    whole decoder, with ``return_tokens`` as SAM2 calls it."""
    from kuzu.models.sam import MaskDecoder as JaxDecoder
    from kuzu.models.sam import TwoWayBlock as JaxBlock

    jm, v, port = vit
    rng = np.random.default_rng(6)
    tokens = rng.normal(size=(3, 7, 32)).astype(np.float32)
    tok_pe = rng.normal(size=(3, 7, 32)).astype(np.float32)
    img = rng.normal(size=(3, 16, 32)).astype(np.float32)
    img_pe = rng.normal(size=(1, 16, 32)).astype(np.float32)
    prompts = rng.normal(size=(3, 4, 32)).astype(np.float32)

    pd = v["params"]["decoder"]

    def jfn(pd, tokens, img, tok_pe, img_pe, prompts):
        blocks = [JaxBlock(2, skip_first_pe=(i == 0)).apply({"params": pd[f"block{i}"]},
                                                            tokens, img, tok_pe, img_pe)
                  for i in range(2)]
        dec = JaxDecoder(32, 2, num_masks=3, return_tokens=True)
        return blocks, dec.apply({"params": pd}, img, img_pe, prompts, (4, 4))

    (b0, b1), (jmask, jiou, jtoks) = jax.jit(jfn)(pd, tokens, img, tok_pe, img_pe, prompts)
    dec = port.decoder
    with torch.no_grad():
        for i, want in enumerate((b0, b1)):
            got = getattr(dec, f"block{i}")(_t(tokens), _t(img), _t(tok_pe), _t(img_pe))
            _close(got[0], want[0], what=f"block{i} tokens")
            _close(got[1], want[1], what=f"block{i} img")
        mask, iou = dec(_t(img), _t(img_pe), _t(prompts), (4, 4))
        assert mask.shape == (3, 3, 16, 16) and mask.dtype == iou.dtype == torch.float32
        _close(mask, jmask, what="masks")
        _close(iou, jiou, what="iou")
        dec.return_tokens = True
        try:
            _, _, toks = dec(_t(img), _t(img_pe), _t(prompts), (4, 4))
        finally:
            dec.return_tokens = False
        _close(toks, jtoks, what="mask tokens")


@pytest.mark.parametrize("kind", ["vit", "tiny"])
def test_image_encoder_and_sam_match_jax(kind, vit, tiny):
    """The encoder's memory and the whole SAM (masks, IoU) in f32: 1e-5."""
    jm, v, port = vit if kind == "vit" else tiny
    imgs = _images(3)
    pts, lbl = _prompts()
    jmem, (jmask, jiou) = jax.jit(lambda v, x, p, l: (jm.apply(v, x, method=jm.encode),
                                                      jm.apply(v, x, p, l)))(v, imgs, pts, lbl)
    with torch.no_grad():
        mem = port.encode(_t(imgs))
        mask, iou = port(_t(imgs), _t(pts), _t(lbl))
    assert mem.shape == (3, 16, 32)
    _close(mem, jmem, what=f"{kind} memory")
    _close(mask, jmask, what=f"{kind} masks")
    _close(iou, jiou, what=f"{kind} iou")


def test_tiny_encoder_pads_as_flax_same():
    """The stride-2 convolutions over even sizes pad (0, 1) as flax's
    'SAME': with torch's (1, 1) the stem's output would differ."""
    from kuzu_torch.models.tiny_encoder import same_pad, window_merge, window_partition

    assert same_pad(64, 3, 2) == (0, 1) and same_pad(65, 3, 2) == (1, 1)
    assert same_pad(16, 3, 1) == (1, 1) and same_pad(16, 1, 1) == (0, 0)
    x = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)
    assert torch.equal(window_merge(window_partition(x, 4), 4, (8, 8)), x)


def test_flash_train_route_matches_einsum():
    """SAM's encoder on the kernel route (``flash_train``: K3 with its row
    statistics and K4, their plain versions on the CPU) against einsum:
    masks, IoU and every gradient of a loss through them."""
    import importlib

    from kuzu_torch.models.sam import SAM, init_sam_

    t_fa = importlib.import_module("kuzu_torch.ops.flash_attention")

    ref = init_sam_(SAM(**SAM_KW), torch.Generator().manual_seed(3))
    fl = SAM(**SAM_KW, attn_impl="flash_train")
    fl.load_state_dict(ref.state_dict())
    imgs, (pts, lbl) = _t(_images(2)), _prompts(2)
    out = {}
    before = (t_fa.area_attention.plain_calls, t_fa.area_attention_bwd.plain_calls)
    for name, m in (("einsum", ref), ("flash", fl)):
        mask, iou = m(imgs, _t(pts), _t(lbl), train=True)
        ((mask * torch.cos(mask)).mean() + iou.square().sum()).backward()
        out[name] = (mask.detach(), iou.detach(), {n: p.grad for n, p in m.named_parameters()})
    assert (t_fa.area_attention.plain_calls - before[0],
            t_fa.area_attention_bwd.plain_calls - before[1]) == (2, 2)  # K3 + K4 a layer
    for i in range(2):
        _close(out["flash"][i], out["einsum"][i], what=f"output {i}")
    top = max(float(g.abs().max()) for g in out["einsum"][2].values())
    for n, g in out["einsum"][2].items():
        _grad_close(out["flash"][2][n], g, top, n)


@pytest.fixture(scope="module")
def seg_folder(tmp_path_factory):
    from kuzu_torch.testing import write_head_folder

    return write_head_folder(tmp_path_factory.mktemp("samds"), "segment",
                             {"train": 6, "val": 3}, hw=(90, 120), nc=1, seed=7)


def test_prompt_dataset_matches_jax(seg_folder):
    """Every sample of both splits (the training split augmented, two
    epochs): image, prompt, mask and ``has_instance`` identical."""
    from kuzu.data.yolo_dataset import load_dataset_yaml as j_yaml
    from kuzu.tasks.sam import SAMPromptDataset as JaxDataset

    from kuzu_torch.data.yolo_dataset import load_dataset_yaml
    from kuzu_torch.tasks.sam import SAMPromptDataset

    boxes = 0
    for split, augment in (("train", True), ("val", False)):
        port = SAMPromptDataset(load_dataset_yaml(seg_folder), split, 64, seed=3, augment=augment)
        ref = JaxDataset(j_yaml(seg_folder), split, 64, seed=3, augment=augment)
        for epoch in (0, 1) if augment else (0,):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in range(len(ref)):
                got, want = port[i], ref[i]
                assert set(got) == set(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split} {i} {k}")
                assert want["labels"][0] == 1 and want["mask"].any()
                boxes += int(want["labels"][1] == 2)
    assert 0 < boxes < 15  # both prompt kinds occur


@pytest.mark.parametrize("src,dst", [((5, 7), (3, 4)), ((16, 16), (24, 20))])
def test_resize_gt_matches_jax_nearest(src, dst):
    """The loss's GT resize where the grids differ: JAX's ``nearest``
    samples at half-pixel centres, as torch's ``nearest-exact`` (torch's
    ``nearest`` does not)."""
    from kuzu_torch.tasks.sam import resize_gt

    gt = (np.random.default_rng(9).random((2, *src)) > 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(gt), (2, *dst), method="nearest"))
    np.testing.assert_array_equal(resize_gt(_t(gt), dst).numpy(), want)


def _batch(seg_folder) -> dict:
    """Four training samples; the last one's instance removed (no prompt,
    empty mask, ``has_instance`` 0)."""
    from kuzu_torch.data.yolo_dataset import load_dataset_yaml
    from kuzu_torch.tasks.sam import PAD, SAMPromptDataset

    ds = SAMPromptDataset(load_dataset_yaml(seg_folder), "train", 64, seed=1)
    samples = [ds[i] for i in range(4)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    batch["labels"][3], batch["points"][3], batch["mask"][3] = PAD, 0.0, 0.0
    batch["has_instance"][3] = 0.0
    return batch


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _flax_layout(arr: np.ndarray, layout) -> np.ndarray:
    if layout == "conv":
        return arr.transpose(2, 3, 1, 0)
    if layout == "conv_transpose":
        return arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    return arr.T if layout == "dense" else arr


@pytest.fixture(scope="module")
def sam_step(vit, seg_folder, tmp_path_factory):
    """One f32 step of both trainers from the JAX init and the same batch:
    JAX's ``SAMTrainer.loss_fn`` under ``value_and_grad`` and the AdamW of
    ``build_optimizer``; the port's through ``make_train_step``."""
    from kuzu.core.config import load_config as j_config
    from kuzu.core.train import build_optimizer as j_optimizer
    from kuzu.models.sam import SAM as JaxSAM
    from kuzu.tasks.sam import SAMTrainer as JaxTrainer

    from kuzu_torch.bridge import _targets, from_flax
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.models.sam import SAM
    from kuzu_torch.tasks.sam import SAMTrainer

    _, v, _ = vit
    batch = _batch(seg_folder)
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.cfg = j_config(overrides=TRAIN_CFG)
    jt.model = JaxSAM(**SAM_KW)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))(
        v["params"], {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.key(0))
    jtx = j_optimizer(jt.cfg, 1)
    jnew = jax.jit(lambda g, p: optax.apply_updates(p, jtx.update(g, jtx.init(p), p)[0]))(
        jgrads, v["params"])

    cfg = load_config(overrides={**TRAIN_CFG, "project": str(tmp_path_factory.mktemp("sam")),
                                 "name": "step", "exist_ok": True})
    trainer = SAMTrainer(cfg, device="cpu")
    model = from_flax(SAM(**SAM_KW), v)
    tx = build_optimizer(cfg, model, steps_per_epoch=1)
    state = TrainState(model, tx, use_ema=True)
    grads, inner = {}, tx.step

    def snapshot_then_step(count, grad_norm):  # clipping scales .grad in place
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        inner(count, grad_norm)

    tx.step = snapshot_then_step
    targets = list(_targets(model))
    tmetrics = make_train_step(trainer.loss_fn, tx)(state, {k: _t(a) for k, a in batch.items()},
                                                     torch.Generator())
    return SimpleNamespace(
        jloss=float(jloss), jmetrics={k: float(a) for k, a in jmetrics.items()},
        jgrads=jax.tree.map(np.asarray, jgrads), jnew=jax.tree.map(np.asarray, jnew),
        jparams=v["params"], jnorm=float(optax.global_norm(jgrads)),
        tmetrics={k: float(a) for k, a in tmetrics.items()}, grads=grads, targets=targets,
        names={id(p): n for n, p in model.named_parameters()}, model=model, trainer=trainer)


def test_sam_step_loss_and_gradients_match(sam_step):
    """Loss, its two terms and ``best_iou`` (1e-5 relative), the gradient
    norm, and every gradient leaf (``_grad_close``; ``gauss`` zero on both
    sides, as ``stop_gradient`` makes it)."""
    s = sam_step
    np.testing.assert_allclose(s.tmetrics["loss"], s.jloss, rtol=REL)
    for k in ("mask_loss", "iou_loss", "best_iou"):
        np.testing.assert_allclose(s.tmetrics[k], s.jmetrics[k], rtol=REL, err_msg=k)
    np.testing.assert_allclose(s.tmetrics["grad_norm"], s.jnorm, rtol=REL)
    n = 0
    top = max(np.abs(g).max() for g in jax.tree.leaves(s.jgrads))
    for path, tensor, layout in s.targets:
        got = _flax_layout(s.grads[s.names[id(tensor)]].numpy(), layout)
        want = _leaf(s.jgrads, path[1:])
        if path[-1] == "gauss":
            assert not got.any() and not want.any()
        else:
            _grad_close(got, want, top, "/".join(path))
        n += 1
    assert n == len(s.grads)


def test_sam_step_adamw_update_matches(sam_step):
    """The weights after AdamW's first step (decay on the 2-d leaves, the
    zero-gradient ``gauss`` among them): where the step has a direction
    (|clipped g + decay| >= 1e-4) within 1e-5 of the lr plus 1e-6 of the
    weight, elsewhere within 2 lr; ``gauss`` moved on both sides."""
    s = sam_step
    lr, wd = TRAIN_CFG["lr0"], TRAIN_CFG["weight_decay"]
    factor = min(1.0, TRAIN_CFG["grad_clip"] / s.jnorm)
    for path, tensor, layout in s.targets:
        got = _flax_layout(tensor.detach().numpy(), layout)
        p0 = _leaf(s.jparams, path[1:])
        g = _leaf(s.jgrads, path[1:]) * factor + (wd * p0 if p0.ndim >= 2 else 0.0)
        ok = np.abs(g) >= 1e-4
        want = _leaf(s.jnew, path[1:])
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=1e-5 * lr,
                                   err_msg="/".join(path))
        assert np.abs(got - want).max() <= 2 * lr * (1 + 1e-6)
        if path[-1] == "gauss":
            assert ok.mean() > 0.5 and np.abs(got - p0)[ok].min() > 0.5 * lr


@pytest.fixture(scope="module")
def sam_run(seg_folder, tmp_path_factory):
    """A port run dir trained through ``Model(task="sam").train`` on the
    folder (f32, 64 px, 3 steps and a validation)."""
    from kuzu_torch.api.model import Model

    root = tmp_path_factory.mktemp("samrun")
    m = Model("sam-lite", task="sam", device="cpu")
    final = m.train(data=str(seg_folder), imgsz=64, dim=32, enc_depth=2, enc_heads=2,
                    dtype="float32", batch=2, epochs=1, workers=0, project=str(root),
                    name="run", exist_ok=True)
    return m._trainer, final


def test_validate_matches_jax(sam_step, seg_folder):
    """The validation's ``miou`` over the val split (padded last batch) on
    the step's EMA weights against JAX's ``validate``."""
    from kuzu.core.config import load_config as j_config
    from kuzu.data.loader import DataLoader as JaxLoader
    from kuzu.data.yolo_dataset import load_dataset_yaml as j_yaml
    from kuzu.models.sam import SAM as JaxSAM
    from kuzu.tasks.sam import SAMPromptDataset as JaxDataset
    from kuzu.tasks.sam import SAMTrainer as JaxTrainer

    from kuzu_torch.models.sam import SAM

    s = sam_step
    t = s.trainer
    t.build_datasets = type(t).build_datasets.__get__(t)
    cfg = t.cfg
    cfg.data, cfg.batch, cfg.workers = str(seg_folder), 2, 0
    _, t.val_loader = t.build_datasets()
    t._val_model = SAM(**SAM_KW).eval()
    state = SimpleNamespace(ema_state_dict=lambda: {n: s.model.state_dict()[n]
                                                    for n in s.model.state_dict()})
    got = t.validate(state)
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.cfg = j_config(overrides={**TRAIN_CFG, "data": str(seg_folder)})
    jt.model = JaxSAM(**SAM_KW)
    jt.val_loader = JaxLoader(JaxDataset(j_yaml(seg_folder), "val", 64), 2, shuffle=False,
                              pad_last=True, num_workers=0)
    params = flax_variables(s.model, collections=("params",))["params"]
    want = jt.validate(SimpleNamespace(ema_params=None, params=params))
    assert 0 < want["miou"] < 1
    np.testing.assert_allclose(got["miou"], want["miou"], rtol=1e-6)
    assert got["fitness"] == got["miou"]


def test_predictor_matches_jax(sam_run, seg_folder, monkeypatch):
    """``SAMPredictor`` over the trained run dir against JAX's predictor on
    the same (EMA) weights: point (foreground and background) and box
    prompts, and ``everything`` on a 4 x 4 grid with no quality floor:
    IoU predictions within 1e-5, masks identical but where the logit lies
    within LOGIT_MARGIN of 0."""
    import kuzu.tasks.sam as jsam

    from kuzu_torch.api.model import Model
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.sam import SAMPredictor

    trainer, final = sam_run
    assert np.isfinite(final["loss"]) and "miou" in final
    run_dir = trainer.save_dir
    assert Model(str(run_dir))._component("predictor") is SAMPredictor
    tp = SAMPredictor(load_config(overrides=dict(model=str(run_dir))), device="cpu")
    tp._setup()
    seen = []  # the port's chosen masks' logits, a prompt set each
    decode = tp.decode

    def recording(*a):
        logits, iou = decode(*a)
        seen.append(logits[np.arange(len(iou)), iou.argmax(1)])
        return logits, iou

    tp.decode = recording

    def setup(self):
        self.imgsz, self.model = 64, jsam.SAM(img_size=64, dim=32, enc_depth=2, enc_heads=2,
                                               num_masks=3)
        self.params = flax_variables(tp.model, collections=("params",))["params"]
        self._encode = jax.jit(lambda p, im: self.model.apply({"params": p}, im,
                                                              method=jsam.SAM.encode))
        self._decode = jax.jit(lambda p, mem, pts, lbl: self.model.apply(
            {"params": p}, mem, pts, lbl, method=jsam.SAM.decode))
        self.ready = True

    monkeypatch.setattr(jsam.SAMPredictor, "_setup", setup)
    jp = jsam.SAMPredictor({})
    image = sorted((seg_folder.parent / "images" / "val").glob("*.png"))[0]
    calls = [dict(points=[[30, 40], [90, 20]], labels=[1, 0]),
             dict(bboxes=[[10, 12, 70, 80]]),
             dict(points=[[50, 50]], bboxes=[[5, 5, 100, 60]])]
    near = 0
    for kw in calls:
        (gm, gi), (wm, wi) = tp(image, **kw), jp(image, **kw)
        _close(gi, wi, what=str(kw))
        assert gm.shape == wm.shape == (len(gi), 16, 16) and gm.any()
        diff = gm != wm
        assert (np.abs(seen[-1][diff]) < LOGIT_MARGIN).all(), int(diff.sum())
        near += int(diff.sum())
    (gm, gq), (wm, wq) = (p.everything(image, grid=4, iou_thresh=-1e9, dedup_iou=0.7)
                          for p in (tp, jp))
    assert len(wm) > 1 and gm.shape == wm.shape
    _close(gq, wq, what="everything quality")
    diff = (gm != wm).any(0)
    assert (np.abs(seen[-1]).min(0)[diff] < LOGIT_MARGIN).all(), int(diff.sum())
    print(f"predictor masks: {near + int(diff.sum())} pixels within {LOGIT_MARGIN} of 0 differ")


def test_fastsam_prompt_matches_jax(tmp_path):
    """FastSAM's selection on one set of segment results (the port's
    ``SegmentPredictor`` over a seeded yolov8n-seg with nc 1 at 64 px): JAX's
    ``prompt`` and the port's pick the same instances for box prompts,
    point prompts, all-negative points and both together;
    ``adjust_boxes_to_border`` equal; ``texts=`` raises."""
    from kuzu.models.fastsam import FastSAMPredictor as JaxFastSAM
    from kuzu.models.fastsam import adjust_boxes_to_border as j_adjust

    from kuzu_torch.models.fastsam import FastSAMPredictor, adjust_boxes_to_border
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.segment import SegmentPredictor

    det = YoloDetector("yolov8n-seg", nc=1, imgsz=64, device="cpu").init(0)
    seg = SegmentPredictor.from_detector(det, conf=0.005, iou=0.9, max_det=20)
    fs = FastSAMPredictor.from_segment_predictor(seg)
    imgs = list(_images(2, seed=8))
    results = seg(imgs)
    assert all(len(r) > 1 and r.masks is not None for r in results)
    jfs = JaxFastSAM.__new__(JaxFastSAM)
    prompts = [dict(bboxes=[[2, 2, 30, 40], [20, 10, 60, 60]]),
               dict(points=[[10, 10], [40, 30]], labels=[1, 1]),
               dict(points=[[10, 10], [40, 30]], labels=[0, 0]),
               dict(bboxes=[[0, 0, 64, 64]], points=[[32, 32]], labels=[0])]
    selected = 0
    for kw in prompts:
        got, want = fs.prompt(results, **kw), jfs.prompt(results, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.boxes.xyxy, w.boxes.xyxy)
            np.testing.assert_array_equal(g.masks.data, w.masks.data)
            selected += len(g)
    assert selected > 0
    boxes = np.array([[3, 50, 40, 61], [25, 1, 63, 30]], np.float32)
    np.testing.assert_array_equal(adjust_boxes_to_border(boxes, (64, 64), 5),
                                  j_adjust(boxes, (64, 64), 5))
    out = fs(imgs, bboxes=[[2, 2, 30, 40]])  # the whole route: predict, snap, select
    assert [len(r) for r in out] == [1, 1]
    with pytest.raises(NotImplementedError, match="CLIP"):
        fs.prompt(results, texts=["a glyph"])


def test_facade_resolves_sam_and_fastsam(monkeypatch):
    """``Model(task="sam")`` and ``task="fastsam"`` resolve to the port's
    classes, which run on the card by default."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.models.fastsam import FastSAMPredictor
    from kuzu_torch.tasks.sam import SAMPredictor, SAMTrainer
    from kuzu_torch.tasks.segment import SegmentTrainer, SegmentValidator

    m = Model("sam-lite", task="sam", device="cpu")
    assert m._component("trainer") is SAMTrainer and m._component("predictor") is SAMPredictor
    with pytest.raises(NotImplementedError, match="validator"):
        m._component("validator")  # JAX registers none: validation runs inside training
    f = Model("yolov8n-seg", task="fastsam", device="cpu")
    assert (f._component("trainer"), f._component("validator"), f._component("predictor")) == (
        SegmentTrainer, SegmentValidator, FastSAMPredictor)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (SAMPredictor, FastSAMPredictor):  # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls({"model": "runs/none"})
