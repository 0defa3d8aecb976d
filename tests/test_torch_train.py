"""The port's training pieces against the JAX package on the CPU: the area
attention backward (K4's plain version) and its autograd pair, the TAL
assigner, the v8 loss, the schedule and the trainer's loop.

Tolerances, each with its reason:
- f32 on both sides is the same arithmetic up to the order of sums: 1e-5
  relative on values of order 1 (a few f32 ulps through a few hundred
  terms);
- bf16 inputs: both sides compute in f32 and round the outputs once, so
  they agree to one bf16 rounding (2e-2);
- the assigner's masks, indices and labels are decisions: identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the module itself: the package attribute of that name is the function it exports
t_fa = importlib.import_module("kuzu_torch.ops.flash_attention")
from kuzu_torch.testing import SyntheticDetectionDataset, f32


def _inputs(rng, shape, dtype):
    a = rng.normal(0, 1, shape).astype(np.float32)
    jt = jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tt = torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return jt, tt


TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_area_attention_bwd_plain_matches_pallas(dtype):
    """The shape of tests/test_flash_attention.py:156-185: G=2, N=48, 3
    heads of 32; the JAX kernel in Pallas interpret mode."""
    from kuzu.ops.flash_attention import area_attention_bwd

    rng = np.random.default_rng(7)
    g, n, heads, hd = 2, 48, 3, 32
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _inputs(rng, (g, n, heads * hd), dtype) for _ in range(4))
    want = area_attention_bwd(jq, jk, jv, jdo, heads, interpret=True)
    before = t_fa.area_attention_bwd.plain_calls
    got = t_fa.area_attention_bwd(tq, tk, tv, tdo, heads)
    assert t_fa.area_attention_bwd.plain_calls == before + 1
    for a, b in zip(got, want):
        assert a.dtype == tq.dtype and a.shape == (g, n, heads * hd)
        np.testing.assert_allclose(f32(a), f32(b), **TOL[dtype])


def test_area_attention_pair_matches_jax_grad():
    """AreaAttention (K3 forward, K4 backward; plain versions here) against
    jax.grad through area_attention_trainable in interpret mode, f32, with
    q and k the column halves of one qk tensor as the training route
    passes them."""
    from kuzu.ops.flash_attention import area_attention_trainable

    rng = np.random.default_rng(3)
    g, n, heads, hd = 2, 48, 3, 32
    c = heads * hd
    qk = rng.normal(0, 1, (g, n, 2 * c)).astype(np.float32)
    v = rng.normal(0, 1, (g, n, c)).astype(np.float32)
    w = rng.normal(0, 1, (g, n, c)).astype(np.float32)

    def jloss(qk_, v_):
        out = area_attention_trainable(qk_[..., :c], qk_[..., c:], v_, heads, True)
        return (out * w).sum()

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(qk), jnp.asarray(v))
    tqk = torch.tensor(qk, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    out = t_fa.AreaAttention.apply(tqk, tv, heads)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tqk, tv))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(f32(a), f32(b), **TOL["f32"])


# (G, N, heads, hd, forward stats given): hd=128 at N=48 (one key tile on the
# card), a ragged N=80 (the card's second 64-row tile has 16 rows), and the
# training route's call with the forward's out, lse and out_lo
BWD_CASES = {
    "hd128_n48": (2, 48, 1, 128, False),
    "ragged_n80": (2, 80, 2, 32, False),
    "stats_given": (2, 80, 3, 32, True),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_area_attention_bwd_plain_cases_match_pallas(case):
    """K4's plain version at the shapes where the kernels' tiling changes,
    and given the forward's out, lse and out_lo as the training route passes
    them (P = exp2(log2(e) S - lse), D = rowsum(dO o (out + out_lo))),
    against the JAX kernel in interpret mode: one bf16 rounding apart."""
    from kuzu.ops.flash_attention import area_attention_bwd

    g, n, heads, hd, given = BWD_CASES[case]
    rng = np.random.default_rng(13)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _inputs(rng, (g, n, heads * hd), "bf16") for _ in range(4))
    want = area_attention_bwd(jq, jk, jv, jdo, heads, interpret=True)
    stats = t_fa.area_attention(tq, tk, tv, heads, return_lse=True) if given else ()
    if given:
        out, lse, out_lo = stats
        assert lse.shape == (g, heads, n) and lse.dtype == torch.float32
        assert out_lo.shape == out.shape and out_lo.dtype == out.dtype
        # out + out_lo is the f32 output to ~16 bits: far closer than out alone
        exact = t_fa.area_attention_plain(tq.float(), tk.float(), tv.float(), heads, hd**-0.5)
        assert ((out.float() + out_lo.float() - exact).abs().max()
                < 0.05 * (out.float() - exact).abs().max())
    got = t_fa.area_attention_bwd(tq, tk, tv, tdo, heads, *stats)
    for a, b in zip(got, want):
        assert a.shape == (g, n, heads * hd)
        np.testing.assert_allclose(f32(a), f32(b), **TOL["bf16"])


def test_area_attention_pair_returns_one_qk_gradient():
    """AreaAttention's backward returns d(qk) as one (G, N, 2C) tensor, its
    halves dq and dk of the backward given the forward's statistics, and
    refuses part of those statistics."""
    rng = np.random.default_rng(5)
    g, n, heads, hd = 2, 32, 2, 16
    c = heads * hd
    qk = torch.from_numpy(rng.normal(0, 1, (g, n, 2 * c)).astype(np.float32)).requires_grad_()
    v = torch.from_numpy(rng.normal(0, 1, (g, n, c)).astype(np.float32)).requires_grad_()
    do = torch.from_numpy(rng.normal(0, 1, (g, n, c)).astype(np.float32))
    dqk, dv = torch.autograd.grad(t_fa.AreaAttention.apply(qk, v, heads), (qk, v), do)
    assert dqk.shape == (g, n, 2 * c)
    q, k = qk.detach()[..., :c], qk.detach()[..., c:]
    stats = t_fa.area_attention(q, k, v.detach(), heads, return_lse=True)
    dq, dk, dv2 = t_fa.area_attention_bwd(q, k, v.detach(), do, heads, *stats)
    assert torch.equal(dqk[..., :c], dq) and torch.equal(dqk[..., c:], dk)
    assert torch.equal(dv, dv2)
    with pytest.raises(ValueError):
        t_fa.area_attention_bwd(q, k, v.detach(), do, heads, lse=stats[1])


def _assign_inputs(seed=0):
    """Two images on a 16x16 + 8x8 anchor grid (strides 8, 16; 128 px).
    GTs of 24-48 px, one pair overlapping (so conflict resolution runs) and
    one masked row; predictions are anchor-centred 20-36 px boxes, so every
    in-GT anchor has a CIoU well above 0 and random scores in [0.05, 0.95]
    make every align value distinct: no near-tie decides a top-k pick (the
    test checks the gaps)."""
    from kuzu.ops.anchors import make_anchors

    rng = np.random.default_rng(seed)
    anc, stride = make_anchors([(16, 16), (8, 8)], [8, 16])
    anc_px = np.asarray(anc * stride)
    a = anc_px.shape[0]
    gt = np.array([[[8, 8, 44, 40], [30, 20, 70, 60], [80, 70, 120, 118], [0, 0, 0, 0]],
                   [[10, 60, 50, 100], [60, 8, 100, 40], [70, 70, 110, 116], [4, 4, 30, 28]]],
                  np.float32)
    labels = np.array([[0, 2, 1, 0], [1, 1, 0, 2]], np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    half = rng.uniform(10, 18, (2, a, 2))
    ctr = anc_px[None] + rng.normal(0, 2, (2, a, 2))
    pd_boxes = np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)
    pd_scores = rng.uniform(0.05, 0.95, (2, a, 3)).astype(np.float32)
    return pd_scores, pd_boxes, anc_px.astype(np.float32), labels, gt, mask


def test_assigner_matches_jax_exactly():
    from kuzu.ops.assigner import task_aligned_assign as j_assign

    from kuzu_torch.ops.assigner import anchors_in_gts
    from kuzu_torch.ops.assigner import task_aligned_assign as t_assign
    from kuzu_torch.ops.boxes import bbox_iou

    args = _assign_inputs()
    want = j_assign(*(jnp.asarray(x) for x in args), topk=10, num_classes=3)
    targs = [torch.from_numpy(x) for x in args]
    got = t_assign(*targs, topk=10, num_classes=3)

    # no near-tie: among each GT's in-box anchors, the 10th and 11th align
    # values differ by more than 1e-3 relative
    pd_scores, pd_boxes, anc, labels, gt, mask = targs
    ov = bbox_iou(gt[:, :, None], pd_boxes[:, None], ciou=True).clamp(min=0)
    sc = torch.gather(pd_scores.transpose(1, 2), 1, labels.long()[:, :, None].expand(-1, -1,
                                                                                     ov.shape[-1]))
    align = torch.where(anchors_in_gts(anc, gt), sc.sqrt() * ov**6, torch.zeros(()))
    top = align.sort(-1, descending=True).values
    gap = (top[..., 9] - top[..., 10]) / top[..., 9].clamp(min=1e-30)
    assert (gap[mask] > 1e-3).all(), gap

    for key in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got["target_bboxes"].numpy(), np.asarray(want["target_bboxes"]))
    np.testing.assert_allclose(got["target_scores"].numpy(), np.asarray(want["target_scores"]),
                               atol=1e-6, rtol=0)
    fg = got["fg_mask"].numpy()
    assert 0 < fg.sum() <= 10 * mask.sum()
    # the overlapping pair shares candidates: resolved to one GT each
    assert (got["target_scores"].numpy()[fg] > 0).sum(-1).max() == 1


def test_detection_loss_matches_jax():
    """Loss, its parts and the gradients of the raw maps, f32."""
    from kuzu.ops.detect_loss import detection_loss as j_loss

    from kuzu_torch.ops.detect_loss import detection_loss as t_loss

    rng = np.random.default_rng(0)
    b, nc, imgsz, strides = 2, 3, 64, (8, 16)
    feats = [rng.normal(0, 0.5, (b, imgsz // s, imgsz // s, 64 + nc)).astype(np.float32)
             for s in strides]
    labels = rng.integers(0, nc, (b, 5)).astype(np.int32)
    xy = rng.uniform(0, 40, (b, 5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (b, 5, 2))], -1).astype(np.float32)
    mask = np.ones((b, 5), bool)
    mask[1, 3:] = False

    def jf(fs):
        return j_loss(fs, jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(mask), nc=nc,
                      imgsz=imgsz, strides=strides)

    (jt, jm), jg = jax.value_and_grad(jf, has_aux=True)([jnp.asarray(f) for f in feats])
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    tt, tm = t_loss(tf, torch.from_numpy(labels), torch.from_numpy(boxes),
                    torch.from_numpy(mask), nc=nc, imgsz=imgsz, strides=strides)
    tt.backward()
    np.testing.assert_allclose(float(tt.detach()), float(jt), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for a, g in zip(tf, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("warmup,cos", [(0.0, False), (1.0, False), (0.5, True)])
def test_lr_schedule_matches_jax(warmup, cos):
    from kuzu.core.config import load_config as j_config
    from kuzu.core.train import lr_schedule as j_sched

    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import lr_schedule

    over = dict(warmup_epochs=warmup, cos_lr=cos, epochs=3)
    js, ts = j_sched(j_config(overrides=over), 10), lr_schedule(load_config(overrides=over), 10)
    for step in (0, 1, 4, 5, 9, 10, 17, 29, 30, 40):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6, abs=1e-12), step
    if warmup:
        assert ts(0) == 0.0  # optax evaluates the schedule before counting: lr 0 first


def test_unported_options_raise(tmp_path):
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import build_optimizer
    from kuzu_torch.tasks.detect import DetectTrainer

    for over in ({"mesh": {"data": 2}}, {"mesh": {"model": 2}}):
        cfg = load_config(overrides={"project": str(tmp_path), **over})
        with pytest.raises(NotImplementedError, match="later slice"):
            DetectTrainer(cfg, device="cpu")
    # LoRA and RAdam are ported: the trainer takes lora_rank, the optimizer radam
    DetectTrainer(load_config(overrides={"project": str(tmp_path), "lora_rank": 4}),
                  device="cpu")
    build_optimizer(load_config(overrides={"optimizer": "radam"}), torch.nn.Linear(2, 2))
    # the folder dataset is ported: build_datasets reads cfg.data's YOLO folder
    from kuzu_torch.data.yolo_dataset import YoloDetectionDataset
    from kuzu_torch.testing import write_yolo_folder

    data = write_yolo_folder(tmp_path / "data", {"train": 2, "val": 1}, hw=(48, 64), nc=2)
    cfg = load_config(overrides={"project": str(tmp_path), "data": str(data), "imgsz": 64,
                                 "batch": 2, "workers": 0})
    train_loader, val_loader = DetectTrainer(cfg, device="cpu").build_datasets()
    assert isinstance(train_loader.dataset, YoloDetectionDataset)
    assert len(train_loader) == 1 and len(val_loader) == 1
    assert next(iter(train_loader))["image"].shape == (2, 64, 64, 3)


def test_trainer_needs_cuda_by_default(monkeypatch, tmp_path):
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import DetectTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetectTrainer(load_config(overrides={"project": str(tmp_path)}))


def test_synthetic_pages():
    """100-300 glyph boxes of 8-40 px per 640 page, inside the page, on ink;
    the same sample for the same seed and index."""
    ds = SyntheticDetectionDataset(3, imgsz=640, max_boxes=400, nc=2, seed=4)
    for i in range(3):
        s = ds[i]
        assert s["image"].dtype == np.uint8 and s["image"].shape == (640, 640, 3)
        k = int(s["mask_gt"].sum())
        assert 100 <= k <= 300
        b = s["gt_boxes"][: k]
        wh = b[:, 2:] - b[:, :2]
        assert (wh >= 8).all() and (wh <= 40).all() and (b >= 0).all() and (b <= 640).all()
        assert (s["gt_boxes"][k:] == 0).all() and set(np.unique(s["gt_labels"][:k])) <= {0, 1}
        x1, y1 = int(b[-1, 0]), int(b[-1, 1])
        assert s["image"][y1, x1].max() < 100  # the last glyph drawn is ink
    np.testing.assert_array_equal(ds[1]["image"], ds[1]["image"])
    assert not np.array_equal(ds[0]["image"], ds[1]["image"])


def test_detect_trainer_runs_and_resumes(tmp_path):
    """DetectTrainer(cfg).train() on the CPU: one epoch of 2 steps of
    yolov12n@64 over the synthetic pages, then validation through the
    BN-folded executor; results.csv, weights/last, weights/best and
    final.json appear, and resume=True continues from last."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import trainer_for

    train_ds = SyntheticDetectionDataset(4, 64, max_boxes=8, nc=2, seed=0)
    val_ds = SyntheticDetectionDataset(2, 64, max_boxes=8, nc=2, seed=1)
    trainer_cls = trainer_for((train_ds, val_ds, 2))
    cfg = load_config(overrides=dict(model="yolov12n", imgsz=64, batch=2, epochs=1, workers=0,
                                     project=str(tmp_path), name="run", exist_ok=True))
    trainer = trainer_cls(cfg, device="cpu")
    final = trainer.train()
    run = tmp_path / "detect" / "run"
    for f in ("args.yaml", "results.csv", "final.json", "weights/last/state.pt",
              "weights/best/state.pt"):
        assert (run / f).exists(), f
    assert trainer.state.step == 2
    assert np.isfinite(final["loss"]) and np.isfinite(final["grad_norm"])
    assert {"map50", "map", "fitness"} <= set(final)
    assert trainer.ckpt.metadata("last")["epoch"] == 0

    cfg2 = load_config(overrides=dict(model="yolov12n", imgsz=64, batch=2, epochs=2, workers=0,
                                      project=str(tmp_path), name="run", exist_ok=True,
                                      resume=True))
    again = trainer_cls(cfg2, device="cpu")
    again.train()
    assert again.state.step == 4  # two restored + two new
    assert again.ckpt.metadata("last")["epoch"] == 1
    assert (run / "results.csv").read_text().strip().splitlines()[-1].startswith("1,")


def test_accumulate_matches_one_batch():
    """accumulate=2 over a batch of two identical halves equals accumulate=1
    over one half (the contract of tests/test_train_accumulate.py): the same
    update, the same loss, and the BatchNorm statistics folded twice,
    x2 = 1.97 x1 - 0.97 x0 with flax's momentum 0.97."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.models.yolo.modules import Conv

    r = np.random.default_rng(3)
    half = {"x": torch.from_numpy(r.normal(0, 1, (4, 3, 8, 8)).astype(np.float32)),
            "y": torch.from_numpy(r.normal(0, 1, (4, 8)).astype(np.float32))}
    dup = {k: torch.cat([v, v]) for k, v in half.items()}
    cfg = load_config(overrides=dict(warmup_epochs=0, epochs=1, grad_clip=0))

    def loss_fn(model, b):
        loss = ((model(b["x"]).mean(dim=(2, 3)) - b["y"]) ** 2).mean()
        return loss, {"mse": loss}

    def run(accumulate, batch):
        torch.manual_seed(0)
        model = Conv(3, 8, 3)
        x0 = model.bn.running_mean.clone()
        state = TrainState(model, build_optimizer(cfg, model, 1))
        step = make_train_step(loss_fn, state.optimizer, accumulate=accumulate)
        return model, x0, step(state, batch)

    m1, x0, r1 = run(1, half)
    m2, _, r2 = run(2, dup)
    for a, b in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(float(r1["loss"]), float(r2["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(r1["mse"]), float(r2["mse"]), rtol=1e-6)
    x1, x2 = m1.bn.running_mean.numpy(), m2.bn.running_mean.numpy()
    assert not np.allclose(x1, x0.numpy())
    np.testing.assert_allclose(x2, 1.97 * x1 - 0.97 * x0.numpy(), atol=1e-6)


def test_a2c2f_residual_train_forward_matches_flax():
    """The l/x-scale A2C2f (two ABlocks with area attention, the gamma
    layer-scale residual) in training mode, f32: the output and the new
    BatchNorm running statistics against flax's train=True apply."""
    from kuzu.models.yolo.modules import A2C2f as JaxA2C2f

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.yolo.modules import A2C2f
    from torch_parity import numpy_tree

    x = np.random.default_rng(5).normal(0, 1, (2, 8, 8, 128)).astype(np.float32)
    jm = JaxA2C2f(128, n=1, a2=True, area=4, residual=True, mlp_ratio=1.5)
    variables = jm.init(jax.random.key(1), jnp.asarray(x), False)
    variables = {"params": {**variables["params"], "gamma": jnp.linspace(0.5, 1.5, 128)},
                 "batch_stats": variables["batch_stats"]}
    jy, mutated = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    tm = A2C2f(128, 128, n=1, a2=True, residual=True, mlp_ratio=1.5, area=4)
    from_flax(tm, numpy_tree(variables))
    ty = tm.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               atol=1e-4, rtol=1e-4)
    after = numpy_tree(mutated["batch_stats"])
    var = after["m0_1"]["attn"]["qk"]["bn"]["var"]
    np.testing.assert_allclose(tm.m0_1.attn.qk.bn.running_var.numpy(), var, rtol=1e-5, atol=1e-6)
