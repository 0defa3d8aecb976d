"""``remat`` in the port's trainer: each C3k2 and A2C2f block of the training
forward runs under ``torch.utils.checkpoint`` (the counterpart of the flax
graph's ``nn.remat`` on its blocks). One f32 train step of yolov12n@128
with it equals the JAX package's step with ``remat=True`` on the same
weights and batch, held to the tolerances of
``tests/test_torch_train_step.py`` (its harness, run with remat on both
sides); and it equals the port's step without it: the loss and every
gradient within those tolerances, and the BatchNorm running statistics
equal (the recomputation leaves them alone, so they move once)."""

import numpy as np
import pytest
import torch

GT_BOXES = [[[8, 8, 40, 44], [60, 10, 96, 40], [20, 70, 60, 110]],
            [[70, 70, 110, 100], [10, 20, 40, 60], [50, 30, 90, 60]]]


def _step(remat: bool, tmp_path, model: str = "yolov12n"):
    """One f32 step of ``model``@128 through ``DetectTrainer``; ``block_calls``
    counts the forwards of the graph's ``REMAT_BLOCKS`` nodes (a recompute
    runs one again)."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.models.yolo.graph import REMAT_BLOCKS
    from kuzu_torch.ops.flash_attention import area_attention
    from kuzu_torch.tasks.detect import DetectTrainer

    cfg = load_config(overrides=dict(model=model, imgsz=128, dtype="float32",
                                     warmup_epochs=0, epochs=1, remat=remat,
                                     project=str(tmp_path), name=f"{model}_remat{int(remat)}"))
    trainer = DetectTrainer(cfg, device="cpu")
    trainer.data_spec = {"nc": 3}
    graph = trainer.build_model()
    assert graph.remat is remat
    block_calls = [0]
    for name, m in graph.named_children():
        if name.split("_", 1)[1] in REMAT_BLOCKS:
            m.register_forward_pre_hook(lambda *_: block_calls.__setitem__(0, block_calls[0] + 1))
    tx = build_optimizer(cfg, graph, 1)
    state = TrainState(graph, tx)
    grads = {}
    update = tx.step

    def snapshot_then_step(count, grad_norm):  # foreach SGD may edit .grad
        grads.update({n: p.grad.detach().clone() for n, p in graph.named_parameters()})
        update(count, grad_norm)

    tx.step = snapshot_then_step
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)),
        "gt_labels": torch.tensor([[0, 1, 2], [2, 0, 1]], dtype=torch.int32),
        "gt_boxes": torch.tensor(GT_BOXES, dtype=torch.float32),
        "mask_gt": torch.tensor([[1, 1, 1], [1, 1, 0]], dtype=torch.bool),
    }
    before = area_attention.plain_calls
    metrics = make_train_step(trainer.loss_fn, tx)(state, batch)
    stats = {n: t.detach().clone() for n, t in graph.named_buffers() if "running" in n}
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads, stats=stats,
                k3_calls=area_attention.plain_calls - before, block_calls=block_calls[0])


@pytest.fixture(scope="module")
def remat_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("remat")
    return _step(False, tmp), _step(True, tmp)


def test_remat_recomputes_the_blocks(remat_pair):
    """The checkpointed blocks run their forward again in the backward: the
    area-attention forward (8 calls per step in the two A2C2f nodes) runs
    twice as often, and never in the plain convs outside the blocks."""
    plain, remat = remat_pair
    assert plain["k3_calls"] == 8
    assert remat["k3_calls"] == 16


def test_remat_loss_and_gradients_match(remat_pair):
    check_remat_pair(remat_pair)


def check_remat_pair(remat_pair) -> None:
    """The remat step's loss and every gradient against the plain step's."""
    plain, remat = remat_pair
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg", "grad_norm"):
        np.testing.assert_allclose(remat["metrics"][k], plain["metrics"][k], rtol=1e-5,
                                   err_msg=k)
    top = max(float(t.abs().max()) for t in plain["grads"].values())
    assert set(remat["grads"]) == set(plain["grads"])
    for name, want in plain["grads"].items():
        atol = max(1e-4 * float(want.abs().max()), 1e-6 * top)
        np.testing.assert_allclose(remat["grads"][name].numpy(), want.numpy(), rtol=1e-3,
                                   atol=atol, err_msg=name)


def test_remat_batch_norm_statistics_equal(remat_pair):
    check_remat_stats(remat_pair)


def check_remat_stats(remat_pair) -> None:
    """The remat step moved the BatchNorm statistics once: equal to the
    plain step's, and moved."""
    plain, remat = remat_pair
    assert set(remat["stats"]) == set(plain["stats"]) and plain["stats"]
    moved = 0
    for name, want in plain["stats"].items():
        assert torch.equal(remat["stats"][name], want), name
        moved += int(not torch.equal(want, torch.ones_like(want))
                     and not torch.equal(want, torch.zeros_like(want)))
    assert moved > 0  # the step did move them


def test_remat_is_inert_outside_training():
    """Evaluation and no-grad forwards take the blocks directly."""
    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec

    path, scale = resolve_model_spec("yolov12n")
    spec = parse_model_yaml(path, scale=scale, nc=3)
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3),
                                                             dtype=np.uint8))
    outs = []
    for remat in (False, True):
        g = YoloGraph(spec, remat=remat)
        g.reset_parameters(torch.Generator().manual_seed(0))
        g.eval()
        with torch.no_grad():
            outs.append(g(img))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_remat_pair():
    from test_torch_train_step import run_step_pair

    return run_step_pair(remat=True, detect_biases="zero")


def test_remat_step_recomputes_against_jax(jax_remat_pair):
    """The port's side of the pair ran its blocks under the checkpoint: the
    area-attention forward ran twice per call (16 in the step)."""
    assert jax_remat_pair["k3_calls"] == 16


def test_remat_loss_matches_jax_remat(jax_remat_pair):
    from test_torch_train_step import check_loss

    check_loss(jax_remat_pair)


def test_remat_gradients_match_jax_remat(jax_remat_pair):
    from test_torch_train_step import check_gradients

    check_gradients(jax_remat_pair)


def test_remat_batch_norm_statistics_match_jax_remat(jax_remat_pair):
    from test_torch_train_step import check_batch_stats

    check_batch_stats(jax_remat_pair)
