"""The ViT patch detector and DETR in the port against the JAX package on
the CPU, the JAX variables carried across by ``kuzu_torch.bridge``.

- ``ViTPatchDetector`` (64 x 32 images, patch 16, dim 32, 2 blocks, 2
  heads, 5 classes; ``det_head``'s kernel x3 so that the boxes spread over
  the image): the forward within 1e-5 of the largest entry; the loss, its
  metrics and its gradient with respect to the outputs (1e-5) with padded
  ground-truth slots and two ground truths on one patch (the scatter-max),
  at the scheduled threshold and at 0; ``freeze_mask`` against JAX's optax
  mask leaf for leaf through the bridge's name map;
- ``DETR`` (64 px, dim 64, one encoder and one decoder block, 2 heads, 8
  queries, 3 classes): the forward (1e-5), the matching cost against the
  cost matrix JAX's loss hands its host callback (1e-5), the port's
  Hungarian assignment on JAX's own cost matrix equal to JAX's, the loss,
  its terms and its gradient with respect to the outputs (1e-5) on JAX's
  assignment, and ``detr_postprocess`` (classes and validity equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import numpy_tree

REL = 1e-5
VIT_KW = dict(num_classes=5, image_size=(64, 32), patch_size=(16, 16), dim=32, depth=2,
              num_heads=2)
DETR_KW = dict(num_classes=3, dim=64, enc_depth=1, dec_depth=1, heads=2, queries=8)


def _close(got, want, rel=REL, what="") -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def vit():
    from kuzu.models.vit_detector import ViTPatchDetector as JaxViT

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.vit_detector import ViTPatchDetector

    jm = JaxViT(**VIT_KW)
    v = numpy_tree(jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 32, 3))))(jax.random.key(0)))
    v["params"]["det_head"]["kernel"] = v["params"]["det_head"]["kernel"] * 3
    return jm, v, from_flax(ViTPatchDetector(**VIT_KW), v).eval()


def _vit_images(n: int = 3) -> np.ndarray:
    return np.random.default_rng(1).integers(0, 256, (n, 64, 32, 3), dtype=np.uint8)


def _vit_gt(out_boxes: np.ndarray):
    """(gt boxes (3, 4, 4), labels, mask): image 0 two ground truths near
    one predicted box (both pick it), image 1 one padded slot, image 2
    boxes off every patch's box; labels past the classes clipped."""
    b = out_boxes
    gt = np.zeros((3, 4, 4), np.float32)
    w, h = b[0, 3, 2] - b[0, 3, 0], b[0, 3, 3] - b[0, 3, 1]
    gt[0, 0] = b[0, 3]
    gt[0, 1] = b[0, 3] + 0.1 * np.array([w, h, -w, -h], np.float32)  # IoU 0.64
    gt[0, 2] = b[0, 5]
    gt[0, 3] = [0.1, 0.1, 0.3, 0.2]
    gt[1, :3] = b[1, [0, 2, 6]]
    gt[1, 3] = [0.5, 0.5, 0.9, 0.9]
    gt[2] = [[0.0, 0.0, 0.05, 0.05], [0.9, 0.9, 1.0, 1.0], [0.2, 0.4, 0.3, 0.6], b[2, 1]]
    labels = np.array([[1, 2, 4, 9], [0, 3, 1, 2], [4, 0, 1, 2]], np.int32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 1, 1]], bool)
    return gt, labels, mask


def test_vit_detector_forward_matches_jax(vit):
    jm, v, port = vit
    imgs = _vit_images()
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, imgs)
    with torch.no_grad():
        got = port(_t(imgs))
    assert got["boxes"].shape == (3, 8, 4) and got["cls"].shape == (3, 8, 5)
    assert (got["boxes"][..., 2] >= got["boxes"][..., 0]).all()
    for k in ("boxes", "conf", "cls"):
        _close(got[k], want[k], what=k)
    assert float(got["boxes"].std()) > 0.05  # the scaled head spreads the boxes


@pytest.mark.parametrize("epoch", [0, None])
def test_vit_detector_loss_matches_jax(vit, epoch):
    """The loss, its metrics and the gradient with respect to the outputs,
    at the schedule's threshold for epoch 0 (0.3) and at 0 (every valid
    ground truth that overlaps a patch's box matched)."""
    from kuzu.models.vit_detector import dynamic_iou_threshold as j_thr
    from kuzu.models.vit_detector import vit_detector_loss as j_loss

    from kuzu_torch.models.vit_detector import dynamic_iou_threshold, vit_detector_loss

    jm, v, _ = vit
    out = {k: np.asarray(a) for k, a in jax.jit(lambda v, x: jm.apply(v, x))(
        v, _vit_images()).items()}
    gt, labels, mask = _vit_gt(out["boxes"])
    thr = 0.0 if epoch is None else float(j_thr(jnp.asarray(epoch)))
    if epoch is not None:
        assert float(dynamic_iou_threshold(epoch)) == thr
        assert float(dynamic_iou_threshold(100)) == pytest.approx(0.5)

    def jfn(o):
        return j_loss(o, gt, labels, mask, jnp.asarray(thr), num_classes=5)

    (jl, jm_), jg = jax.value_and_grad(jfn, has_aux=True)(out)
    o = {k: _t(a).requires_grad_() for k, a in out.items()}
    loss, metrics = vit_detector_loss(o, _t(gt), _t(labels), _t(mask), thr, num_classes=5)
    loss.backward()
    _close(loss.detach(), jl, what="loss")
    for k, want in jm_.items():
        _close(metrics[k].detach(), want, what=k)
    for k in o:
        _close(o[k].grad, jg[k], what=f"d loss / d {k}")
    assert float(metrics["n_matched"]) > (1.0 if epoch is None else 0.0)


def test_vit_detector_freeze_mask_matches_jax(vit):
    """The first two blocks frozen: each flax leaf's optax mask equals the
    port's ``freeze_mask`` of the parameter it lands in."""
    from kuzu.models.vit_detector import freeze_mask as j_mask

    from kuzu_torch.bridge import param_slots
    from kuzu_torch.models.vit_detector import ViTPatchDetector, freeze_mask

    kw = dict(VIT_KW, depth=3)
    from kuzu.models.vit_detector import ViTPatchDetector as JaxViT

    v = jax.eval_shape(lambda: JaxViT(**kw).init(jax.random.key(0), jnp.zeros((1, 64, 32, 3))))
    jmask = jax.tree_util.tree_flatten_with_path(j_mask(v["params"], frozen_blocks=2))[0]
    port = ViTPatchDetector(**kw)
    mask = freeze_mask(port, 2)
    slots = param_slots(port)
    assert len(jmask) == len(slots) == len(mask)
    for path, trains in jmask:
        key = tuple(p.key for p in path)
        assert mask[slots[key].param] == trains, key
    assert not mask["block1.attn.q.weight"] and mask["block2.attn.q.weight"]
    assert mask["det_head.weight"] and mask["PatchEmbed_0.proj.weight"]


@pytest.fixture(scope="module")
def detr():
    from kuzu.models.detr import DETR as JaxDETR

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.detr import DETR

    jm = JaxDETR(**DETR_KW)
    v = numpy_tree(jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 3))))(jax.random.key(2)))
    imgs = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out = {k: np.asarray(a) for k, a in jax.jit(lambda v, x: jm.apply(v, x))(v, imgs).items()}
    return jm, v, from_flax(DETR(**DETR_KW), v).eval(), imgs, out


def _detr_gt():
    """Image 0 three ground truths, image 1 two and a padded slot."""
    gt = np.array([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9], [0.2, 0.6, 0.35, 0.95]],
                   [[0.05, 0.3, 0.6, 0.5], [0.7, 0.1, 0.8, 0.3], [0.0, 0.0, 0.0, 0.0]]],
                  np.float32)
    labels = np.array([[0, 2, 1], [1, 5, 0]], np.int32)
    mask = np.array([[1, 1, 1], [1, 1, 0]], bool)
    return gt, labels, mask


def test_detr_forward_matches_jax(detr):
    _, _, port, imgs, want = detr
    with torch.no_grad():
        got = port(_t(imgs))
    assert got["logits"].shape == (2, 8, 4) and got["boxes"].shape == (2, 8, 4)
    for k in ("logits", "boxes"):
        _close(got[k], want[k], what=k)


def test_detr_matching_and_loss_match_jax(detr, monkeypatch):
    """JAX's loss hands its cost matrix to ``_hungarian_host`` (recorded
    here): the port's cost within 1e-5 of it, the port's assignment on it
    equal to JAX's, and on this data the port's own matching as well; the
    loss, its terms and its gradient with respect to the outputs on that
    assignment within 1e-5."""
    import kuzu.models.detr as jd

    from kuzu_torch.models.detr import _hungarian_host, detr_cost, detr_loss

    _, _, _, _, out = detr
    gt, labels, mask = _detr_gt()
    seen = []
    host = jd._hungarian_host

    def recording(cost):
        seen.append(np.array(cost))
        a = host(cost)
        seen.append(a)
        return a

    monkeypatch.setattr(jd, "_hungarian_host", recording)

    def jfn(o):
        return jd.detr_loss(o, gt, labels, mask, num_classes=3)

    (jl, jterms), jg = jax.value_and_grad(jfn, has_aux=True)(out)
    jax.effects_barrier()
    jcost, jassign = seen[0], seen[1]
    assert jcost.shape == (2, 8, 3) and (jcost[1, :, 2] == 1e4).all()
    o = {k: _t(a).requires_grad_() for k, a in out.items()}
    cost = detr_cost(o, _t(gt), _t(labels), _t(mask), num_classes=3)
    _close(cost.detach(), jcost, what="cost")
    np.testing.assert_array_equal(_hungarian_host(jcost), jassign)
    np.testing.assert_array_equal(_hungarian_host(cost.detach().numpy()), jassign)
    loss, terms = detr_loss(o, _t(gt), _t(labels), _t(mask), num_classes=3,
                            assign=_t(jassign))
    loss.backward()
    _close(loss.detach(), jl, what="loss")
    for k, want in jterms.items():
        _close(terms[k].detach(), want, what=k)
    for k in o:
        _close(o[k].grad, jg[k], what=f"d loss / d {k}")
    own, _ = detr_loss({k: _t(a) for k, a in out.items()}, _t(gt), _t(labels), _t(mask),
                       num_classes=3)
    _close(own, jl, what="loss with the port's own matching")


def test_detr_postprocess_matches_jax(detr):
    from kuzu.models.detr import detr_postprocess as j_post

    from kuzu_torch.models.detr import detr_postprocess

    _, _, _, _, out = detr
    want = j_post({k: jnp.asarray(a) for k, a in out.items()}, conf=0.3, image_size=64)
    got = detr_postprocess({k: _t(a) for k, a in out.items()}, conf=0.3, image_size=64)
    _close(got["boxes"], want["boxes"], what="boxes")
    _close(got["scores"], want["scores"], what="scores")
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_detr_size_registry_matches_jax():
    from kuzu.models.detr import SIZE_REGISTRY as J

    from kuzu_torch.models.detr import SIZE_REGISTRY

    assert SIZE_REGISTRY == J
