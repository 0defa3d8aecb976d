"""SAM2-lite in the port against the JAX package on the CPU: the tiny SAM2 of
``tests/test_sam2.py`` (img 64, dim 64, mem_dim 32, a 2-layer encoder with
4 heads, 4 decoder heads, one memory-attention layer, a 4 + 4 ring), its
variables from JAX's ``SAM2VideoPredictor.create`` (the ``track`` init)
carried across by ``kuzu_torch.bridge``.

- ``track`` over T = 6 frames (the ring wraps) against JAX's
  ``SAM2VideoPredictor.predict``, masks and IoU in f32 within 1e-5 of the
  largest entry; the memory encoder alone (flax's ``'SAME'`` pads (0, 1)
  on the even mask), ``sincos_1d``, the single-frame contract;
- the memory is read (frame 1 after two different frames 0) and lanes are
  independent objects, each as JAX's;
- ``attn_impl="flash"`` (K3's plain version on the CPU) against einsum for
  ``track``, and ``"flash_train"`` (K3 with its statistics and K4) for a
  gradient of ``forward(train=True)``;
- ``encoder_kind="tiny"`` against JAX's.

Every JAX clip has the shape (2, 6): one compile a model serves each case.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import numpy_tree

KW = dict(img_size=64, dim=64, mem_dim=32, enc_depth=2, enc_heads=4, dec_heads=4, mem_depth=1,
          mem_frames=4, max_ptrs=4)
REL = 1e-5
T = 6


def _close(got, want, rel=REL, what="") -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _init(kind: str):
    """(JAX SAM2, its jitted predict, its variables as numpy, the port SAM2
    with them)."""
    from kuzu.models.sam2 import SAM2 as JaxSAM2
    from kuzu.models.sam2 import SAM2VideoPredictor as JaxPredictor

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.sam2 import SAM2

    jm = JaxSAM2(**KW, encoder_kind=kind)
    pred = JaxPredictor.create(jm, jax.random.key(0), clip_shape=(2, 2), num_points=1)
    v = numpy_tree(pred.variables)
    return jm, pred, v, from_flax(SAM2(**KW, encoder_kind=kind), v).eval()


@pytest.fixture(scope="module")
def vit():
    return _init("vit")


def _clip(b: int = 2, t: int = T, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (b, t, 64, 64, 3)).astype(np.float32)


PTS = np.array([[[0.5, 0.5]], [[0.25, 0.25]]], np.float32)
LBL = np.ones((2, 1), np.int32)


def _track(model, frames, pts=PTS, lbl=LBL):
    with torch.no_grad():
        m, i = model.track(_t(frames), _t(pts), _t(lbl))
    return m.numpy(), i.numpy()


def test_track_matches_jax_predictor(vit):
    """T = 6 > M = 4: the ring overwrites its oldest slots; masks and IoU
    within 1e-5 of the largest, finite."""
    _, pred, _, port = vit
    frames = _clip()
    jm, ji = pred.predict(frames, PTS, LBL)
    m, i = _track(port, frames)
    assert m.shape == (2, T, 16, 16) and i.shape == (2, T)
    assert np.isfinite(m).all() and np.isfinite(i).all()
    _close(m, jm, what="masks")
    _close(i, ji, what="iou")


def test_ring_positions_and_bank():
    """The bank's ring after six frames: slots written at frames 4, 5, 2, 3
    (memories) and the same for pointers, all valid; ``idx`` a Python int."""
    from kuzu_torch.models.sam import PAD
    from kuzu_torch.models.sam2 import SAM2, init_sam2_

    m = init_sam2_(SAM2(**KW), torch.Generator().manual_seed(0)).eval()
    bank = m.empty_bank(2)
    assert bank["idx"] == 0 and not bank["mem_valid"].any()
    frames, pts = _t(_clip()), _t(PTS)
    with torch.no_grad():
        for t in range(T):
            lbl = _t(LBL) if t == 0 else torch.full((2, 1), PAD, dtype=torch.int32)
            bank, (mask, iou) = m.track_step(bank, frames[:, t], pts, lbl, t)
    assert bank["idx"] == T and isinstance(bank["idx"], int)
    assert bank["mem_t"].tolist() == [[4, 5, 2, 3]] * 2 == bank["ptr_t"].tolist()
    assert bank["mem_valid"].all() and bank["ptr_valid"].all()
    assert mask.shape == (2, 16, 16) and iou.shape == (2,)


def test_memory_encoder_and_sincos_match_jax(vit):
    """The memory encoder on random features and mask logits (16 x 16 mask:
    flax pads its stride-2 convolutions (0, 1); torch's symmetric padding
    would not match), and ``sincos_1d`` of clipped recency."""
    from kuzu.models.sam2 import MemoryEncoder as JaxMemoryEncoder
    from kuzu.models.sam2 import sincos_1d as j_sincos

    from kuzu_torch.models.sam2 import MemoryEncoder, sincos_1d

    _, _, v, port = vit
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 16, 64)).astype(np.float32)
    logits = (3 * rng.normal(size=(2, 16, 16))).astype(np.float32)
    pv = v["params"]["memory_encoder"]
    want = jax.jit(lambda p, f, m: JaxMemoryEncoder(32).apply({"params": p}, f, m, (4, 4)))(
        pv, feat, logits)
    enc = port.memory_encoder
    with torch.no_grad():
        _close(enc(_t(feat), _t(logits), (4, 4)), want, what="memory encoder")
    pos = np.array([[0, 1, 5, 1024], [3, 0, 7, 2]], np.int32)
    _close(sincos_1d(32, _t(pos)), j_sincos(32, jnp.asarray(pos)), what="sincos_1d")
    assert isinstance(enc, MemoryEncoder)


def test_single_frame_contract_matches_jax(vit):
    """``forward`` is SAM's contract on the track-initialised variables."""
    jm, _, v, port = vit
    imgs = _clip(2, 1, seed=4)[:, 0]
    jmask, jiou = jax.jit(lambda v, x, p, l: jm.apply(v, x, p, l))(v, imgs, PTS, LBL)
    with torch.no_grad():
        mask, iou = port(_t(imgs), _t(PTS), _t(LBL))
    assert mask.shape == (2, 3, 16, 16) and iou.shape == (2, 3)
    _close(mask, jmask, what="masks")
    _close(iou, jiou, what="iou")


def test_memory_is_read_and_lanes_are_independent(vit):
    """Frame 1 identical in both lanes after different frames 0: the masks
    differ (the memory is read), as JAX's do; lane 0 of two clips that
    differ only in lane 1 is the same to 1e-5 (no leakage across lanes)."""
    _, pred, _, port = vit
    a = _clip(seed=5)
    a[1, 1:] = a[0, 1:]
    a[1, 0] = _clip(1, 1, seed=6)[0, 0]
    pts = np.array([[[0.5, 0.5]], [[0.5, 0.5]]], np.float32)
    m, _ = _track(port, a, pts)
    jm, _ = pred.predict(a, pts, LBL)
    _close(m, jm, what="masks")
    assert not np.allclose(m[0, 1], m[1, 1])
    b = a.copy()
    b[1] = _clip(1, T, seed=7)[0]
    mb, _ = _track(port, b, pts)
    np.testing.assert_allclose(mb[0], m[0], rtol=0, atol=1e-5)


def test_flash_route_matches_einsum():
    """``attn_impl="flash"``: the encoder's self-attention on K3's plain
    version (2 calls a frame), masks and IoU within 1e-5 of einsum's."""
    from kuzu_torch.models.sam2 import SAM2, init_sam2_

    fa = importlib.import_module("kuzu_torch.ops.flash_attention")
    ref = init_sam2_(SAM2(**KW), torch.Generator().manual_seed(1)).eval()
    fl = SAM2(**KW, attn_impl="flash").eval()
    fl.load_state_dict(ref.state_dict())
    frames = _clip(seed=8)
    before = fa.area_attention.plain_calls
    got = _track(fl, frames)
    assert fa.area_attention.plain_calls - before == KW["enc_depth"] * T
    want = _track(ref, frames)
    for g, w, what in zip(got, want, ("masks", "iou")):
        _close(g, w, what=what)


def test_flash_train_gradient_matches_einsum():
    """``forward(train=True)`` under ``"flash_train"`` (K3 with its row
    statistics and K4, plain versions): the outputs within 1e-5, every
    gradient within 1e-4 of its largest entry (a key bias: 1e-6 of the
    model's largest gradient)."""
    from kuzu_torch.models.sam2 import SAM2, init_sam2_

    fa = importlib.import_module("kuzu_torch.ops.flash_attention")
    ref = init_sam2_(SAM2(**KW), torch.Generator().manual_seed(2))
    fl = SAM2(**KW, attn_impl="flash_train")
    fl.load_state_dict(ref.state_dict())
    imgs = _t(_clip(2, 1, seed=9)[:, 0])
    out = {}
    before = fa.area_attention_bwd.plain_calls
    for name, m in (("einsum", ref), ("flash", fl)):
        mask, iou = m(imgs, _t(PTS), _t(LBL), train=True)
        ((mask * torch.cos(mask)).mean() + iou.square().sum()).backward()
        out[name] = (mask.detach(), iou.detach(),
                     {n: p.grad for n, p in m.named_parameters() if p.grad is not None})
    assert fa.area_attention_bwd.plain_calls - before == KW["enc_depth"]
    for i in range(2):
        _close(out["flash"][i], out["einsum"][i], what=f"output {i}")
    top = max(float(g.abs().max()) for g in out["einsum"][2].values())
    for n, g in out["einsum"][2].items():
        tol = 1e-6 * top if n.endswith("k.bias") else 1e-4 * float(g.abs().max())
        np.testing.assert_allclose(out["flash"][2][n].numpy(), g.numpy(), rtol=0,
                                   atol=max(tol, 1e-30), err_msg=n)


def test_tiny_encoder_track_matches_jax():
    """``encoder_kind="tiny"`` (MobileSAM's TinyViT) through ``track``."""
    _, pred, _, port = _init("tiny")
    frames = _clip(seed=10)
    jm, ji = pred.predict(frames, PTS, LBL)
    m, i = _track(port, frames)
    _close(m, jm, what="masks")
    _close(i, ji, what="iou")


def test_video_predictor_on_the_cpu():
    """``SAM2VideoPredictor.create(..., device="cpu")``: seeded weights,
    numpy inputs, deterministic results."""
    from kuzu_torch.models.sam2 import SAM2, SAM2VideoPredictor

    p = SAM2VideoPredictor.create(SAM2(**KW), seed=3, device="cpu")
    frames = _clip(2, 3, seed=11)
    m1, i1 = p.predict(frames, PTS, LBL)
    m2, i2 = p.predict(frames, PTS, LBL)
    assert m1.shape == (2, 3, 16, 16) and torch.equal(m1, m2) and torch.equal(i1, i2)
