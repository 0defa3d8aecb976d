"""Helpers for the parity tests of the PyTorch port against the JAX package.

A JAX model is initialised on the CPU from a fixed key and its flax
variables are loaded into the port through ``kuzu_torch.bridge``, so both
sides run the same weights. Inputs are made with numpy and handed to both.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kuzu_torch.testing import MAP_CLOSE_SHARE, MAP_MAX_REL, maps_agreement

# Two intra-op threads for torch in every test process. The suite runs in
# several worker processes on the host's cores, and torch's default (a
# thread a core in each) left their OpenMP pools spinning against each
# other and against XLA's: six port test files under six workers took 399
# s at the default, 70 s at two threads, on an 8-core host. Each pytest
# worker collects every test module, and so imports this one. On one
# thread a remat gradient leaf (sequential f32 sums) falls outside its
# tolerance; at two, as at the default, it is within it.
torch.set_num_threads(2)


def numpy_tree(tree):
    """A flax variables tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def flax_variables(model, sd: dict | None = None,
                   collections: tuple = ("params", "batch_stats")) -> dict:
    """The inverse of ``kuzu_torch.bridge.from_flax`` for every leaf, the
    LSTM's gates among them: ``model``'s weights (or the state dict ``sd``
    of the same names, gradients say) as a flax tree of numpy arrays over
    ``collections``, each flax leaf read out of its port tensor through
    ``bridge.param_slots``, so a JAX model can run the port's seeded
    weights without a JAX init."""
    from kuzu_torch.bridge import _targets, param_slots

    own = model.state_dict(keep_vars=True)
    sd = own if sd is None else sd
    names = {id(t): n for n, t in own.items()}
    tree: dict = {}

    def put(path, arr):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr

    for path, slot in param_slots(model).items() if "params" in collections else ():
        t = sd[slot.param].detach().float()
        if slot.rows is not None:
            t = t[slot.rows[0]:slot.rows[1]]
        arr = t.cpu().numpy()
        if slot.layout == "conv_transpose":  # (in, out, kh, kw) -> flax's unflipped HWIO
            arr = np.ascontiguousarray(arr.transpose(2, 3, 0, 1)[::-1, ::-1])
        elif len(slot.shape) == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        put(("params", *path), arr.T if slot.transpose else arr)
    for path, tensor, _ in _targets(model):
        if path[0] == "batch_stats" and "batch_stats" in collections:
            put(path, sd[names[id(tensor)]].detach().float().cpu().numpy())
    return tree


def jax_and_port_detector(name: str, nc: int = 3, imgsz: int = 128, seed: int = 0):
    """(JAX YoloDetector, its variables, port YoloDetector on the CPU with the
    same weights): the port's seeded weights, handed to JAX through
    :func:`flax_variables` (no JAX init to compile)."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector

    from kuzu_torch.models.yolo.detector import YoloDetector

    jdet = JaxDetector(name, nc=nc, dtype=jnp.bfloat16, imgsz=imgsz)
    tdet = YoloDetector(name, nc=nc, imgsz=imgsz, device="cpu").init(seed)
    return jdet, flax_variables(tdet.graph), tdet


def assert_maps_close(ref, out) -> None:
    """The raw-map criteria of ``tests/test_yolo_infer.py:35-40``, as
    ``kuzu_torch.testing.maps_match`` states them."""
    rel, share = maps_agreement(ref, out)
    assert rel < MAP_MAX_REL, rel
    assert share > MAP_CLOSE_SHARE, share


# The TrOCR and CharMLM of the parity tests: 128 x 32 crops at patch 16 (a
# 8 x 2 grid, N = 16 tokens: the attention kernel's gate holds), encoder 64
# wide with 2 heads and 2 layers, decoder 64 wide with 4 heads and 2 layers,
# max_len 16; the LM 64 wide, 4 heads, 2 layers, 32 positions. The vocabulary
# is TOKEN_CHARS with the five specials (40 ids).
TOKEN_CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHI"
TROCR_KW = dict(vocab_size=40, image_size=(128, 32), enc_dim=64, enc_depth=2, enc_heads=2,
                dec_dim=64, dec_depth=2, dec_heads=4, max_len=16)
LM_KW = dict(vocab_size=40, max_len=32, dim=64, depth=2, num_heads=4)


def jax_trocr_variables(seed: int = 0) -> dict:
    """Seeded flax variables of the tiny TrOCR with its CTC head, shaped for
    decoding tests (at init the logits are O(0.1) and nearly the same for
    every crop and position, so the argmax would be one token with margins
    near the logits' rounding): the decoder's lm_head x10, pos_embed x5 and
    memory_proj x10, so that tokens depend on the crop and the position;
    EOS's lm_head column a copy of token 18's, its bias 0.5 above, so that
    rows end where they would emit 18, at different steps."""
    from kuzu.models.trocr import TrOCR as JaxTrOCR

    model = JaxTrOCR(**TROCR_KW, ctc_head=True)

    def init(m, images, tokens):
        mem = m.encode(images)
        return m.decode_tokens(tokens, mem, train=False), m.ctc_logits(mem)

    variables = numpy_tree(jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 128, 32, 3), jnp.uint8), jnp.zeros((1, 8), jnp.int32),
        method=init))(jax.random.key(seed)))
    dec = variables["params"]["decoder"]
    dec["pos_embed"] = dec["pos_embed"] * 5
    dec["memory_proj"]["kernel"] = dec["memory_proj"]["kernel"] * 10
    kernel, bias = dec["lm_head"]["kernel"] * 10, dec["lm_head"]["bias"].copy()
    kernel[:, 3], bias[3] = kernel[:, 18], bias[18] + 0.5  # 3: the tokenizer's EOS id
    dec["lm_head"]["kernel"], dec["lm_head"]["bias"] = kernel, bias
    return variables


def jax_lm_variables(seed: int = 0) -> dict:
    """Seeded flax variables of the tiny CharMLM, its lm_head x10 (logits of
    O(1): the pseudo-log-likelihoods spread)."""
    from kuzu.models.lm import CharMLM as JaxCharMLM

    model = JaxCharMLM(**LM_KW)
    variables = numpy_tree(jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 8), jnp.int32)))(jax.random.key(seed)))
    variables["params"]["lm_head"]["kernel"] = variables["params"]["lm_head"]["kernel"] * 10
    return variables


def jax_detect_predictor(tdet, name: str, conf: float = 0.001, max_det: int = 300, iou: float = 0.7,
                         f32: bool = False, pad_to: int = 8, **cfg):
    """A JAX ``DetectPredictor`` (its own ``__call__``, ``_predict_frames``,
    letterbox and unscaling) over the port detector ``tdet``'s weights, with
    no run dir: its forward is the BN-folded executor in bf16 (the port's)
    with Pallas in interpret mode, or with ``f32`` the flax apply in f32 (what
    JAX's predictor runs on the CPU); then decode and, as JAX's predictor
    chooses by ``spec.end2end``, NMS or yolov10's NMS-free selection (``iou``
    unused there). Every batch pads to
    ``pad_to`` images before the jitted forward (NMS is per image), so one
    compile serves every call; ``_fwd_jit`` and ``variables`` serve the
    ship-once cascade. ``name``: the architecture ``tdet`` was built as;
    ``cfg``: overrides of the predictor's config (batch)."""
    from kuzu.core.config import load_config
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.models.yolo.infer import run_graph
    from kuzu.ops.nms import nms_free_select, non_max_suppression
    from kuzu.tasks.detect import DetectPredictor

    jdet = JaxDetector(name, nc=tdet.nc, dtype=jnp.float32 if f32 else jnp.bfloat16,
                       imgsz=tdet.imgsz, reg_max=tdet.spec.reg_max)

    def fwd(variables, images):
        maps = (jdet.module.apply(variables, images, train=False) if f32
                else run_graph(jdet.spec, variables, images, interpret=True))
        pred = jdet.decode(maps)
        if jdet.spec.end2end:
            return nms_free_select(pred, conf_thres=conf, max_det=max_det)
        return non_max_suppression(pred, conf_thres=conf, iou_thres=iou, max_det=max_det)

    pred = DetectPredictor(load_config(overrides={"conf": conf, "iou": iou,
                                                  "max_det": max_det, **cfg}))
    pred.ready, pred.imgsz, pred.min_bucket, pred.names = True, tdet.imgsz, 1, {}
    pred.variables = flax_variables(tdet.graph)
    pred._fwd_jit = jax.jit(fwd)

    def padded(images):
        images = np.asarray(images)
        n = len(images)
        if n > pad_to:
            raise ValueError(f"{n} images: raise pad_to ({pad_to})")
        full = np.concatenate([images, np.zeros((pad_to - n, *images.shape[1:]), images.dtype)])
        return pred._fwd_jit(pred.variables, jnp.asarray(full))

    pred._fwd = padded
    return pred
