"""The port's deployable artifact against the JAX package's on the CPU.

A seeded yolov12n (nc 2, its box head set by ``box_head``) goes to JAX
through the weight bridge; JAX exports forward + decode + NMS with
``kuzu.api.export.export_fn`` (its Pallas kernels in interpret mode, its NMS
on the CPU route) and reloads it with ``load_exported``. The port exports
the same weights with ``export_detector`` and reloads the ``.pt2`` through
``AutoBackend``. At 128 px node 6 takes K3 and node 8 K2
(``tests/test_torch_detector.py``), so the graph holds all three operators
(at 64 px no area-attention node passes the kernels' gates, na = 4, and it
would hold K1 alone).

Against JAX, detections follow the detector parity tests' criteria (valid
counts within 10% per image, >= 90% matched both ways at IoU >= 0.5, same
class): bf16 maps differ by roundings that can swap which of two near-equal
boxes NMS keeps. Against the port's own eager predictor the reloaded
program is held bit for bit. Each ``kuzu_torch::`` operator passes
``torch.library.opcheck``, gives the plain version's result and the same
flop count as it.
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu_torch.testing import box_head, detections_match

t_fa = importlib.import_module("kuzu_torch.ops.flash_attention")
from kuzu_torch.ops import fused_ablock as t_fb  # noqa: E402
from kuzu_torch.ops import nms_kernel as t_nk  # noqa: E402
from torch_parity import flax_variables  # noqa: E402

CONF, IOU, MAX_DET, B = 0.001, 0.7, 300, 2
COUNTERS = {"nms_keep": t_nk.batched_suppress, "fused_ablock": t_fb.fused_ablock,
            "area_attention": t_fa.area_attention}
# operator nodes of yolov12n@128's exported detector
NODES = {"nms_keep": 1, "fused_ablock": 4, "area_attention": 4}


def _plain_calls() -> dict:
    return {name: fn.plain_calls for name, fn in COUNTERS.items()}


def _zero() -> None:
    for fn in COUNTERS.values():
        fn.plain_calls = 0


def _detector(imgsz: int):
    from kuzu_torch.models.yolo.detector import YoloDetector

    return box_head(YoloDetector("yolov12n", nc=2, imgsz=imgsz, device="cpu").init(0),
                    (1, 2, 1, 2))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One JAX artifact and one port artifact of the same weights at
    ``imgsz``, both run on one seeded batch, and the port's eager output."""
    import jax

    from kuzu.api.export import export_fn as jax_export_fn
    from kuzu.api.export import load_exported as jax_load
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.models.yolo.infer import run_graph
    from kuzu.ops.nms import non_max_suppression as jax_nms

    from kuzu_torch.api.backend import AutoBackend
    from kuzu_torch.api.export import export_detector
    from kuzu_torch.tasks.detect import DetectPredictor

    imgsz = 128
    det = _detector(imgsz)
    jdet = JaxDetector("yolov12n", nc=2, dtype=jnp.bfloat16, imgsz=imgsz,
                       reg_max=det.spec.reg_max)
    variables = flax_variables(det.graph)

    def fwd(images):
        maps = run_graph(jdet.spec, variables, images, interpret=True)
        return jax_nms(jdet.decode(maps), conf_thres=CONF, iou_thres=IOU, max_det=MAX_DET)

    tmp = tmp_path_factory.mktemp(f"export{imgsz}")
    jblob = jax_export_fn(fwd, (jnp.zeros((B, imgsz, imgsz, 3), jnp.float32),), tmp / "jax")
    x = np.random.default_rng(0).random((B, imgsz, imgsz, 3), dtype=np.float32)
    jout = {k: np.asarray(v) for k, v in jax.device_get(jax_load(jblob)(jnp.asarray(x))).items()}

    _zero()
    blob = export_detector(det, tmp / "port" / "detector", batch=B, conf=CONF, iou=IOU,
                           max_det=MAX_DET)
    export_calls = _plain_calls()
    backend = AutoBackend(blob)
    _zero()
    out = backend(x)
    run_calls = _plain_calls()
    eager = DetectPredictor.from_detector(det, CONF, IOU, MAX_DET)._fwd(torch.from_numpy(x))
    return dict(imgsz=imgsz, blob=blob, jout=jout, out=out, backend=backend,
                eager={k: v.numpy() for k, v in eager.items()},
                export_calls=export_calls, run_calls=run_calls)


def test_exported_detector_matches_jax(exported):
    """The reloaded ``.pt2`` against JAX's reloaded StableHLO, on one batch."""
    jd, td = exported["jout"], exported["out"]
    assert set(td) == set(jd) == {"boxes", "scores", "classes", "valid"}
    for k in jd:
        assert td[k].shape == jd[k].shape and td[k].dtype == jd[k].dtype, k
    jn, tn = jd["valid"].sum(1), td["valid"].sum(1)
    assert (jn > 0).all()
    assert (np.abs(jn - tn) <= 0.1 * jn).all(), (jn, tn)
    assert detections_match(jd, td) >= 0.9
    assert detections_match(td, jd) >= 0.9


def test_reloaded_program_equals_eager(exported):
    """``AutoBackend`` on the ``.pt2`` against ``DetectPredictor._fwd`` on
    the same images: equal bit for bit."""
    for k, want in exported["eager"].items():
        np.testing.assert_array_equal(exported["out"][k], want, err_msg=k)


def test_graph_holds_the_operators(exported):
    """The program's graph holds each kernel as a ``kuzu_torch::`` node:
    the export ran only the fake implementations (no plain call), and one
    reloaded call runs each operator's CPU implementation once a node."""
    from kuzu_torch.ops.registry import graph_operators

    nodes = NODES
    meta = json.loads(exported["blob"].with_suffix(".json").read_text())
    assert graph_operators(exported["backend"]._fn) == meta["operators"] == nodes
    assert exported["export_calls"] == dict.fromkeys(nodes, 0)
    assert exported["run_calls"] == nodes
    imgsz = exported["imgsz"]
    assert meta["in_avals"] == [f"float32[{B},{imgsz},{imgsz},3]"]
    assert meta["out_avals"] == {"boxes": f"float32[{B},{MAX_DET},4]",
                                 "scores": f"float32[{B},{MAX_DET}]",
                                 "classes": f"int32[{B},{MAX_DET}]",
                                 "valid": f"bool[{B},{MAX_DET}]"}
    assert (meta["device"], meta["dtype"], meta["include_nms"]) == ("cpu", "bfloat16", True)


# ------------------------------------------------------------ the operators
def _op_case(name: str):
    """(operator, args, plain version) at tiny shapes, seeded."""
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype)

    if name == "nms_keep":
        xy = torch.rand((2, 40, 2), generator=g) * 50
        wh = torch.rand((2, 40, 2), generator=g) * 20 + 2
        boxes = torch.cat([xy, xy + wh], -1)
        valid = torch.rand((2, 40), generator=g) < 0.8
        return (torch.ops.kuzu_torch.nms_keep, (boxes, valid, 0.45), t_nk.suppress_reference)
    if name == "fused_ablock":
        c, hidden, n = 32, 48, 32
        weights = [rnd(c, 2 * c) * 0.2, rnd(1, 2 * c, dtype=torch.float32), rnd(c, c) * 0.2,
                   rnd(1, c, dtype=torch.float32), rnd(c, hidden) * 0.2,
                   rnd(1, hidden, dtype=torch.float32), rnd(hidden, c) * 0.2,
                   rnd(1, c, dtype=torch.float32)]
        args = (rnd(2, n, c), rnd(2, n, c), rnd(2, n, c), weights, 2, 2)
        return torch.ops.kuzu_torch.fused_ablock, args, t_fb.fused_ablock_plain
    dtype = torch.float32 if name.endswith("f32") else torch.bfloat16
    qkv = tuple(rnd(3, 16, 32, dtype=dtype) for _ in range(3))

    def plain(q, k, v, heads):
        return t_fa.area_attention_plain(q, k, v, heads, t_fa.attention_scale(q, heads))

    return torch.ops.kuzu_torch.area_attention, (*qkv, 2), plain


OPS = ("nms_keep", "fused_ablock", "area_attention_bf16", "area_attention_f32")


@pytest.mark.parametrize("name", OPS)
def test_operator_opcheck(name):
    """Schema, fake implementation and dispatch (``torch.library.opcheck``);
    the fake output's shape and dtype are the real one's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, _ = _op_case(name)
    torch.library.opcheck(op, args)
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*[[mode.from_tensor(w) for w in a] if isinstance(a, list)
                    else mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args])
    assert (fake.shape, fake.dtype) == (real.shape, real.dtype)


@pytest.mark.parametrize("name", OPS)
def test_operator_equals_plain_and_counts_its_flops(name):
    """The operator on CPU tensors gives the plain version's result, and
    ``flops_of`` counts it as it counts the plain version (its formula, not
    the plain version's products a second time)."""
    from kuzu_torch.tools.profiling import flops_of

    op, args, plain = _op_case(name)
    torch.testing.assert_close(op(*args), plain(*args), rtol=0, atol=0)
    assert flops_of(op, *args) == flops_of(plain, *args)
    if name != "nms_keep":
        assert flops_of(op, *args) > 0


def test_wrappers_gate_before_the_operator():
    """A CUDA-only refusal stays in the wrapper: a tensor on another device
    raises there, before any operator call."""
    q = torch.zeros(1, 16, 32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_fa.area_attention(q, q, q, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_fb.fused_ablock(q, q, q, [q] * 8, 1, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_nk.batched_suppress(torch.zeros(1, 4, 4, device="meta"),
                              torch.zeros(1, 4, dtype=torch.bool, device="meta"), 0.5)


# ------------------------------------------------------ Exporter, AutoBackend
@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A detect run dir as ``DetectTrainer`` writes one (yolov12n at 64)."""
    import yaml

    from kuzu_torch.core.checkpoint import CheckpointManager
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState

    run = tmp_path_factory.mktemp("export_run")
    load_config(overrides={"task": "detect", "model": "yolov12n", "imgsz": 64}).to_yaml(
        run / "args.yaml")
    (run / "data_spec.yaml").write_text(yaml.safe_dump({"nc": 2, "names": {0: "a", 1: "b"}}))
    det = _detector(64)
    CheckpointManager(run / "weights").save(
        TrainState(det.graph, torch.optim.SGD(det.graph.parameters(), lr=0.1)), fitness=1.0)
    return run


def test_exporter_reads_the_config(run_dir, monkeypatch):
    """``Model.export()`` hands ``export_detector`` the config as JAX's
    Exporter reads it (``nms: false`` in the default config leaves NMS
    out, ``nms=True`` puts it in, ``batch``, ``conf``, ``iou``, ``max_det``);
    ``format: stablehlo`` names the ``.pt2`` program; the formats that need
    other packages raise naming them. ``tests/test_torch_predict.py`` and
    ``test_torch_tools.py`` write real ``.pt2`` files through it."""
    from kuzu_torch.api import export
    from kuzu_torch.api.model import Model

    calls = []
    monkeypatch.setattr(export, "export_detector",
                        lambda source, **kw: calls.append((source, kw)) or "written")
    model = Model(str(run_dir), device="cpu")
    assert model.export() == "written"
    assert model.export(nms=True, batch=2, conf=0.1, iou=0.5, max_det=7) == "written"
    common = dict(device="cpu")
    assert calls == [
        (str(run_dir), dict(batch=16, include_nms=False, conf=0.25, iou=0.7, max_det=300,
                            **common)),
        (str(run_dir), dict(batch=2, include_nms=True, conf=0.1, iou=0.5, max_det=7,
                            **common))]
    with pytest.raises(ImportError, match="'onnx' \\+ 'onnxscript'"):
        model.export(format="onnx")
    has_tf = importlib.util.find_spec("tensorflow") is not None
    for fmt in ("saved_model", "tflite"):
        with pytest.raises(NotImplementedError if has_tf else ImportError, match="tensorflow"):
            model.export(format=fmt)
    with pytest.raises(NotImplementedError, match="not supported"):
        model.export(format="engine")


def test_autobackend_kinds(run_dir, exported, tmp_path, monkeypatch):
    """Kind detection as JAX's ``_detect_kind`` (``tests/test_misc_utils.py::
    test_autobackend_run_dir_detection``); a run dir runs the predictor; the
    kinds whose runtimes the port lacks raise naming their packages; a CUDA
    program where there is no card raises and is not moved to the CPU."""
    from kuzu_torch.api.backend import AutoBackend
    from kuzu_torch.tasks.detect import DetectPredictor

    with pytest.raises(ValueError, match="cannot identify"):
        AutoBackend(tmp_path / "nothing.xyz")
    backend = AutoBackend(run_dir, device="cpu", conf=CONF, max_det=20)
    assert backend.kind == "run_dir"
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    want = DetectPredictor.from_detector(_detector(64), CONF, 0.7, 20)._fwd(torch.from_numpy(x))
    got = backend(x)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    (tmp_path / "a.stablehlo").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="JAX StableHLO"):
        AutoBackend(tmp_path / "a.stablehlo")
    (tmp_path / "a.onnx").write_bytes(b"")
    with pytest.raises(ImportError, match="onnxruntime"):
        AutoBackend(tmp_path / "a.onnx")
    has_tf = importlib.util.find_spec("tensorflow") is not None
    (tmp_path / "sm").mkdir()
    (tmp_path / "sm" / "saved_model.pb").write_bytes(b"")
    (tmp_path / "a.tflite").write_bytes(b"")
    for p in (tmp_path / "sm", tmp_path / "a.tflite"):
        with pytest.raises(NotImplementedError if has_tf else ImportError, match="tensorflow"):
            AutoBackend(p)
    blob = exported["blob"]
    meta = json.loads(blob.with_suffix(".json").read_text())
    cuda = tmp_path / "cuda.pt2"
    cuda.write_bytes(blob.read_bytes())
    cuda.with_suffix(".json").write_text(json.dumps({**meta, "device": "cuda:0"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoBackend(cuda)


def test_f32_program_runs_with_tf32_off(tmp_path, monkeypatch):
    """An f32 ``.pt2`` (the module tree in eval mode) runs inside
    ``f32_products`` through ``AutoBackend`` and equals the eager f32 path
    bit for bit."""
    from kuzu_torch.api.backend import AutoBackend
    from kuzu_torch.api.export import export_detector

    det = _detector(64)
    blob = export_detector(det, tmp_path / "f32", batch=1, conf=CONF, iou=IOU,
                           max_det=MAX_DET, dtype=torch.float32)
    backend = AutoBackend(blob)
    assert backend.dtype == torch.float32
    # the f32 tree's attention is materialised: the graph holds K1 alone
    assert backend.meta["operators"] == {"nms_keep": 1, "fused_ablock": 0, "area_attention": 0}
    seen = []
    program = backend._fn

    def spy(x):
        seen.append((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))
        return program(x)

    monkeypatch.setattr(backend, "_fn", spy)
    x = np.random.default_rng(2).random((1, 64, 64, 3), dtype=np.float32)
    got = backend(x)
    assert seen == [("highest", False)]
    with torch.no_grad():
        want = det.select(det.decode(det.graph.eval()(torch.from_numpy(x))), CONF, IOU,
                          MAX_DET)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
