"""The port's tools and the rest of the Model facade on the CPU, against the
JAX package where it has the same code: the tuner (numpy: the same seed
and fitnesses give the same files, byte for byte), ``format_table``, the
benchmark rows' keys, the profiling helpers, the local hub (one registry
for both packages), ``Results.plot`` / ``save`` (cv2, byte for byte) and
the CLI's ``tune``, ``export`` and ``benchmark`` modes, on one tiny port run
dir (yolov12n at 64, two classes) and one tiny YOLO folder."""

import json

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A port detect run dir (as ``DetectTrainer`` writes one) and a YOLO
    folder of two training images and one validation image."""
    import yaml

    from kuzu_torch.core.checkpoint import CheckpointManager
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.testing import box_head, write_yolo_folder

    root = tmp_path_factory.mktemp("tools")
    run = root / "run"
    run.mkdir()
    load_config(overrides={"task": "detect", "model": "yolov12n", "imgsz": 64}).to_yaml(
        run / "args.yaml")
    (run / "data_spec.yaml").write_text(yaml.safe_dump({"nc": 2, "names": {0: "a", 1: "b"}}))
    det = box_head(YoloDetector("yolov12n", nc=2, imgsz=64, device="cpu").init(1), (1, 2, 1, 2))
    CheckpointManager(run / "weights").save(
        TrainState(det.graph, torch.optim.SGD(det.graph.parameters(), lr=0.1)), fitness=1.0)
    data = write_yolo_folder(root / "data", {"train": 2, "val": 1}, hw=(48, 64), nc=2)
    return dict(root=root, run=run, data=data)


def _tune_kwargs(tiny, name: str) -> dict:
    """One short epoch a tuning iteration, from the run's weights."""
    return dict(model="yolov12n", pretrained=str(tiny["run"] / "weights"), data=str(tiny["data"]),
                epochs=1, imgsz=64, batch=2, workers=0, project=str(tiny["root"] / name),
                tune_dir=str(tiny["root"] / name / "tune"))


# ------------------------------------------------------------------- tuner
def test_tuner_matches_jax(tmp_path):
    """One deterministic quadratic fitness, one seed: the same
    ``tune_results.csv`` and ``best_hyps.yaml``, byte for byte."""
    from kuzu.tools.tuner import Tuner as JaxTuner

    from kuzu_torch.tools.tuner import Tuner

    def train_fn(h: dict) -> float:
        return -sum((h[k] - t) ** 2 for k, t in (("lr0", 0.01), ("momentum", 0.9),
                                                 ("box", 7.5), ("mosaic", 0.2)))

    best = [cls(train_fn, save_dir=tmp_path / name, seed=5).run(iterations=6)
            for cls, name in ((JaxTuner, "jax"), (Tuner, "port"))]
    assert best[0] == best[1]
    for f in ("tune_results.csv", "best_hyps.yaml"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    assert len((tmp_path / "port" / "tune_results.csv").read_text().splitlines()) == 7


def test_model_tune_on_a_port_run_dir(tiny):
    """``Model.tune(iterations=2)``: two short trainings from the run's
    weights, two rows in ``tune_results.csv``, the best of them returned."""
    from kuzu_torch.api.model import Model

    kw = _tune_kwargs(tiny, "tune2")
    out = Model(str(tiny["run"]), device="cpu").tune(iterations=2, **kw)
    rows = (tiny["root"] / "tune2" / "tune" / "tune_results.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("fitness,")
    fitness = [float(r.split(",")[0]) for r in rows[1:]]
    assert out["best_fitness"] == max(fitness) and np.isfinite(fitness).all()
    assert set(out) >= {"lr0", "momentum", "mosaic"}


# --------------------------------------------------------------- benchmarks
def test_format_table_matches_jax():
    from kuzu.tools.benchmarks import format_table as jax_format_table

    from kuzu_torch.tools.benchmarks import format_table

    rows = [dict(model="yolov12n", batch=1, params_m=2.56, median_ms=20.5, ms_per_img=20.5,
                 tflops=0.1),
            dict(model="yolov12s", batch=16, params_m=9.25, median_ms=310.25, ms_per_img=19.391,
                 tflops=1.2)]
    assert format_table(rows) == jax_format_table(rows)
    assert format_table([]) == jax_format_table([]) == "(no results)"


def test_benchmark_detectors_rows(monkeypatch):
    """yolov12n@64 b1: one row with JAX's keys (JAX's harness run on a
    stub detector and a stub timer, so that nothing compiles), its TFLOP/s
    from the flop count of the call."""
    import kuzu.models.yolo.detector as jax_detector
    import kuzu.tools.benchmarks as jax_benchmarks

    from kuzu_torch.tools.benchmarks import benchmark_detectors

    class Stub:
        def __init__(self, *a, **kw):
            pass

        def init(self, *a, **kw):
            return {}

        def param_count(self, variables):
            return 0

    monkeypatch.setattr(jax_detector, "YoloDetector", Stub)
    monkeypatch.setattr(jax_benchmarks, "timed", lambda *a, **kw: dict(median_ms=1.0, tflops=0.0))
    (want,) = jax_benchmarks.benchmark_detectors(("yolov12n",), (1,), imgsz=64)
    (row,) = benchmark_detectors(("yolov12n",), (1,), imgsz=64, device="cpu")
    assert list(row) == list(want)
    assert (row["model"], row["batch"], row["params_m"]) == ("yolov12n", 1, 2.55)
    assert row["median_ms"] > 0 and row["ms_per_img"] > 0 and row["tflops"] >= 0


def test_profiling_helpers(tmp_path):
    """``timed`` returns JAX's keys; ``flops_of`` counts products (two a
    multiply-add); ``model_info``; ``trace`` writes a Chrome trace and
    yields the profiler; ``StageTimer`` (a copy of JAX's)."""
    from kuzu_torch.tools.profiling import StageTimer, flops_of, model_info, timed, trace

    lin = torch.nn.Linear(32, 16)
    x = torch.randn(4, 32)
    t = timed(lin, x, reps=3, warmup=1)
    assert set(t) == {"median_ms", "min_ms", "tflops", "flops"}
    assert t["flops"] == flops_of(lin, x) == 2 * 4 * 32 * 16
    assert 0 < t["min_ms"] <= t["median_ms"]
    assert model_info(lin, x) == {"params": 32 * 16 + 16, "gflops": 2 * 4 * 32 * 16 / 1e9}
    with trace(tmp_path / "trace") as prof:
        lin(x)
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any("addmm" in e.key for e in prof.key_averages())
    st = StageTimer()
    for _ in range(2):
        with st.stage("detect"):
            pass
    assert list(st.summary()) == ["detect"] and st.counts == {"detect": 2}


# --------------------------------------------------------------------- hub
def test_hub_publish_resolve_and_model(tiny, tmp_path, monkeypatch):
    """A port run published into the local hub: its weights and classes are
    in the manifest, the JAX package's resolver reads the same registry,
    a changed file fails verification, and ``Model("hub://<name>")``
    predicts as the run dir does."""
    from kuzu.core.hub import resolve as jax_resolve

    from kuzu_torch.api.model import Model
    from kuzu_torch.core.hub import hub_dir, list_models, publish, resolve
    from kuzu_torch.tools import hub as hub_cli

    monkeypatch.setenv("KUZU_HUB_DIR", str(tmp_path / "hub"))
    dest = publish(tiny["run"], "det")
    meta = json.loads((dest / "model.json").read_text())
    assert meta["task"] == "detect" and "data_spec.yaml" in meta["files"]
    assert any(k.startswith("weights/") for k in meta["files"])
    assert resolve("hub://det", verify=True) == jax_resolve("hub://det", verify=True) == dest
    assert [m["name"] for m in list_models()] == ["det"] and dest.parent == hub_dir()
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    got = Model("hub://det", device="cpu").predict(img, conf=0.001, max_det=10)
    want = Model(str(tiny["run"]), device="cpu").predict(img, conf=0.001, max_det=10)
    assert [r.to_json() for r in got] == [r.to_json() for r in want] and len(got[0]) == 10
    hub_cli.main(["resolve", "hub://det"])
    with pytest.raises(FileNotFoundError, match="tools.hub publish"):
        Model("hub://nope")
    publish(tiny["run"], "bad")
    (hub_dir() / "bad" / "data_spec.yaml").write_text("nc: 3\n")
    with pytest.raises(ValueError, match="sha256 mismatch"):
        resolve("hub://bad", verify=True)


# ----------------------------------------------------------------- Results
def test_results_plot_and_save_match_jax(tmp_path):
    """The port's ``Results.plot`` against JAX's on the same boxes, byte for
    byte; ``save`` writes the plot as a PNG that reads back equal."""
    import cv2

    from kuzu.api.results import Boxes as JaxBoxes
    from kuzu.api.results import Results as JaxResults

    from kuzu_torch.api.results import Boxes, Results

    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    xy = rng.uniform(0, 90, (5, 2))
    args = (np.concatenate([xy, xy + rng.uniform(8, 30, (5, 2))], 1),
            rng.uniform(0.1, 1, 5), np.array([0, 1, 1, 0, 2]), (96, 128))
    names = {0: "a", 1: "b", 2: "kana"}
    port = Results(img, "p.png", names, Boxes(*args))
    ref = JaxResults(img, "p.png", names, JaxBoxes(*args))
    plot = port.plot()
    assert plot.tobytes() == ref.plot().tobytes() and not np.array_equal(plot, img)
    assert Results(None, "", names, Boxes(*args)).plot().tobytes() == \
        JaxResults(None, "", names, JaxBoxes(*args)).plot().tobytes()
    out = port.save(tmp_path / "out" / "p.png")
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(str(out)), cv2.COLOR_BGR2RGB), plot)


# --------------------------------------------------------------------- CLI
def test_cli_tune_export_benchmark(tiny, capsys):
    """``python -m kuzu_torch.api.cli tune | export | benchmark detect ...
    device=cpu`` run and return 0: one tuning iteration, the run's ``.pt2``
    and its ``.json``, one benchmark row."""
    from kuzu_torch.api import cli

    kw = _tune_kwargs(tiny, "cli")
    kw.pop("model")
    assert cli.main(["tune", "detect", "model=yolov12n", "device=cpu", "iterations=1",
                     *(f"{k}={v}" for k, v in kw.items())]) == 0
    assert "best_fitness=" in capsys.readouterr().out
    assert (tiny["root"] / "cli" / "tune" / "tune_results.csv").exists()
    assert cli.main(["export", "detect", f"model={tiny['run']}", "device=cpu", "batch=1",
                     "nms=True"]) == 0
    blob = tiny["run"] / "export" / "detector.pt2"
    assert capsys.readouterr().out.strip().splitlines()[-1] == str(blob)
    meta = json.loads(blob.with_suffix(".json").read_text())
    assert meta["include_nms"] is True and meta["in_avals"] == ["float32[1,64,64,3]"]
    assert cli.main(["benchmark", "detect", f"model={tiny['run']}", "device=cpu", "imgsz=64",
                     "batch=1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["model", "batch", "params_m", "median_ms", "ms_per_img", "tflops"]
    assert lines[2].split()[:2] == ["yolov12n", "1"]
