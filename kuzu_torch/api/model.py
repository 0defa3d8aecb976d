"""Model facade, the public entry point (counterpart of
``kuzu/api/model.py``): ``Model(...).train() / .val() / .predict() /
.track() / .tune() / .export() / .benchmark()``.

A task name maps to its trainer, validator and predictor classes; the port's
task modules (``detect``, ``segment``, ``pose``, ``obb``, ``classify``,
``ctc``, ``recognize``, ``lm``, ``nas``, ``sam``, and ``fastsam`` from
``models/fastsam.py``) register themselves on import through
:func:`register_task`. As in JAX, a name guesses its task by markers only
(``yolov8n-seg`` guesses detect): pass ``task`` for the other heads. Every component runs on
``device`` (the card when None). ``Model("hub://<name>")`` resolves a run
published in the local hub (``core/hub.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable

import torch

from kuzu_torch.core.config import Config, load_config

_TASK_REGISTRY: dict[str, dict[str, Callable]] = {}


def register_task(name: str, **components: Callable) -> None:
    _TASK_REGISTRY.setdefault(name, {}).update(components)


def task_map() -> dict[str, dict[str, Callable]]:
    # import side-effect registration
    import kuzu_torch.tasks.classify  # noqa: F401
    import kuzu_torch.tasks.ctc  # noqa: F401
    import kuzu_torch.tasks.detect  # noqa: F401
    import kuzu_torch.tasks.lm  # noqa: F401
    import kuzu_torch.tasks.nas  # noqa: F401
    import kuzu_torch.tasks.obb  # noqa: F401
    import kuzu_torch.tasks.pose  # noqa: F401
    import kuzu_torch.tasks.recognize  # noqa: F401
    import kuzu_torch.tasks.segment  # noqa: F401
    import kuzu_torch.models.fastsam  # noqa: F401  (registers 'fastsam')
    import kuzu_torch.tasks.sam  # noqa: F401

    return _TASK_REGISTRY


class Model:
    """Facade over a task's trainer / validator / predictor.

    ``model`` may be a model-yaml path (build from scratch), a run directory
    (restore), or an architecture name like ``yolov12n`` / ``trocr``; the
    task is ``task``, else the run's ``args.yaml`` task, else guessed from
    the name. ``device`` is passed to every component (the card when None)."""

    def __init__(self, model: str | Path, task: str | None = None,
                 device: torch.device | str | None = None, **kwargs: Any):
        if str(model).startswith("hub://"):  # local registry (core/hub.py)
            from kuzu_torch.core.hub import resolve

            model = resolve(model)
        self.model_spec = str(model)
        self.task = task or self._guess_task(self.model_spec)
        self.device = device
        self.overrides: dict[str, Any] = dict(kwargs)
        self._trainer = None
        self._predictor = None
        self._predictor_key: tuple | None = None

    # ordered (task, markers): first marker hit wins
    _TASK_MARKERS: tuple[tuple[str, tuple[str, ...]], ...] = (
        ("recognize", ("trocr", "ocr", "unet", "csa")),
        ("classify", ("simplevit", "simple_vit", "classify", "cvae", "stackgan")),
        ("lm", ("mlm", "roberta", "lm")),
        ("ctc", ("crnn", "ctc")),
    )

    @classmethod
    def _guess_task(cls, spec: str) -> str:
        # a run dir records its task in args.yaml: trust it over heuristics
        args = Path(spec) / "args.yaml"
        if args.exists():
            import yaml

            recorded = (yaml.safe_load(args.read_text()) or {}).get("task")
            if recorded:
                return str(recorded)
        s = spec.lower()
        for task, markers in cls._TASK_MARKERS:
            if any(m in s for m in markers):
                return task
        return "detect"

    def _component(self, kind: str) -> Callable:
        tmap = task_map()
        if self.task not in tmap or kind not in tmap[self.task]:
            raise NotImplementedError(
                f"task '{self.task}' has no registered '{kind}'"
            )
        return tmap[self.task][kind]

    def _cfg(self, mode: str, **kwargs: Any) -> Config:
        ov = {**self.overrides, **kwargs, "mode": mode, "task": self.task}
        ov.setdefault("model", self.model_spec)
        return load_config(overrides=ov)

    def train(self, **kwargs: Any) -> dict:
        trainer_cls = self._component("trainer")
        self._trainer = trainer_cls(self._cfg("train", **kwargs), device=self.device)
        return self._trainer.train()

    def val(self, **kwargs: Any) -> dict:
        validator_cls = self._component("validator")
        return validator_cls(self._cfg("val", **kwargs), device=self.device).run()

    def predict(self, source: Any, **kwargs: Any):
        predictor_cls = self._component("predictor")
        key = tuple(sorted((k, repr(v)) for k, v in kwargs.items()))
        if self._predictor is None or key != self._predictor_key:
            self._predictor = predictor_cls(self._cfg("predict", **kwargs), device=self.device)
            self._predictor_key = key
        return self._predictor(source)

    def __call__(self, source: Any, **kwargs: Any):
        return self.predict(source, **kwargs)

    def track(self, source: Any, tracker: str = "bytetrack", persist: bool = False,
              **kwargs: Any):
        """Predict frames in order and associate detections across them (the
        reference ``Model.track``): the per-frame ``Results``, their boxes
        the tracked ones, carrying ``.boxes.id``.

        ``tracker``: ``"bytetrack"``, or ``"botsort"`` (camera-motion
        compensated; it needs cv2 and raises naming it where cv2 is not
        installed). ``persist=True`` keeps the tracker's state across calls
        (streaming). The keys ``track_high_thresh``, ``track_low_thresh``,
        ``match_thresh``, ``new_track_thresh`` and ``track_buffer`` go to the
        tracker, the rest to ``predict``."""
        import numpy as np

        from kuzu_torch.api.results import Boxes
        from kuzu_torch.pipeline.tracker import BoTSORT, ByteTracker

        tk_kwargs = {k: kwargs.pop(k) for k in ("track_high_thresh", "track_low_thresh",
                                                "match_thresh", "new_track_thresh",
                                                "track_buffer") if k in kwargs}
        results = self.predict(source, **kwargs)
        if not persist or getattr(self, "_tracker_obj", None) is None:
            cls = BoTSORT if str(tracker).startswith("botsort") else ByteTracker
            self._tracker_obj = cls(**tk_kwargs)
        tk = self._tracker_obj
        for r in results:
            extra = {}
            if isinstance(tk, BoTSORT):
                if r.orig_img is not None:
                    extra["frame"] = r.orig_img
                elif r.path:
                    from kuzu_torch.data.image_io import imread_rgb

                    extra["frame"] = imread_rgb(r.path)
            tracks = tk.update(r.boxes.xyxy, r.boxes.conf, r.boxes.cls, **extra)
            if tracks:
                r.boxes = Boxes(np.stack([t.box for t in tracks]),
                                np.array([t.score for t in tracks]),
                                np.array([t.cls for t in tracks]), r.boxes.orig_shape,
                                ids=np.array([t.track_id for t in tracks]))
            else:
                r.boxes = Boxes(np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,)),
                                r.boxes.orig_shape, ids=np.zeros((0,)))
        return results

    def tune(self, iterations: int = 10, **kwargs: Any) -> dict:
        """Evolutionary hyperparameter search — the reference ``Model.tune``
        (``engine/model.py:817``): mutate the best-so-far hyps, run a short
        training per iteration, track fitness in tune_results.csv."""
        from kuzu_torch.tools.tuner import Tuner

        tune_dir = kwargs.pop("tune_dir", "runs/tune")
        seed = int(kwargs.get("seed", 0))

        def train_fn(hyps: dict) -> float:
            res = self.train(**{**kwargs, **hyps})
            return float(res.get("fitness", 0.0))

        tuner = Tuner(train_fn, save_dir=tune_dir, seed=seed)
        fitness, hyps = tuner.run(iterations=int(iterations))
        return {"best_fitness": fitness, **hyps}

    def export(self, **kwargs: Any):
        """The ``.pt2`` program of a detector run (``api/export.py``;
        ``format``, ``nms``, ``batch``, ``conf``, ``iou``, ``max_det`` from the
        config), exported on ``device``."""
        exporter = self._component("exporter")
        return exporter(self._cfg("export", **kwargs), device=self.device).run()

    def benchmark(self, **kwargs: Any) -> dict:
        """Rows of ``tools/benchmarks.py::benchmark_detectors`` for this
        model's architecture on ``device``."""
        from kuzu_torch.tools.benchmarks import benchmark_model

        return benchmark_model(self, **kwargs)


class YOLO(Model):
    """Detection-flavoured alias kept for reference-API familiarity."""

    def __init__(self, model: str | Path = "yolov12n", **kwargs: Any):
        super().__init__(model, task="detect", **kwargs)
