"""The ``nas`` task (counterpart of ``kuzu/models/nas.py::register``): the
detect task's trainer, validator and predictor over
``models/nas.py::NASDetector``. Training runs the three-branch QARepVGG
forward under the v8 loss; validation and prediction run the
re-parameterised forward, the DFL decode and NMS on the K1 kernel."""

from __future__ import annotations

from kuzu_torch.api.model import register_task
from kuzu_torch.models.nas import NASDetector
from kuzu_torch.tasks.detect import DetectPredictor, DetectTrainer, DetectValidator


class NASTrainer(DetectTrainer):
    detector_cls = NASDetector


class NASValidator(DetectValidator):
    trainer_cls = NASTrainer


class NASPredictor(DetectPredictor):
    detector_cls = NASDetector


register_task("nas", trainer=NASTrainer, validator=NASValidator, predictor=NASPredictor)
