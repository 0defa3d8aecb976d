"""The port stands alone: no JAX, flax or kuzu import anywhere in it, it
imports without a GPU, nvcc or triton, and its entry points refuse to fall
back to the CPU when the card is missing."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "kuzu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kuzu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_or_kuzu(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the package (and chip_smoke.py) imports with jax, flax
    and kuzu made unimportable, and without nvcc, a GPU or triton."""
    mods = [
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT_FILES if p.name != "__init__.py"
    ]
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'kuzu', 'triton'): sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_detector_without_device_needs_cuda(monkeypatch):
    from kuzu_torch.models.yolo.detector import YoloDetector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YoloDetector("yolov12n")
    assert YoloDetector("yolov12n", device="cpu").device.type == "cpu"


def test_unported_modules_raise():
    """Every module the yaml parser knows is built now; a node of another
    module (here one renamed after YOLO-NAS's blocks) raises naming where
    YOLO-NAS is built."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.models.yolo.graph import parse_model_yaml

    spec = parse_model_yaml({
        "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "SPPF", [16, 5]]],
        "head": [[[1], 1, "Segment", [8, 32]]],
    }, nc=2)
    YoloDetector(spec, device="cpu")
    spec.nodes[1].module = "QARepVGGBlock"
    with pytest.raises(NotImplementedError, match="QARepVGGBlock.*YOLO-NAS.*nas task"):
        YoloDetector(spec, device="cpu")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from kuzu_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("nms")


@pytest.mark.parametrize("name", ["yolov12.yaml", "yolov12-p2.yaml", "yolov8.yaml", "yolov9c.yaml",
                                  "yolov10n.yaml", "yolov10s.yaml", "yolov10x.yaml",
                                  "yolo11.yaml", "yolov8-seg.yaml", "yolov8-pose.yaml",
                                  "yolov8-obb.yaml", "yolov8-cls.yaml"])
def test_yaml_copies_are_identical(name):
    port = REPO / "kuzu_torch" / "cfg" / "models" / name
    assert port.read_bytes() == (REPO / "kuzu" / "cfg" / "models" / name).read_bytes()


def test_default_cfg_copy_is_identical():
    port = REPO / "kuzu_torch" / "cfg" / "default.yaml"
    assert port.read_bytes() == (REPO / "kuzu" / "cfg" / "default.yaml").read_bytes()


def test_chip_smoke_fails_without_card(tmp_path):
    """No card: chip_smoke.py exits non-zero and prints no result line; in a
    directory holding only the script it fails as well."""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes((REPO / "chip_smoke.py").read_bytes())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
