"""Image-folder-per-class glyph dataset (counterpart of
``kuzu/data/folder_dataset.py``).

``root/<class>/*.png`` layout, class directory -> index map (sorted names),
a square resize and grayscale or RGB. PIL's calls of the JAX dataset are
the port's, byte for byte: the decode (``image_io.imread_rgb(backend=
"pil")``, PIL's ``convert("RGB")``), ``convert("L")`` (``rgb_to_l_u8``) and
``resize(BILINEAR)`` (``resize_pil_bilinear_u8``). An image that does not
decode becomes zeros, as the reference's dummy tensor; a format this machine
has no codec for raises its ``ImportError`` instead (a blank glyph would
train as a label).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from kuzu_torch.data import image_io as io
from kuzu_torch.data.loader import one_thread

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def load_glyph(path: str | Path, size: int, channels: int) -> np.ndarray:
    """An image file as the classifier's (size, size, channels) uint8 input:
    PIL's ``Image.open(p).convert("L" or "RGB").resize((size, size),
    BILINEAR)``."""
    rgb = io.imread_rgb(path, backend="pil")
    img = io.rgb_to_l_u8(rgb)[..., None] if channels == 1 else rgb
    return io.resize_pil_bilinear_u8(img, (size, size))


class GlyphFolderDataset:
    def __init__(self, root: str | Path, image_size: int = 128, channels: int = 1,
                 class_map: dict[str, int] | None = None):
        self.root = Path(root)
        self.image_size = image_size
        self.channels = channels
        dirs = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_map = class_map or {name: i for i, name in enumerate(dirs)}
        self.samples: list[tuple[Path, int]] = []
        for name in dirs:
            if name not in self.class_map:
                continue
            label = self.class_map[name]
            for p in sorted((self.root / name).iterdir()):
                if p.suffix.lower() in IMG_EXTS:
                    self.samples.append((p, label))

    @property
    def num_classes(self) -> int:
        return len(self.class_map)

    def save_class_map(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.class_map, ensure_ascii=False))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        path, label = self.samples[idx]
        s = self.image_size
        try:
            with one_thread():
                arr = load_glyph(path, s, self.channels)
        except ImportError:
            raise
        except Exception:
            arr = np.zeros((s, s, self.channels), np.uint8)
        return {"image": arr, "label": np.int32(label)}
