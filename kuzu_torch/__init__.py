"""PyTorch/CUDA port of kuzu for NVIDIA Hopper (see README, "PyTorch port").

Importing the package registers the detector path's kernels as the
operators ``kuzu_torch::nms_keep``, ``fused_ablock`` and
``area_attention`` (``ops/registry.py``), which a ``.pt2`` that
``api/export.py`` wrote holds as nodes."""

from kuzu_torch.ops import registry as _registry  # noqa: F401
