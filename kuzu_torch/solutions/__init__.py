"""Analytics solutions over predict / track results (counterpart of
``kuzu/solutions``)."""

from kuzu_torch.solutions.solutions import (
    Analytics,
    Heatmap,
    ObjectCounter,
    QueueManager,
    Region,
    RegionCounter,
    SpeedEstimator,
    TrackZone,
    heatmap_accumulate,
)

__all__ = [
    "Analytics",
    "Heatmap",
    "ObjectCounter",
    "QueueManager",
    "Region",
    "RegionCounter",
    "SpeedEstimator",
    "TrackZone",
    "heatmap_accumulate",
]
