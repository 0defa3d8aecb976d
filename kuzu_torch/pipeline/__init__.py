"""The page -> text cascade: tiling, device-side pages and crops, the pipeline."""
