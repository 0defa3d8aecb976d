"""The public facade: ``Model`` / ``YOLO``, ``Results`` and the CLI."""
