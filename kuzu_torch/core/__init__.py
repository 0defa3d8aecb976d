"""Training engine: config, callbacks, metrics, train step, checkpoints."""
