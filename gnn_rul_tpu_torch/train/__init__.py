"""Training: algorithm specs, engine, metrics, checkpoint, trainer."""
