"""Engine: evaluation and checkpoints."""
