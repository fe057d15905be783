"""Host-side utilities: the Flax checkpoint reader and writer, and
train-state checkpoints."""
