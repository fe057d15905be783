"""Host-side utilities: the Flax checkpoint reader."""
