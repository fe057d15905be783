"""Weight bridges into the PyTorch port's state dicts."""
