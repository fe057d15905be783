"""Weight bridges between Flax variable trees and the PyTorch port's state
dicts."""
