"""Segmentation backbones and the inference engine of the PyTorch port."""
