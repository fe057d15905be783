"""Device ops of the PyTorch port: resamplers, pooling, morphology, the
homography warp, and the hand-written CUDA kernels (``ops.cuda``)."""
