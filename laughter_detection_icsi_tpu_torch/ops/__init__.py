"""Device ops: the fbank featurizer and its CUDA kernel, windows, smoothing."""
