"""Device ops: the fbank featurizer and its CUDA kernel, windows, smoothing,
the packed-PCM wire codec."""
