"""Multichannel batch inference on one device (``sharded_inference``)."""

from laughter_detection_icsi_tpu_torch.parallel.sharded_inference import (  # noqa: F401
    ShardedPipeline,
    ShardedStreamingSession,
)
