"""Several processes, one device each: data-parallel training and
multichannel inference with the channel axis split over the processes.

The counterpart of the JAX package's ``parallel`` over a
``torch.distributed`` process group: parameters replicated, batch and
channel rows in contiguous blocks in rank order (``mesh``), gradients and
BatchNorm statistics summed by ``all_reduce`` (``data_parallel``), and the
process group's set-up, votes and resume broadcast (``distributed``).  In
a run of one process every class here works on one device.
"""

from laughter_detection_icsi_tpu_torch.parallel.mesh import (  # noqa: F401
    row_block,
    shard_batch,
    world,
)
from laughter_detection_icsi_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DataParallelTrainer,
)
from laughter_detection_icsi_tpu_torch.parallel.sharded_inference import (  # noqa: F401
    ShardedPipeline,
    ShardedStreamingSession,
)
from laughter_detection_icsi_tpu_torch.parallel import distributed  # noqa: F401
