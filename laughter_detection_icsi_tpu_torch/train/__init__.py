"""Training: the train and eval steps, Adam, the epoch loop, checkpoints."""

from laughter_detection_icsi_tpu_torch.train.loop import (  # noqa: F401
    TrainLoop,
    Trainer,
    batch_metrics,
    bce_loss,
    mean_eval_metrics,
    step_generator,
    update_metrics_on_disk,
)
from laughter_detection_icsi_tpu_torch.train.optim import (  # noqa: F401
    Adam,
    AdamState,
    clip_by_global_norm,
    global_norm,
)
