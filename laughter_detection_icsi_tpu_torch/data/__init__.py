"""Data layer: audio decode, feature cache, sample tables, datasets."""

from laughter_detection_icsi_tpu_torch.data import audio  # noqa: F401
from laughter_detection_icsi_tpu_torch.data.dataset import (  # noqa: F401
    LadDataset,
    ResidentLadDataset,
    load_split_df,
)
from laughter_detection_icsi_tpu_torch.data.feature_cache import (  # noqa: F401
    FeatureCache,
    compute_track_features,
)
from laughter_detection_icsi_tpu_torch.data.sampler import (  # noqa: F401
    DataFrameSampler,
    write_data_dfs,
)
