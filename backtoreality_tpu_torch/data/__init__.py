"""Dataset configs, detection datasets, and host-side input pipeline."""

from backtoreality_tpu_torch.data.config import (
    DatasetConfig,
    scannet_md40_config,
    scannet_config,
    matterport_md40_config,
    get_config,
)
