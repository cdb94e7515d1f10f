"""PointNet++ neural layers (channels-last, torch.nn)."""

from backtoreality_tpu_torch.nn.norm import (BatchNorm, bn_momentum_schedule,
                                             set_bn_momentum)
from backtoreality_tpu_torch.nn.mlp import Dense, PointwiseMLP, SharedMLP
from backtoreality_tpu_torch.nn.sa_fp import (FPModule, SAModuleCenters,
                                              SAModuleVotes)

__all__ = [
    "BatchNorm",
    "bn_momentum_schedule",
    "set_bn_momentum",
    "Dense",
    "SharedMLP",
    "PointwiseMLP",
    "SAModuleVotes",
    "SAModuleCenters",
    "FPModule",
]
