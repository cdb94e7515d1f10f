"""PointNet++ neural layers (channels-last, torch.nn)."""

from backtoreality_tpu_torch.nn.norm import BatchNorm
from backtoreality_tpu_torch.nn.mlp import PointwiseMLP, SharedMLP
from backtoreality_tpu_torch.nn.sa_fp import FPModule, SAModuleVotes

__all__ = [
    "BatchNorm",
    "SharedMLP",
    "PointwiseMLP",
    "SAModuleVotes",
    "FPModule",
]
