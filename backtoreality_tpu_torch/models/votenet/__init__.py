"""VoteNet detector (PyTorch)."""

from backtoreality_tpu_torch.models.votenet.backbone import (
    Pointnet2Backbone,
    Pointnet2BackboneCam,
    Pointnet2BackboneJitter,
)
from backtoreality_tpu_torch.models.votenet.voting import VotingModule
from backtoreality_tpu_torch.models.votenet.proposal import (
    ProposalModule,
    decode_scores,
)
from backtoreality_tpu_torch.models.votenet.votenet import VoteNet
from backtoreality_tpu_torch.models.votenet.da import (
    VoteNetDA,
    VoteNetDAJitter,
    VoteNetDAJitter2,
    grad_reverse,
)
from backtoreality_tpu_torch.models.votenet.boxnet import BoxNet

__all__ = [
    "Pointnet2Backbone",
    "Pointnet2BackboneCam",
    "Pointnet2BackboneJitter",
    "VotingModule",
    "ProposalModule",
    "decode_scores",
    "VoteNet",
    "VoteNetDA",
    "VoteNetDAJitter",
    "VoteNetDAJitter2",
    "BoxNet",
    "grad_reverse",
]
