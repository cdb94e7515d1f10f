"""VoteNet detector (PyTorch)."""

from backtoreality_tpu_torch.models.votenet.backbone import (
    Pointnet2Backbone,
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
    grad_reverse,
)

__all__ = [
    "Pointnet2Backbone",
    "Pointnet2BackboneJitter",
    "VotingModule",
    "ProposalModule",
    "decode_scores",
    "VoteNet",
    "VoteNetDA",
    "VoteNetDAJitter",
    "grad_reverse",
]
