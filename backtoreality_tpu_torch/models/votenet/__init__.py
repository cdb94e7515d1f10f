"""VoteNet detector (PyTorch)."""

from backtoreality_tpu_torch.models.votenet.backbone import \
    Pointnet2Backbone
from backtoreality_tpu_torch.models.votenet.voting import VotingModule
from backtoreality_tpu_torch.models.votenet.proposal import (
    ProposalModule,
    decode_scores,
)
from backtoreality_tpu_torch.models.votenet.votenet import VoteNet

__all__ = [
    "Pointnet2Backbone",
    "VotingModule",
    "ProposalModule",
    "decode_scores",
    "VoteNet",
]
