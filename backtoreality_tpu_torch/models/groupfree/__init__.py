"""GroupFree3D detector (PyTorch): the plain model and its
domain-adaptation variants."""

from backtoreality_tpu_torch.models.groupfree.backbone import GFBackbone
from backtoreality_tpu_torch.models.groupfree.da import (
    CALayer, GroupFreeDetectorDA, GroupFreeDetectorDAJitter)
from backtoreality_tpu_torch.models.groupfree.detector import \
    GroupFreeDetector
from backtoreality_tpu_torch.models.groupfree.modules import (
    PointsObjClsModule, PositionEmbeddingLearned, PredictHead)
from backtoreality_tpu_torch.models.groupfree.transformer import \
    TransformerDecoderLayer

__all__ = [
    "CALayer",
    "GFBackbone",
    "GroupFreeDetector",
    "GroupFreeDetectorDA",
    "GroupFreeDetectorDAJitter",
    "PointsObjClsModule",
    "PositionEmbeddingLearned",
    "PredictHead",
    "TransformerDecoderLayer",
]
