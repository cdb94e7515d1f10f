"""GroupFree3D detector (PyTorch): the plain model. The DA and jitter
models (``backtoreality_tpu/models/groupfree/da.py``) are not ported
yet."""

from backtoreality_tpu_torch.models.groupfree.backbone import GFBackbone
from backtoreality_tpu_torch.models.groupfree.detector import \
    GroupFreeDetector
from backtoreality_tpu_torch.models.groupfree.modules import (
    PointsObjClsModule, PositionEmbeddingLearned, PredictHead)
from backtoreality_tpu_torch.models.groupfree.transformer import \
    TransformerDecoderLayer

__all__ = [
    "GFBackbone",
    "GroupFreeDetector",
    "PointsObjClsModule",
    "PositionEmbeddingLearned",
    "PredictHead",
    "TransformerDecoderLayer",
]
