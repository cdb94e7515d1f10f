"""GroupFree3D domain-adaptation variants
(`detection/GroupFree3D/models/detector_DA.py:56-585`).

Counterpart of ``backtoreality_tpu/models/groupfree/da.py``. DA adds,
behind gradient reversal, a global discriminator over the seed features
(288->256->128 with BN and ReLU, mean-pooled, then Linear 128->2) and a
local discriminator on the last decoder layer's query
(288->128->128->1 + sigmoid). The jitter variant also groups the fp2
features at the given GT centres (SA-centres head, r=0.8, radius
normalized, mlp [288->128]), appends the class one-hot and predicts each
centre's jitter with 128+C->64->3.

The heads sit under the JAX package's names (``da_heads``, ``ctjt_head``,
``jitter_net``), so `bridge.state_dict_from_jax` maps every leaf and
`train.common.make_gf_optimizer` keeps them out of the decoder's group.
The decoder loop is `GroupFreeDetector.detect`'s; the heads come in
through its hooks. The heads compute in the model's `dtype`, as in the
JAX package (the jitter net too, unlike VoteNet's).
"""

from __future__ import annotations

import torch
from torch import nn

from backtoreality_tpu_torch.models.groupfree.detector import \
    GroupFreeDetector
from backtoreality_tpu_torch.models.votenet.da import (_ConvBNStack,
                                                       grad_reverse)
from backtoreality_tpu_torch.nn import Dense, SAModuleCenters
from backtoreality_tpu_torch.nn.norm import BatchNorm


class CALayer(nn.Module):
    """Channel-attention (SE) block, dead in the reference: defined at
    `detector_DA.py:35-53`, never instantiated. Channels-last: Linear
    C->C/reduction, ReLU, Linear back, ``y = x*sigmoid(.) + x``, then the
    (N*C,) vector of each scan batch-normed (`nn.BatchNorm1d(288*64)` in
    the reference). The submodules carry the JAX package's compact names
    (``Dense_0``, ``Dense_1``, ``BatchNorm_0``) as lists.

    num_points: N of the inputs, which fixes the BatchNorm's width."""

    def __init__(self, channel: int, num_points: int, reduction: int = 8,
                 dtype: torch.dtype | None = None):
        super().__init__()
        squeezed = channel // reduction
        self.Dense = nn.ModuleList([Dense(channel, squeezed, dtype=dtype),
                                    Dense(squeezed, channel, dtype=dtype)])
        self.BatchNorm = nn.ModuleList([BatchNorm(num_points * channel)])

    def forward(self, x):
        """x (B, N, C) -> (B, N*C)."""
        y = self.Dense[1](torch.relu(self.Dense[0](x)))
        y = x * torch.sigmoid(y) + x
        return self.BatchNorm[0](y.reshape(y.shape[0], -1))


class _GFDAHeads(nn.Module):
    """The global (seed features) and local (last query) discriminators."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.global_netD1 = _ConvBNStack(288, (256, 128), dtype=dtype)
        self.global_netD2 = Dense(128, 2, dtype=dtype)
        self.decoder_netD = _ConvBNStack(288, (128, 128), out=1, dtype=dtype)

    def global_pred(self, seed_features):
        g = self.global_netD1(grad_reverse(seed_features))
        return self.global_netD2(torch.mean(g, dim=1))  # (B, 2)

    def local_pred(self, query):
        return torch.sigmoid(self.decoder_netD(grad_reverse(query)))


class GroupFreeDetectorDA(GroupFreeDetector):
    """`GroupFreeDetector_DA`: the plain graph plus `_GFDAHeads`."""

    def __init__(self, *args, dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, dtype=dtype, **kwargs)
        self.da_heads = _GFDAHeads(dtype)

    def _last_query(self, end_points, query):
        end_points["last_local_d_pred"] = self.da_heads.local_pred(query)

    def detect(self, point_clouds, *labels):
        end_points = super().detect(point_clouds, *labels)
        end_points["global_d_pred"] = self.da_heads.global_pred(
            end_points["seed_features"])
        return end_points


class GroupFreeDetectorDAJitter(GroupFreeDetectorDA):
    """`GroupFreeDetector_DA_jitter` (`detector_DA.py:317-585`): DA plus
    the centre-jitter prediction from the fp2 features grouped at the GT
    centres. forward(point_clouds, center_label (B, K, 3), sem_cls_label
    (B, K))."""

    def __init__(self, num_class: int, *args,
                 query_mode: str = "stratified",
                 dtype: torch.dtype | None = None, **kwargs):
        super().__init__(num_class, *args, query_mode=query_mode,
                         dtype=dtype, **kwargs)
        self.num_class = num_class
        self.ctjt_head = SAModuleCenters(
            radius=0.8, nsample=16, in_features=288, mlp=[128],
            query_mode=query_mode, normalize_xyz=True, dtype=dtype)
        self.jitter_net = _ConvBNStack(128 + num_class, (64,), out=3,
                                       dtype=dtype)

    def _before_queries(self, end_points, center_label, sem_cls_label):
        feats = self.ctjt_head(end_points["sa2_xyz"],
                               end_points["fp2_features"], center_label)
        onehot = torch.eye(self.num_class, dtype=feats.dtype,
                           device=feats.device)[sem_cls_label.long()]
        end_points["center_features"] = torch.cat([feats, onehot], dim=-1)
        end_points["jitter_pred"] = self.jitter_net(
            end_points["center_features"])  # (B, K, 3)
