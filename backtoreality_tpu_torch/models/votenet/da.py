"""Domain-adaptation VoteNet variants
(`detection/Votenet/models/votenet_DA.py:47-332`).

Counterpart of ``backtoreality_tpu/models/votenet/da.py``. Adds, behind
gradient reversal:

* a global domain classifier over mean-pooled seed features
  (Linear 256->256->128 with BN and ReLU, then Linear 128->2);
* a local per-proposal discriminator over aggregated vote features
  (128->128->128->1 + sigmoid);
* (jitter variant) a jitter-prediction net 150->64->3 on
  `center_features` and a jitter-domain discriminator
  (150->128->128->1 + sigmoid).

Submodules carry the JAX package's names, so `bridge.state_dict_from_jax`
maps every leaf. The domain heads and the jitter discriminator compute in
the model's `dtype`, the jitter-prediction net in `head_dtype`, as in the
JAX package. ``VoteNetDAJitter2`` keeps the plain backbone and groups the
aggregated votes (their features detached) around the GT centres.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from backtoreality_tpu_torch.models.votenet.backbone import \
    Pointnet2BackboneJitter
from backtoreality_tpu_torch.models.votenet.votenet import VoteNet
from backtoreality_tpu_torch.nn import Dense, SAModuleCenters
from backtoreality_tpu_torch.nn.norm import BatchNorm
from backtoreality_tpu_torch.train.observability import span


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return -grad


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, negated gradient (`votenet_DA.py:31-44`)."""
    return _GradReverse.apply(x)


class _ConvBNStack(nn.Module):
    """(Linear without bias + BN + ReLU) per hidden width, then an
    optional biased Linear ``out``, all computing in `dtype`; PyTorch's
    default Linear init, as the JAX package's
    ``torch_default_kernel_init``."""

    def __init__(self, in_features: int, hidden: tp.Sequence[int],
                 out: int | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.num = len(hidden)
        width = in_features
        for i, ch in enumerate(hidden):
            self.add_module(f"dense{i}",
                            Dense(width, ch, bias=False, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(ch))
            width = ch
        self.out = (Dense(width, out, dtype=dtype) if out is not None
                    else None)

    def forward(self, x):
        for i in range(self.num):
            x = getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x),
                                        relu=True)
        return x if self.out is None else self.out(x)


class _DAHeads(nn.Module):
    """Global + local domain discriminators shared by both variants."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.global_netD1 = _ConvBNStack(256, (256, 128), dtype=dtype)
        self.global_netD2 = Dense(128, 2, dtype=dtype)
        self.local_netD = _ConvBNStack(128, (128, 128), out=1, dtype=dtype)

    def forward(self, end_points):
        g = self.global_netD1(grad_reverse(end_points["seed_features"]))
        end_points["global_d_pred"] = self.global_netD2(
            torch.mean(g, dim=1))  # (B, 2)
        local = self.local_netD(
            grad_reverse(end_points["aggregated_vote_features"]))
        end_points["local_d_pred"] = torch.sigmoid(local)  # (B, K, 1)
        return end_points


class VoteNetDA(VoteNet):
    """`VoteNet_DA` (`votenet_DA.py:47-176`): VoteNet + `_DAHeads`."""

    def __init__(self, *args, dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, dtype=dtype, **kwargs)
        self.da_heads = _DAHeads(dtype)

    def forward(self, point_clouds, generator=None):
        with span("model"):
            return self.detect(point_clouds, generator)

    def detect(self, point_clouds, generator=None):
        """The backbone, voting, proposals and the domain heads."""
        return self.da_heads(self.heads(self.backbone_net(point_clouds),
                                        generator))


class VoteNetDAJitter(VoteNetDA):
    """`VoteNet_DA_jitter` (`votenet_DA.py:179-332`): DA + centre-jitter
    prediction from GT-centre-grouped features."""

    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr,
                 input_feature_dim: int = 0, query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None,
                 head_dtype: torch.dtype | None = None, f32_tail: int = 0,
                 **kwargs):
        backbone = Pointnet2BackboneJitter(
            num_class=num_class, input_feature_dim=input_feature_dim,
            query_mode=query_mode, fps_candidates=fps_candidates,
            dtype=dtype, f32_tail=f32_tail)
        super().__init__(num_class, num_heading_bin, num_size_cluster,
                         mean_size_arr, input_feature_dim=input_feature_dim,
                         query_mode=query_mode, dtype=dtype,
                         head_dtype=head_dtype, backbone=backbone, **kwargs)
        width = 128 + num_class
        self.jitter_netD = _ConvBNStack(width, (128, 128), out=1,
                                        dtype=dtype)
        self.jitter_net = _ConvBNStack(width, (64,), out=3,
                                       dtype=head_dtype)

    def forward(self, point_clouds, center_label, sem_cls_label,
                generator=None):
        """center_label (B, K, 3) and sem_cls_label (B, K): the (weak)
        GT centres and classes the jitter head groups at."""
        with span("model"):
            end_points = self.backbone_net(point_clouds, center_label,
                                           sem_cls_label)
            end_points["jitter_pred"] = self.jitter_net(
                end_points["center_features"])  # (B, K, 3)
            end_points = self.da_heads(self.heads(end_points, generator))
            jd = self.jitter_netD(
                grad_reverse(end_points["center_features"]))
            end_points["jitter_d_pred"] = torch.sigmoid(jd)
            return end_points


class VoteNetDAJitter2(VoteNetDA):
    """`VoteNet_DA_jitter2` (`votenet_DA.py:335-487`): the plain backbone,
    voting, proposals and the domain heads, then a centre-jitter head
    ``ctjt_head`` (r=0.8, 16 slots, one MLP layer to 128, no radius
    normalization, `votenet_DA.py:412-419`) that groups the aggregated
    votes at the GT centres, their features detached (the positions keep
    their gradient, as in the JAX package), and ``jitter_net`` on those
    features beside the class one-hot."""

    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr,
                 query_mode: str = "stratified",
                 dtype: torch.dtype | None = None,
                 head_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(num_class, num_heading_bin, num_size_cluster,
                         mean_size_arr, query_mode=query_mode, dtype=dtype,
                         head_dtype=head_dtype, **kwargs)
        self.num_class = num_class
        self.ctjt_head = SAModuleCenters(radius=0.8, nsample=16,
                                         in_features=128, mlp=[128],
                                         query_mode=query_mode, dtype=dtype)
        self.jitter_net = _ConvBNStack(128 + num_class, (64,), out=3,
                                       dtype=head_dtype)

    def forward(self, point_clouds, center_label, sem_cls_label,
                generator=None):
        """center_label (B, K, 3) and sem_cls_label (B, K): the (weak)
        GT centres and classes the jitter head groups at."""
        with span("model"):
            end_points = self.detect(point_clouds, generator)
            cf = self.ctjt_head(
                end_points["aggregated_vote_xyz"],
                end_points["aggregated_vote_features"].detach(),
                center_label)
            onehot = torch.eye(self.num_class, dtype=cf.dtype,
                               device=cf.device)[sem_cls_label.long()]
            end_points["center_features"] = torch.cat([cf, onehot], dim=-1)
            end_points["jitter_pred"] = self.jitter_net(
                end_points["center_features"])  # (B, K, 3)
            return end_points
