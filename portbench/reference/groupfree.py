"""Plain GroupFree3D (Liu et al., ICCV 2021): the PointNet++ backbone at
288 seed channels, KPS (the seeds with the top objectness logits), a
proposal head, then decoder layers (post-norm: self-attention over the
queries, cross-attention to the seeds, a feed-forward block; learned
position embeddings added at every layer; LayerNorm eps 1e-6), each with
its own box head. Dropout draws its masks from the generator handed to
:func:`GroupFree3D.forward`, in the order the layers apply them: the
self-attention weights (one mask over batch and heads), the
self-attention output, the cross-attention weights, its output, the
feed-forward block's hidden layer and its output."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from portbench.reference import ops
from portbench.reference.nn import BatchNorm, Backbone, Dense, PointwiseMLP

HEADS = ("objectness", "center_residual", "heading_class",
         "heading_residual", "size_class", "size_residual", "sem_cls")


class PositionEmbeddingLearned(nn.Module):
    def __init__(self, input_channel: int, d: int = 288):
        super().__init__()
        self.dense0 = Dense(input_channel, d, bias=False)
        self.bn0 = BatchNorm(d)
        self.dense1 = Dense(d, d)

    def forward(self, xyz):
        return self.dense1(torch.relu(self.bn0(self.dense0(xyz))))


class PredictHead(nn.Module):
    def __init__(self, num_class, nh, ns, mean_size_arr, d: int = 288):
        super().__init__()
        self.nh, self.ns = nh, ns
        self.mean_size_arr = np.asarray(mean_size_arr, np.float32)
        for i in range(2):
            self.add_module(f"dense{i}", Dense(d, d, bias=False))
            self.add_module(f"bn{i}", BatchNorm(d))
        for name, out in zip(HEADS, (1, 3, nh, nh, ns, ns * 3, num_class)):
            self.add_module(name, Dense(d, out))

    def forward(self, features, base_xyz, ep, prefix):
        nh, ns = self.nh, self.ns
        net = features
        for i in range(2):
            net = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"dense{i}")(net)))
        center = base_xyz + self.center_residual(net)
        msa = torch.as_tensor(self.mean_size_arr).to(net.device)[None, None]
        b, k = features.shape[:2]
        size_scores = self.size_class(net)
        srn = self.size_residual(net).reshape(b, k, ns, 3)
        size_residuals = srn * msa
        size_recover = size_residuals + msa
        index = torch.argmax(size_scores, -1)[..., None, None].expand(
            -1, -1, 1, 3)
        pred_size = torch.gather(size_recover, 2, index)[:, :, 0, :]
        hrn = self.heading_residual(net)
        ep[f"{prefix}objectness_scores"] = self.objectness(net)
        ep[f"{prefix}center"] = center
        ep[f"{prefix}heading_scores"] = self.heading_class(net)
        ep[f"{prefix}heading_residuals_normalized"] = hrn
        ep[f"{prefix}heading_residuals"] = hrn * (math.pi / nh)
        ep[f"{prefix}size_scores"] = size_scores
        ep[f"{prefix}size_residuals_normalized"] = srn
        ep[f"{prefix}size_residuals"] = size_residuals
        ep[f"{prefix}sem_cls_scores"] = self.sem_cls(net)
        return center, pred_size


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int, nhead: int, rate: float):
        super().__init__()
        self.nhead, self.rate = nhead, rate
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(d, d))

    def forward(self, q, k, v, generator):
        def heads(x):
            b, n, c = x.shape
            return x.reshape(b, n, self.nhead, c // self.nhead)

        q, k, v = (heads(self.query(q)), heads(self.key(k)),
                   heads(self.value(v)))
        q = q / math.sqrt(q.shape[-1])
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        if self.training and self.rate > 0.0:
            keep = 1.0 - self.rate
            mask = torch.bernoulli(torch.full(
                weights.shape[-2:], keep, dtype=weights.dtype,
                device=weights.device), generator=generator)
            weights = weights * (mask / keep)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(out.shape[0], out.shape[1], -1))


class DecoderLayer(nn.Module):
    def __init__(self, d: int, nhead: int, dim_ff: int, rate: float):
        super().__init__()
        self.rate = rate
        self.self_attn = MultiHeadAttention(d, nhead, rate)
        self.cross_attn = MultiHeadAttention(d, nhead, rate)
        for i in (1, 2, 3):
            self.add_module(f"norm{i}", nn.LayerNorm(d, eps=1e-6))
        self.linear1 = Dense(d, dim_ff)
        self.linear2 = Dense(dim_ff, d)

    def _drop(self, x, generator):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return x * mask.to(x.dtype) / keep

    def forward(self, query, key, qpos, kpos, g):
        q = query + qpos
        query = self.norm1(query + self._drop(self.self_attn(q, q, q, g), g))
        k = key + kpos
        attn = self.cross_attn(query + qpos, k, k, g)
        query = self.norm2(query + self._drop(attn, g))
        ff = self._drop(torch.relu(self.linear1(query)), g)
        return self.norm3(query + self._drop(self.linear2(ff), g))


class GroupFree3D(nn.Module):
    """Self position embedding of the box (centre and size, 6 inputs),
    cross position embedding of the seeds' xyz (3 inputs)."""

    def __init__(self, num_class, nh, ns, mean_size_arr, input_feature_dim,
                 width, num_proposal, nhead, num_decoder_layers, dim_ff,
                 dropout):
        super().__init__()
        self.num_proposal = num_proposal
        self.num_decoder_layers = num_decoder_layers
        self.backbone_net = Backbone(input_feature_dim, width, 288)
        self.points_obj_cls = PointwiseMLP(288, [288, 288], 1)
        head = (num_class, nh, ns, mean_size_arr)
        self.proposal_head = PredictHead(*head)
        self.decoder_key_proj = Dense(288, 288)
        self.decoder_query_proj = Dense(288, 288)
        layers = range(num_decoder_layers)
        self.decoder_self_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(6) for _ in layers)
        self.decoder_cross_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(3) for _ in layers)
        self.decoder = nn.ModuleList(
            DecoderLayer(288, nhead, dim_ff, dropout) for _ in layers)
        self.prediction_heads = nn.ModuleList(
            PredictHead(*head) for _ in layers)

    def forward(self, point_clouds, generator=None):
        ep = self.backbone_net(point_clouds)
        ep["seed_inds"] = ep["fp2_inds"]
        ep["seed_xyz"] = ep["fp2_xyz"]
        xyz, features = ep["fp2_xyz"], ep["fp2_features"]
        logits = self.points_obj_cls(features)
        ep["seeds_obj_cls_logits"] = logits
        inds = ops.top_k_indices(torch.sigmoid(logits[..., 0]),
                                 self.num_proposal).to(torch.int32)
        cluster_xyz = ops.gather_points(xyz, inds)
        cluster_feature = ops.gather_points(features, inds)
        ep["query_points_xyz"] = cluster_xyz
        ep["query_points_sample_inds"] = inds
        base_xyz, base_size = self.proposal_head(cluster_feature, cluster_xyz,
                                                 ep, "proposal_")
        base_xyz, base_size = base_xyz.detach(), base_size.detach()
        query = self.decoder_query_proj(cluster_feature)
        key = self.decoder_key_proj(features)
        for i in range(self.num_decoder_layers):
            prefix = ("last_" if i == self.num_decoder_layers - 1
                      else f"{i}head_")
            qpos = self.decoder_self_posembeds[i](
                torch.cat([base_xyz, base_size], -1))
            kpos = self.decoder_cross_posembeds[i](xyz)
            query = self.decoder[i](query, key, qpos, kpos, generator)
            base_xyz, base_size = self.prediction_heads[i](
                query, cluster_xyz, ep, prefix)
            base_xyz, base_size = base_xyz.detach(), base_size.detach()
        return ep


def build(config) -> GroupFree3D:
    m = config["model"]
    return GroupFree3D(m["num_class"], m["num_heading_bin"],
                       m["num_size_cluster"], config["mean_size_arr"],
                       m["input_feature_dim"], m["width"],
                       m["num_proposal"], m["nhead"],
                       m["num_decoder_layers"], m["dim_feedforward"],
                       m["transformer_dropout"])
