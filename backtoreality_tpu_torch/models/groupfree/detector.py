"""GroupFree3D detector (`detection/GroupFree3D/models/detector.py:15-232`).

Counterpart of ``backtoreality_tpu/models/groupfree/detector.py``:
backbone -> KPS top-k query selection (or FPS) -> proposal head ->
num_decoder_layers x (decoder layer + per-layer PredictHead), with
base_xyz and base_size detached between layers and per-layer learned
position embeddings added to Q/K/V. The lists of per-layer modules are
``nn.ModuleList``s, which `bridge` maps from the JAX package's
``decoder_0``, ``decoder_1``, ... names. As in the JAX package, the
backbone (its last `f32_tail` stages in float32), KPS's scorer, the query
and key projections, the position embeddings and the decoder compute in
`dtype`; the box heads in `head_dtype`, which the JAX package's
`build_model` never sets (None: the parameters' dtype, float32).

The domain-adaptation models (`da.py`) add their heads through two hooks
of `forward`: `_before_queries` (the jitter head, on the backbone's
outputs and the labels passed after the point clouds) and `_last_query`
(the local discriminator, on the last decoder layer's query before its
prediction head).

Spans (`observability.span`): the forward in ``model``, the query
selection in ``model.kps`` (KPS or FPS), the proposal head in
``model.proposal``, the decoder in ``model.decoder`` and each of its
layers, with that layer's prediction head, in ``model.decoder.layer<i>``.
"""

from __future__ import annotations

import torch
from torch import nn

from backtoreality_tpu_torch.models.groupfree.backbone import GFBackbone
from backtoreality_tpu_torch.models.groupfree.modules import (
    PointsObjClsModule, PositionEmbeddingLearned, PredictHead, fps_sample,
    general_sample)
from backtoreality_tpu_torch.models.groupfree.transformer import \
    TransformerDecoderLayer
from backtoreality_tpu_torch.nn import Dense
from backtoreality_tpu_torch.ops import top_k_indices
from backtoreality_tpu_torch.train.observability import span

POSITION_EMBEDDINGS = {"none": 0, "xyz_learned": 3, "loc_learned": 6}


class GroupFreeDetector(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr,
                 input_feature_dim: int = 0, width: int = 1,
                 num_proposal: int = 256, sampling: str = "kps",
                 dropout_rate: float = 0.1, nhead: int = 8,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 self_position_embedding: str = "xyz_learned",
                 cross_position_embedding: str = "xyz_learned",
                 query_mode: str = "stratified",
                 fps_candidates: int | None = None,
                 dtype: torch.dtype | None = None,
                 head_dtype: torch.dtype | None = None, f32_tail: int = 0):
        super().__init__()
        if sampling not in ("kps", "fps"):
            raise NotImplementedError(f"sampling {sampling!r}")
        for embedding in (self_position_embedding, cross_position_embedding):
            if embedding not in POSITION_EMBEDDINGS:
                raise NotImplementedError(embedding)
        self.num_proposal = num_proposal
        self.sampling = sampling
        self.num_decoder_layers = num_decoder_layers
        self.self_position_embedding = self_position_embedding
        self.cross_position_embedding = cross_position_embedding
        self.backbone_net = GFBackbone(
            input_feature_dim=input_feature_dim, width=width,
            query_mode=query_mode, fps_candidates=fps_candidates,
            dtype=dtype, f32_tail=f32_tail)
        if sampling == "kps":
            self.points_obj_cls = PointsObjClsModule(288, dtype=dtype)
        head_kw = dict(num_class=num_class, num_heading_bin=num_heading_bin,
                       num_size_cluster=num_size_cluster,
                       mean_size_arr=mean_size_arr, seed_feat_dim=288,
                       dtype=head_dtype)
        self.proposal_head = PredictHead(**head_kw)
        if num_decoder_layers <= 0:
            return
        self.decoder_key_proj = Dense(288, 288, dtype=dtype)
        self.decoder_query_proj = Dense(288, 288, dtype=dtype)
        layers = range(num_decoder_layers)
        self._layer_spans = tuple(f"model.decoder.layer{i}" for i in layers)
        if self_position_embedding != "none":
            self.decoder_self_posembeds = nn.ModuleList(
                PositionEmbeddingLearned(
                    POSITION_EMBEDDINGS[self_position_embedding], 288, dtype)
                for _ in layers)
        if cross_position_embedding != "none":
            self.decoder_cross_posembeds = nn.ModuleList(
                PositionEmbeddingLearned(
                    POSITION_EMBEDDINGS[cross_position_embedding], 288,
                    dtype)
                for _ in layers)
        self.decoder = nn.ModuleList(
            TransformerDecoderLayer(288, nhead, dim_feedforward,
                                    dropout_rate, dtype) for _ in layers)
        self.prediction_heads = nn.ModuleList(
            PredictHead(**head_kw) for _ in layers)

    def _select_queries(self, end_points):
        xyz = end_points["fp2_xyz"]
        features = end_points["fp2_features"]
        if self.sampling == "fps":
            q_xyz, q_feat, inds = fps_sample(xyz, features,
                                             self.num_proposal)
        else:  # kps
            logits = self.points_obj_cls(features)
            end_points["seeds_obj_cls_logits"] = logits  # (B, S, 1)
            scores = torch.sigmoid(logits[..., 0])
            inds = top_k_indices(scores, self.num_proposal).to(torch.int32)
            q_xyz, q_feat, inds = general_sample(xyz, features, inds)
        end_points["query_points_xyz"] = q_xyz
        end_points["query_points_feature"] = q_feat
        end_points["query_points_sample_inds"] = inds
        return q_xyz, q_feat

    def _before_queries(self, end_points):
        """Hook: runs on the backbone's end_points (and any labels given
        to `forward`) before the queries are selected."""

    def _last_query(self, end_points, query):
        """Hook: runs on the last decoder layer's query (B, K, 288) before
        that layer's prediction head."""

    def forward(self, point_clouds, *labels):
        """point_clouds (B, N, 3 + C); `labels` go to `_before_queries`
        (none for this model). Returns the end_points dict, with the
        per-head keys under the prefixes ``proposal_``, ``0head_`` ...
        and ``last_``."""
        with span("model"):
            return self.detect(point_clouds, *labels)

    def detect(self, point_clouds, *labels):
        """`forward` outside its span."""
        end_points = self.backbone_net(point_clouds)
        end_points["seed_inds"] = end_points["fp2_inds"]
        end_points["seed_xyz"] = end_points["fp2_xyz"]
        end_points["seed_features"] = end_points["fp2_features"]
        self._before_queries(end_points, *labels)

        with span("model.kps"):
            cluster_xyz, cluster_feature = self._select_queries(end_points)
        with span("model.proposal"):
            base_xyz, base_size = self.proposal_head(
                cluster_feature, cluster_xyz, end_points, "proposal_")
        base_xyz, base_size = base_xyz.detach(), base_size.detach()
        if self.num_decoder_layers <= 0:
            return end_points

        with span("model.decoder"):
            query = self.decoder_query_proj(cluster_feature)
            key = self.decoder_key_proj(end_points["fp2_features"])
            key_pos = end_points["fp2_xyz"]
            for i in range(self.num_decoder_layers):
                with span(self._layer_spans[i]):
                    query, base_xyz, base_size = self._decoder_layer(
                        i, query, key, key_pos, base_xyz, base_size,
                        cluster_xyz, end_points)
        return end_points

    def _decoder_layer(self, i, query, key, key_pos, base_xyz, base_size,
                       cluster_xyz, end_points):
        """Decoder layer `i` and its prediction head; returns the query
        and the detached base positions and sizes the next layer takes."""
        prefix = ("last_" if i == self.num_decoder_layers - 1
                  else f"{i}head_")
        if self.self_position_embedding == "none":
            query_pos_embed = None
        elif self.self_position_embedding == "xyz_learned":
            query_pos_embed = self.decoder_self_posembeds[i](base_xyz)
        else:  # loc_learned
            query_pos_embed = self.decoder_self_posembeds[i](
                torch.cat([base_xyz, base_size], -1))
        key_pos_embed = (
            None if self.cross_position_embedding == "none"
            else self.decoder_cross_posembeds[i](key_pos))
        query = self.decoder[i](query, key, query_pos_embed, key_pos_embed)
        if prefix == "last_":
            self._last_query(end_points, query)
        base_xyz, base_size = self.prediction_heads[i](
            query, cluster_xyz, end_points, prefix)
        return query, base_xyz.detach(), base_size.detach()
