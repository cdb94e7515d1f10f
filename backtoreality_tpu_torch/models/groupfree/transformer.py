"""Transformer decoder layer (`detection/GroupFree3D/models/transformer.py:
10-76`).

Counterpart of ``backtoreality_tpu/models/groupfree/transformer.py``:
post-norm DETR-style layer, self-attention over the queries,
cross-attention to the seed keys, then the FFN; the position embeddings
are added to Q/K/V at every layer. Attention has separate ``query``,
``key``, ``value`` and ``out`` projections (the JAX package's
multi-head dot-product attention, which `bridge` maps onto them), the
queries scaled by 1/sqrt(head_dim), and dropout on the attention weights
with one mask over the batch and the heads (the JAX attention's
``broadcast_dropout``). LayerNorm's eps is 1e-6, as there. Plain PyTorch:
the JAX package leaves attention to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6


class MultiHeadAttention(nn.Module):
    """Multi-head dot-product attention over channels-last (B, L, C)."""

    def __init__(self, d_model: int, nhead: int, dropout_rate: float):
        super().__init__()
        self.nhead = nhead
        self.dropout_rate = dropout_rate
        for name in ("query", "key", "value", "out"):
            layer = nn.Linear(d_model, d_model)
            nn.init.xavier_uniform_(layer.weight)
            nn.init.zeros_(layer.bias)
            self.add_module(name, layer)

    def _heads(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.nhead, c // self.nhead)

    def forward(self, q, k, v):
        q, k, v = (self._heads(proj(x)) for proj, x in
                   ((self.query, q), (self.key, k), (self.value, v)))
        q = q / math.sqrt(q.shape[-1])
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        if self.training and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            mask = torch.bernoulli(torch.full(
                weights.shape[-2:], keep, dtype=weights.dtype,
                device=weights.device))
            weights = weights * (mask / keep)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(out.shape[0], out.shape[1], -1))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int = 288, nhead: int = 8,
                 dim_feedforward: int = 2048, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout_rate)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout_rate)
        for i in (1, 2, 3):
            self.add_module(f"norm{i}",
                            nn.LayerNorm(d_model, eps=LAYER_NORM_EPS))
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def _drop(self, x):
        return F.dropout(x, self.dropout_rate, self.training)

    def forward(self, query, key, query_pos_embed, key_pos_embed):
        """query (B, Pq, C); key (B, Pk, C); the position embeddings of
        the same shapes, or None."""

        def with_pos(x, pos):
            return x if pos is None else x + pos

        q = with_pos(query, query_pos_embed)
        query = self.norm1(query + self._drop(self.self_attn(q, q, q)))
        k = with_pos(key, key_pos_embed)
        attn = self.cross_attn(with_pos(query, query_pos_embed), k, k)
        query = self.norm2(query + self._drop(attn))
        ff = self._drop(torch.relu(self.linear1(query)))
        return self.norm3(query + self._drop(self.linear2(ff)))
