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

The layer computes in `dtype` (None: the parameters', float32) where the
JAX package's does: every projection is a `Dense` of that dtype, the
attention logits and the softmax are in it (``jax.nn.softmax`` of the
logits' dtype), and LayerNorm takes its statistics and affine step in at
least float32 and returns `dtype`. Where XLA keeps a bfloat16 result in
float32 inside a fusion (the softmax's sum, the residual sums that
LayerNorm reads), so does the port: those are the JAX package's rounding
points.
Dropout draws from the global RNG, or from the `generator` set on the
layer (:func:`set_dropout_generator`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from backtoreality_tpu_torch.nn import Dense

LAYER_NORM_EPS = 1e-6


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis. Below float32, ``jax.nn.softmax``'s
    steps rounded where XLA rounds them: ``x - max`` in `x`'s dtype, its
    exponentials in float32, rounded for the numerator but summed
    unrounded, the sum rounded, the quotient in `x`'s dtype. One fused
    call otherwise."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.softmax(x, -1)
    e = torch.exp((x - torch.amax(x, -1, keepdim=True)).float())
    return e.to(x.dtype) / e.sum(-1, keepdim=True).to(x.dtype)


def _dropout(x, rate: float, training: bool, generator):
    """Inverted dropout; the mask from `generator` when one is given."""
    if generator is None or not training or rate == 0.0:
        return F.dropout(x, rate, training)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return x * mask.to(x.dtype) / keep


def _residual(x, y):
    """``x + y`` ahead of a LayerNorm, in at least float32: XLA keeps such
    a sum of two bfloat16 tensors unrounded, as the LayerNorm's float32
    statistics read it straight away."""
    ct = torch.promote_types(torch.promote_types(x.dtype, y.dtype),
                             torch.float32)
    return x.to(ct) + y.to(ct)


class LayerNorm(nn.LayerNorm):
    """The JAX package's LayerNorm (eps 1e-6): the statistics and the
    affine step in at least float32, the result in `dtype` (None: the
    promoted input's dtype)."""

    def __init__(self, features: int, dtype: torch.dtype | None = None):
        super().__init__(features, eps=LAYER_NORM_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(ct), self.normalized_shape,
                         self.weight.to(ct), self.bias.to(ct), self.eps)
        return y.to(self.compute_dtype or ct)


class MultiHeadAttention(nn.Module):
    """Multi-head dot-product attention over channels-last (B, L, C)."""

    def __init__(self, d_model: int, nhead: int, dropout_rate: float,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.nhead = nhead
        self.dropout_rate = dropout_rate
        self.generator = None
        for name in ("query", "key", "value", "out"):
            layer = Dense(d_model, d_model, dtype=dtype)
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
        weights = _softmax(torch.einsum("bqhd,bkhd->bhqk", q, k))
        if self.training and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            mask = torch.bernoulli(torch.full(
                weights.shape[-2:], keep, dtype=weights.dtype,
                device=weights.device), generator=self.generator)
            weights = weights * (mask / keep)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(out.shape[0], out.shape[1], -1))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int = 288, nhead: int = 8,
                 dim_feedforward: int = 2048, dropout_rate: float = 0.1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.generator = None
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout_rate,
                                            dtype)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout_rate,
                                             dtype)
        for i in (1, 2, 3):
            self.add_module(f"norm{i}", LayerNorm(d_model, dtype))
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)

    def _drop(self, x):
        return _dropout(x, self.dropout_rate, self.training, self.generator)

    def forward(self, query, key, query_pos_embed, key_pos_embed):
        """query (B, Pq, C); key (B, Pk, C); the position embeddings of
        the same shapes, or None."""

        def with_pos(x, pos):
            return x if pos is None else x + pos

        q = with_pos(query, query_pos_embed)
        query = self.norm1(_residual(query,
                                     self._drop(self.self_attn(q, q, q))))
        k = with_pos(key, key_pos_embed)
        attn = self.cross_attn(with_pos(query, query_pos_embed), k, k)
        query = self.norm2(_residual(query, self._drop(attn)))
        ff = self._drop(torch.relu(self.linear1(query)))
        return self.norm3(_residual(query, self._drop(self.linear2(ff))))


def set_dropout_generator(model: nn.Module, generator):
    """Draw the dropout masks of every decoder layer of `model` from
    `generator` (None: the global RNG again)."""
    for module in model.modules():
        if isinstance(module, (MultiHeadAttention, TransformerDecoderLayer)):
            module.generator = generator
