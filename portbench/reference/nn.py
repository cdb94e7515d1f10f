"""Plain PointNet++ layers of the reference, channels-last (B, N, C), in
float32: linear layers, BatchNorm with torch-style momentum over the
batch moments E[x] and E[x^2], shared MLPs, single-scale set abstraction
(FPS, the stratified ball query, grouping with the centre subtracted and
the radius divided out, a shared MLP, max pooling) and feature
propagation (3-NN inverse-distance interpolation, a shared MLP).
Submodules are named as the detectors' state dicts name them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import ops


class Dense(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    eps = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.momentum = 0.1
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            mean2 = (x * x).mean(dim=dims)
            count = x.numel() // self.features
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            unbiased = var * (count / max(count - 1, 1))
            m = np.float32(self.momentum)
            keep = float(np.float32(1) - m)
            m = float(m)
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean + m * mean)
                self.running_var.copy_(keep * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * inv + self.bias


def set_bn_momentum(model: nn.Module, momentum: float):
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.momentum = momentum


class SharedMLP(nn.Module):
    """(Linear without bias, BN, ReLU) per width."""

    def __init__(self, in_features: int, channels):
        super().__init__()
        self.num = len(channels)
        width = in_features
        for i, ch in enumerate(channels):
            self.add_module(f"dense{i}", Dense(width, ch, bias=False))
            self.add_module(f"bn{i}", BatchNorm(ch))
            width = ch

    def forward(self, x):
        for i in range(self.num):
            x = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"dense{i}")(x)))
        return x


class PointwiseMLP(nn.Module):
    """(Linear without bias, BN, ReLU) per hidden width, then a biased
    Linear ``out``."""

    def __init__(self, in_features: int, hidden, out: int):
        super().__init__()
        self.num = len(hidden)
        width = in_features
        for i, ch in enumerate(hidden):
            self.add_module(f"dense{i}", Dense(width, ch, bias=False))
            self.add_module(f"bn{i}", BatchNorm(ch))
            width = ch
        self.out = Dense(width, out)

    def forward(self, x):
        for i in range(self.num):
            x = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"dense{i}")(x)))
        return self.out(x)


class SAModuleVotes(nn.Module):
    """Set abstraction: `npoint` centres by FPS, `nsample` neighbours
    within `radius` by the stratified ball query, ``[local xyz / radius,
    features]`` through a shared MLP, max over the neighbours."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_features: int, mlp):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.mlp = SharedMLP(in_features + 3, mlp)

    def forward(self, xyz, features=None):
        inds = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        idx, _ = ops.ball_query_stratified(xyz, new_xyz, self.radius,
                                           self.nsample)
        grouped = ops.group_localize(xyz, features, new_xyz, idx,
                                     self.radius)
        return new_xyz, torch.amax(self.mlp(grouped), dim=2), inds


class FPModule(nn.Module):
    def __init__(self, in_features: int, mlp):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist, idx = ops.three_nn(unknown, known)
        interp = ops.three_interpolate(known_feats, idx,
                                       ops.interpolation_weights(dist))
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class Backbone(nn.Module):
    """Four SA layers (2048/0.2/64, 1024/0.4/32, 512/0.8/16, 256/1.2/16)
    and two FP layers back to the 1024 SA2 positions, at the width
    multiplier `w` and with `out` channels at the last FP layer."""

    def __init__(self, input_feature_dim: int, w: int = 1, out: int = 256):
        super().__init__()
        self.sa1 = SAModuleVotes(2048, 0.2, 64, input_feature_dim,
                                 [64 * w, 64 * w, 128 * w])
        self.sa2 = SAModuleVotes(1024, 0.4, 32, 128 * w,
                                 [128 * w, 128 * w, 256 * w])
        self.sa3 = SAModuleVotes(512, 0.8, 16, 256 * w,
                                 [128 * w, 128 * w, 256 * w])
        self.sa4 = SAModuleVotes(256, 1.2, 16, 256 * w,
                                 [128 * w, 128 * w, 256 * w])
        self.fp1 = FPModule(512 * w, [256 * w, 256 * w])
        self.fp2 = FPModule(512 * w, [256 * w, out])

    def forward(self, pointcloud):
        ep = {}
        xyz = pointcloud[..., 0:3]
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        for i, sa in enumerate((self.sa1, self.sa2, self.sa3, self.sa4), 1):
            xyz, features, inds = sa(xyz, features)
            ep[f"sa{i}_inds"] = inds
            ep[f"sa{i}_xyz"] = xyz
            ep[f"sa{i}_features"] = features
        features = self.fp1(ep["sa3_xyz"], ep["sa4_xyz"],
                            ep["sa3_features"], ep["sa4_features"])
        features = self.fp2(ep["sa2_xyz"], ep["sa3_xyz"],
                            ep["sa2_features"], features)
        ep["fp2_features"] = features
        ep["fp2_xyz"] = ep["sa2_xyz"]
        ep["fp2_inds"] = ep["sa1_inds"][:, 0:ep["fp2_xyz"].shape[1]]
        return ep
