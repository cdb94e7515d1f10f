"""Plain point-cloud ops of the reference: furthest point sampling, the
stratified ball query, the gathers, 3-NN interpolation and the
nearest-neighbour distances, in plain PyTorch on any device.

Semantics, as the detectors' published code defines them:

* FPS starts at index 0, skips points with |p|^2 <= 1e-3 (padding) and
  takes the point furthest from the chosen set, the lowest index among
  ties; squared distances are rounded as ``(dx*dx + dy*dy) + dz*dz``.
* The stratified ball query splits the N points into ``nsample``
  contiguous buckets of ``bucket`` points (ceil(N / nsample) rounded up to
  a multiple of 128); slot s holds the first point of bucket s inside the
  ball, an empty slot the first hit of the first non-empty bucket, and a
  centre with no hit index 0 in every slot. Inside the ball means
  ``|p|^2 - 2 c.p < r^2 - |c|^2`` with |p|^2 and r^2 - |c|^2 rounded to
  float32 as above and the left side summed as three fused multiply-adds
  ``fma(-2 cz, z, fma(-2 cy, y, fma(-2 cx, x, |p|^2)))``, each rounded
  once to float32. Each multiply-add is taken exactly in float64 and
  rounded to float32 (a float32 product is exact in float64; the sum may
  round twice, which changes the float32 result in about one case in 2^29
  and the test only where that case lies on the radius).
"""

from __future__ import annotations

import torch

_PAD_NORM2 = 1e-3
_BIG = 1e10


def _sq3(x, y, z):
    return (x * x + y * y) + z * z


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices."""
    xyz = xyz.detach().float()
    b = xyz.shape[0]
    x, y, z = xyz.unbind(-1)
    valid = _sq3(x, y, z) > _PAD_NORM2
    mindist = torch.where(valid, _BIG, -1.0).to(xyz.dtype)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    idxs = torch.zeros(b, npoint, dtype=torch.int32, device=xyz.device)
    for j in range(1, npoint):
        ref = xyz[rows, last]
        d = _sq3(x - ref[:, 0:1], y - ref[:, 1:2], z - ref[:, 2:3])
        mindist = torch.minimum(mindist, d)
        last = torch.argmax(mindist, dim=-1)
        idxs[:, j] = last.to(torch.int32)
    return idxs


def bucket_size(n: int, nsample: int) -> int:
    return max(-(-(-(-n // nsample)) // 128) * 128, 128)


def _fma32(a, b, c):
    """round_f32(a * b + c) for float32 tensors, through float64."""
    return (a.double() * b.double() + c.double()).float()


def ball_query_stratified(xyz, new_xyz, radius: float, nsample: int,
                          chunk_bytes: int = 1 << 29):
    """(B, N, 3) points, (B, M, 3) centres -> (B, M, nsample) int32
    indices and the (B, M, nsample) mask of slots with a hit of their
    own bucket."""
    xyz = xyz.detach().float()
    new_xyz = new_xyz.detach().float()
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    r2 = torch.tensor(radius * radius, dtype=torch.float32,
                      device=xyz.device)
    bucket = bucket_size(n, nsample)
    pad = bucket * nsample - n
    x, y, z = (v[:, None, :] for v in xyz.unbind(-1))  # (B, 1, N)
    pp = _sq3(x, y, z)
    chunk = max(1, min(m, chunk_bytes // (8 * b * n)))
    idx_out, hit_out = [], []
    base = torch.arange(nsample, device=xyz.device) * bucket
    for start in range(0, m, chunk):
        c = new_xyz[:, start:start + chunk]  # (B, m', 3)
        cx, cy, cz = (v[..., None] for v in c.unbind(-1))  # (B, m', 1)
        qw = r2 - _sq3(cx, cy, cz)
        d = _fma32(-2.0 * cz, z, _fma32(-2.0 * cy, y,
                                        _fma32(-2.0 * cx, x, pp)))
        mask = d < qw  # (B, m', N)
        if pad:
            mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (pad,))],
                             -1)
        mask_b = mask.reshape(mask.shape[:-1] + (nsample, bucket))
        has_hit = mask_b.any(dim=-1)
        local = torch.where(has_hit, mask_b.to(torch.uint8).argmax(dim=-1),
                            0)
        idx = base + local
        first_bucket = has_hit.to(torch.uint8).argmax(dim=-1, keepdim=True)
        fill = torch.gather(idx, -1, first_bucket)
        out = torch.where(has_hit, idx, fill)
        idx_out.append(torch.clamp(out, max=n - 1).to(torch.int32))
        hit_out.append(has_hit)
    return torch.cat(idx_out, 1), torch.cat(hit_out, 1)


def gather_points(points, idx):
    """(B, N, C) by (B, M) -> (B, M, C)."""
    c = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, c))


def group_points(points, idx):
    """(B, N, C) by (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    return gather_points(points, idx.reshape(b, m * s)).reshape(
        b, m, s, points.shape[-1])


def group_localize(xyz, features, new_xyz, idx, radius: float):
    """``[(xyz[idx] - centre) / radius, features[idx]]``: one subtraction,
    then a true division."""
    points = xyz if features is None else torch.cat([xyz, features], -1)
    grouped = group_points(points, idx)
    r = torch.full((), radius, dtype=xyz.dtype, device=xyz.device)
    local_xyz = (grouped[..., :3] - new_xyz[:, :, None, :]) / r
    if features is None:
        return local_xyz
    return torch.cat([local_xyz, grouped[..., 3:]], -1)


def pairwise_d2(a, b):
    """(B, M, 3) x (B, N, 3) -> (B, M, N) as |a|^2 - 2 a.b + |b|^2."""
    cross = torch.matmul(a, b.transpose(-1, -2))
    a2 = _sq3(*a.unbind(-1))[..., :, None]
    b2 = _sq3(*b.unbind(-1))[..., None, :]
    return a2 - 2.0 * cross + b2


def three_nn(unknown, known):
    """The 3 nearest known points of each unknown one: distances and
    int32 indices, the lowest index first among ties."""
    d2 = pairwise_d2(unknown.float(), known.float())
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    return (torch.sqrt(torch.clamp(d2s[..., :3], min=0.0)),
            idx[..., :3].to(torch.int32))


def three_interpolate(features, idx, weight):
    b, n, _ = idx.shape
    c = features.shape[-1]
    index = idx.reshape(b, n * 3, 1).long().expand(-1, -1, c)
    g = torch.gather(features, 1, index).reshape(b, n, 3, c)
    return torch.sum(g * weight[..., None], dim=2)


def interpolation_weights(dist, eps: float = 1e-8):
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def huber_loss(error, delta: float = 1.0):
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def nn_distance(pc1, pc2, l1: bool = False):
    """Each point's (squared, or with `l1` L1) distance to its nearest
    neighbour in the other set, and that neighbour's index."""
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]
    if l1:
        pc_dist = torch.sum(torch.abs(diff), dim=-1)
    else:
        pc_dist = torch.sum(diff * diff, dim=-1)
    return (torch.amin(pc_dist, dim=2),
            torch.argmin(pc_dist, dim=2).to(torch.int32),
            torch.amin(pc_dist, dim=1),
            torch.argmin(pc_dist, dim=1).to(torch.int32))


def top_k_indices(scores, k: int):
    """The k largest of each row, largest first, lower index first among
    ties."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][
        ..., :k]
