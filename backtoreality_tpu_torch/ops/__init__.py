"""Point-cloud op library (PyTorch).

Counterpart of ``backtoreality_tpu/ops``. The ops that the JAX package
runs as Pallas TPU kernels (furthest point sampling, stratified ball
query, stratified grouping, the latter also fused with a set-abstraction
layer's localize step) and the exact first-k ball query, which it leaves
to XLA, have hand-written CUDA kernels here, launched for CUDA tensors;
CPU tensors take each kernel's plain PyTorch version. The other ops it
left to XLA (gathers, 3-NN, chamfer) are plain PyTorch on every device.
Everything is batched and channels-last.
"""

from backtoreality_tpu_torch.ops.fps import furthest_point_sample
from backtoreality_tpu_torch.ops.ball_query import (ball_query,
                                                     ball_query_stratified)
from backtoreality_tpu_torch.ops.chamfer import huber_loss, nn_distance
from backtoreality_tpu_torch.ops.grouping import (
    gather_points, group_localize_stratified, group_points,
    group_points_stratified, sample_uniformly)
from backtoreality_tpu_torch.ops.interpolate import (three_interpolate,
                                                      three_nn)
from backtoreality_tpu_torch.ops.topk import top_k_indices

__all__ = [
    "furthest_point_sample",
    "ball_query",
    "ball_query_stratified",
    "gather_points",
    "group_points",
    "group_points_stratified",
    "group_localize_stratified",
    "sample_uniformly",
    "three_nn",
    "three_interpolate",
    "nn_distance",
    "huber_loss",
    "top_k_indices",
]
