"""Point-cloud op library (PyTorch).

Counterpart of ``backtoreality_tpu/ops``. The ops that the JAX package
runs as Pallas TPU kernels (furthest point sampling, stratified ball
query) have hand-written CUDA kernels here, launched for CUDA tensors;
CPU tensors take each kernel's plain PyTorch version. Everything is
batched and channels-last.
"""

from backtoreality_tpu_torch.ops.fps import furthest_point_sample
from backtoreality_tpu_torch.ops.ball_query import ball_query_stratified
from backtoreality_tpu_torch.ops.grouping import (gather_points,
                                                   group_points,
                                                   group_points_stratified)
from backtoreality_tpu_torch.ops.interpolate import (three_interpolate,
                                                      three_nn)

__all__ = [
    "furthest_point_sample",
    "ball_query_stratified",
    "gather_points",
    "group_points",
    "group_points_stratified",
    "three_nn",
    "three_interpolate",
]
