"""backtoreality_tpu_torch: the PyTorch/CUDA port of the JAX package
(backtoreality_tpu).

The JAX package stays the reference; this package mirrors its layout and
names and runs on an NVIDIA Hopper card, with hand-written CUDA kernels
where the JAX package has Pallas TPU kernels. It imports nothing of JAX
or of the JAX package.

Subpackages
-----------
ops       Point-cloud ops (FPS, stratified ball query and stratified
          grouping with CUDA kernels; gathers, 3-NN interpolation and
          chamfer distance in plain PyTorch).
nn        PointNet++ layers (SharedMLP, BatchNorm, SA/FP modules).
models    The VoteNet detector.
losses    The VoteNet FSB criterion.
data      Dataset configs, detection datasets, host loaders (numpy).
eval      Box geometry, NMS, AP evaluation (host-side numpy).
train     The evaluation and training entry points (VoteNet and
          GroupFree3D, four recipes each), data-parallel over processes.
parallel  The process group, the row split and the collectives of a
          global-batch train step.
bridge    JAX variables -> the port's state_dict.
"""

__version__ = "0.1.0"
