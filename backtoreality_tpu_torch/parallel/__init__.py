"""Data parallelism: the process group, the row split and the collectives
of a global-batch train step (counterpart of
``backtoreality_tpu/parallel``)."""

from backtoreality_tpu_torch.parallel.mesh import (
    ShardedRows, all_reduce_grads, all_reduce_sum, backend, check_same,
    free_port, gather_rows, init, process_shard_info, rank, replicate,
    shard_rows, shutdown, world)

__all__ = ["ShardedRows", "all_reduce_grads", "all_reduce_sum", "backend",
           "check_same", "free_port", "gather_rows", "init",
           "process_shard_info", "rank", "replicate", "shard_rows",
           "shutdown", "world"]
