from .data_parallel import (
    average_batch_stats,
    make_compressed_dp_train_step,
    make_compressed_hier_train_step,
    make_dp_train_step,
    make_shardmap_dp_train_step,
    rank_seed,
    replicate,
    set_batchnorm_group,
    shard_batch,
)
from .distributed import Groups, check_world, init_world, make_groups, spawn

__all__ = [
    "Groups",
    "average_batch_stats",
    "check_world",
    "init_world",
    "make_compressed_dp_train_step",
    "make_compressed_hier_train_step",
    "make_dp_train_step",
    "make_groups",
    "make_shardmap_dp_train_step",
    "rank_seed",
    "replicate",
    "set_batchnorm_group",
    "shard_batch",
    "spawn",
]
