from .sharded import (
    COLLECTIVES,
    batch_align_sharded,
    build_map_sharded,
    lo_train_step,
    newton_align_sharded_fused,
    newton_align_sharded_reg,
    svn_align_sharded,
)

__all__ = [
    "COLLECTIVES",
    "batch_align_sharded",
    "build_map_sharded",
    "newton_align_sharded_fused",
    "newton_align_sharded_reg",
    "svn_align_sharded",
    "lo_train_step",
]
