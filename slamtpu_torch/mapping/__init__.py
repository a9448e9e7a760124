from . import voxel
from .gaussian_map import (GaussianMap, VoxelStats, build_map, finalize, merge_stats,
                           stats_from_points)
