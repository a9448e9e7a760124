from . import voxel
from .gaussian_map import GaussianMap, VoxelStats, build_map, finalize, stats_from_points
