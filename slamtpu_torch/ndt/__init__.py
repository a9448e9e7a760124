from .constants import gauss_constants
from .fused_math import (LAUNCHES, aniso_pair, fused_objective, gather_megaT, gicp_align_fused,
                         gicp_pair, ndt_pair, newton_align_fused, pregathered_table, rows_objective,
                         score_grad_hess_fused)
from .gicp import gicp_map, regularize_plane_covariance, stencil_point_covariances
from .newton import NewtonConfig, NewtonResult, regularize_step
from .objective import NdtObjective, sanitize_points
from .regmap import RegMap, build_regmap, empty_regmap, grid_rows
from .svn import SvnConfig, SvnResult, svn_align_reg
