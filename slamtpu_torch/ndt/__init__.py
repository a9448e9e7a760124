from .constants import gauss_constants
from .fused_math import (LAUNCHES, aniso_pair, fused_objective, gather_megaT, gicp_align,
                         gicp_align_aniso, gicp_align_fused, gicp_pair, ndt_pair, newton_align_fused,
                         pregathered_table, rows_objective, score_grad_hess_fused)
from .gicp import (gicp_map, gicp_map_aniso, regularize_plane_covariance, source_point_covariances,
                   stencil_point_covariances)
from .multires import MultiResLevel, build_pyramid, multires_align
from .newton import NewtonConfig, NewtonResult, newton_align, regularize_step
from .objective import (NdtObjective, full_hessian, point_jacobian, sanitize_points, score_grad_hess,
                        score_only)
from .regmap import RegMap, build_regmap, empty_regmap, grid_rows
from .svn import SvnConfig, SvnResult, svn_align, svn_align_reg
