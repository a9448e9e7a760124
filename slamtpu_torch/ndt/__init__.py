from .constants import gauss_constants
from .fused_math import LAUNCHES, aniso_pair, fused_objective, gather_megaT, ndt_pair
from .gicp import regularize_plane_covariance, stencil_point_covariances
from .objective import NdtObjective, sanitize_points
from .regmap import RegMap, build_regmap, empty_regmap, point_rows
from .svn import SvnConfig, SvnResult, svn_align_reg
