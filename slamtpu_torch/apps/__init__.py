"""Application pipelines: ``lo_svn.LoSvnApp`` mirrors the reference's
pipeline_lo_svn executable, ``odom_ndt.OdomNdtApp`` its plain pipeline and
``ligo_tc.LigoTcApp`` its pipeline_ligo_tc (ins_map and the other apps are
not ported yet)."""
from .common import IngestPipeline, TrajectoryEntry, ate_rmse, ins_pose_ned
from .lo_svn import LoSvnApp
