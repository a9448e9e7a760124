"""Application pipelines: ``lo_svn.LoSvnApp`` mirrors the reference's
pipeline_lo_svn executable (the other apps are not ported yet)."""
from .common import IngestPipeline, TrajectoryEntry, ate_rmse, ins_pose_ned
from .lo_svn import LoSvnApp
