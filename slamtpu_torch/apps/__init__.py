"""Application pipelines: ``lo_svn.LoSvnApp`` mirrors the reference's
pipeline_lo_svn executable, ``odom_ndt.OdomNdtApp`` its plain pipeline,
``ligo_tc.LigoTcApp`` its pipeline_ligo_tc, ``ins_map.InsMapApp`` its
pipeline_ins_map_distribution, ``calib_compass.CalibCompassApp`` its
pipeline_calib_compass and ``viz_lidar.VizLidarApp`` its viz_lidar_udp."""
from .calib_compass import CalibCompassApp
from .common import IngestPipeline, TrajectoryEntry, ate_rmse, ins_pose_ned
from .ins_map import InsMapApp
from .ligo_tc import LigoTcApp
from .lo_svn import LoSvnApp
from .odom_ndt import OdomNdtApp
from .viz_lidar import VizLidarApp
