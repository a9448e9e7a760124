from . import replay, stats, sync
from .config import PipelineConfig, RegisterConfig
from .replay import STREAM_COMPASS, STREAM_LIDAR, ReplayWriter, read_replay
from .stats import KeyFrameStats, StageTimer, StatsArchive
from .sync import SyncedFrame, Synchronizer, interpolate_at
