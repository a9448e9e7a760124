from .ouster import (FrameAssembler, FrameGrid, LidarParams, Luts, SensorMeta, build_luts,
                     packet_size, parse_packet, synthetic_os2_metadata)
from .project import ProjectionFilters, ScanBuffer, filters_from_params, project_frame
