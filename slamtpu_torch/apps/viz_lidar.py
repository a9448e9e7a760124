"""LiDAR decode check, the reference's ``viz_lidar_udp`` (port of
slamtpu/apps/viz_lidar.py): decode the packets of a replay into sweeps,
project them on ``device`` and write PLY point clouds to look at."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..lidar.ouster import FrameAssembler, FrameGrid, build_luts
from ..lidar.project import ScanBuffer, filters_from_params, project_frame
from ..runtime.config import PipelineConfig
from ..runtime.export import write_ply
from ..runtime.replay import STREAM_LIDAR, read_replay


@dataclasses.dataclass
class VizLidarApp:
    cfg: PipelineConfig
    device: torch.device  # where the projection runs ("cuda" or "cpu")

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.luts = build_luts(self.cfg.meta, self.cfg.lidar)
        self.assembler = FrameAssembler(self.cfg.meta, self.luts)
        self.filters = filters_from_params(self.cfg.lidar)
        self.frames: List[FrameGrid] = []
        self._dir = torch.as_tensor(self.luts.direction, dtype=torch.float32, device=self.device)
        self._off = torch.as_tensor(self.luts.offset, dtype=torch.float32, device=self.device)

    def run_replay(self, replay_path: str, max_frames: int = 10**9):
        for stream, _ts, payload in read_replay(replay_path):
            if stream != STREAM_LIDAR:
                continue
            frame = self.assembler.push_packet(payload)
            if frame is not None:
                self.frames.append(frame)
                if len(self.frames) >= max_frames:
                    break
        return self.frames

    def project(self, frame: FrameGrid) -> ScanBuffer:
        """The projected ScanBuffer of a decoded sweep (body frame)."""
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        return project_frame(t(frame.ranges_m), t(frame.reflectivity),
                             t(frame.col_timestamp_s.astype(np.float32)), t(frame.col_valid),
                             self._dir, self._off, self.filters)

    def export_frame(self, frame: FrameGrid, path: str) -> int:
        sb = self.project(frame)
        write_ply(sb.points.cpu().numpy(), path, mask=sb.mask.cpu().numpy())
        return int(sb.num_points)
