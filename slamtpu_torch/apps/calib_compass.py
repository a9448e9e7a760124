"""Compass logger for IMU noise calibration, the reference's
``pipeline_calib_compass`` (port of slamtpu/apps/calib_compass.py): decode
the ANPP packets of a replay, keep the complete NavFrames and write them as
the CSV archive for offline Allan-variance analysis. Host only."""
from __future__ import annotations

import dataclasses
from typing import List

from ..ins.anpp import AnppDecoder, NavFrame
from ..runtime.export import write_compass_csv
from ..runtime.replay import STREAM_COMPASS, read_replay


@dataclasses.dataclass
class CalibCompassApp:
    def __post_init__(self):
        self.decoder = AnppDecoder()
        self.frames: List[NavFrame] = []

    def run_replay(self, replay_path: str, max_frames: int = 10**9):
        for stream, _ts, payload in read_replay(replay_path):
            if stream != STREAM_COMPASS:
                continue
            frame = self.decoder.push_packet(payload)
            if frame is not None:
                self.frames.append(frame)
                if len(self.frames) >= max_frames:
                    break
        return self.frames

    def export(self, path: str):
        write_compass_csv(self.frames, path)
