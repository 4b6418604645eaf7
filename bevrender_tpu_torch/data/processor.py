"""Dataset list construction (own copy of bevrender_tpu/data/processor.py).

Host-side, numpy only: reads the GPS trace CSV, converts UTM poses to aerial
map pixel coordinates through the inverse JGW world-file affine, splits the
trace into contiguous sequences at gaps of a second or more, and builds
temporal windows (non-overlapping or sliding) of more than
``window_num_imgs`` frames within ``window_timespin`` microseconds.

A record has 12 fields: ``[timestamp, rgb_path, map_path, utm_e, utm_n,
utm_h, roll, pitch, yaw, pixel_x, pixel_y, vehicle_type]``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SPLIT_TIMESPIN_US = 1e6  # dataprocessor.py:22

# CSV column layout (dataprocessor.py:12-21)
(
    TIMESTAMP_COL,
    VEHICLE_TYPE_COL,
    UTM_EASTING_COL,
    UTM_NORTHING_COL,
    UTM_HEIGHT_COL,
    ROLL_COL,
    PITCH_COL,
    YAW_COL,
) = range(8)

# Record field indices (dataprocessor.py:347-366)
(
    REC_TIMESTAMP,
    REC_RGB_PATH,
    REC_MAP_PATH,
    REC_UTM_E,
    REC_UTM_N,
    REC_UTM_H,
    REC_ROLL,
    REC_PITCH,
    REC_YAW,
    REC_PIXEL_X,
    REC_PIXEL_Y,
    REC_VEHICLE_TYPE,
) = range(12)


def pixel_from_utm(
    utm_northing: float, utm_easting: float, jgw_info: Sequence[float]
) -> Tuple[float, float]:
    """Invert the 6-parameter JGW world-file affine (dataprocessor.py:404-413).

    jgw_info = (a, d, b, e, c, f) with world = [[a, b], [d, e]] @ pixel + (c, f).
    """
    a, d, b, e, c, f = jgw_info
    det = a * e - b * d
    pixel_x = (e * utm_easting - b * utm_northing + b * f - e * c) / det
    pixel_y = (-d * utm_easting + a * utm_northing - a * f + d * c) / det
    return pixel_x, pixel_y


@dataclass
class DatasetProcessor:
    """API-parity processor (constructor keys match the reference's,
    dataprocessor.py:24-79; unused knobs kept so reference configs drop in)."""

    gps_file_path: str
    rgb_img_dir: str
    map_img_dir: str
    jgw_info: Sequence[float]
    map_width: int
    map_height: int
    window_timespin: float  # microseconds
    window_num_imgs: int
    overlap: bool = False
    map_resize_scale: float = 1.0
    dataset_dir: str = ""
    logger: Optional[object] = None

    # ------------------------------------------------------------------
    def get_full_datalist(self) -> List[list]:
        """CSV rows -> 12-field records (dataprocessor.py:368-402)."""
        lines = np.loadtxt(Path(self.gps_file_path), delimiter=",", dtype=np.float64)
        lines = np.atleast_2d(lines)
        records = []
        for line in lines:
            ts = line[TIMESTAMP_COL]
            img_name = f"{int(ts)}.png"
            px, py = pixel_from_utm(
                line[UTM_NORTHING_COL], line[UTM_EASTING_COL], self.jgw_info
            )
            if not (0 <= px < self.map_width and 0 <= py < self.map_height):
                raise ValueError(
                    f"pose at ts {ts} maps outside the aerial map: ({px}, {py})"
                )
            records.append(
                [
                    ts,
                    str(Path(self.rgb_img_dir, img_name)),
                    str(Path(self.map_img_dir, img_name)),
                    line[UTM_EASTING_COL],
                    line[UTM_NORTHING_COL],
                    line[UTM_HEIGHT_COL],
                    line[ROLL_COL],
                    line[PITCH_COL],
                    line[YAW_COL],
                    px,
                    py,
                    int(line[VEHICLE_TYPE_COL]),
                ]
            )
        return records

    def split_sequence(self, records: List[list]) -> List[List[list]]:
        """Break the trace at >1 s gaps (dataprocessor.py:322-345)."""
        ts = np.array([r[REC_TIMESTAMP] for r in records], dtype=np.float64)
        if not np.all(ts[:-1] <= ts[1:]):
            raise ValueError("GPS trace timestamps must be sorted")
        breaks = np.where(ts[1:] - ts[:-1] >= SPLIT_TIMESPIN_US)[0] + 1
        bounds = np.concatenate([[0], breaks, [len(records)]])
        return [records[int(a) : int(b)] for a, b in zip(bounds[:-1], bounds[1:])]

    # ------------------------------------------------------------------
    def _windows(
        self, sequences: List[List[list]], overlap: bool
    ) -> List[List[list]]:
        """Temporal windows longer than ``window_num_imgs`` within
        ``window_timespin`` (non-overlap: dataprocessor.py:125-152;
        sliding: 229-250)."""
        out = []
        for seq in sequences:
            if overlap:
                starts = range(max(0, len(seq) - self.window_num_imgs))
            else:
                starts = None
            if overlap:
                for start in starts:
                    w = self._take_window(seq, start)
                    if len(w) > self.window_num_imgs:
                        out.append(w)
            else:
                idx = 0
                while idx + 1 < len(seq):
                    w = self._take_window(seq, idx)
                    idx += max(len(w), 1)
                    if len(w) > self.window_num_imgs:
                        out.append(w)
        return out

    def _take_window(self, seq: List[list], start: int) -> List[list]:
        t0 = seq[start][REC_TIMESTAMP]
        w = []
        i = start
        while i + 1 < len(seq) and seq[i][REC_TIMESTAMP] - t0 <= self.window_timespin:
            w.append(seq[i])
            i += 1
        return w

    def get_train_datalist(self, sequences) -> List[List[list]]:
        return self._windows(sequences, overlap=False)

    def get_overlap_train_datalist(self, sequences) -> List[List[list]]:
        return self._windows(sequences, overlap=True)

    def get_val_datalist(
        self, sequences, percentage: float, rng: Optional[random.Random] = None
    ):
        """Sample validation windows and remove their frames from the train
        sequences (dataprocessor.py:154-227; overlap variant removes only the
        first frame, 252-320). Seeded, unlike the reference (SURVEY 5.2)."""
        rng = rng or random.Random(0)
        candidates = self._windows(sequences, overlap=self.overlap)
        n_take = int(len(candidates) * percentage)
        take = sorted(rng.sample(range(len(candidates)), n_take))
        val = [candidates[i] for i in take]
        drop = set()
        for w in val:
            frames = [w[0]] if self.overlap else w
            for fr in frames:
                drop.add(id(fr))
        remaining = [
            [fr for fr in seq if id(fr) not in drop] for seq in sequences
        ]
        return val, remaining

    # ------------------------------------------------------------------
    def process_windows(self) -> List[List[list]]:
        """CSV -> sequences -> windows (the list the Dataset consumes);
        mirrors ``process_dataset`` (dataprocessor.py:81-91) minus dataset
        construction, which the caller owns."""
        records = self.get_full_datalist()
        sequences = self.split_sequence(records)
        if self.overlap:
            return self.get_overlap_train_datalist(sequences)
        return self.get_train_datalist(sequences)
