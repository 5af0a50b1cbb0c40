"""Video decode/encode on the host (cv2-backed).

Equivalent of the reference's FFmpeg reader/writer units
(video_framework/video_reader_unit.{h,cpp}, video_writer_unit.{h,cpp}):
BGR24 frames, fps sanitization, downscale modes with even-dimension
rounding, and streaming iteration.  The ffmpeg binary is not present in
this image; cv2's codec backend handles the containers.
"""

from __future__ import annotations

import dataclasses

import cv2
import numpy as np


@dataclasses.dataclass
class VideoInfo:
    width: int
    height: int
    fps: float
    frame_count: int
    orig_width: int
    orig_height: int


def _sanitize_fps(fps: float) -> float:
    # video_reader_unit.cpp:131-149: NaN -> 24, clamp [5, 60].
    if fps != fps or fps <= 0:
        return 24.0
    return min(max(fps, 5.0), 60.0)


def _even(x: int) -> int:
    return x - (x % 2)


def compute_scaled_dims(w: int, h: int, downscale: str, factor: float = 1.0,
                        min_size: int = 0, max_size: int = 0):
    """Downscale modes mirroring video_reader_unit.cpp:155-190."""
    if downscale == "none":
        sw, sh = w, h
    elif downscale == "by_factor":
        sw, sh = int(w / factor + 0.5), int(h / factor + 0.5)
    elif downscale == "to_min":
        m = min(w, h)
        if min_size and m > min_size:
            s = min_size / m
            sw, sh = int(w * s + 0.5), int(h * s + 0.5)
        else:
            sw, sh = w, h
    elif downscale == "to_max":
        m = max(w, h)
        if max_size and m > max_size:
            s = max_size / m
            sw, sh = int(w * s + 0.5), int(h * s + 0.5)
        else:
            sw, sh = w, h
    else:
        raise ValueError(f"unknown downscale mode {downscale}")
    return max(2, _even(sw)), max(2, _even(sh))


class VideoReader:
    """Streaming BGR frame source with optional downscaling."""

    def __init__(self, path: str, downscale: str = "none",
                 downscale_factor: float = 1.0, downscale_size: int = 0,
                 trim_to: int = 0):
        self._cap = cv2.VideoCapture(0 if path == "CAMERA" else path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        ow = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        oh = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w, h = compute_scaled_dims(ow, oh, downscale, downscale_factor,
                                   downscale_size, downscale_size)
        self.info = VideoInfo(
            width=w, height=h,
            fps=_sanitize_fps(self._cap.get(cv2.CAP_PROP_FPS)),
            frame_count=int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            orig_width=ow, orig_height=oh)
        self._trim_to = trim_to
        self._read = 0

    def __iter__(self):
        while True:
            if self._trim_to and self._read >= self._trim_to:
                return
            ok, frame = self._cap.read()
            if not ok:
                return
            if (frame.shape[1], frame.shape[0]) != (self.info.width,
                                                    self.info.height):
                frame = cv2.resize(frame,
                                   (self.info.width, self.info.height),
                                   interpolation=cv2.INTER_AREA)
            self._read += 1
            yield frame

    def pts_of(self, frame_idx: int) -> int:
        """Synthetic pts in 1/fps units scaled to a 1000-tick base."""
        return int(round(frame_idx * 1000.0 / self.info.fps))

    def seek(self, frame_idx: int) -> None:
        """Position the stream so the next read returns `frame_idx`
        (checkpoint resume; the reference reader seeks via
        av_seek_frame + nonkey skip, video_reader_unit.cpp:401-443)."""
        self._cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
        self._read = frame_idx

    def close(self):
        self._cap.release()


class VideoWriter:
    """Streaming BGR frame sink (mp4).

    Output-scaling options mirror VideoWriterOptions
    (video_writer_unit.h:45-69): `scale` factor (overrides min/max-dim),
    `scale_max_dim`/`scale_min_dim` fit the larger/smaller dimension, and
    dimensions round to a multiple of `fraction`.  cv2's encoder exposes
    no bit-rate control (the reference's bit_rate knob maps to
    VIDEOWRITER_PROP_QUALITY where the backend supports it)."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 scale: float = 1.0, scale_max_dim: int = 0,
                 scale_min_dim: int = 0, fraction: int = 4,
                 quality: float = 0.0, fourcc: str = "mp4v"):
        if scale_max_dim and scale_min_dim:
            raise ValueError("scale_max_dim and scale_min_dim are "
                             "mutually exclusive")
        if scale != 1.0:
            s = scale
        elif scale_max_dim:
            s = scale_max_dim / max(width, height)
        elif scale_min_dim:
            s = scale_min_dim / min(width, height)
        else:
            s = 1.0
        frac = max(1, fraction)
        self.width = max(frac, int(round(width * s / frac)) * frac)
        self.height = max(frac, int(round(height * s / frac)) * frac)
        self._w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc),
                                  fps, (self.width, self.height))
        if not self._w.isOpened():
            raise IOError(f"cannot open video writer: {path}")
        if quality > 0:
            self._w.set(cv2.VIDEOWRITER_PROP_QUALITY, quality)

    def write(self, frame_bgr: np.ndarray):
        if frame_bgr.shape[1] != self.width \
                or frame_bgr.shape[0] != self.height:
            frame_bgr = cv2.resize(frame_bgr, (self.width, self.height),
                                   interpolation=cv2.INTER_AREA)
        self._w.write(frame_bgr)

    def close(self):
        self._w.release()
