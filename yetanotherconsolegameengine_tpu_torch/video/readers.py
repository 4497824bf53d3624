"""Asynchronous frame sources.

Copied from ``yetanotherconsolegameengine_tpu/video/readers.py``. A reader
exposes (width, height, fps) and ``try_get_frame() -> (H, W, 3) uint8 or
None``.

``FfmpegVideoReader`` runs an ``ffmpeg`` subprocess decoding to raw RGB
over a pipe, with a reader thread filling a double buffer ahead of the
consumer, FPS pacing and a restart at the end of the file;
``open_camera`` reads a v4l2 device the same way. ``SyntheticReader``
generates procedural frames, so the video texture path runs with no media
files and no ffmpeg.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np


class SyntheticReader:
    """Procedural animated frames (plasma pattern); IFrameReader-shaped."""

    def __init__(self, width: int = 320, height: int = 180,
                 fps: float = 30.0):
        self.width = width
        self.height = height
        self.fps = fps
        self._t0 = time.monotonic()

    def try_get_frame(self) -> Optional[np.ndarray]:
        t = time.monotonic() - self._t0
        y, x = np.mgrid[0:self.height, 0:self.width].astype(np.float32)
        u = x / self.width * 6.28
        v = y / self.height * 6.28
        r = np.sin(u + t) * 0.5 + 0.5
        g = np.sin(v + 1.3 * t) * 0.5 + 0.5
        b = np.sin(u + v + 0.7 * t) * 0.5 + 0.5
        return (np.stack([r, g, b], -1) * 255).astype(np.uint8)

    def close(self):
        pass


def probe_video(path: str) -> Tuple[int, int, float]:
    """(width, height, fps) via ffprobe (the reference probes with OpenCV,
    AsyncFFMPEGVideoReader.cs metadata block)."""
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        raise RuntimeError("ffprobe not found")
    out = subprocess.run(
        [ffprobe, "-v", "quiet", "-print_format", "json", "-show_streams",
         "-select_streams", "v:0", path],
        capture_output=True, timeout=30, check=True)
    info = json.loads(out.stdout)["streams"][0]
    num, den = (info.get("avg_frame_rate") or "30/1").split("/")
    fps = float(num) / max(1.0, float(den))
    return int(info["width"]), int(info["height"]), fps


def open_camera(device: str = "/dev/video0", width: int = 640,
                height: int = 360, fps: float = 30.0) -> "FfmpegVideoReader":
    """Live camera capture (AsyncCameraReader.cs role): the same ffmpeg
    raw-RGB pipe reading from a v4l2 device instead of a file (the image
    has no OpenCV; ffmpeg's v4l2 demuxer replaces VideoCapture)."""
    r = FfmpegVideoReader.__new__(FfmpegVideoReader)
    r.path = device
    r.fps = fps
    r.width = width
    r.height = height
    r.loop = False
    r._extra_args = ["-f", "v4l2", "-framerate", str(int(fps)),
                     "-video_size", f"{width}x{height}"]
    r._init_buffers()
    return r


class FfmpegVideoReader:
    """ffmpeg subprocess -> raw RGB frames, double-buffered on a thread.

    Reader thread decodes ahead into two alternating buffers; the consumer
    takes the freshest completed frame, FPS-paced (the double-buffered
    unmanaged memory scheme of AsyncFFMPEGVideoReader.cs:201-258).
    Auto-restarts the decoder at EOF (:283-303) for looping playback.
    """

    def __init__(self, path: str, width: Optional[int] = None,
                 height: Optional[int] = None, loop: bool = True):
        self.path = path
        src_w, src_h, self.fps = probe_video(path)
        self.width = width or src_w
        self.height = height or src_h
        self.loop = loop
        self._extra_args: list = []
        self._init_buffers()

    def _init_buffers(self):
        self._frame_bytes = self.width * self.height * 3
        self._buffers = [np.zeros((self.height, self.width, 3), np.uint8)
                         for _ in range(2)]
        self._ready_idx = -1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._proc: Optional[subprocess.Popen] = None
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _spawn(self):
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            raise RuntimeError("ffmpeg not found")
        return subprocess.Popen(
            [ffmpeg, "-v", "quiet", *self._extra_args, "-i", self.path,
             "-f", "rawvideo", "-pix_fmt", "rgb24",
             "-s", f"{self.width}x{self.height}", "pipe:1"],
            stdout=subprocess.PIPE, start_new_session=True)

    def _read_loop(self):
        write_idx = 0
        while not self._stop.is_set():
            if self._proc is None or self._proc.poll() is not None:
                if self._proc is not None and not self.loop:
                    return
                try:
                    self._proc = self._spawn()
                except RuntimeError:
                    return
            buf = self._buffers[write_idx]
            view = memoryview(buf).cast("B")
            got = 0
            while got < self._frame_bytes and not self._stop.is_set():
                chunk = self._proc.stdout.read(self._frame_bytes - got)
                if not chunk:
                    break
                view[got:got + len(chunk)] = chunk
                got += len(chunk)
            if got == self._frame_bytes:
                with self._lock:
                    self._ready_idx = write_idx
                write_idx = 1 - write_idx
                # Pace the decode to the video's FPS.
                time.sleep(max(0.0, 1.0 / max(1.0, self.fps) - 0.001))
            elif self._proc.poll() is None:
                time.sleep(0.005)

    def try_get_frame(self) -> Optional[np.ndarray]:
        with self._lock:
            if self._ready_idx < 0:
                return None
            return self._buffers[self._ready_idx].copy()

    def close(self):
        self._stop.set()
        if self._proc is not None:
            try:
                self._proc.terminate()
            except OSError:
                pass
        self._thread.join(timeout=2.0)
