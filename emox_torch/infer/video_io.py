"""Video IO (the port's copy of emox/infer/video_io.py, numpy only):
frames to uint8, .mp4 writing through imageio or cv2 (optional imports)
with the audio muxed in by ffmpeg where it is installed, and the
reference's documented `.npz` output where none of them is; tiled grids of
a batch of clips; a cv2 frame reader."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class VideoReader:
    """cv2-backed reader with dims/fps/length/seek/read (capability parity
    with reference video.py:15-103 Video and videoreader.py:31-156).
    Yields RGB float32 frames in [-1, 1]."""

    def __init__(self, path: str):
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video {path}")
        self.path = path

    @property
    def fps(self) -> float:
        return float(self.cap.get(self._cv2.CAP_PROP_FPS) or 25.0)

    @property
    def width(self) -> int:
        return int(self.cap.get(self._cv2.CAP_PROP_FRAME_WIDTH))

    @property
    def height(self) -> int:
        return int(self.cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT))

    def __len__(self) -> int:
        return int(self.cap.get(self._cv2.CAP_PROP_FRAME_COUNT))

    def seek(self, frame_index: int) -> None:
        self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, frame_index)

    def read(self) -> Optional[np.ndarray]:
        ok, frame = self.cap.read()
        if not ok:
            return None
        rgb = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)
        return rgb.astype(np.float32) / 127.5 - 1.0

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def close(self) -> None:
        self.cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def frames_to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float frames -> uint8."""
    return np.clip((np.asarray(frames, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def save_video(frames: np.ndarray, path: str, fps: float = 25.0, wav: Optional[np.ndarray] = None, sample_rate: int = 16000) -> str:
    """[T, H, W, 3] float in [-1,1] or uint8 -> .mp4 (imageio/ffmpeg) or .npz
    fallback; mux audio when ffmpeg is available and wav is given."""
    arr = frames if frames.dtype == np.uint8 else frames_to_uint8(frames)
    if path.endswith(".npz"):
        np.savez_compressed(path, frames=arr, fps=fps)
        return path
    try:
        import imageio.v3 as iio

        iio.imwrite(path, arr, fps=fps, plugin="FFMPEG")
    except Exception:
        try:
            import cv2

            h, w = arr.shape[1:3]
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            for f in arr:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            vw.release()
        except Exception:
            path = path.rsplit(".", 1)[0] + ".npz"
            np.savez_compressed(path, frames=arr, fps=fps)
            return path
    if wav is not None:
        import subprocess, os

        wav_path = path + ".wav.tmp"
        try:
            _write_wav(wav_path, np.asarray(wav), sample_rate)
            muxed = path.rsplit(".", 1)[0] + "_audio.mp4"
            subprocess.run(
                ["ffmpeg", "-v", "quiet", "-y", "-i", path, "-i", wav_path, "-c:v", "copy", "-c:a", "aac", muxed],
                check=True,
            )
            os.replace(muxed, path)
        except (OSError, subprocess.CalledProcessError):
            pass
        finally:
            if os.path.exists(wav_path):
                os.remove(wav_path)
    return path


def tile_video_grid(videos: np.ndarray, n_cols: int = 6, pad: int = 2, pad_value: float = -1.0) -> np.ndarray:
    """[B, T, H, W, 3] batch of clips -> [T, Hg, Wg, 3] grid video (the
    reference's save_videos_grid tiling, reference
    magicanimate/utils/util.py:21-33 / torchvision make_grid semantics:
    row-major, `pad` pixels of border between and around cells)."""
    videos = np.asarray(videos)
    if videos.ndim != 5:
        raise ValueError(f"expected [B, T, H, W, C], got {videos.shape}")
    b, t, h, w, c = videos.shape
    cols = min(n_cols, b)
    rows = (b + cols - 1) // cols
    hg = rows * (h + pad) + pad
    wg = cols * (w + pad) + pad
    grid = np.full((t, hg, wg, c), pad_value, videos.dtype)
    for i in range(b):
        r, q = divmod(i, cols)
        y = pad + r * (h + pad)
        x = pad + q * (w + pad)
        grid[:, y : y + h, x : x + w] = videos[i]
    return grid


def save_videos_grid(videos: np.ndarray, path: str, fps: float = 25.0, n_cols: int = 6) -> str:
    """Batch of clips [B, T, H, W, 3] in [-1, 1] -> one tiled grid mp4
    (capability parity with reference magicanimate/utils/util.py:21-33)."""
    return save_video(tile_video_grid(videos, n_cols=n_cols), path, fps=fps)


def _write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    import struct, wave

    pcm = np.clip(wav, -1, 1)
    pcm16 = (pcm * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm16.tobytes())
