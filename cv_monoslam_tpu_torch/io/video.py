""".avi video ingestion — the reference's m_playType video mode
(SLAM.cpp:288-309: cvCaptureFromAVI + per-frame grab; 529-543: RGB->gray).

Primary path: a self-contained RIFF walker that indexes the MJPEG frame
chunks ('00dc'/'00db') once, giving random access by frame number without
decoding ahead — each frame is an independent JPEG decoded through PIL.
Non-MJPEG codecs fall back to OpenCV's VideoCapture when available (the
reference's own backend).

Also provides a minimal standards-conforming MJPEG AVI writer (RIFF +
avih/strh/strf headers + idx1) used by tests and the synthetic tooling;
files it writes are readable by OpenCV and vice versa.
"""

from __future__ import annotations

import io as _io
import struct
from typing import List, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# RIFF / MJPEG-AVI reading
# --------------------------------------------------------------------------


def index_avi_frames(path: str) -> List[Tuple[int, int]]:
    """Walk the RIFF tree; return [(offset, size)] of video frame chunks.

    Handles 'LIST movi' and nested 'rec ' lists; frame chunks are ids
    '##dc' / '##db' (compressed / uncompressed DIB).
    """
    frames: List[Tuple[int, int]] = []
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"not an AVI file: {path}")
        riff_end = 8 + struct.unpack("<I", head[4:8])[0]

        def walk(pos: int, end: int):
            while pos + 8 <= end:
                f.seek(pos)
                hdr = f.read(8)
                if len(hdr) < 8:
                    return
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:8])[0]
                body = pos + 8
                if cid in (b"RIFF", b"LIST"):
                    walk(body + 4, body + size)      # skip the list type
                elif cid[2:4] in (b"dc", b"db") and size > 0:
                    frames.append((body, size))
                pos = body + size + (size & 1)       # word alignment

        walk(12, min(riff_end, _file_size(f)))
    return frames


def _file_size(f) -> int:
    cur = f.tell()
    f.seek(0, 2)
    n = f.tell()
    f.seek(cur)
    return n


def _decode_jpeg_gray(data: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(_io.BytesIO(data)).convert("L")
    return np.asarray(img, dtype=np.float32)


class VideoSequence:
    """Image provider over an .avi file (same protocol as ImageSequence).

    ``get(frame_id)`` returns grayscale float32 frame number ``frame_id``
    (the odometry file's image index — the reference pairs odometry row k
    with video frame k). MJPEG files are indexed once and decoded on
    demand; other codecs use OpenCV with exact intra seek fallback to a
    decoded cache.
    """

    def __init__(self, path: str):
        self.path = path
        self._frames: Optional[List[Tuple[int, int]]] = None
        self._cap = None
        self._cache = {}
        try:
            idx = index_avi_frames(path)
        except ValueError:
            idx = []
        if idx and self._looks_jpeg(idx[0]):
            self._frames = idx
        else:
            try:
                import cv2

                self._cap = cv2.VideoCapture(path)
                if not self._cap.isOpened():
                    raise RuntimeError(f"cannot open video: {path}")
            except ImportError as e:
                raise RuntimeError(
                    f"unsupported non-MJPEG AVI without OpenCV: {path}"
                ) from e

    def _looks_jpeg(self, entry: Tuple[int, int]) -> bool:
        off, _ = entry
        with open(self.path, "rb") as f:
            f.seek(off)
            return f.read(2) == b"\xff\xd8"

    def __len__(self) -> int:
        if self._frames is not None:
            return len(self._frames)
        import cv2

        return int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def get(self, frame_id: int) -> np.ndarray:
        k = int(frame_id)
        if self._frames is not None:
            off, size = self._frames[k]
            with open(self.path, "rb") as f:
                f.seek(off)
                data = f.read(size)
            return _decode_jpeg_gray(data)
        if k in self._cache:
            return self._cache[k]
        import cv2

        self._cap.set(cv2.CAP_PROP_POS_FRAMES, k)
        ok, frame = self._cap.read()
        if not ok:
            raise IndexError(f"frame {k} unreadable in {self.path}")
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)
        self._cache[k] = gray
        return gray


# --------------------------------------------------------------------------
# MJPEG-AVI writing (tests / synthetic tooling)
# --------------------------------------------------------------------------


def _jpeg_encode_gray(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8), "L").convert(
        "RGB").save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(path: str, frames: Optional[np.ndarray] = None,
                    fps: int = 10, quality: int = 95,
                    payloads: Optional[List[bytes]] = None,
                    size: Optional[Tuple[int, int]] = None) -> None:
    """frames: (N, H, W) grayscale uint8/float in [0, 255] -> MJPG .avi.

    Alternatively pass pre-encoded JPEG ``payloads`` + ``size=(w, h)`` —
    used to build an .avi bit-identical (per frame) to a %04d.jpg
    directory, the reference's two interchangeable play modes.
    """
    if payloads is None:
        frames = np.asarray(frames)
        n, h, w = frames.shape
        payloads = [_jpeg_encode_gray(f, quality) for f in frames]
    else:
        w, h = size
        n = len(payloads)
    max_sz = max(len(p) for p in payloads) if payloads else 0

    def chunk(cid: bytes, data: bytes) -> bytes:
        pad = b"\x00" if len(data) & 1 else b""
        return cid + struct.pack("<I", len(data)) + data + pad

    def lst(ltype: bytes, data: bytes) -> bytes:
        return chunk(b"LIST", ltype + data)

    avih = struct.pack(
        "<14I", 1000000 // fps, max_sz * fps, 0, 0x10, n, 0, 1, max_sz,
        w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG"
            + struct.pack("<10I", 0, 0, 0, 1, fps, 0, n, max_sz,
                          0xFFFFFFFF, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_items = []
    offsets = []
    pos = 4                                         # after the 'movi' tag
    for p in payloads:
        offsets.append(pos)
        c = chunk(b"00dc", p)
        movi_items.append(c)
        pos += len(c)
    movi = lst(b"movi", b"".join(movi_items))

    idx = b"".join(
        b"00dc" + struct.pack("<3I", 0x10, off, len(p))
        for off, p in zip(offsets, payloads))
    idx1 = chunk(b"idx1", idx)

    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
