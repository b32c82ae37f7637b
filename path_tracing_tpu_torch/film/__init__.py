"""Film: progressive accumulation, tone mapping, PNG output and input
(``path_tracing_tpu.film``; checkpoints are not ported yet)."""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AccumState:
    """Progressive accumulation state on the render device."""

    radiance_sum: torch.Tensor  # (H*W, 3) linear radiance summed over iterations
    n_iters: int

    @staticmethod
    def zeros(width: int, height: int, device) -> "AccumState":
        return AccumState(
            radiance_sum=torch.zeros((height * width, 3), device=device),
            n_iters=0)

    def add(self, frame: torch.Tensor) -> "AccumState":
        return AccumState(radiance_sum=self.radiance_sum + frame,
                          n_iters=self.n_iters + 1)

    def mean(self) -> torch.Tensor:
        return self.radiance_sum / max(self.n_iters, 1)


def tonemap_u8(linear, width: int, height: int) -> np.ndarray:
    """clamp [0, 1] -> gamma 1/2.2 -> u8, rows top to bottom (H, W, 3)."""
    img = np.asarray(linear, np.float32).reshape(height, width, 3)
    img = np.clip(img, 0.0, 1.0) ** (1.0 / 2.2)
    return (img * 255.0).astype(np.uint8)


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """Dependency-free PNG encoder (RGB8) -> bytes."""
    h, w, _ = rgb_u8.shape
    raw = b"".join(b"\x00" + rgb_u8[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb_u8))


def read_png(path: str) -> np.ndarray:
    """Dependency-free PNG reader: 8-bit RGB, not interlaced, every row
    filter.  Returns (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, w, h, idat = 8, None, None, b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bit, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                              body[:13])
            if bit != 8 or color != 2 or interlace:
                raise ValueError(f"{path}: only 8-bit RGB non-interlaced "
                                 "PNGs are read")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride, bpp = w * 3, 3
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(stride, np.int32)
    for i in range(h):
        row = raw[i * (stride + 1):(i + 1) * (stride + 1)]
        ft = row[0]
        line = np.frombuffer(row[1:], np.uint8).astype(np.int32)
        if ft == 1:        # Sub
            for j in range(bpp, stride):
                line[j] = (line[j] + line[j - bpp]) & 0xFF
        elif ft == 2:      # Up
            line = (line + prev) & 0xFF
        elif ft == 3:      # Average
            for j in range(stride):
                a = line[j - bpp] if j >= bpp else 0
                line[j] = (line[j] + (a + prev[j]) // 2) & 0xFF
        elif ft == 4:      # Paeth
            for j in range(stride):
                a = line[j - bpp] if j >= bpp else 0
                b = prev[j]
                c = prev[j - bpp] if j >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[j] = (line[j] + pred) & 0xFF
        elif ft != 0:
            raise ValueError(f"{path}: unknown PNG row filter {ft}")
        out[i] = line.reshape(w, 3)
        prev = line
    return out


def save_image(path: str, linear, width: int, height: int) -> None:
    write_png(path, tonemap_u8(linear, width, height))
