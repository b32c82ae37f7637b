"""Film: progressive accumulation, tone mapping and PNG output
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


def save_image(path: str, linear, width: int, height: int) -> None:
    write_png(path, tonemap_u8(linear, width, height))
