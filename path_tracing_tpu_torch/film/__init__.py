"""Film: progressive accumulation, tone mapping, PNG output and input,
the terminal preview and checkpoints (``path_tracing_tpu.film``).  A
checkpoint is the JAX package's npz (``radiance_sum``, ``n_iters``,
``meta_*``), so each package resumes from the other's file."""
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


# PNG colour type -> (samples per pixel, bit depths read)
_PNG_FORMATS = {0: (1, (1, 2, 4, 8)),     # grey
                2: (3, (8, 16)),          # RGB
                3: (1, (1, 2, 4, 8)),     # palette
                4: (2, (8, 16)),          # grey + alpha
                6: (4, (8, 16))}          # RGBA


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str):
    """Undo the per-row filters of a non-interlaced image: (h, stride)
    uint8, ``bpp`` bytes per complete pixel (at least 1)."""
    out = np.zeros((h, stride), np.uint8)
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
        out[i] = line
        prev = line
    return out


def read_png(path: str) -> np.ndarray:
    """Dependency-free PNG reader returning (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(path).convert("RGB")`` does, for non-interlaced grey (1,
    2, 4 or 8 bits, scaled to 0-255), RGB and RGBA (8 or 16 bits: the high
    byte), palette (1, 2, 4 or 8 bits, with PLTE) and grey + alpha (8 or
    16 bits).  Alpha is dropped and tRNS ignored.  Any other format raises
    a ValueError naming its colour type and bit depth."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, w, h, idat, plte = 8, None, None, b"", None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bit, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                              body[:13])
            fmt = _PNG_FORMATS.get(color)
            if fmt is None or bit not in fmt[1] or interlace:
                raise ValueError(
                    f"{path}: PNG colour type {color} at bit depth {bit}"
                    f"{' (interlaced)' if interlace else ''} is not read")
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    if w is None:
        raise ValueError(f"{path}: PNG without IHDR")
    ch = _PNG_FORMATS[color][0]
    stride = (w * ch * bit + 7) // 8
    rows = _unfilter(zlib.decompress(idat), h, stride,
                     max(1, ch * bit // 8), path)
    if bit == 16:      # big-endian samples: keep the high byte
        s = rows.reshape(h, w * ch, 2)[..., 0]
    elif bit == 8:
        s = rows
    else:              # packed samples, most significant bits first
        bits = np.unpackbits(rows, axis=1)[:, :w * bit]
        s = (bits.reshape(h, w, bit)
             * (1 << np.arange(bit - 1, -1, -1, dtype=np.uint8))).sum(
                 axis=2, dtype=np.uint8)
    s = s.reshape(h, w, ch)
    if color == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        return pal[s[..., 0]]
    if color in (0, 4):
        grey = s[..., 0]
        if bit < 8:
            grey = grey * np.uint8(255 // ((1 << bit) - 1))
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def save_image(path: str, linear, width: int, height: int) -> None:
    write_png(path, tonemap_u8(linear, width, height))


def ansi_preview(rgb_u8: np.ndarray, max_cols: int = 80) -> str:
    """An (H, W, 3) u8 image as 24-bit-colour Unicode half-blocks, the
    JAX package's string for string: each cell shows two stacked pixels
    ('▀', the top one as foreground, the bottom one as background), the
    image box-averaged down to ``max_cols`` columns at about square
    aspect."""
    h, w, _ = rgb_u8.shape
    cols = max(2, min(max_cols, w))
    rows2 = max(2, int(round(h * cols / w)))  # pixel rows in the preview
    rows2 += rows2 % 2

    def bucket(img, n, axis):
        edges = np.linspace(0, img.shape[axis], n + 1).astype(int)
        sums = np.add.reduceat(img.astype(np.float32), edges[:-1], axis=axis)
        cnt = np.maximum(np.diff(edges), 1)
        shape = [1, 1, 1]
        shape[axis] = n
        return sums / cnt.reshape(shape)

    small = bucket(bucket(rgb_u8, rows2, 0), cols, 1)
    small = np.clip(small + 0.5, 0, 255).astype(np.uint8)
    top, bot = small[0::2], small[1::2]
    lines = []
    for r in range(top.shape[0]):
        cells = []
        for c in range(cols):
            tr, tg, tb = (int(v) for v in top[r, c])
            br, bg, bb = (int(v) for v in bot[r, c])
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def save_checkpoint(path: str, state: AccumState, meta: dict | None = None
                    ) -> None:
    """Write the accumulation as the JAX package's npz: ``radiance_sum``
    (H*W, 3) float32, ``n_iters`` int32 and one ``meta_<k>`` per entry."""
    np.savez(path,
             radiance_sum=state.radiance_sum.detach().cpu().numpy()
             .astype(np.float32),
             n_iters=np.asarray(state.n_iters, np.int32),
             **{f"meta_{k}": v for k, v in (meta or {}).items()})


def load_checkpoint(path: str, device="cpu") -> tuple[AccumState, dict]:
    """Read a checkpoint of either package onto ``device``: the state and
    its meta entries (numpy values, keys without ``meta_``)."""
    z = np.load(path, allow_pickle=False)
    state = AccumState(
        radiance_sum=torch.from_numpy(
            np.asarray(z["radiance_sum"], np.float32)).to(device),
        n_iters=int(z["n_iters"]))
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return state, meta
