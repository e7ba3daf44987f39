"""A PNG reader and writer on zlib and struct: the port's stand-in for PIL's
``Image.open``, cv2's ``imread`` and cv2's ``imwrite``.

Scope: 8- and 16-bit samples, not interlaced, colour types 0 (gray), 2 (RGB),
4 (gray and alpha) and 6 (RGBA), any of the five row filters. Anything else
raises: sub-byte samples, palettes, Adam7 interlacing, a tRNS chunk.

- `read_png` gives the samples as stored: uint8, or native uint16 from a
  16-bit file's big-endian samples.
- `load_rgb` / `load_gray` give PIL's ``convert("RGB")`` / ``convert("L")``
  of the file (alpha dropped; gray replicated to RGB; RGB to L by PIL's
  integer formula, `device_preprocess.pil_grayscale_u8`). PIL opens a 16-bit
  gray file as ``I;16`` and clips it at 255; every other 16-bit file it
  opens at the high byte of each sample.
- `load_unchanged` gives ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: gray as
  (H, W), colour in cv2's order, BGR or BGRA (gray with alpha as BGRA), uint8
  or uint16 as stored. The annotation masks are read so (channel 1 instance
  ids, channel 2 semantic ids, in that order).
- `load_color` gives ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``
  and `load_gray_cv2` ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: libpng's
  reading, the high byte of a 16-bit sample, alpha stripped, gray replicated,
  and colour to gray by libpng's fixed-point weights (truncated on 8-bit
  samples, rounded on 16-bit ones before the high byte is taken).
- `png_header` reads (height, width, bit depth) from the IHDR chunk alone, as
  PIL's ``Image.open(path).size`` does without decoding the pixels.
- `write_png` writes (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA, uint8 or
  uint16, as an 8- or 16-bit PNG with the samples in the array's order (the
  JAX package's ``cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))``
  writes the same RGB pixels); with ``bgr=True`` the array is in cv2's order
  and the file holds what ``cv2.imwrite(path, image)`` writes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .device_preprocess import pil_grayscale_u8

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}  # samples per pixel -> colour type written


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the decompressed image data -> (h, w * bpp) uint8."""
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {data.size} bytes, expected {h * (stride + 1)}")
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the image
    for y in range(h):
        ftype, line, prior = rows[y, 0], rows[y, 1:], out[y]
        if ftype == 0:  # None
            out[y + 1] = line
        elif ftype == 1:  # Sub: a running sum per byte position modulo 256
            out[y + 1] = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            out[y + 1] = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each pixel depends on its left neighbour
            cur = bytearray(stride)
            ln, up = line.tolist(), prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (ln[i] + pred) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
    return out[1:]


def read_png(path: str) -> np.ndarray:
    """The file's samples as stored: (H, W) for gray, (H, W, C) otherwise, in the
    file's channel order (gray, gray+alpha, RGB or RGBA), uint8 or uint16."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        length, ctype = struct.unpack(">I4s", blob[pos : pos + 8])
        body = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype in (b"tRNS", b"PLTE"):
            raise ValueError(f"{path}: PNG {ctype.decode()} chunks are not supported")
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace {interlace}; "
            "only 8- and 16-bit, non-interlaced gray, gray+alpha, RGB and RGBA are supported"
        )
    c, size = _CHANNELS[ctype], depth // 8
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, c * size)
    if size == 2:
        pixels = pixels.view(">u2").astype(np.uint16)
    pixels = pixels.reshape(h, w, c)
    return pixels[..., 0] if c == 1 else pixels


def png_header(path: str) -> tuple[int, int, int]:
    """(height, width, bit depth) of a PNG file from its IHDR chunk, the first
    one after the signature; no pixel data is read."""
    with open(path, "rb") as f:
        head = f.read(25)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file with an IHDR chunk first")
    w, h, depth = struct.unpack(">IIB", head[16:25])
    return int(h), int(w), int(depth)


def png_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG file (`png_header`)."""
    return png_header(path)[:2]


def _pil_u8(x: np.ndarray) -> np.ndarray:
    """The 8-bit samples PIL opens a file's samples as: 16-bit gray clipped at
    255 (mode ``I;16``), other 16-bit samples at their high byte."""
    if x.dtype == np.uint8:
        return x
    if x.ndim == 2:
        return np.minimum(x, 255).astype(np.uint8)
    return (x >> 8).astype(np.uint8)


def load_rgb(path: str) -> np.ndarray:
    """PIL ``Image.open(path).convert("RGB")`` -> (H, W, 3) uint8."""
    x = _pil_u8(read_png(path))
    if x.ndim == 2:
        return np.repeat(x[..., None], 3, axis=-1)
    if x.shape[-1] == 2:
        return np.repeat(x[..., :1], 3, axis=-1)
    return np.ascontiguousarray(x[..., :3])


def load_gray(path: str) -> np.ndarray:
    """PIL ``Image.open(path).convert("L")`` -> (H, W) uint8."""
    x = _pil_u8(read_png(path))
    if x.ndim == 2:
        return x
    if x.shape[-1] == 2:
        return np.ascontiguousarray(x[..., 0])
    return pil_grayscale_u8(torch.from_numpy(x[..., :3])).numpy()


def load_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: gray (H, W); gray with alpha,
    RGB and RGBA as BGRA, BGR and BGRA; uint8 or uint16 as stored."""
    x = read_png(path)
    if x.ndim == 2:
        return x
    if x.shape[-1] == 2:
        x = np.concatenate([np.repeat(x[..., :1], 3, axis=-1), x[..., 1:]], axis=-1)
    return np.ascontiguousarray(np.concatenate([x[..., 2::-1], x[..., 3:]], axis=-1))


def _libpng(path: str) -> tuple[np.ndarray, bool]:
    """The file's samples as libpng hands them to cv2's 8-bit reads, alpha
    stripped: (H, W) gray or (H, W, 3) RGB as int64, and whether they are
    16-bit (kept whole here)."""
    x = read_png(path)
    deep = x.dtype == np.uint16
    x = x.astype(np.int64)
    if x.ndim == 3 and x.shape[-1] in (2, 4):
        x = x[..., :-1]
    return (x[..., 0] if x.ndim == 3 and x.shape[-1] == 1 else x), deep


def load_color(path: str) -> np.ndarray:
    """``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` -> (H, W, 3) uint8:
    16-bit samples at their high byte, gray replicated, alpha stripped."""
    x, deep = _libpng(path)
    if deep:
        x = x >> 8
    if x.ndim == 2:
        x = np.repeat(x[..., None], 3, axis=-1)
    return np.ascontiguousarray(x.astype(np.uint8))


def load_gray_cv2(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` -> (H, W) uint8. Colour goes
    to gray by libpng's weights (9797, 19234, 3737) / 32768, truncated on 8-bit
    samples and rounded on 16-bit ones; a pixel with equal channels keeps its
    value; a 16-bit result keeps its high byte."""
    x, deep = _libpng(path)
    if x.ndim == 3:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        mixed = (9797 * r + 19234 * g + 3737 * b + (16384 if deep else 0)) >> 15
        x = np.where((r == g) & (r == b), r, mixed)
    return (x >> 8 if deep else x).astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray, bgr: bool = False) -> None:
    """Write (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA, uint8 or uint16, as an
    8- or 16-bit, non-interlaced PNG (filter 0 on every row, zlib level 6).
    With `bgr` the colour channels are in cv2's order (BGR or BGRA) and are
    stored reversed, as ``cv2.imwrite`` stores them."""
    image = np.asarray(image)
    c = 1 if image.ndim == 2 else (image.shape[-1] if image.ndim == 3 else 0)
    if image.dtype not in (np.uint8, np.uint16) or c not in _COLOUR_TYPE or image.shape[0] == 0 or \
            image.shape[1] == 0:
        raise ValueError(f"write_png takes non-empty (H, W), (H, W, 3) or (H, W, 4) uint8 or uint16; got "
                         f"{image.dtype} {image.shape}")
    if bgr and c > 1:
        image = np.concatenate([image[..., 2::-1], image[..., 3:]], axis=-1)
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image, ">u2" if image.dtype == np.uint16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter byte 0 per row
    header = struct.pack(">IIBBBBB", w, h, 8 * image.itemsize, _COLOUR_TYPE[c], 0, 0, 0)
    blob = _SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(blob)
