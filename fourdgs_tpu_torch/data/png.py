"""PNG codec for 8-bit RGB and RGBA images, on `zlib` and numpy.

The JAX package decodes its images with PIL (data/blender.py, data/scene.py);
the port has a codec of its own, used on every machine alike, so that the
path the card runs is the path the tests run.

`read_png` decodes non-interlaced 8-bit colour type 2 (RGB) and 6 (RGBA)
files with any of the five row filters; anything else (16-bit, palette,
greyscale, interlaced) raises. `write_png` writes the same two kinds with
filter 0 on every row.

Decoding: rows whose filters are all none, sub or up are undone row by row
(sub is a per-channel running sum mod 256). Average and Paeth depend on
the decoded left, upper and upper-left bytes, so an image with either is
decoded along anti-diagonals: every pixel of one diagonal depends only on
the two before it, and each diagonal is one vectorised step.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}   # colour type -> channels


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter_rows(f: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """None, sub and up rows, in row order."""
    h, stride = f.shape
    out = np.empty_like(f)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        row = f[r]
        t = types[r]
        if t == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif t == 2:
            row = row + prior       # uint8 arithmetic wraps mod 256
        out[r] = row
        prior = out[r]
    return out


def _unfilter_diagonals(f: np.ndarray, types: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any filters, one anti-diagonal of pixels at a time."""
    h, stride = f.shape
    w = stride // bpp
    fp = f.reshape(h, w, bpp).astype(np.int32)
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)   # zero row 0 and col 0
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a = rec[r + 1, c]          # left
        b = rec[r, c + 1]          # up
        cc = rec[r, c]             # upper left
        t = types[r][:, None]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, c + 1] = (fp[r, c] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) or (H, W, 4) uint8 from an 8-bit RGB or RGBA PNG."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB or RGBA PNGs are read "
            f"(bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace})")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{w}x{h}x{bpp}")
    raw = raw.reshape(h, stride + 1)
    types, f = raw[:, 0], raw[:, 1:]
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {types.max()}")
    if np.isin(types, (3, 4)).any():
        out = _unfilter_diagonals(f, types, bpp)
    else:
        out = _unfilter_rows(f, types, bpp)
    return out.reshape(h, w, bpp)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W, 4) uint8 image, filter 0 on every
    row."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes (H, W, 3|4) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, ch = img.shape
    ctype = 2 if ch == 3 else 6
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * ch)], axis=1)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))
