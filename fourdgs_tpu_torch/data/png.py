"""PNG codec for 8-bit greyscale, RGB and RGBA images: zlib, and the row
unfilter in the port's host library.

The JAX package decodes its images with PIL (data/blender.py, data/scene.py);
the port has a codec of its own, used on every machine alike, so that the
path the card runs is the path the tests run.

`read_png` decodes non-interlaced 8-bit colour type 0 (greyscale, as
HyperNeRF's covisible masks are), 2 (RGB) and 6 (RGBA) files with any of
the five row filters; anything else (16-bit, palette, greyscale with
alpha, interlaced) raises, and so does a corrupt or truncated file,
naming it. `png_size` reads (W, H) from the header alone. `write_png`
writes greyscale, RGB and RGBA with filter 0 (none) or 4 (Paeth, which
PIL's encoder picks for most rows of a photograph) on every row.

Decoding: Python's `zlib` inflates the IDAT chunks (in C, without the
interpreter lock), then `unfilter` undoes the row filters in C++
(csrc/host/png.cpp, through fourdgs_tpu_torch.native). `unfilter_plain`
is its plain version in numpy: rows whose filters are all none, sub or up
are undone row by row (sub is a per-channel running sum mod 256). Average
and Paeth depend on the decoded left, upper and upper-left bytes, so an
image with either is decoded along anti-diagonals: every pixel of one
diagonal depends only on the two before it, and each diagonal is one
vectorised step on a skewed copy of the image in which the three
neighbours are contiguous slices.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
from numpy.lib.stride_tricks import as_strided

from fourdgs_tpu_torch import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> channels


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
    """Any filters, one anti-diagonal of pixels at a time. The bytes are
    first laid out skewed and planar, diagonal d of the image in row
    d + 2 of `rec` with image row r at column r + 1 (column 0 and rows 0-1
    are the zeros left of and above the image), so that a pixel's left,
    upper and upper-left neighbours are contiguous slices of the two rows
    before its own; the predictors of filter types absent from a
    diagonal's rows are not computed."""
    h, stride = f.shape
    w = stride // bpp
    n_diag = h + w - 1
    pad = h + 2                                 # zero columns left of 0
    padded = np.zeros((h + 1, pad + w + h + 2, bpp), np.int16)
    padded[1:, pad:pad + w] = f.reshape(h, w, bpp)
    s0, s1, s2 = padded.strides
    # filt[k, ch, r'] = padded[r', pad - 1 + k - r', ch]
    filt = np.ascontiguousarray(as_strided(
        padded[:, pad - 1:], shape=(n_diag + 2, bpp, h + 1),
        strides=(s1, s2, s0 - s1)))
    rec = np.zeros_like(filt)
    t = np.full(h + 1, -1, np.int64)
    t[1:] = types
    is_type = [t == j for j in range(5)]
    counts = np.concatenate([np.zeros((1, 5), np.int64),
                             np.cumsum(t[:, None] == np.arange(5), axis=0)])
    da, db, pa, pb, pc, pred = (np.empty((bpp, h), np.int16)
                                for _ in range(6))
    pick_a, pick_b, le = (np.empty((bpp, h), bool) for _ in range(3))
    for d in range(n_diag):
        k = d + 2
        r0, r1 = max(0, d - w + 1) + 1, min(h - 1, d) + 2   # columns r'
        n = r1 - r0
        present = counts[r1] - counts[r0]
        a = rec[k - 1, :, r0:r1]                # left
        b = rec[k - 1, :, r0 - 1:r1 - 1]        # up
        p = pred[:, :n]
        if present[4]:
            c = rec[k - 2, :, r0 - 1:r1 - 1]    # upper left
            np.subtract(a, c, out=da[:, :n])
            np.subtract(b, c, out=db[:, :n])
            np.abs(db[:, :n], out=pa[:, :n])    # |p - a|, p = a + b - c
            np.abs(da[:, :n], out=pb[:, :n])    # |p - b|
            np.add(da[:, :n], db[:, :n], out=pc[:, :n])
            np.abs(pc[:, :n], out=pc[:, :n])    # |p - c|
            np.less_equal(pa[:, :n], pb[:, :n], out=pick_a[:, :n])
            pick_a[:, :n] &= np.less_equal(pa[:, :n], pc[:, :n],
                                           out=le[:, :n])
            np.less_equal(pb[:, :n], pc[:, :n], out=pick_b[:, :n])
            np.copyto(p, c)
            np.copyto(p, b, where=pick_b[:, :n])
            np.copyto(p, a, where=pick_a[:, :n])
            if present[4] != n:
                np.copyto(p, 0, where=~is_type[4][r0:r1])
        else:
            p[...] = 0
        if present[3]:
            np.copyto(p, (a + b) >> 1, where=is_type[3][r0:r1])
        if present[2]:
            np.copyto(p, b, where=is_type[2][r0:r1])
        if present[1]:
            np.copyto(p, a, where=is_type[1][r0:r1])
        out = rec[k, :, r0:r1]
        np.add(filt[k, :, r0:r1], p, out=out)
        out &= 255
    # back to rows: image (r, c) is rec[r + c + 2, :, r + 1]
    rr, cc = np.mgrid[0:h, 0:w]
    img = rec[(rr + cc + 2)[..., None], np.arange(bpp), (rr + 1)[..., None]]
    return img.astype(np.uint8).reshape(h, stride)


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) inflated rows (each a filter type 0..4, then its
    bytes) -> (H, stride) uint8, in the host library."""
    return native.png_unfilter(raw, bpp)


def unfilter_plain(raw: np.ndarray, bpp: int) -> np.ndarray:
    """The plain version of `unfilter`, in numpy."""
    types, f = raw[:, 0], raw[:, 1:]
    if np.isin(types, (3, 4)).any():
        return _unfilter_diagonals(f, types, bpp)
    return _unfilter_rows(f, types, bpp)


def png_size(path: str) -> tuple[int, int]:
    """(W, H) from a PNG's IHDR chunk, without decoding the image."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 from an 8-bit greyscale PNG (as PIL's np.asarray of an
    "L" image), (H, W, 3) or (H, W, 4) from an 8-bit RGB or RGBA one."""
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
            f"{path}: only 8-bit non-interlaced greyscale, RGB or RGBA PNGs "
            f"are read "
            f"(bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace})")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{w}x{h}x{bpp}")
    raw = raw.reshape(h, stride + 1)
    if raw[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {raw[:, 0].max()}")
    out = unfilter(raw, bpp)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 from a greyscale, RGB or RGBA PNG: greyscale
    repeated over three channels and alpha dropped, as PIL's
    `convert("RGB")` gives them."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, row_filter: int = 0) -> None:
    """Write an (H, W), (H, W, 3) or (H, W, 4) uint8 image, with
    `row_filter` 0 (none) or 4 (Paeth) on every row."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3,
                                                                      4):
        raise ValueError(f"write_png takes (H, W[, 3|4]) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch)
    if row_filter == 4:
        x = rows.astype(np.int16)
        left, up, ul = (np.zeros_like(x) for _ in range(3))
        left[:, ch:] = x[:, :-ch]
        up[1:] = x[:-1]
        ul[1:, ch:] = x[:-1, :-ch]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
        rows = ((x - pred) & 255).astype(np.uint8)
    elif row_filter != 0:
        raise ValueError(f"write_png writes row filter 0 or 4, not "
                         f"{row_filter}")
    raw = np.concatenate([np.full((h, 1), row_filter, np.uint8), rows],
                         axis=1)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))
