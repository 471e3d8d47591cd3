"""JPEG codec: a decoder equal to Pillow's (libjpeg-turbo's defaults) and a
baseline encoder in numpy.

The JAX package opens its JPEGs with `Image.open(p).convert("RGB")`; the
card's machine has neither PIL nor OpenCV, so the port decodes them itself.
`decode_jpeg` (and `read_jpeg`) decodes in the port's host library, C++
(csrc/host/jpeg.cpp, through fourdgs_tpu_torch.native), one call a file;
`decode_jpeg_plain` is its plain version in numpy and Python, which the
tests hold it to bit for bit and which this docstring describes. Neither
imports torch, and neither hands a file to another decoder.

Both read baseline, extended-sequential and progressive Huffman files
(SOF0, SOF1, SOF2) with 8-bit samples, one or three components, any
integral sampling factors, DQT (8 or 16 bit), DHT (optimised tables too,
redefined between scans), DRI with RST0-7 (which reset the DC predictors
and the EOB run and start byte-aligned), APPn and COM segments (skipped:
EXIF orientation is ignored, as `Image.open` ignores it) and 0xFF fill
bytes. They raise `NotImplementedError` naming the marker for lossless
(SOF3), hierarchical (SOF5-7) and arithmetic coding (SOF9-15, DAC), for
12-bit samples and for 4-component (CMYK, YCCK) files, and `ValueError`
naming the file for a corrupt or truncated one.

Decoding follows libjpeg-turbo's defaults, which Pillow uses:
  * the Huffman stage: a 65,536-entry table per DHT maps every 16-bit
    prefix to (bits consumed, zero run, value, extra bits); where a code
    and its magnitude bits fit in 16 bits the value is in the entry, else
    the magnitude is read after it. The bits come from a 64-bit window
    refilled 32 bits at a time from the unstuffed scan (0xFF00 -> 0xFF),
    split at the restart markers. A sequential file's nonzero coefficients
    are collected as (index, value) pairs and scattered into one array;
  * a progressive file's scans (jdphuff.c) write into one whole-image
    coefficient array: DC first scans (interleaved or not) the predicted
    DC shifted left by Al, DC refinements one bit each; AC first scans
    (one component) a spectral band Ss..Se with EOB runs, AC refinements
    a new coefficient of size 1 and one correction bit for each nonzero
    coefficient passed over (the bit Al where it is not yet set, towards
    the coefficient's sign). libjpeg-turbo's block smoothing does not
    apply: it runs only while some low AC coefficient's bits are unknown,
    and a complete file is read whole before any output;
  * dequantisation in zig-zag order, then the "islow" integer IDCT
    (jidctint.c: CONST_BITS 13, PASS1_BITS 2, columns descaled by 11 bits
    into a workspace, rows by 18) with the IDCT range limit (the low 10
    bits as a signed value, plus 128, clipped to 0..255), vectorised over
    the blocks that have an AC coefficient; a DC-only block is one value;
  * "fancy" chroma upsampling (jdsample.c: h2v1, h2v2 and h1v2 triangle
    filters with their biases; plain replication where the downsampled
    width is at most 2, or for other ratios) of planes cut to
    ceil(X h / hmax) x ceil(Y v / vmax), the edge rows repeated;
  * YCbCr -> RGB in 16-bit fixed point (jdcolor.c), clipped to 0..255;
    greyscale repeated into three channels, as `.convert("RGB")` does.

`write_jpeg` writes baseline files (4:2:0, 4:2:2, 4:4:0 or 4:4:4, or
greyscale) with the Annex K tables scaled by libjpeg's quality rule, a
float forward DCT and Huffman coding vectorised in numpy. Its bytes are
not Pillow's; Pillow and `read_jpeg` decode them to the same pixels.
"""
from __future__ import annotations

import re

import numpy as np

from fourdgs_tpu_torch import native

# natural (row-major) index of each zig-zag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# zig-zag position of each natural index
_UNZIGZAG = np.argsort(ZIGZAG)

# markers the decoder refuses, by name
_REFUSED = {0xC3: "lossless JPEG (SOF3)",
            0xCC: "arithmetic-coded JPEG (DAC)"}
_REFUSED.update({m: f"hierarchical JPEG (SOF{m - 0xC0})"
                 for m in (0xC5, 0xC6, 0xC7)})
_REFUSED.update({m: f"arithmetic-coded JPEG (SOF{m - 0xC0})"
                 for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)})
_END_OF_SCAN = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")
# Huffman lookup tables by their DHT bytes (files of one encoder share them)
_TABLES: dict = {}
_TABLES_KEPT = 64


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def _lookup(counts: bytes, symbols: bytes, is_ac: bool,
            eob_runs: bool = False) -> list:
    """The 65,536-entry lookup of one Huffman table: for each 16-bit
    prefix, (bits consumed, zero run, value, extra bits). An entry whose
    code and magnitude fit in 16 bits holds the value (extra 0); else it
    consumes the code alone and names the magnitude's size; an invalid
    code has extra -1. A sequential AC end of block has run 64, ZRL run
    15; with `eob_runs` (a progressive AC table) a size-0 symbol keeps its
    run r, an EOB run of 2^r blocks plus r more bits (r 0-14) or ZRL."""
    key = (is_ac, eob_runs, counts, symbols)
    hit = _TABLES.get(key)
    if hit is not None:
        return hit
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    code = k = 0
    for n_bits in range(1, 17):
        for _ in range(counts[n_bits - 1]):
            if code >= 1 << n_bits:
                raise ValueError("corrupt JPEG: bad Huffman table")
            lo = code << (16 - n_bits)
            hi = (code + 1) << (16 - n_bits)
            length[lo:hi] = n_bits
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    look = np.arange(65536, dtype=np.int64)
    if is_ac:
        run, size = symbol >> 4, symbol & 15
        if not eob_runs:
            run = np.where((size == 0) & (run != 15), 64, run)
    else:
        run, size = np.zeros_like(symbol), symbol
    fits = length + size <= 16
    shift = np.maximum(16 - length - size, 0)
    raw = (look >> shift) & ((1 << size) - 1)
    value = np.where(raw < (1 << np.maximum(size - 1, 0)),
                     raw - (1 << size) + 1, raw)
    value = np.where((size > 0) & fits, value, 0)
    consumed = np.where(fits, length + size, length)
    extra = np.where(fits, 0, size)
    extra = np.where(length == 0, -1, extra)
    table = list(zip(consumed.tolist(), run.tolist(), value.tolist(),
                     extra.tolist()))
    if len(_TABLES) >= _TABLES_KEPT:
        _TABLES.pop(next(iter(_TABLES)))
    _TABLES[key] = table
    return table


def _words(segment: bytes) -> list:
    """An entropy-coded segment, unstuffed, as big-endian 32-bit words,
    padded with zeros (libjpeg reads zeros past the data)."""
    data = segment.replace(b"\xff\x00", b"\xff")
    data += bytes(8 + (-len(data)) % 4)
    return np.frombuffer(data, ">u4").tolist()


def _decode_blocks(segments: list, comps: list, bases: list,
                   per_interval: int, dc_tabs: list, ac_tabs: list,
                   idx: list, val: list) -> None:
    """Decode one sequential scan's blocks, in order: block i belongs to
    scan component comps[i] and its zig-zag coefficients go to bases[i] +
    0..63. Nonzero coefficients are appended to idx/val; DC values are
    the predictor sums. Each restart interval of per_interval blocks
    starts its own segment, with the predictors at 0."""
    ia, va = idx.append, val.append
    n = len(comps)
    for si, start in enumerate(range(0, n, per_interval)):
        words = _words(segments[si] if si < len(segments) else b"")
        acc = nbits = wi = 0
        pred = [0, 0, 0, 0]
        stop = min(n, start + per_interval)
        try:
            for ci, base in zip(comps[start:stop], bases[start:stop]):
                dct = dc_tabs[ci]
                act = ac_tabs[ci]
                if nbits < 32:
                    acc = ((acc & 0xFFFFFFFF) << 32) | words[wi]
                    wi += 1
                    nbits += 32
                c, r, v, s = dct[(acc >> (nbits - 16)) & 0xFFFF]
                nbits -= c
                if s:
                    if s < 0:
                        raise ValueError("corrupt JPEG: bad Huffman code")
                    nbits -= s
                    v = (acc >> nbits) & ((1 << s) - 1)
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                v += pred[ci]
                pred[ci] = v
                if v:
                    ia(base)
                    va(v)
                k = 1
                while k < 64:
                    if nbits < 32:
                        acc = ((acc & 0xFFFFFFFF) << 32) | words[wi]
                        wi += 1
                        nbits += 32
                    c, r, v, s = act[(acc >> (nbits - 16)) & 0xFFFF]
                    nbits -= c
                    if s:
                        if s < 0:
                            raise ValueError("corrupt JPEG: bad Huffman code")
                        nbits -= s
                        v = (acc >> nbits) & ((1 << s) - 1)
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                    k += r
                    if v:
                        ia(base + k)
                        va(v)
                    k += 1
        except IndexError:
            raise ValueError("corrupt JPEG: the scan ends early") from None


class _Bits:
    """The bits of one entropy-coded segment (as _decode_blocks reads
    them, zeros past its end), for the progressive scans."""

    def __init__(self, segment: bytes):
        self.words = _words(segment)
        self.acc = self.nbits = self.wi = 0

    def _fill(self) -> None:
        if self.wi == len(self.words):
            raise ValueError("corrupt JPEG: the scan ends early")
        self.acc = ((self.acc & 0xFFFFFFFF) << 32) | self.words[self.wi]
        self.wi += 1
        self.nbits += 32

    def bits(self, n: int) -> int:
        """The next n <= 16 bits as an unsigned value."""
        if n == 0:
            return 0
        if self.nbits < 32:
            self._fill()
        self.nbits -= n
        return (self.acc >> self.nbits) & ((1 << n) - 1)

    def symbol(self, table: list) -> tuple[int, int]:
        """(run, value) of the next Huffman symbol of a _lookup table; the
        value is 0 for a symbol of size 0."""
        if self.nbits < 32:
            self._fill()
        c, r, v, s = table[(self.acc >> (self.nbits - 16)) & 0xFFFF]
        self.nbits -= c
        if s:
            if s < 0:
                raise ValueError("corrupt JPEG: bad Huffman code")
            v = self.bits(s)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        return r, v


def _ac_first(rd: _Bits, table: list, coef: list, base: int, ss: int,
              se: int, al: int, eobrun: int) -> int:
    """One block of an AC first scan (jdphuff.c decode_mcu_AC_first);
    returns the EOB run left."""
    if eobrun:
        return eobrun - 1
    k = ss
    while k <= se:
        r, v = rd.symbol(table)
        if v:
            k += r
            coef[base + min(k, 63)] = v << al
        elif r == 15:
            k += 15
        else:
            return (1 << r) + rd.bits(r) - 1
        k += 1
    return 0


def _ac_refine(rd: _Bits, table: list, coef: list, base: int, ss: int,
               se: int, al: int, eobrun: int) -> int:
    """One block of an AC refinement scan (jdphuff.c
    decode_mcu_AC_refine): each nonzero coefficient passed over takes one
    correction bit, a new one lands on the r-th zero; returns the EOB run
    left."""
    p1 = 1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            r, v = rd.symbol(table)
            new = 0
            if v:
                if v not in (1, -1):
                    raise ValueError("corrupt JPEG: a refinement scan's new "
                                     "coefficient is not of size 1")
                new = p1 if v > 0 else -p1
            elif r != 15:
                eobrun = (1 << r) + rd.bits(r)
                break
            while k <= se:
                z = base + k
                if coef[z]:
                    if rd.bits(1) and not coef[z] & p1:
                        coef[z] += p1 if coef[z] >= 0 else -p1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if new:
                coef[base + min(k, 63)] = new
            k += 1
    if eobrun > 0:
        while k <= se:
            z = base + k
            if coef[z] and rd.bits(1) and not coef[z] & p1:
                coef[z] += p1 if coef[z] >= 0 else -p1
            k += 1
        eobrun -= 1
    return eobrun


def _decode_progressive(segments: list, comps: list, bases: list,
                        per_interval: int, tabs: list, coef: list,
                        spectral: tuple) -> None:
    """Decode one progressive scan's blocks into `coef` (zig-zag order,
    block i's at bases[i] + 0..63), as _decode_blocks orders them; each
    restart interval resets the DC predictors and the EOB run.
    `spectral` is (Ss, Se, Ah, Al); tabs[ci] the component's DC table in a
    DC scan, its AC table (with EOB runs) in an AC scan."""
    ss, se, ah, al = spectral
    n = len(comps)
    for si, start in enumerate(range(0, n, per_interval)):
        rd = _Bits(segments[si] if si < len(segments) else b"")
        pred = [0, 0, 0, 0]
        eobrun = 0
        stop = min(n, start + per_interval)
        for ci, base in zip(comps[start:stop], bases[start:stop]):
            if ss == 0 and ah == 0:
                pred[ci] += rd.symbol(tabs[ci])[1]
                coef[base] = pred[ci] << al
            elif ss == 0:
                if rd.bits(1):
                    coef[base] |= 1 << al
            elif ah == 0:
                eobrun = _ac_first(rd, tabs[ci], coef, base, ss, se, al,
                                   eobrun)
            else:
                eobrun = _ac_refine(rd, tabs[ci], coef, base, ss, se, al,
                                    eobrun)


def _idct_pass(s, descale: int) -> list:
    """One pass of jidctint.c's islow IDCT over the last axis pairs:
    s[k] is the k-th input of every 1-D transform; returns the eight
    outputs, descaled by `descale` bits."""
    z1 = (s[2] + s[6]) * 4433
    tmp2 = z1 - s[6] * 15137
    tmp3 = z1 + s[2] * 6270
    tmp0 = (s[0] + s[4]) << 13
    tmp1 = (s[0] - s[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0 = t0 * 2446
    t1 = t1 * 16819
    t2 = t2 * 25172
    t3 = t3 * 12299
    z1 = z1 * -7373
    z2 = z2 * -20995
    z3 = z3 * -16069 + z5
    z4 = z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (descale - 1)
    return [(x + half) >> descale for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit(x: np.ndarray) -> np.ndarray:
    """libjpeg's IDCT range limit: the low 10 bits as a signed value, plus
    128, clipped to 0..255."""
    x = x & 1023
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(n, 8, 8) dequantised coefficients in natural order -> (n, 8, 8)
    samples 0..255, as jpeg_idct_islow computes them."""
    x = coef.astype(np.int64)
    cols = _idct_pass([x[:, k, :] for k in range(8)], 11)
    ws = np.stack(cols, axis=1)            # (n, row, col)
    rows = _idct_pass([ws[:, :, k] for k in range(8)], 18)
    return _range_limit(np.stack(rows, axis=2))


def _component_plane(coef: np.ndarray, quant: np.ndarray, grid,
                     has_ac: np.ndarray) -> np.ndarray:
    """A component's (rows, cols) samples from its (n, 64) zig-zag
    coefficients on a (by, bx) block grid."""
    deq = coef * quant[None, :]
    out = np.empty((len(coef), 8, 8), np.int64)
    # a DC-only block: both passes' shortcuts, one value
    dc = _range_limit(((deq[:, 0] << 2) + 16) >> 5)
    out[:] = dc[:, None, None]
    if has_ac.any():
        nat = deq[has_ac][:, _UNZIGZAG].reshape(-1, 8, 8)
        out[has_ac] = idct_islow(nat)
    by, bx = grid
    return out.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(
        by * 8, bx * 8)


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A plane upsampled by (fh, fv) as libjpeg-turbo's jdsample.c does by
    default: h2v1, h2v2 and h1v2 with the triangle ("fancy") filters,
    plain replication where the width is at most 2 or for other ratios."""
    h, w = p.shape
    if (fh, fv) == (1, 1):
        return p
    if (fh, fv) == (1, 2):
        up = np.concatenate([p[:1], p[:-1]])
        down = np.concatenate([p[1:], p[-1:]])
        out = np.empty((2 * h, w), np.int64)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out
    if (fh, fv) in ((2, 1), (2, 2)) and w > 2:
        if fv == 2:
            up = np.concatenate([p[:1], p[:-1]])
            down = np.concatenate([p[1:], p[-1:]])
            sums = np.empty((2 * h, w), np.int64)
            sums[0::2] = 3 * p + up
            sums[1::2] = 3 * p + down
            bias_even, bias_odd, edge = 8, 7, 4
            shift = 4
        else:
            sums = p
            bias_even, bias_odd, edge = 1, 2, None
            shift = 2
        out = np.empty((sums.shape[0], 2 * w), np.int64)
        out[:, 2::2] = (3 * sums[:, 1:] + sums[:, :-1] + bias_even) >> shift
        out[:, 1:-1:2] = (3 * sums[:, :-1] + sums[:, 1:] + bias_odd) >> shift
        if edge is None:
            out[:, 0] = sums[:, 0]
            out[:, -1] = sums[:, -1]
        else:
            out[:, 0] = (4 * sums[:, 0] + 8) >> 4
            out[:, -1] = (4 * sums[:, -1] + 7) >> 4
        return out
    return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert in 16-bit fixed point."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    g = y + ((-46802 * cr - 22554 * cb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


class _Frame:
    def __init__(self):
        self.width = self.height = 0
        self.progressive = False
        self.comps: list = []      # [id, h, v, tq] each
        self.quant_of: dict = {}   # component id -> its latched table
        self.coef_idx: list = []   # a sequential file's nonzero coefficients
        self.coef_val: list = []
        self.coef: list = []       # a progressive file's, all of them
        self.offset: dict = {}     # component id -> first block index
        self.grid: dict = {}       # component id -> (by, bx)
        self.mcus = (0, 0)
        self.hmax = self.vmax = 1


def _start_frame(frame: _Frame, seg: bytes, marker: int) -> None:
    if len(seg) < 6:
        raise ValueError("corrupt JPEG: a truncated frame header")
    precision = seg[0]
    frame.height, frame.width, nc = _u16(seg, 1), _u16(seg, 3), seg[5]
    if precision != 8:
        raise NotImplementedError(
            f"{precision}-bit samples (SOF{marker - 0xC0}): only 8-bit "
            f"JPEGs are decoded")
    if nc == 4:
        raise NotImplementedError(
            f"4-component JPEG (CMYK or YCCK, SOF{marker - 0xC0}): only "
            f"greyscale and three-component files are decoded")
    if nc not in (1, 3):
        raise NotImplementedError(f"{nc}-component JPEG")
    if frame.height == 0:
        raise NotImplementedError("a JPEG whose height is in a DNL marker")
    if frame.width == 0:
        raise ValueError("corrupt JPEG: an image of width 0")
    if len(seg) < 6 + 3 * nc:
        raise ValueError("corrupt JPEG: a truncated frame header")
    frame.progressive = marker == 0xC2
    for i in range(nc):
        cid, hv, tq = seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i]
        if not (hv >> 4 and hv & 15):
            raise ValueError("corrupt JPEG: bad sampling factors")
        frame.comps.append([cid, hv >> 4, hv & 15, tq])
    frame.hmax = max(c[1] for c in frame.comps)
    frame.vmax = max(c[2] for c in frame.comps)
    mx = -(-frame.width // (8 * frame.hmax))
    my = -(-frame.height // (8 * frame.vmax))
    frame.mcus = (my, mx)
    n = 0
    for cid, h, v, _ in frame.comps:
        if frame.hmax % h or frame.vmax % v:
            raise NotImplementedError(
                f"sampling factors {h}x{v} of {frame.hmax}x{frame.vmax}")
        frame.offset[cid] = n
        frame.grid[cid] = (my * v, mx * h)
        n += my * v * mx * h
    if frame.progressive:
        frame.coef = [0] * (64 * n)


def _scan_blocks(frame: _Frame, scan: list):
    """The scan's blocks in decode order: (index of the component in the
    scan, base coefficient index), and the blocks a restart MCU holds."""
    my, mx = frame.mcus
    if len(scan) == 1:
        cid, h, v = scan[0][:3]
        by, bx = frame.grid[cid]
        cw = -(-frame.width * h // frame.hmax)
        ch = -(-frame.height * v // frame.vmax)
        rows, cols = np.mgrid[0:-(-ch // 8), 0:-(-cw // 8)]
        blocks = frame.offset[cid] + rows * bx + cols
        return [0] * blocks.size, (64 * blocks.ravel()).tolist(), 1
    parts, comps = [], []
    for si, (cid, h, v) in enumerate(s[:3] for s in scan):
        bx = frame.grid[cid][1]
        m_r, m_c, j, i = np.meshgrid(np.arange(my), np.arange(mx),
                                     np.arange(v), np.arange(h),
                                     indexing="ij")
        blocks = frame.offset[cid] + (m_r * v + j) * bx + m_c * h + i
        parts.append(blocks.reshape(my * mx, v * h))
        comps += [si] * (v * h)
    order = np.concatenate(parts, axis=1)
    return comps * (my * mx), (64 * order.ravel()).tolist(), len(comps)


def _spectral(frame: _Frame, seg: bytes, ns: int) -> tuple:
    """A scan's (Ss, Se, Ah, Al), checked as jdphuff.c checks a
    progressive file's."""
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if frame.progressive and (
            (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
            or (ah and al != ah - 1) or al > 13):
        raise ValueError("corrupt JPEG: bad progression parameters")
    return ss, se, ah, al


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8 RGB (see the module doc),
    decoded in the host library; errors name the file (`name`)."""
    return native.decode_jpeg(data, name)


def decode_jpeg_plain(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The plain version of `decode_jpeg`, in numpy and Python."""
    try:
        return _decode_plain(data)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    except NotImplementedError as e:
        raise NotImplementedError(f"{name}: {e}") from None


def _decode_plain(data: bytes) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    quant: dict = {}
    dc_def: dict = {}
    ac_def: dict = {}
    restart = 0
    frame = None
    jfif = False
    adobe = None
    pos = 2
    while True:
        if pos >= len(data):
            raise ValueError("truncated JPEG (no EOI marker)")
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG (no marker at {pos})")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos + 1 > len(data):
            raise ValueError("truncated JPEG (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG (no EOI marker)")
        length = _u16(data, pos)
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _REFUSED:
            raise NotImplementedError(
                f"{_REFUSED[marker]} is not decoded; only baseline, "
                f"extended-sequential and progressive Huffman files (SOF0, "
                f"SOF1, SOF2) are")
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("two frames in one JPEG")
            frame = _Frame()
            _start_frame(frame, seg, marker)
        elif marker == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                n = 128 if pq else 64
                if tq > 3:
                    raise ValueError("corrupt JPEG: bad quantisation table")
                if p + 1 + n > len(seg):
                    raise ValueError(
                        "corrupt JPEG: a truncated quantisation table")
                q = np.frombuffer(seg[p + 1:p + 1 + n],
                                  ">u2" if pq else np.uint8)
                quant[tq] = q.astype(np.int64)
                p += 1 + n
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                if p + 17 > len(seg):
                    raise ValueError("corrupt JPEG: a truncated Huffman table")
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = seg[p + 1:p + 17]
                n = sum(counts)
                if tc > 1 or th > 3 or n > 256 or p + 17 + n > len(seg):
                    raise ValueError("corrupt JPEG: bad Huffman table")
                symbols = seg[p + 17:p + 17 + n]
                (ac_def if tc else dc_def)[th] = (counts, symbols)
                p += 17 + n
        elif marker == 0xDD:
            if len(seg) < 2:
                raise ValueError("corrupt JPEG: a truncated restart interval")
            restart = _u16(seg, 0)
        elif marker == 0xE0:
            jfif = jfif or seg[:5] == b"JFIF\x00"
        elif marker == 0xEE:
            if seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("a scan before the frame header")
            ns = seg[0] if seg else 0
            if ns < 1 or len(seg) < 4 + 2 * ns:
                raise ValueError("corrupt JPEG: a truncated scan header")
            spectral = _spectral(frame, seg, ns)
            ss, _, ah, _ = spectral
            need_dc = not frame.progressive or (ss == 0 and ah == 0)
            need_ac = not frame.progressive or ss > 0
            by_id = {c[0]: c for c in frame.comps}
            scan, dcs, acs = [], [], []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                if cid not in by_id:
                    raise ValueError("corrupt JPEG: a scan names no "
                                     "component of the frame")
                c = by_id[cid]
                if c[3] not in quant:
                    raise ValueError(f"no quantisation table {c[3]}")
                frame.quant_of.setdefault(cid, quant[c[3]])
                try:
                    dcs.append(_lookup(*dc_def[t >> 4], False)
                               if need_dc else None)
                    acs.append(_lookup(*ac_def[t & 15], True,
                                       frame.progressive)
                               if need_ac else None)
                except KeyError:
                    raise ValueError("a scan names a Huffman table that is "
                                     "not defined") from None
                scan.append(c)
            comps, bases, per_mcu = _scan_blocks(frame, scan)
            end = _END_OF_SCAN.search(data, pos)
            stop = end.start() if end else len(data)
            body = data[pos:stop]
            segments = _RESTART.split(body) if restart else [body]
            per = restart * per_mcu if restart else len(comps)
            if frame.progressive:
                _decode_progressive(segments, comps, bases, per,
                                    dcs if ss == 0 else acs, frame.coef,
                                    spectral)
            else:
                _decode_blocks(segments, comps, bases, per, dcs, acs,
                               frame.coef_idx, frame.coef_val)
            pos = stop
        # APPn, COM and other segments are skipped
    if frame is None:
        raise ValueError("a JPEG without a frame")
    return _finish(frame, jfif, adobe)


def _finish(frame: _Frame, jfif: bool, adobe) -> np.ndarray:
    total = sum(by * bx for by, bx in frame.grid.values())
    if frame.progressive:
        coef = np.asarray(frame.coef, np.int64).reshape(total, 64)
        has_ac = coef[:, 1:].any(axis=1)
    else:
        coef = np.zeros(total * 64, np.int64)
        idx = np.asarray(frame.coef_idx, np.int64)
        coef[idx] = np.asarray(frame.coef_val, np.int64)
        has_ac = np.zeros(total, bool)
        has_ac[np.unique(idx[(idx & 63) != 0] >> 6)] = True
        coef = coef.reshape(total, 64)
    w, h = frame.width, frame.height
    planes = []
    for cid, hs, vs, _ in frame.comps:
        if cid not in frame.quant_of:
            raise ValueError("corrupt JPEG: a component in no scan")
        by, bx = frame.grid[cid]
        o = frame.offset[cid]
        p = _component_plane(coef[o:o + by * bx], frame.quant_of[cid],
                             (by, bx), has_ac[o:o + by * bx])
        cw = -(-w * hs // frame.hmax)
        ch = -(-h * vs // frame.vmax)
        p = _upsample(p[:ch, :cw], frame.hmax // hs, frame.vmax // vs)
        planes.append(p[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    ids = [c[0] for c in frame.comps]
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == [82, 71, 66]         # "R", "G", "B"
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 3) uint8: the counterpart of
    `np.asarray(Image.open(path).convert("RGB"))` on a JPEG file."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                   [24, 26, 56, 99], [47, 66, 99, 99]]
# Annex K's Huffman tables: counts of codes of 1..16 bits, and symbols
_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
            bytes(range(12)))
_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
              bytes(range(12)))
_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
            bytes.fromhex(
                "01020300041105122131410613516107227114328191a10823"
                "42b1c11552d1f02433627282090a161718191a25262728292a"
                "3435363738393a434445464748494a535455565758595a6364"
                "65666768696a737475767778797a838485868788898a929394"
                "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
                "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8"
                "e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
              bytes.fromhex(
                  "00010203110405213106124151076171132232810814429"
                  "1a1b1c109233352f0156272d10a162434e125f11718191a"
                  "262728292a35363738393a434445464748494a535455565"
                  "758595a636465666768696a737475767778797a82838485"
                  "868788898a92939495969798999aa2a3a4a5a6a7a8a9aab"
                  "2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7"
                  "d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
SAMPLINGS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
             "4:4:0": (1, 2)}


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline:
    1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _codes(table) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of each of the 256 symbols of a Huffman table."""
    counts, symbols = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code = k = 0
    for n_bits in range(1, 17):
        for _ in range(counts[n_bits - 1]):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = n_bits
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    c[0] /= np.sqrt(2)
    return c


def _magnitude(v: np.ndarray):
    """JPEG's (size, bits) of each value: size = bit length of |v|, bits
    the low `size` bits of v, or of v - 1 where v < 0."""
    a = np.abs(v)
    size = np.zeros_like(a)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v < 0, v - 1, v) & ((1 << size) - 1)
    return size, bits


def _entropy_code(zz: np.ndarray, comp: np.ndarray, tables: list) -> bytes:
    """Huffman-code blocks (n, 64) of quantised zig-zag coefficients in
    scan order, block i of component comp[i], whose (DC, AC) code tables
    are tables[comp]. Returns the stuffed entropy-coded bytes."""
    n = len(zz)
    dc = zz[:, 0].copy()
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    dc_code = np.stack([tables[c][0][0] for c in range(len(tables))])
    dc_len = np.stack([tables[c][0][1] for c in range(len(tables))])
    ac_code = np.stack([tables[c][1][0] for c in range(len(tables))])
    ac_len = np.stack([tables[c][1][1] for c in range(len(tables))])
    # DC tokens: code then magnitude
    s, b = _magnitude(diff)
    dc_val = (dc_code[comp, s] << s) | b
    dc_bits = dc_len[comp, s] + s
    # AC tokens: for each nonzero, its ZRLs then (run, size) and magnitude
    blk, pos = np.nonzero(zz[:, 1:])
    k1 = pos + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k1[:-1]]))
    run = k1 - prev - 1
    zrl = run >> 4
    v = zz[blk, k1]
    s, b = _magnitude(v)
    sym = ((run & 15) << 4) | s
    cb = comp[blk]
    ac_val = (ac_code[cb, sym] << s) | b
    ac_bits = ac_len[cb, sym] + s
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, k1)
    eob = last < 63
    # token positions: a block's DC, its entries' ZRLs and codes, its EOB
    per_entry = zrl + 1
    entry_tok = np.bincount(blk, weights=per_entry, minlength=n).astype(
        np.int64)
    count = 1 + entry_tok + eob
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    excl = np.concatenate([[0], np.cumsum(per_entry)[:-1]])
    first_excl = np.zeros(n, np.int64)
    first_excl[blk[first]] = excl[first]
    at = start[blk] + 1 + excl - first_excl[blk]
    total = int(count.sum())
    val = np.zeros(total, np.int64)
    nb = np.zeros(total, np.int64)
    val[start] = dc_val
    nb[start] = dc_bits
    val[at + zrl] = ac_val
    nb[at + zrl] = ac_bits
    z_at = np.repeat(at, zrl) + (np.arange(int(zrl.sum()))
                                 - np.repeat(np.cumsum(zrl) - zrl, zrl))
    z_comp = np.repeat(cb, zrl)
    val[z_at] = ac_code[z_comp, 0xF0]
    nb[z_at] = ac_len[z_comp, 0xF0]
    e_at = (start + count - 1)[eob]
    e_comp = comp[eob]
    val[e_at] = ac_code[e_comp, 0x00]
    nb[e_at] = ac_len[e_comp, 0x00]
    # the tokens' bits, most significant first, padded with ones
    n_bits = int(nb.sum())
    tok = np.repeat(np.arange(total), nb)
    offs = np.arange(n_bits) - np.repeat(np.cumsum(nb) - nb, nb)
    bits = ((val[tok] >> (nb[tok] - 1 - offs)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-n_bits % 8, np.uint8)])
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_jpeg(img: np.ndarray, quality: int = 95,
                subsampling: str = "4:2:0") -> bytes:
    """A baseline JFIF file of an (H, W, 3) or (H, W) uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("write_jpeg takes (H, W, 3) or (H, W) uint8")
    h, w = img.shape[:2]
    x = img.astype(np.float64)
    if img.ndim == 2:
        planes, factors = [x], [(1, 1)]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
        factors = [SAMPLINGS[subsampling], (1, 1), (1, 1)]
    hmax, vmax = factors[0]
    my, mx = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    quants = [quality_table(_LUMA_Q, quality),
              quality_table(_CHROMA_Q, quality)]
    tables = [(_codes(_DC_LUMA), _codes(_AC_LUMA)),
              (_codes(_DC_CHROMA), _codes(_AC_CHROMA))]
    c = _dct_matrix()
    blocks = []
    for ci, (p, (hs, vs)) in enumerate(zip(planes, factors)):
        fh, fv = hmax // hs, vmax // vs
        p = np.pad(p, ((0, my * 8 * vmax - h), (0, mx * 8 * hmax - w)),
                   mode="edge")
        p = p.reshape(p.shape[0] // fv, fv, p.shape[1] // fh, fh).mean((1, 3))
        by, bx = p.shape[0] // 8, p.shape[1] // 8
        tiles = (p - 128).reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
        coef = c @ tiles @ c.T
        q = quants[min(ci, 1)].reshape(8, 8)
        zz = np.rint(coef / q).astype(np.int64).reshape(by, bx, 64)[
            ..., ZIGZAG]
        # MCU order: each MCU's vs x hs blocks of this component
        zz = zz.reshape(my, vs, mx, hs, 64).transpose(0, 2, 1, 3, 4)
        blocks.append(zz.reshape(my * mx, vs * hs, 64))
    nc = len(planes)
    order = np.concatenate(blocks, axis=1).reshape(-1, 64)
    comp = np.tile(np.repeat(np.arange(nc), [f[0] * f[1] for f in factors]),
                   my * mx)
    data = _entropy_code(order, comp, [tables[min(ci, 1)]
                                       for ci in range(nc)])
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out.append(_segment(0xDB, b"".join(
        bytes([t]) + bytes(quants[t][ZIGZAG].astype(np.uint8))
        for t in range(min(nc, 2)))))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + \
        bytes([nc])
    for ci, (hs, vs) in enumerate(factors):
        sof += bytes([ci + 1, (hs << 4) | vs, min(ci, 1)])
    out.append(_segment(0xC0, sof))
    dht = b""
    for t, (dc_t, ac_t) in enumerate(((_DC_LUMA, _AC_LUMA),
                                      (_DC_CHROMA, _AC_CHROMA))[:min(nc, 2)]):
        dht += bytes([t]) + dc_t[0] + dc_t[1]
        dht += bytes([0x10 | t]) + ac_t[0] + ac_t[1]
    out.append(_segment(0xC4, dht))
    sos = bytes([nc]) + b"".join(bytes([ci + 1, min(ci, 1) * 0x11])
                                 for ci in range(nc)) + bytes([0, 63, 0])
    out.append(_segment(0xDA, sos))
    out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95,
               subsampling: str = "4:2:0") -> None:
    """Write an (H, W, 3) or (H, W) uint8 image as a baseline JPEG
    (encode_jpeg)."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, subsampling))
