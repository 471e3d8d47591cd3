// JPEG decoding equal to Pillow's (libjpeg-turbo's defaults) bit for bit:
// baseline, extended-sequential and progressive Huffman files (SOF0, SOF1,
// SOF2) with 8-bit samples, one or three components, any integral
// sampling factors, restart intervals. The plain version, and the
// description of each stage, is data/jpeg.py:decode_jpeg_plain; this file
// follows it step for step:
//
//   * every scan's coefficients go to one whole-image buffer (natural
//     order, int32), so that a progressive file's DC and AC bands, first
//     and refinement scans, land where libjpeg's jdphuff.c puts them;
//   * dequantisation and the islow IDCT (jidctint.c) with its range limit;
//   * fancy upsampling (jdsample.c: h2v1, h2v2, h1v2) and YCbCr -> RGB
//     (jdcolor.c), or plain replication, greyscale repeated into RGB.
//
// A complete progressive file gets no block smoothing in libjpeg-turbo:
// `smoothing_ok` asks for some low AC coefficient whose bits are not all
// known, and jpeg_start_decompress reads the whole file before any output.
//
//   jpeg_decode(data, n, dims, out, err, err_len) -> 0, 1 (a corrupt or
//       truncated file: ValueError), 2 (a kind of file that is not
//       decoded: NotImplementedError) or 3 (out of memory); err gets the
//       message. With out NULL it reads the headers up to the frame and
//       writes (height, width, components) to dims; else it decodes the
//       file into out, (height, width, 3) uint8.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Error {
    int code;
    std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) {
    throw Error{code, msg};
}

[[noreturn]] void corrupt(const std::string& what) {
    fail(1, "corrupt JPEG: " + what);
}

// natural index of each zig-zag position; past 63, 63 (jutils.c), so that
// a corrupt run cannot leave the block
const int kNatural[64 + 16] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;
// zero bytes a segment may be read past its end before it is called short
constexpr int kPadBytes = 16;

struct HuffSpec {         // a DHT table as defined, built when a scan uses it
    bool defined = false;
    uint8_t counts[16];
    uint8_t symbols[256];
};

struct Huff {
    uint16_t look[1 << kLookBits];   // (length << 8) | symbol, 0: longer
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
};

void make_huff(Huff& t, const HuffSpec& spec) {
    std::memset(t.look, 0, sizeof(t.look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
        t.valoffset[len] = k - code;
        for (int i = 0; i < spec.counts[len - 1]; ++i) {
            if (code >= (1 << len)) corrupt("bad Huffman table");
            if (len <= kLookBits) {
                const int lo = code << (kLookBits - len);
                const int hi = (code + 1) << (kLookBits - len);
                for (int j = lo; j < hi; ++j)
                    t.look[j] = static_cast<uint16_t>((len << 8)
                                                      | spec.symbols[k]);
            }
            t.vals[k] = spec.symbols[k];
            ++code;
            ++k;
        }
        t.maxcode[len] = spec.counts[len - 1] ? code - 1 : -1;
        code <<= 1;
    }
}

// the bits of one entropy-coded segment, 0xFF00 unstuffed, zeros past
// its end (libjpeg reads zeros past the data)
struct Bits {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;
    int n = 0;
    int zeros = 0;

    Bits(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}

    void fill() {
        if (end - p >= 8) {          // whole bytes at once where no 0xFF is
            uint64_t x;
            std::memcpy(&x, p, 8);
            const uint64_t nx = ~x;
            if (((nx - 0x0101010101010101ull) & ~nx & 0x8080808080808080ull)
                == 0) {
                const int k = (64 - n) >> 3;
                x = __builtin_bswap64(x) & (~0ull << (64 - 8 * k));
                buf |= x >> n;
                n += 8 * k;
                p += k;
                return;
            }
        }
        while (n <= 56) {
            uint64_t b;
            if (p < end) {
                b = *p++;
                if (b == 0xFF && p < end && *p == 0) ++p;
            } else {
                b = 0;
                if (++zeros > kPadBytes) corrupt("the scan ends early");
            }
            buf |= b << (56 - n);
            n += 8;
        }
    }
    int get(int k) {                 // k <= 16
        if (k == 0) return 0;
        if (n < k) fill();
        const int v = static_cast<int>(buf >> (64 - k));
        buf <<= k;
        n -= k;
        return v;
    }
    int symbol(const Huff& t) {
        if (n < 16) fill();
        const int e = t.look[buf >> (64 - kLookBits)];
        if (e) {
            buf <<= e >> 8;
            n -= e >> 8;
            return e & 0xFF;
        }
        int len = kLookBits + 1;
        int32_t code = static_cast<int32_t>(buf >> (64 - len));
        while (code > t.maxcode[len]) {
            if (++len > 16) corrupt("bad Huffman code");
            code = static_cast<int32_t>(buf >> (64 - len));
        }
        buf <<= len;
        n -= len;
        return t.vals[code + t.valoffset[len]];
    }
};

inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
    int id, h, v, tq;
    int by, bx;               // block grid, padded to whole MCUs
    int64_t offset;           // first block in the coefficient buffer
    bool latched = false;     // its quantisation table, at its first scan
    int32_t quant[64];        // natural order
};

struct Frame {
    int width = 0, height = 0, hmax = 1, vmax = 1, my = 0, mx = 0;
    bool progressive = false;
    int64_t blocks = 0;
    std::vector<Component> comps;
    std::vector<int32_t> coef;        // allocated once the file is decoded
};

int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

void start_frame(Frame& f, const uint8_t* seg, int64_t len, int marker) {
    const std::string sof = "SOF" + std::to_string(marker - 0xC0);
    if (len < 6) corrupt("a truncated frame header");
    const int precision = seg[0];
    f.height = u16(seg + 1);
    f.width = u16(seg + 3);
    const int nc = seg[5];
    if (precision != 8)
        fail(2, std::to_string(precision) + "-bit samples (" + sof
                    + "): only 8-bit JPEGs are decoded");
    if (nc == 4)
        fail(2, "4-component JPEG (CMYK or YCCK, " + sof
                    + "): only greyscale and three-component files are "
                      "decoded");
    if (nc != 1 && nc != 3)
        fail(2, std::to_string(nc) + "-component JPEG");
    if (f.height == 0) fail(2, "a JPEG whose height is in a DNL marker");
    if (f.width == 0) corrupt("an image of width 0");
    if (len < 6 + 3 * nc) corrupt("a truncated frame header");
    f.progressive = marker == 0xC2;
    for (int i = 0; i < nc; ++i) {
        Component c;
        c.id = seg[6 + 3 * i];
        c.h = seg[7 + 3 * i] >> 4;
        c.v = seg[7 + 3 * i] & 15;
        c.tq = seg[8 + 3 * i];
        if (c.h == 0 || c.v == 0) corrupt("bad sampling factors");
        f.comps.push_back(c);
    }
    f.hmax = f.vmax = 1;
    for (const Component& c : f.comps) {
        if (c.h > f.hmax) f.hmax = c.h;
        if (c.v > f.vmax) f.vmax = c.v;
    }
    f.mx = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
    f.my = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
    int64_t n = 0;
    for (Component& c : f.comps) {
        if (f.hmax % c.h || f.vmax % c.v)
            fail(2, "sampling factors " + std::to_string(c.h) + "x"
                        + std::to_string(c.v) + " of "
                        + std::to_string(f.hmax) + "x"
                        + std::to_string(f.vmax));
        c.offset = n;
        c.by = f.my * c.v;
        c.bx = f.mx * c.h;
        n += static_cast<int64_t>(c.by) * c.bx;
    }
    f.blocks = n;
}

// the scan's end: the first 0xFF run followed by a byte other than 0x00,
// RST0-7 or 0xFF, from `pos` (data/jpeg.py's _END_OF_SCAN)
int64_t end_of_scan(const uint8_t* data, int64_t len, int64_t pos) {
    int64_t i = pos;
    while (i < len) {
        if (data[i] != 0xFF) {
            ++i;
            continue;
        }
        int64_t j = i;
        while (j < len && data[j] == 0xFF) ++j;
        if (j < len && data[j] != 0x00 && !(data[j] >= 0xD0 && data[j] <= 0xD7))
            return i;
        i = j;
    }
    return len;
}

// [begin, end) of each segment between restart markers (0xFF run, RSTn)
std::vector<std::pair<int64_t, int64_t>> restart_segments(
        const uint8_t* data, int64_t begin, int64_t end) {
    std::vector<std::pair<int64_t, int64_t>> segs;
    int64_t start = begin, i = begin;
    while (i < end) {
        if (data[i] != 0xFF) {
            ++i;
            continue;
        }
        int64_t j = i;
        while (j < end && data[j] == 0xFF) ++j;
        if (j < end && data[j] >= 0xD0 && data[j] <= 0xD7) {
            segs.emplace_back(start, i);
            start = j + 1;
            i = j + 1;
        } else {
            i = j;
        }
    }
    segs.emplace_back(start, end);
    return segs;
}

struct ScanComp {
    Component* c;
    const Huff* dc;
    const Huff* ac;
};

struct Scan {
    std::vector<ScanComp> comps;
    int ss, se, ah, al;
};

void decode_sequential(Bits& b, const ScanComp& sc, int32_t* blk, int& pred) {
    int s = b.symbol(*sc.dc);
    if (s > 16) corrupt("bad Huffman code");
    pred += s ? extend(b.get(s), s) : 0;
    blk[0] = pred;
    for (int k = 1; k < 64; ++k) {
        const int rs = b.symbol(*sc.ac);
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            blk[kNatural[k]] = extend(b.get(s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

// jdphuff.c: decode_mcu_DC_first, decode_mcu_DC_refine, decode_mcu_AC_first
// and decode_mcu_AC_refine for one block
void decode_progressive(Bits& b, const ScanComp& sc, const Scan& scan,
                        int32_t* blk, int& pred, int& eobrun) {
    const int al = scan.al;
    if (scan.ss == 0) {
        if (scan.ah == 0) {
            const int s = b.symbol(*sc.dc);
            if (s > 16) corrupt("bad Huffman code");
            pred += s ? extend(b.get(s), s) : 0;
            blk[0] = pred * (1 << al);
        } else if (b.get(1)) {
            blk[0] |= 1 << al;
        }
        return;
    }
    if (scan.ah == 0) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        for (int k = scan.ss; k <= scan.se; ++k) {
            const int rs = b.symbol(*sc.ac);
            const int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = extend(b.get(s), s) * (1 << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = (1 << r) + b.get(r) - 1;
                break;
            }
        }
        return;
    }
    const int p1 = 1 << al, m1 = -p1;
    int k = scan.ss;
    if (eobrun == 0) {
        for (; k <= scan.se; ++k) {
            const int rs = b.symbol(*sc.ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                if (s != 1)
                    corrupt("a refinement scan's new coefficient is not of "
                            "size 1");
                s = b.get(1) ? p1 : m1;
            } else if (r != 15) {
                eobrun = (1 << r) + b.get(r);
                break;
            }
            do {
                int32_t& c = blk[kNatural[k]];
                if (c != 0) {
                    if (b.get(1) && (c & p1) == 0) c += c >= 0 ? p1 : m1;
                } else if (--r < 0) {
                    break;
                }
                ++k;
            } while (k <= scan.se);
            if (s) blk[kNatural[k]] = s;
        }
    }
    if (eobrun > 0) {
        for (; k <= scan.se; ++k) {
            int32_t& c = blk[kNatural[k]];
            if (c != 0 && b.get(1) && (c & p1) == 0) c += c >= 0 ? p1 : m1;
        }
        --eobrun;
    }
}

// one scan's blocks, in decode order, each restart interval of `restart`
// MCUs from its own segment with the predictors and the EOB run at 0
void decode_scan(Frame& f, const Scan& scan, const uint8_t* data,
                 int64_t begin, int64_t end, int restart) {
    const bool single = scan.comps.size() == 1;
    int64_t rows, cols;
    if (single) {
        const Component& c = *scan.comps[0].c;
        const int64_t cw = (static_cast<int64_t>(f.width) * c.h + f.hmax - 1)
                           / f.hmax;
        const int64_t ch = (static_cast<int64_t>(f.height) * c.v + f.vmax - 1)
                           / f.vmax;
        rows = (ch + 7) / 8;
        cols = (cw + 7) / 8;
    } else {
        rows = f.my;
        cols = f.mx;
    }
    const int64_t mcus = rows * cols;
    std::vector<std::pair<int64_t, int64_t>> segs;
    if (restart)
        segs = restart_segments(data, begin, end);
    else
        segs.emplace_back(begin, end);
    const int64_t per = restart ? restart : mcus;
    int32_t* coef = f.coef.data();
    for (int64_t start = 0, si = 0; start < mcus; start += per, ++si) {
        Bits b = si < static_cast<int64_t>(segs.size())
                     ? Bits(data + segs[si].first, data + segs[si].second)
                     : Bits(data, data);
        int pred[4] = {0, 0, 0, 0};
        int eobrun = 0;
        const int64_t stop = start + per < mcus ? start + per : mcus;
        for (int64_t m = start; m < stop; ++m) {
            const int64_t mr = m / cols, mc = m % cols;
            for (size_t ci = 0; ci < scan.comps.size(); ++ci) {
                const ScanComp& sc = scan.comps[ci];
                const Component& c = *sc.c;
                const int nv = single ? 1 : c.v, nh = single ? 1 : c.h;
                for (int j = 0; j < nv; ++j) {
                    for (int i = 0; i < nh; ++i) {
                        const int64_t blk = c.offset
                                            + (mr * nv + j) * c.bx
                                            + mc * nh + i;
                        int32_t* p = coef + blk * 64;
                        if (f.progressive)
                            decode_progressive(b, sc, scan, p, pred[ci],
                                               eobrun);
                        else
                            decode_sequential(b, sc, p, pred[ci]);
                    }
                }
            }
        }
    }
}

inline int range_limit(int64_t x) {
    int64_t v = x & 1023;
    if (v >= 512) v -= 1024;
    v += 128;
    return v < 0 ? 0 : (v > 255 ? 255 : static_cast<int>(v));
}

// jidctint.c's islow pass over eight inputs s[0..7] (stride apart)
inline void idct_pass(const int64_t* s, int stride, int descale, int64_t* o,
                      int ostride) {
    const int64_t s0 = s[0], s1 = s[stride], s2 = s[2 * stride],
                  s3 = s[3 * stride], s4 = s[4 * stride], s5 = s[5 * stride],
                  s6 = s[6 * stride], s7 = s[7 * stride];
    int64_t z1 = (s2 + s6) * 4433;
    const int64_t tmp2 = z1 - s6 * 15137;
    const int64_t tmp3 = z1 + s2 * 6270;
    const int64_t tmp0 = (s0 + s4) * 8192;
    const int64_t tmp1 = (s0 - s4) * 8192;
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = s7, t1 = s5, t2 = s3, t3 = s1;
    z1 = t0 + t3;
    int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
    const int64_t z5 = (z3 + z4) * 9633;
    t0 *= 2446;
    t1 *= 16819;
    t2 *= 25172;
    t3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int64_t half = int64_t{1} << (descale - 1);
    o[0] = (tmp10 + t3 + half) >> descale;
    o[ostride] = (tmp11 + t2 + half) >> descale;
    o[2 * ostride] = (tmp12 + t1 + half) >> descale;
    o[3 * ostride] = (tmp13 + t0 + half) >> descale;
    o[4 * ostride] = (tmp13 - t0 + half) >> descale;
    o[5 * ostride] = (tmp12 - t1 + half) >> descale;
    o[6 * ostride] = (tmp11 - t2 + half) >> descale;
    o[7 * ostride] = (tmp10 - t3 + half) >> descale;
}

// one block's samples into out (stride apart) in int64: columns descaled
// by 11 bits into a workspace, rows by 18; a column or row whose AC inputs
// are all 0 takes the shortcut, which gives the same values
void idct_block_wide(const int32_t* coef, const int32_t* q, uint8_t* out,
                     int64_t stride) {
    int64_t deq[64], ws[64], row[8];
    for (int i = 0; i < 64; ++i) deq[i] = static_cast<int64_t>(coef[i]) * q[i];
    for (int c = 0; c < 8; ++c) {
        if (!(deq[8 + c] | deq[16 + c] | deq[24 + c] | deq[32 + c]
              | deq[40 + c] | deq[48 + c] | deq[56 + c])) {
            const int64_t dc = deq[c] * 4;
            for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
            continue;
        }
        idct_pass(deq + c, 8, 11, ws + c, 8);
    }
    for (int r = 0; r < 8; ++r) {
        const int64_t* s = ws + 8 * r;
        uint8_t* o = out + r * stride;
        if (!(s[1] | s[2] | s[3] | s[4] | s[5] | s[6] | s[7])) {
            const uint8_t v = static_cast<uint8_t>(range_limit((s[0] + 16) >> 5));
            std::memset(o, v, 8);
            continue;
        }
        idct_pass(s, 1, 18, row, 1);
        for (int c = 0; c < 8; ++c) o[c] = static_cast<uint8_t>(range_limit(row[c]));
    }
}

#define ALWAYS_INLINE inline __attribute__((always_inline))

// the same pass on eight transforms at once in int32, lane l of input k at
// in[8 k + l], output r of lane l to out[8 r + l]. Exact where every input
// lies in [-32767, 32767]: no intermediate then passes 61,214 x 32,767
// plus the rounding half, below 2^31.
ALWAYS_INLINE void idct_lanes(const int32_t* in, int descale, int32_t* out) {
    const int32_t half = 1 << (descale - 1);
    for (int l = 0; l < 8; ++l) {
        const int32_t s0 = in[l], s1 = in[8 + l], s2 = in[16 + l],
                      s3 = in[24 + l], s4 = in[32 + l], s5 = in[40 + l],
                      s6 = in[48 + l], s7 = in[56 + l];
        int32_t z1 = (s2 + s6) * 4433;
        const int32_t tmp2 = z1 - s6 * 15137;
        const int32_t tmp3 = z1 + s2 * 6270;
        const int32_t tmp0 = (s0 + s4) * 8192;
        const int32_t tmp1 = (s0 - s4) * 8192;
        const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        int32_t z2 = s5 + s3, z3 = s7 + s3, z4 = s5 + s1;
        z1 = s7 + s1;
        const int32_t z5 = (z3 + z4) * 9633;
        z1 *= -7373;
        z2 *= -20995;
        z3 = z3 * -16069 + z5;
        z4 = z4 * -3196 + z5;
        const int32_t t0 = s7 * 2446 + z1 + z3;
        const int32_t t1 = s5 * 16819 + z2 + z4;
        const int32_t t2 = s3 * 25172 + z2 + z3;
        const int32_t t3 = s1 * 12299 + z1 + z4;
        out[l] = (tmp10 + t3 + half) >> descale;
        out[8 + l] = (tmp11 + t2 + half) >> descale;
        out[16 + l] = (tmp12 + t1 + half) >> descale;
        out[24 + l] = (tmp13 + t0 + half) >> descale;
        out[32 + l] = (tmp13 - t0 + half) >> descale;
        out[40 + l] = (tmp12 - t1 + half) >> descale;
        out[48 + l] = (tmp11 - t2 + half) >> descale;
        out[56 + l] = (tmp10 - t3 + half) >> descale;
    }
}

ALWAYS_INLINE int32_t max_abs64(const int32_t* x) {
    int32_t m = 0;
    for (int i = 0; i < 64; ++i) {
        const int32_t a = x[i] < 0 ? -x[i] : x[i];
        m = a > m ? a : m;
    }
    return m;
}

// a component's blocks (by x bx, `coef` in natural order) into its plane
// (stride bytes a row): each block in int32 lanes (both passes at once
// over its eight columns, then its eight rows) where its inputs keep the
// int32 pass exact, else in int64; a DC-only block is one value
__attribute__((target_clones("avx2", "default")))
void idct_plane(const int32_t* coef, const int32_t* q, int64_t by, int64_t bx,
                uint8_t* plane, int64_t stride) {
    for (int64_t b = 0; b < by * bx; ++b) {
        const int32_t* blk = coef + b * 64;
        uint8_t* out = plane + (b / bx) * 8 * stride + (b % bx) * 8;
        int32_t ac = 0;
        for (int i = 1; i < 64; ++i) ac |= blk[i];
        if (ac == 0) {
            const int64_t dc = static_cast<int64_t>(blk[0]) * q[0];
            const uint8_t v = static_cast<uint8_t>(range_limit((dc * 4 + 16) >> 5));
            for (int r = 0; r < 8; ++r) std::memset(out + r * stride, v, 8);
            continue;
        }
        int32_t deq[64], ws[64], wt[64], o[64];
        bool narrow = max_abs64(blk) <= 32767;   // |coef q| < 2^31
        if (narrow) {
            for (int i = 0; i < 64; ++i) deq[i] = blk[i] * q[i];
            narrow = max_abs64(deq) <= 32767;
        }
        if (narrow) {
            idct_lanes(deq, 11, ws);              // ws[8 r + c]
            narrow = max_abs64(ws) <= 32767;
        }
        if (!narrow) {
            idct_block_wide(blk, q, out, stride);
            continue;
        }
        for (int r = 0; r < 8; ++r)
            for (int k = 0; k < 8; ++k) wt[8 * k + r] = ws[8 * r + k];
        idct_lanes(wt, 18, o);                    // o[8 c + r]
        for (int i = 0; i < 64; ++i) {
            int32_t v = o[i] & 1023;
            v = (v >= 512 ? v - 1024 : v) + 128;
            o[i] = v < 0 ? 0 : (v > 255 ? 255 : v);
        }
        for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c)
                out[r * stride + c] = static_cast<uint8_t>(o[8 * c + r]);
    }
}

// the h2 triangle filter over one row of sums s[0..cw) (cw > 2) into
// buf[0..2 cw): jdsample.c's h2v1 (v2 false: biases 1, 2, >> 2, the edges
// copied) or h2v2 (biases 8, 7, >> 4, the edges 4 s + 8 or 7, >> 4)
__attribute__((target_clones("avx2", "default")))
void h2_row(const int* s, int64_t cw, bool v2, uint8_t* buf) {
    const int even = v2 ? 8 : 1, odd = v2 ? 7 : 2, shift = v2 ? 4 : 2;
    for (int64_t j = 0; j + 1 < cw; ++j) {
        buf[2 * j + 1] = static_cast<uint8_t>((3 * s[j] + s[j + 1] + odd) >> shift);
        buf[2 * j + 2] = static_cast<uint8_t>((3 * s[j + 1] + s[j] + even) >> shift);
    }
    buf[0] = static_cast<uint8_t>(v2 ? (4 * s[0] + 8) >> 4 : s[0]);
    buf[2 * cw - 1] = static_cast<uint8_t>(v2 ? (4 * s[cw - 1] + 7) >> 4
                                              : s[cw - 1]);
}

// the vertical triangle of h2v2 and h1v2: 3 cur + nb into s[0..n)
__attribute__((target_clones("avx2", "default")))
void v2_sums(const uint8_t* cur, const uint8_t* nb, int64_t n, int* s) {
    for (int64_t x = 0; x < n; ++x) s[x] = 3 * cur[x] + nb[x];
}

// jdcolor.c's ycc_rgb_convert over one row, in 16-bit fixed point
__attribute__((target_clones("avx2", "default")))
void ycc_row(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
             int64_t w, uint8_t* rgb) {
    for (int64_t x = 0; x < w; ++x) {
        const int yy = y[x], b = cb[x] - 128, r = cr[x] - 128;
        int v0 = yy + ((91881 * r + 32768) >> 16);
        int v1 = yy + ((-46802 * r - 22554 * b + 32768) >> 16);
        int v2 = yy + ((116130 * b + 32768) >> 16);
        v0 = v0 < 0 ? 0 : (v0 > 255 ? 255 : v0);
        v1 = v1 < 0 ? 0 : (v1 > 255 ? 255 : v1);
        v2 = v2 < 0 ? 0 : (v2 > 255 ? 255 : v2);
        rgb[3 * x] = static_cast<uint8_t>(v0);
        rgb[3 * x + 1] = static_cast<uint8_t>(v1);
        rgb[3 * x + 2] = static_cast<uint8_t>(v2);
    }
}

// a component plane of (ch, cw) samples (row stride `stride`) and how it
// is upsampled by (fh, fv) as jdsample.c does by default: the h2v1, h2v2
// and h1v2 triangle filters (h2 only where cw > 2), else replication
struct Plane {
    const uint8_t* p;
    int64_t stride, ch, cw;
    int fh, fv;
    std::vector<int> sums;
    std::vector<uint8_t> buf;

    const uint8_t* row(int64_t y) const {
        return p + (y < 0 ? 0 : (y >= ch ? ch - 1 : y)) * stride;
    }

    // output row oy of the upsampled plane (at least the image's width)
    const uint8_t* upsampled(int64_t oy) {
        if (fh == 1 && fv == 1) return row(oy);
        const int64_t y = oy / fv;
        const uint8_t* cur = row(y);
        const uint8_t* nb = row(oy % 2 ? y + 1 : y - 1);
        buf.resize(static_cast<size_t>(cw * fh));
        sums.resize(static_cast<size_t>(cw));
        if (fh == 1 && fv == 2) {
            v2_sums(cur, nb, cw, sums.data());
            const int bias = oy % 2 ? 2 : 1;
            for (int64_t x = 0; x < cw; ++x)
                buf[x] = static_cast<uint8_t>((sums[x] + bias) >> 2);
        } else if (fh == 2 && (fv == 1 || fv == 2) && cw > 2) {
            if (fv == 2)
                v2_sums(cur, nb, cw, sums.data());
            else
                for (int64_t x = 0; x < cw; ++x) sums[x] = cur[x];
            h2_row(sums.data(), cw, fv == 2, buf.data());
        } else {
            for (int64_t x = 0; x < cw * fh; ++x) buf[x] = cur[x / fh];
        }
        return buf.data();
    }
};

// jdcolor.c's ycc_rgb_convert is ycc_row; greyscale repeats into RGB
void finish(Frame& f, bool jfif, int adobe, uint8_t* out) {
    const int64_t w = f.width, h = f.height;
    std::vector<std::vector<uint8_t>> samples(f.comps.size());
    std::vector<Plane> planes;
    for (size_t ci = 0; ci < f.comps.size(); ++ci) {
        const Component& c = f.comps[ci];
        if (!c.latched) corrupt("a component in no scan");
        const int64_t pw = static_cast<int64_t>(c.bx) * 8;
        samples[ci].resize(static_cast<size_t>(pw * c.by * 8));
        idct_plane(f.coef.data() + c.offset * 64, c.quant, c.by, c.bx,
                   samples[ci].data(), pw);
        planes.push_back(Plane{samples[ci].data(), pw,
                               (h * c.v + f.vmax - 1) / f.vmax,
                               (w * c.h + f.hmax - 1) / f.hmax,
                               f.hmax / c.h, f.vmax / c.v, {}, {}});
    }
    if (planes.size() == 1) {
        for (int64_t y = 0; y < h; ++y) {
            const uint8_t* g = planes[0].upsampled(y);
            uint8_t* o = out + y * w * 3;
            for (int64_t x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
        }
        return;
    }
    bool rgb;
    if (jfif)
        rgb = false;
    else if (adobe >= 0)
        rgb = adobe == 0;
    else
        rgb = f.comps[0].id == 82 && f.comps[1].id == 71
              && f.comps[2].id == 66;             // "R", "G", "B"
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* p0 = planes[0].upsampled(y);
        const uint8_t* p1 = planes[1].upsampled(y);
        const uint8_t* p2 = planes[2].upsampled(y);
        uint8_t* o = out + y * w * 3;
        if (rgb) {
            for (int64_t x = 0; x < w; ++x) {
                o[3 * x] = p0[x];
                o[3 * x + 1] = p1[x];
                o[3 * x + 2] = p2[x];
            }
            continue;
        }
        ycc_row(p0, p1, p2, w, o);
    }
}

bool refused(int marker, std::string& what) {
    switch (marker) {
        case 0xC3: what = "lossless JPEG (SOF3)"; return true;
        case 0xCC: what = "arithmetic-coded JPEG (DAC)"; return true;
        case 0xC5: case 0xC6: case 0xC7:
            what = "hierarchical JPEG (SOF" + std::to_string(marker - 0xC0) + ")";
            return true;
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
            what = "arithmetic-coded JPEG (SOF" + std::to_string(marker - 0xC0)
                   + ")";
            return true;
        default:
            return false;
    }
}

void decode(const uint8_t* data, int64_t len, int64_t* dims, uint8_t* out) {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8)
        fail(1, "not a JPEG file");
    int32_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    HuffSpec dc_spec[4], ac_spec[4];
    int restart = 0;
    Frame frame;
    bool have_frame = false, jfif = false;
    int adobe = -1;
    int64_t pos = 2;
    for (;;) {
        if (pos >= len) fail(1, "truncated JPEG (no EOI marker)");
        if (data[pos] != 0xFF)
            fail(1, "corrupt JPEG (no marker at " + std::to_string(pos) + ")");
        while (pos < len && data[pos] == 0xFF) ++pos;
        if (pos >= len) fail(1, "truncated JPEG (no EOI marker)");
        const int marker = data[pos++];
        if (marker == 0xD9) break;
        if (marker == 0x01 || marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7))
            continue;
        if (pos + 2 > len) fail(1, "truncated JPEG (no EOI marker)");
        const int length = u16(data + pos);
        const uint8_t* seg = data + pos + 2;
        const int64_t end = pos + length < len ? pos + length : len;
        const int64_t seg_len = end - (pos + 2) > 0 ? end - (pos + 2) : 0;
        pos += length;
        std::string what;
        if (refused(marker, what))
            fail(2, what + " is not decoded; only baseline, extended-"
                           "sequential and progressive Huffman files (SOF0, "
                           "SOF1, SOF2) are");
        if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
            if (have_frame) fail(1, "two frames in one JPEG");
            start_frame(frame, seg, seg_len, marker);
            have_frame = true;
            if (out == nullptr) {
                dims[0] = frame.height;
                dims[1] = frame.width;
                dims[2] = static_cast<int64_t>(frame.comps.size());
                return;
            }
            frame.coef.assign(static_cast<size_t>(frame.blocks) * 64, 0);
        } else if (marker == 0xDB) {
            int64_t p = 0;
            while (p < seg_len) {
                const int pq = seg[p] >> 4, tq = seg[p] & 15;
                if (tq > 3) corrupt("bad quantisation table");
                if (p + 1 + (pq ? 128 : 64) > seg_len)
                    corrupt("a truncated quantisation table");
                for (int k = 0; k < 64; ++k)
                    quant[tq][kNatural[k]] = pq ? u16(seg + p + 1 + 2 * k)
                                                : seg[p + 1 + k];
                quant_defined[tq] = true;
                p += pq ? 129 : 65;
            }
        } else if (marker == 0xC4) {
            int64_t p = 0;
            while (p < seg_len) {
                if (p + 17 > seg_len) corrupt("a truncated Huffman table");
                const int tc = seg[p] >> 4, th = seg[p] & 15;
                if (tc > 1 || th > 3) corrupt("bad Huffman table");
                int n = 0;
                for (int i = 0; i < 16; ++i) n += seg[p + 1 + i];
                if (n > 256 || p + 17 + n > seg_len)
                    corrupt("bad Huffman table");
                HuffSpec& spec = tc ? ac_spec[th] : dc_spec[th];
                std::memcpy(spec.counts, seg + p + 1, 16);
                std::memcpy(spec.symbols, seg + p + 17, static_cast<size_t>(n));
                spec.defined = true;
                p += 17 + n;
            }
        } else if (marker == 0xDD) {
            if (seg_len < 2) corrupt("a truncated restart interval");
            restart = u16(seg);
        } else if (marker == 0xE0) {
            jfif = jfif || (seg_len >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0);
        } else if (marker == 0xEE) {
            if (seg_len >= 12 && std::memcmp(seg, "Adobe", 5) == 0)
                adobe = seg[11];
        } else if (marker == 0xDA) {
            if (!have_frame) fail(1, "a scan before the frame header");
            const int ns = seg_len ? seg[0] : 0;
            if (ns < 1 || seg_len < 1 + 2 * ns + 3)
                corrupt("a truncated scan header");
            Scan scan;
            scan.ss = seg[1 + 2 * ns];
            scan.se = seg[2 + 2 * ns];
            scan.ah = seg[3 + 2 * ns] >> 4;
            scan.al = seg[3 + 2 * ns] & 15;
            if (frame.progressive) {
                bool bad = scan.ss == 0 ? scan.se != 0
                                        : scan.ss > scan.se || scan.se > 63
                                              || ns != 1;
                bad = bad || (scan.ah && scan.al != scan.ah - 1) || scan.al > 13;
                if (bad) corrupt("bad progression parameters");
            }
            const bool need_dc = !frame.progressive
                                 || (scan.ss == 0 && scan.ah == 0);
            const bool need_ac = !frame.progressive || scan.ss > 0;
            std::vector<Huff> tables(static_cast<size_t>(2 * ns));
            for (int i = 0; i < ns; ++i) {
                const int cid = seg[1 + 2 * i], t = seg[2 + 2 * i];
                Component* c = nullptr;
                for (Component& cc : frame.comps)
                    if (cc.id == cid) { c = &cc; break; }
                if (c == nullptr) corrupt("a scan names no component of the frame");
                if (c->tq > 3 || !quant_defined[c->tq])
                    fail(1, "no quantisation table " + std::to_string(c->tq));
                if (!c->latched) {
                    std::memcpy(c->quant, quant[c->tq], sizeof(c->quant));
                    c->latched = true;
                }
                ScanComp sc{c, nullptr, nullptr};
                if (need_dc) {
                    if ((t >> 4) > 3 || !dc_spec[t >> 4].defined)
                        fail(1, "a scan names a Huffman table that is not "
                                "defined");
                    make_huff(tables[2 * i], dc_spec[t >> 4]);
                    sc.dc = &tables[2 * i];
                }
                if (need_ac) {
                    if ((t & 15) > 3 || !ac_spec[t & 15].defined)
                        fail(1, "a scan names a Huffman table that is not "
                                "defined");
                    make_huff(tables[2 * i + 1], ac_spec[t & 15]);
                    sc.ac = &tables[2 * i + 1];
                }
                scan.comps.push_back(sc);
            }
            const int64_t stop = end_of_scan(data, len, pos);
            decode_scan(frame, scan, data, pos, stop, restart);
            pos = stop;
        }
        // APPn, COM and other segments are skipped
    }
    if (!have_frame) fail(1, "a JPEG without a frame");
    finish(frame, jfif, adobe, out);
}

void put_message(char* err, int64_t err_len, const std::string& msg) {
    if (err == nullptr || err_len <= 0) return;
    const size_t n = msg.size() < static_cast<size_t>(err_len - 1)
                         ? msg.size() : static_cast<size_t>(err_len - 1);
    std::memcpy(err, msg.data(), n);
    err[n] = '\0';
}

}  // namespace

extern "C" int64_t jpeg_decode(const uint8_t* data, int64_t len, int64_t* dims,
                               uint8_t* out, char* err, int64_t err_len) {
    try {
        decode(data, len, dims, out);
        return 0;
    } catch (const Error& e) {
        put_message(err, err_len, e.msg);
        return e.code;
    } catch (const std::bad_alloc&) {
        put_message(err, err_len, "out of memory");
        return 3;
    }
}
