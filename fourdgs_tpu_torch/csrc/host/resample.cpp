// Pillow's resampling (its Resample.c) of 8-bit images, LANCZOS and
// BICUBIC, bit for bit: a horizontal pass, then a vertical one, each
// skipped where that side keeps its size, both through an 8-bit image.
// The plain version is data/resample.py:resample_plain, whose module
// docstring gives the coefficients' rule; they are computed here in the
// same double arithmetic, with the C library's sin, as Pillow's are.
//
//   resample_u8(in, h, w, ch, out, out_h, out_w, filter) -> 0, or -1 for
//       an unknown filter (0 LANCZOS, 1 BICUBIC) or a size below 1
//
// in is (h, w, ch) uint8, out (out_h, out_w, ch), any ch >= 1.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 22;

double sinc(double x) {
    if (x == 0.0) return 1.0;
    x = x * M_PI;
    return std::sin(x) / x;
}

double lanczos(double x) {
    if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3);
    return 0.0;
}

double bicubic(double x) {
    const double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
}

struct Coeffs {
    int ksize = 0;
    std::vector<int> xmin, n;     // first sample and sample count per output
    std::vector<int32_t> k;       // (out, ksize) fixed-point weights
};

Coeffs coefficients(int in_size, int out_size, int filter) {
    double (*fn)(double) = filter == 0 ? lanczos : bicubic;
    const double filter_support = filter == 0 ? 3.0 : 2.0;
    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = filter_support * filterscale;
    Coeffs c;
    c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    c.xmin.resize(out_size);
    c.n.resize(out_size);
    c.k.assign(static_cast<size_t>(out_size) * c.ksize, 0);
    const double ss = 1.0 / filterscale;
    std::vector<double> w(c.ksize);
    for (int xx = 0; xx < out_size; ++xx) {
        const double center = (xx + 0.5) * scale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double ww = 0.0;
        for (int x = 0; x < xmax; ++x) {
            w[x] = fn((x + xmin - center + 0.5) * ss);
            ww += w[x];
        }
        int32_t* kk = c.k.data() + static_cast<size_t>(xx) * c.ksize;
        for (int x = 0; x < xmax; ++x) {
            const double v = ww != 0.0 ? w[x] / ww : w[x];
            kk[x] = v < 0 ? static_cast<int32_t>(-0.5 + v * (1 << kPrecisionBits))
                          : static_cast<int32_t>(0.5 + v * (1 << kPrecisionBits));
        }
        c.xmin[xx] = xmin;
        c.n[xx] = xmax;
    }
    return c;
}

inline uint8_t clip8(int32_t v) {
    v >>= kPrecisionBits;
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void horizontal(const uint8_t* in, int64_t h, int64_t w, int64_t ch,
                uint8_t* out, int out_w, const Coeffs& c) {
    const int32_t half = 1 << (kPrecisionBits - 1);
    std::vector<int32_t> acc(ch);
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = in + y * w * ch;
        uint8_t* o = out + y * out_w * ch;
        for (int xx = 0; xx < out_w; ++xx) {
            const int32_t* k = c.k.data() + static_cast<size_t>(xx) * c.ksize;
            const uint8_t* src = row + static_cast<int64_t>(c.xmin[xx]) * ch;
            const int n = c.n[xx];
            if (ch == 3) {
                int32_t s0 = half, s1 = half, s2 = half;
                for (int x = 0; x < n; ++x, src += 3) {
                    s0 += src[0] * k[x];
                    s1 += src[1] * k[x];
                    s2 += src[2] * k[x];
                }
                o[3 * xx] = clip8(s0);
                o[3 * xx + 1] = clip8(s1);
                o[3 * xx + 2] = clip8(s2);
                continue;
            }
            for (int64_t j = 0; j < ch; ++j) acc[j] = half;
            for (int x = 0; x < n; ++x, src += ch)
                for (int64_t j = 0; j < ch; ++j) acc[j] += src[j] * k[x];
            for (int64_t j = 0; j < ch; ++j) o[xx * ch + j] = clip8(acc[j]);
        }
    }
}

void vertical(const uint8_t* in, int64_t row_len, uint8_t* out, int out_h,
              const Coeffs& c) {
    std::vector<int32_t> acc(row_len);
    for (int yy = 0; yy < out_h; ++yy) {
        const int32_t* k = c.k.data() + static_cast<size_t>(yy) * c.ksize;
        for (int64_t i = 0; i < row_len; ++i) acc[i] = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < c.n[yy]; ++y) {
            const uint8_t* row = in + (c.xmin[yy] + y) * row_len;
            const int32_t ky = k[y];
            for (int64_t i = 0; i < row_len; ++i) acc[i] += row[i] * ky;
        }
        uint8_t* o = out + yy * row_len;
        for (int64_t i = 0; i < row_len; ++i) o[i] = clip8(acc[i]);
    }
}

}  // namespace

extern "C" int64_t resample_u8(const uint8_t* in, int64_t h, int64_t w,
                               int64_t ch, uint8_t* out, int64_t out_h,
                               int64_t out_w, int64_t filter) {
    if ((filter != 0 && filter != 1) || h < 1 || w < 1 || ch < 1
        || out_h < 1 || out_w < 1)
        return -1;
    if (out_w == w && out_h == h) {
        std::memcpy(out, in, static_cast<size_t>(h * w * ch));
        return 0;
    }
    std::vector<uint8_t> tmp;
    const uint8_t* src = in;
    if (out_w != w) {
        const Coeffs c = coefficients(static_cast<int>(w),
                                      static_cast<int>(out_w),
                                      static_cast<int>(filter));
        uint8_t* dst = out;
        if (out_h != h) {
            tmp.resize(static_cast<size_t>(h * out_w * ch));
            dst = tmp.data();
        }
        horizontal(in, h, w, ch, dst, static_cast<int>(out_w), c);
        src = dst;
    }
    if (out_h != h) {
        const Coeffs c = coefficients(static_cast<int>(h),
                                      static_cast<int>(out_h),
                                      static_cast<int>(filter));
        vertical(src, out_w * ch, out, static_cast<int>(out_h), c);
    }
    return 0;
}
