// PNG row unfiltering (the five filter types of the PNG specification,
// section 9) for 1, 3 and 4 bytes a pixel (greyscale, RGB, RGBA), row by row: the left, upper and
// upper-left bytes of Paeth and average are the bytes this loop has just
// written. The plain version is data/png.py:unfilter_plain.
//
//   png_unfilter(raw, h, stride, bpp, out) -> 0, 1 + the row whose
//       filter type is not 0..4, or -1 for a bpp other than 1, 3 and 4
//
// raw holds h rows of 1 + stride bytes (the filter type, then the
// filtered bytes) as inflated from the IDAT chunks; out gets h x stride.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// the Paeth predictor without branches (noise makes them unpredictable):
// a where |p - a| <= |p - b| and |p - c|, else b where |p - b| <= |p - c|,
// else c, for p = a + b - c
inline int paeth(int a, int b, int c) {
    const int pa = std::abs(b - c);
    const int pb = std::abs(a - c);
    const int pc = std::abs(a + b - 2 * c);
    const int ab = pb < pa ? b : a;
    const int dab = pb < pa ? pb : pa;
    return pc < dab ? c : ab;
}

// a Paeth row at a fixed bpp, so that the bpp chains through `left`
// interleave
template <int kBpp>
void paeth_row(const uint8_t* f, const uint8_t* prior, uint8_t* o,
               int64_t stride) {
    for (int64_t i = 0; i < kBpp && i < stride; ++i)
        o[i] = static_cast<uint8_t>(f[i] + prior[i]);
    for (int64_t i = kBpp; i < stride; ++i)
        o[i] = static_cast<uint8_t>(
            f[i] + paeth(o[i - kBpp], prior[i], prior[i - kBpp]));
}

}  // namespace

extern "C" int64_t png_unfilter(const uint8_t* raw, int64_t h,
                                int64_t stride, int64_t bpp, uint8_t* out) {
    if (bpp != 1 && bpp != 3 && bpp != 4) return -1;
    std::vector<uint8_t> zeros(static_cast<size_t>(stride), 0);
    const uint8_t* prior = zeros.data();
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* f = raw + r * (stride + 1);
        const int type = *f++;
        uint8_t* o = out + r * stride;
        const int64_t n0 = bpp < stride ? bpp : stride;
        switch (type) {
            case 0:
                std::memcpy(o, f, static_cast<size_t>(stride));
                break;
            case 1:
                for (int64_t i = 0; i < n0; ++i) o[i] = f[i];
                for (int64_t i = bpp; i < stride; ++i)
                    o[i] = static_cast<uint8_t>(f[i] + o[i - bpp]);
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i)
                    o[i] = static_cast<uint8_t>(f[i] + prior[i]);
                break;
            case 3:
                for (int64_t i = 0; i < n0; ++i)
                    o[i] = static_cast<uint8_t>(f[i] + (prior[i] >> 1));
                for (int64_t i = bpp; i < stride; ++i)
                    o[i] = static_cast<uint8_t>(
                        f[i] + ((o[i - bpp] + prior[i]) >> 1));
                break;
            case 4:
                if (bpp == 3)
                    paeth_row<3>(f, prior, o, stride);
                else if (bpp == 4)
                    paeth_row<4>(f, prior, o, stride);
                else
                    paeth_row<1>(f, prior, o, stride);
                break;
            default:
                return r + 1;
        }
        prior = o;
    }
    return 0;
}
