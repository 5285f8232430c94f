// PNG row unfiltering, for data/png.py.
//
// Built with g++ into build/ by detectorfreesfm_tpu_torch/data/png.py;
// needs no header beyond the C++ standard library.
//
// The Average (3) and Paeth (4) filters predict each byte from the
// decoded byte one pixel to its left, so a row undoes byte by byte. In
// Python that loop costs about a microsecond a byte, and adaptive-filter
// PNGs (what libpng and PIL write for photographs) are mostly Paeth rows.
// Here it runs at a few nanoseconds a byte, and ctypes releases the GIL
// for the call, so a thread pool decodes images in parallel.
//
// Exposed C ABI (ctypes):
//   int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
//                    int64_t bpp, uint8_t* out);
// raw holds h rows of (1 filter byte + stride data bytes); out receives
// the h * stride decoded bytes. Returns 0, or 1 + the row of the first
// unknown filter type. Semantics match png.py's Python rows exactly.

#include <cstdint>
#include <cstdlib>

extern "C" {

int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp,
                 uint8_t* out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t kind = raw[y * (stride + 1)];
        const uint8_t* cur = raw + y * (stride + 1) + 1;
        uint8_t* dst = out + y * stride;
        const uint8_t* up = y > 0 ? out + (y - 1) * stride : nullptr;
        for (int64_t i = 0; i < stride; ++i) {
            const int a = i >= bpp ? dst[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            const int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int pred;
            switch (kind) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b),
                              pc = std::abs(p - c);
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return static_cast<int>(y + 1);
            }
            dst[i] = static_cast<uint8_t>(cur[i] + pred);
        }
    }
    return 0;
}

}  // extern "C"
