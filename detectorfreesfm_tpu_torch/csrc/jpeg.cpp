// A self-contained JPEG decoder for data/images.py: baseline and
// progressive Huffman JPEG with 8-bit samples, gray or YCbCr.
//
// Built with g++ into build/native/ by detectorfreesfm_tpu_torch/data/
// images.py; needs no header beyond the C++ standard library, so it builds
// wherever g++ does (libjpeg's headers are not needed). ctypes releases
// the GIL for each call, so a thread pool decodes images in parallel.
//
// What it reads: SOF0/SOF1 (sequential) and SOF2 (progressive, with
// successive approximation) frames of 1 component (gray) or 3 components
// (YCbCr), any size, restart intervals, 8- or 16-bit quantisation tables,
// interleaved and single-component scans. RGB output takes chroma sampled
// 4:4:4, 4:2:2 or 4:2:0; gray output needs only full-resolution luma.
// Everything else is refused with a message that names the feature:
// arithmetic coding, 12-bit samples, lossless and hierarchical frames,
// CMYK/YCCK, RGB stored without the colour transform, and truncated or
// corrupt data (where libjpeg would warn and fill in grey, this raises).
//
// What it gives, bit for bit as libjpeg(-turbo) with its defaults:
//   * gray: the Y plane through the integer "islow" IDCT (jidctint.c's
//     constants, descaling and range limiting), as libjpeg's
//     JCS_GRAYSCALE output does;
//   * RGB: chroma upsampled as libjpeg's fancy upsampling (jdsample.c: the
//     h2v1 triangle filter with +1/+2 rounding, h2v2 with +8/+7, edges
//     replicated, box filtering where the chroma plane is 2 or fewer
//     samples wide), then jdcolor.c's fixed-point YCbCr -> RGB tables;
//     what PIL's convert("RGB") gives for a JPEG.
// A progressive file is decoded to its end before its IDCT, so libjpeg's
// block smoothing (which fires only on coefficients still unrefined) never
// applies.
//
// Exposed C ABI (ctypes); each returns 0, or 1 with a message in err:
//   int jpeg_gray(const char* path, uint8_t* out, long cap, int* wh,
//                 char* err, int errlen);
//   int jpeg_rgb(const char* path, uint8_t* out, long cap, int* wh,
//                char* err, int errlen);
//   int jpeg_gray_resize(const char* path, int long_side, int df,
//                        int pad_to, float* out, int* meta, char* err,
//                        int errlen);
// jpeg_gray_resize is the JAX package's native/imageloader.cpp
// decode_gray_resize contract (meta = [w0, h0, nw, nh]) with that file's
// resample_axis arithmetic.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Refused {
  std::string msg;
};

[[noreturn]] void refuse(const std::string& msg) { throw Refused{msg}; }

// Zigzag position -> natural (row-major) position, with 16 spare entries
// so that a corrupt run past 63 lands on a harmless index (as libjpeg's
// jpeg_natural_order).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  uint8_t look_nbits[1 << kLookBits];
  uint8_t look_sym[1 << kLookBits];

  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    std::memcpy(huffval, vals, nvals);
    // Canonical codes (jdhuff.c's jpeg_make_d_derived_tbl). The length's
    // codes are checked before any is written: the last must leave the
    // all-ones code of its length free, as libjpeg requires, which also
    // keeps every index below 1 << kLookBits.
    int code = 0, p = 0;
    std::memset(look_nbits, 0, sizeof(look_nbits));
    for (int l = 1; l <= 16; ++l) {
      const int n = bits[l - 1];
      if (code + n >= (1 << l)) refuse("corrupt Huffman table");
      if (n) {
        valoffset[l] = p - code;
        for (int i = 0; i < n; ++i, ++p, ++code) {
          if (l <= kLookBits) {
            const int shift = kLookBits - l;
            for (int k = 0; k < (1 << shift); ++k) {
              look_nbits[(code << shift) | k] = static_cast<uint8_t>(l);
              look_sym[(code << shift) | k] = vals[p];
            }
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
        valoffset[l] = 0;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;  // stops the slow path's search
    valoffset[17] = 0;
    defined = true;
  }
};

// Entropy-coded data: a 64-bit MSB-first bit buffer over the file's bytes
// with 0xFF00 unstuffed. At a marker (or the end of the file) it feeds zero
// bits, as libjpeg does, and counts them, so that a decoder that consumes
// any of them knows the data ran out (refused as truncated or corrupt).
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;
  int bits = 0;
  int fake = 0;  // zero bits fed after the data ended, at the buffer's tail
  bool at_marker = false;

  void start(const uint8_t* from, const uint8_t* to) {
    p = from;
    end = to;
    buf = 0;
    bits = 0;
    fake = 0;
    at_marker = false;
  }

  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes before a marker
          if (q < end && *q == 0x00) {
            p = q + 1;  // stuffed data byte 0xFF
          } else {
            at_marker = true;  // p stays on the marker's first 0xFF
            b = 0;
            fake += 8;
          }
        } else {
          ++p;
        }
      } else {
        at_marker = true;
        fake += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }

  inline void need(int n) {
    if (bits < n) fill();
  }
  inline uint32_t peek(int n) const {
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  inline void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  inline uint32_t get(int n) {  // n in 1..16
    need(n);
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  inline int get_bit() { return static_cast<int>(get(1)); }
  bool overran() const { return bits < fake; }

  inline int decode(const Huffman& h) {
    need(16);
    const uint32_t look = peek(kLookBits);
    const int nb = h.look_nbits[look];
    if (nb) {
      skip(nb);
      return h.look_sym[look];
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(peek(l));
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) refuse("corrupt entropy-coded data (bad Huffman code)");
      code = static_cast<int32_t>(peek(l));
    }
    skip(l);
    return h.huffval[(h.valoffset[l] + code) & 0xFF];
  }

  // s bits, sign-extended as JPEG's EXTEND (s in 1..16).
  inline int receive_extend(int s) {
    const int v = static_cast<int>(get(s));
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
};

// The DC predictor plus a difference; a sum past int's range is refused as
// libjpeg-turbo refuses it (JERR_BAD_DCT_COEF).
inline int add_dc(int pred, int diff) {
  const int64_t v = static_cast<int64_t>(pred) + diff;
  if (v > INT32_MAX || v < INT32_MIN) refuse("corrupt entropy-coded data");
  return static_cast<int>(v);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;      // samples (libjpeg's downsampled_*)
  int bw = 0, bh = 0;             // blocks holding samples
  int stride_blocks = 0, rows_blocks = 0;  // blocks allocated (MCU grid)
  int dc_pred = 0;
  bool quant_latched = false;
  int16_t quant[64];              // natural order
  std::vector<int16_t> coef;      // rows_blocks * stride_blocks * 64
  std::vector<uint8_t> plane;     // (rows_blocks*8) x (stride_blocks*8)
};

struct Decoder {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;

  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;

  bool frame = false, progressive = false;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  bool want[4] = {true, true, true, true};
  bool eoi = false;

  uint8_t byte() {
    if (pos >= size) refuse("truncated file");
    return data[pos++];
  }
  int u16() {
    const int a = byte();
    return (a << 8) | byte();
  }

  void parse_dqt(size_t seg_end) {
    while (pos < seg_end) {
      const int b = byte();
      const int pq = b >> 4, tq = b & 15;
      if (tq > 3 || pq > 1) refuse("corrupt quantisation table");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : byte());
      qt_defined[tq] = true;
    }
  }

  void parse_dht(size_t seg_end) {
    while (pos < seg_end) {
      const int b = byte();
      const int tc = b >> 4, th = b & 15;
      if (tc > 1 || th > 3) refuse("corrupt Huffman table");
      uint8_t counts[16];
      int n = 0;
      for (int i = 0; i < 16; ++i) n += counts[i] = byte();
      if (n > 256) refuse("corrupt Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < n; ++i) vals[i] = byte();
      (tc ? ac_tables : dc_tables)[th].build(counts, vals, n);
    }
  }

  void parse_sof(int marker) {
    if (frame) refuse("more than one frame");
    if (marker == 0xC3) refuse("lossless JPEG (SOF3) is not supported");
    if (marker >= 0xC9) {
      refuse("arithmetic coding (SOF" + std::to_string(marker - 0xC0) +
             ") is not supported");
    }
    if (marker >= 0xC5) {
      refuse("hierarchical JPEG (SOF" + std::to_string(marker - 0xC0) +
             ") is not supported");
    }
    progressive = marker == 0xC2;
    const int precision = byte();
    if (precision != 8)
      refuse(std::to_string(precision) + "-bit samples are not supported");
    height = u16();
    width = u16();
    if (height == 0) refuse("a height set by a DNL marker is not supported");
    if (width == 0) refuse("zero image width");
    const int nf = byte();
    if (nf == 4) refuse("CMYK/YCCK (4 components) is not supported");
    if (nf != 1 && nf != 3)
      refuse(std::to_string(nf) + " components are not supported");
    comps.resize(nf);
    for (auto& c : comps) {
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        refuse("corrupt frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.width = static_cast<int>(
          (static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>(
          (static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.bw = (c.width + 7) / 8;
      c.bh = (c.height + 7) / 8;
      c.stride_blocks = std::max(c.bw, nf > 1 ? mcux * c.h : c.bw);
      c.rows_blocks = std::max(c.bh, nf > 1 ? mcuy * c.v : c.bh);
    }
    frame = true;
  }

  void check_colour_space() {
    if (comps.size() != 3) return;
    // jdapimin.c's default_decompress_parms: JFIF implies YCbCr; an Adobe
    // marker's transform flag decides; else RGB by component ids.
    bool rgb = false;
    if (saw_jfif) {
      rgb = false;
    } else if (saw_adobe) {
      rgb = adobe_transform == 0;
    } else {
      rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
    }
    if (rgb)
      refuse("Adobe RGB without the colour transform is not supported");
  }

  void allocate() {
    for (size_t i = 0; i < comps.size(); ++i) {
      Component& c = comps[i];
      if (!want[i]) continue;
      c.coef.assign(static_cast<size_t>(c.stride_blocks) * c.rows_blocks * 64,
                    0);
    }
  }

  int16_t* block(Component& c, int by, int bx) {
    return c.coef.data() +
           (static_cast<size_t>(by) * c.stride_blocks + bx) * 64;
  }

  // Scans the bytes from `from` for the next marker that is not a restart
  // marker; returns its position (of the 0xFF) or size.
  size_t next_marker(size_t from) const {
    size_t i = from;
    while (i + 1 < size) {
      if (data[i] == 0xFF) {
        size_t j = i + 1;
        while (j < size && data[j] == 0xFF) ++j;
        if (j >= size) return size;
        const uint8_t m = data[j];
        if (m != 0x00 && !(m >= 0xD0 && m <= 0xD7)) return j - 1;
        i = j + 1;
      } else {
        ++i;
      }
    }
    return size;
  }

  // At an interval's end: the expected RSTn must come next.
  void restart(BitReader& br, int& next_rst) {
    size_t i = static_cast<size_t>(br.p - data);
    while (i < size && data[i] != 0xFF) ++i;  // only padding may remain
    while (i < size && data[i] == 0xFF) ++i;
    if (i >= size) refuse("truncated file");
    if (data[i] != 0xD0 + next_rst)
      refuse("corrupt data: expected restart marker " +
             std::to_string(next_rst));
    next_rst = (next_rst + 1) & 7;
    br.start(data + i + 1, data + size);
  }

  void scan() {
    const size_t len = u16();
    if (len < 2 || pos + len - 2 > size) refuse("truncated file");
    const size_t seg_end = pos + len - 2;
    const int ns = byte();
    if (ns < 1 || ns > 4) refuse("corrupt scan header");
    int ci[4], td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      const int id = byte();
      const int t = byte();
      ci[i] = -1;
      for (size_t k = 0; k < comps.size(); ++k)
        if (comps[k].id == id) ci[i] = static_cast<int>(k);
      if (ci[i] < 0) refuse("scan names an unknown component");
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) refuse("corrupt scan header");
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    pos = seg_end;
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        refuse("corrupt sequential scan header");
    } else {
      if (ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) ||
          (ss > 0 && ns != 1))
        refuse("corrupt progressive scan header");
    }
    // Latch quantisation tables at a component's first scan (libjpeg's
    // latch_quant_tables).
    for (int i = 0; i < ns; ++i) {
      Component& c = comps[ci[i]];
      if (!c.quant_latched) {
        if (!qt_defined[c.tq]) refuse("missing quantisation table");
        for (int k = 0; k < 64; ++k)
          c.quant[k] = static_cast<int16_t>(qt[c.tq][k]);
        c.quant_latched = true;
      }
    }
    // A scan of components nobody asked for (gray output: the chroma
    // scans) is skipped: each scan's data stands alone.
    bool needed = false;
    for (int i = 0; i < ns; ++i) needed |= want[ci[i]];
    if (!needed) {
      pos = next_marker(pos);
      return;
    }
    for (int i = 0; i < ns; ++i) {
      const bool need_dc = !(progressive && (ss > 0 || ah > 0));
      const bool need_ac = !progressive || ss > 0;
      if (need_dc && !dc_tables[td[i]].defined)
        refuse("missing Huffman table");
      if (need_ac && !ac_tables[ta[i]].defined)
        refuse("missing Huffman table");
      comps[ci[i]].dc_pred = 0;
    }

    BitReader br;
    br.start(data + pos, data + size);
    int eobrun = 0;
    int next_rst = 0;
    int16_t scratch[64];
    long n_units;  // MCUs (interleaved) or blocks (single component)
    if (ns == 1) {
      const Component& c = comps[ci[0]];
      n_units = static_cast<long>(c.bw) * c.bh;
    } else {
      n_units = static_cast<long>(mcux) * mcuy;
    }
    int todo = restart_interval;

    auto decode_block = [&](int16_t* blk, Component& c, int i) {
      const Huffman& dct = dc_tables[td[i]];
      const Huffman& act = ac_tables[ta[i]];
      if (!progressive) {
        const int s = br.decode(dct);
        if (s > 16) refuse("corrupt entropy-coded data");
        const int diff = s ? br.receive_extend(s) : 0;
        c.dc_pred = add_dc(c.dc_pred, diff);
        blk[0] = static_cast<int16_t>(c.dc_pred);
        for (int k = 1; k < 64; ++k) {
          const int rs = br.decode(act);
          const int r = rs >> 4, s2 = rs & 15;
          if (s2) {
            k += r;
            if (k > 63) refuse("corrupt entropy-coded data");
            blk[kNatural[k]] = static_cast<int16_t>(br.receive_extend(s2));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      } else if (ss == 0) {
        if (ah == 0) {  // DC first
          const int s = br.decode(dct);
          if (s > 16) refuse("corrupt entropy-coded data");
          const int diff = s ? br.receive_extend(s) : 0;
          c.dc_pred = add_dc(c.dc_pred, diff);
          blk[0] = static_cast<int16_t>(
              static_cast<unsigned>(c.dc_pred) << al);
        } else if (br.get_bit()) {  // DC refine
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {  // AC first
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        for (int k = ss; k <= se; ++k) {
          const int rs = br.decode(act);
          const int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            if (k > 63) refuse("corrupt entropy-coded data");
            blk[kNatural[k]] = static_cast<int16_t>(
                static_cast<unsigned>(br.receive_extend(s)) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += static_cast<int>(br.get(r));
            --eobrun;
            break;
          }
        }
      } else {  // AC refine (jdphuff.c's decode_mcu_AC_refine)
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            const int rs = br.decode(act);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              if (s != 1) refuse("corrupt entropy-coded data");
              s = br.get_bit() ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) eobrun += static_cast<int>(br.get(r));
              break;
            }
            do {
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0) {
                if (br.get_bit() && (*coef & p1) == 0)
                  *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1
                                                          : *coef + m1);
              } else if (--r < 0) {
                break;
              }
              ++k;
            } while (k <= se);
            if (s) blk[kNatural[std::min(k, 63 + 15)]] =
                static_cast<int16_t>(s);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0 && br.get_bit() && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1
                                                      : *coef + m1);
          }
          --eobrun;
        }
      }
    };

    for (long u = 0; u < n_units; ++u) {
      if (restart_interval) {
        if (todo == 0) {
          restart(br, next_rst);
          for (int i = 0; i < ns; ++i) comps[ci[i]].dc_pred = 0;
          eobrun = 0;
          todo = restart_interval;
        }
        --todo;
      }
      if (ns == 1) {
        Component& c = comps[ci[0]];
        const int by = static_cast<int>(u / c.bw);
        const int bx = static_cast<int>(u % c.bw);
        int16_t* blk = scratch;
        if (want[ci[0]]) {
          blk = block(c, by, bx);
        } else {
          std::memset(scratch, 0, sizeof(scratch));
        }
        decode_block(blk, c, 0);
      } else {
        const int my = static_cast<int>(u / mcux);
        const int mx = static_cast<int>(u % mcux);
        for (int i = 0; i < ns; ++i) {
          Component& c = comps[ci[i]];
          for (int y = 0; y < c.v; ++y) {
            for (int x = 0; x < c.h; ++x) {
              int16_t* blk = scratch;
              if (want[ci[i]]) {
                blk = block(c, my * c.v + y, mx * c.h + x);
              } else {
                std::memset(scratch, 0, sizeof(scratch));
              }
              decode_block(blk, c, i);
            }
          }
        }
      }
      if (br.overran()) refuse("truncated file or corrupt entropy-coded data");
    }
    pos = next_marker(static_cast<size_t>(br.p - data));
  }

  void parse() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) refuse("not a JPEG");
    pos = 2;
    while (!eoi) {
      // Find the next marker, skipping fill bytes.
      uint8_t b = byte();
      if (b != 0xFF) refuse("corrupt data: expected a marker");
      do {
        b = byte();
      } while (b == 0xFF);
      const int marker = b;
      if (marker == 0xD9) {
        eoi = true;
        break;
      }
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (marker == 0xDA) {
        if (!frame) refuse("scan before the frame header");
        scan();
        continue;
      }
      const size_t len = u16();
      if (len < 2 || pos + len - 2 > size) refuse("truncated file");
      const size_t seg_end = pos + len - 2;
      if (marker == 0xDB) {
        parse_dqt(seg_end);
      } else if (marker == 0xC4) {
        parse_dht(seg_end);
      } else if (marker == 0xCC) {
        refuse("arithmetic coding (DAC) is not supported");
      } else if (marker == 0xC8) {
        refuse("the reserved JPEG extension marker (0xC8) is not supported");
      } else if (marker >= 0xC0 && marker <= 0xCF) {
        parse_sof(marker);
        check_colour_space();
        configure();
      } else if (marker == 0xDD) {
        restart_interval = u16();
      } else if (marker == 0xDC) {
        refuse("a DNL marker is not supported");
      } else if (marker == 0xDE || marker == 0xDF) {
        refuse("hierarchical JPEG is not supported");
      } else if (marker == 0xE0) {
        if (len >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0)
          saw_jfif = true;
      } else if (marker == 0xEE) {
        if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = data[pos + 11];
        }
      }
      pos = seg_end;
    }
    if (!frame) refuse("no frame header");
  }

  // Set by the caller before parse(): which output.
  bool rgb_out = false;

  void configure() {
    // The JFIF/Adobe markers come before the frame, so the colour space
    // is known here.
    if (!rgb_out || comps.size() == 1) {
      const Component& y = comps[0];
      if (y.h != hmax || y.v != vmax)
        refuse("subsampled luma is not supported");
      for (size_t i = 1; i < comps.size(); ++i) want[i] = false;
    } else {
      const Component &y = comps[0], &cb = comps[1], &cr = comps[2];
      const int fh = hmax / cb.h, fv = vmax / cb.v;
      const bool ok = y.h == hmax && y.v == vmax && cb.h == cr.h &&
                      cb.v == cr.v && hmax % cb.h == 0 && vmax % cb.v == 0 &&
                      ((fh == 1 && fv == 1) || (fh == 2 && fv == 1) ||
                       (fh == 2 && fv == 2));
      if (!ok) {
        refuse("chroma sampling " + std::to_string(y.h) + "x" +
               std::to_string(y.v) + "," + std::to_string(cb.h) + "x" +
               std::to_string(cb.v) + "," + std::to_string(cr.h) + "x" +
               std::to_string(cr.v) +
               " is not supported (4:4:4, 4:2:2 and 4:2:0 are)");
      }
    }
    allocate();
  }
};

// -- the islow IDCT (jidctint.c, 8-bit samples) ------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

// The IDCT's sums are 64-bit, as libjpeg-turbo's JLONG is on LP64: no
// coefficient a corrupt file can hold overflows them. Left shifts are
// multiplications, which are defined for negative values.
using Acc = int64_t;

inline Acc shl(Acc x, int n) { return x * (static_cast<Acc>(1) << n); }

inline Acc descale(Acc x, int n) {
  return (x + (static_cast<Acc>(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: sample = table[x & 1023] for the
// descaled value x, i.e. x + 128 clamped to [0, 255] for x in
// [-512, 511], and wrapping beyond (jdmaster.c's prepare_range_limit_table).
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = static_cast<uint8_t>(v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                size_t stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int32_t dc = static_cast<int32_t>(
          shl(static_cast<int32_t>(ip[0]) * qp[0], kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    Acc z2 = static_cast<int32_t>(ip[16]) * qp[16];
    Acc z3 = static_cast<int32_t>(ip[48]) * qp[48];
    Acc z1 = (z2 + z3) * FIX_0_541196100;
    Acc tmp2 = z1 + z3 * -FIX_1_847759065;
    Acc tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int32_t>(ip[0]) * qp[0];
    z3 = static_cast<int32_t>(ip[32]) * qp[32];
    Acc tmp0 = shl(z2 + z3, kConstBits);
    Acc tmp1 = shl(z2 - z3, kConstBits);
    const Acc tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const Acc tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = static_cast<int32_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int32_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int32_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int32_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    Acc z4 = tmp1 + tmp3;
    const Acc z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int32_t>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int32_t>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int32_t>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int32_t>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int32_t>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int32_t>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int32_t>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int32_t>(descale(tmp13 - tmp0, n));
  }
  constexpr int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t v =
          kRange.t[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    Acc z2 = wp[2], z3 = wp[6];
    Acc z1 = (z2 + z3) * FIX_0_541196100;
    Acc tmp2 = z1 + z3 * -FIX_1_847759065;
    Acc tmp3 = z1 + z2 * FIX_0_765366865;
    Acc tmp0 = shl(static_cast<Acc>(wp[0]) + wp[4], kConstBits);
    Acc tmp1 = shl(static_cast<Acc>(wp[0]) - wp[4], kConstBits);
    const Acc tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const Acc tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    Acc z4 = tmp1 + tmp3;
    const Acc z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[static_cast<int>(descale(tmp10 + tmp3, n)) & 1023];
    op[7] = kRange.t[static_cast<int>(descale(tmp10 - tmp3, n)) & 1023];
    op[1] = kRange.t[static_cast<int>(descale(tmp11 + tmp2, n)) & 1023];
    op[6] = kRange.t[static_cast<int>(descale(tmp11 - tmp2, n)) & 1023];
    op[2] = kRange.t[static_cast<int>(descale(tmp12 + tmp1, n)) & 1023];
    op[5] = kRange.t[static_cast<int>(descale(tmp12 - tmp1, n)) & 1023];
    op[3] = kRange.t[static_cast<int>(descale(tmp13 + tmp0, n)) & 1023];
    op[4] = kRange.t[static_cast<int>(descale(tmp13 - tmp0, n)) & 1023];
  }
}

void idct_component(Component& c) {
  const size_t stride = static_cast<size_t>(c.stride_blocks) * 8;
  c.plane.assign(stride * c.rows_blocks * 8, 0);
  // Blocks past bw x bh hold no samples of the image: skipped.
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(c.coef.data() +
                     (static_cast<size_t>(by) * c.stride_blocks + bx) * 64,
                 c.quant, c.plane.data() + by * 8 * stride + bx * 8, stride);
}

// -- chroma upsampling (jdsample.c) and colour conversion (jdcolor.c) --------

// Output row y of chroma component c at full resolution (2 * c.width
// samples where fh = 2, else c.width). For h2v2, row y >> 1 is the near
// chroma row and the one above (y even) or below (y odd) the far one,
// replicated at the plane's edges, combined as libjpeg's column sums.
void upsample_row(const Component& c, int fh, int fv, int y, uint8_t* out) {
  const size_t stride = static_cast<size_t>(c.stride_blocks) * 8;
  const int dw = c.width;
  if (fh == 1) {  // 4:4:4
    std::memcpy(out, c.plane.data() + y * stride, dw);
    return;
  }
  const bool fancy = dw > 2;
  if (fv == 1) {  // h2v1
    const uint8_t* in = c.plane.data() + y * stride;
    if (!fancy) {
      for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in[x];
      return;
    }
    out[0] = in[0];
    out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      const int v = in[x] * 3;
      out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
    }
    out[2 * dw - 2] =
        static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = in[dw - 1];
    return;
  }
  // h2v2
  const int cy = y >> 1;
  const uint8_t* in0 = c.plane.data() + cy * stride;
  if (!fancy) {
    for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in0[x];
    return;
  }
  const int far_y = (y & 1) ? std::min(cy + 1, c.height - 1)
                            : std::max(cy - 1, 0);
  const uint8_t* in1 = c.plane.data() + far_y * stride;
  int this_sum = in0[0] * 3 + in1[0];
  int next_sum = in0[1] * 3 + in1[1];
  out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 1; x < dw - 1; ++x) {
    next_sum = in0[x + 1] * 3 + in1[x + 1];
    out[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1L << kScale) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void to_rgb(Decoder& d, uint8_t* out) {
  const int w = d.width, h = d.height;
  const Component& y = d.comps[0];
  const size_t ys = static_cast<size_t>(y.stride_blocks) * 8;
  if (d.comps.size() == 1) {
    for (int r = 0; r < h; ++r) {
      const uint8_t* in = y.plane.data() + r * ys;
      uint8_t* o = out + static_cast<size_t>(r) * w * 3;
      for (int x = 0; x < w; ++x)
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return;
  }
  const Component &cb = d.comps[1], &cr = d.comps[2];
  const int fh = d.hmax / cb.h, fv = d.vmax / cb.v;
  std::vector<uint8_t> rb(2 * static_cast<size_t>(cb.width) + 2);
  std::vector<uint8_t> rr(2 * static_cast<size_t>(cr.width) + 2);
  for (int r = 0; r < h; ++r) {
    upsample_row(cb, fh, fv, r, rb.data());
    upsample_row(cr, fh, fv, r, rr.data());
    const uint8_t* in = y.plane.data() + r * ys;
    uint8_t* o = out + static_cast<size_t>(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = in[x], b = rb[x], c = rr[x];
      o[3 * x] = clamp255(yy + kYcc.cr_r[c]);
      o[3 * x + 1] =
          clamp255(yy + static_cast<int>((kYcc.cb_g[b] + kYcc.cr_g[c]) >> 16));
      o[3 * x + 2] = clamp255(yy + kYcc.cb_b[b]);
    }
  }
}

// -- file reading and the resize (native/imageloader.cpp's) ------------------

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) refuse("cannot open the file");
  std::vector<uint8_t> buf;
  uint8_t chunk[1 << 16];
  size_t n;
  while ((n = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    buf.insert(buf.end(), chunk, chunk + n);
  std::fclose(f);
  return buf;
}

void decode(const char* path, bool rgb, Decoder& d,
            std::vector<uint8_t>& file) {
  file = read_file(path);
  d.data = file.data();
  d.size = file.size();
  d.rgb_out = rgb;
  d.parse();
  for (size_t i = 0; i < d.comps.size(); ++i)
    if (d.want[i]) idct_component(d.comps[i]);
}

// Pillow-compatible separable triangle resample, as native/imageloader.cpp's
// resample_axis: the same taps, added in the same order in double and
// rounded once to float, so the floats equal that file's. The loops run
// line by line (the taps are computed once), which changes no sum.
void resample_axis(const float* src, int sw, int sh, float* dst, int dn,
                   bool horizontal) {
  const int src_n = horizontal ? sw : sh;
  const double scale = static_cast<double>(src_n) / dn;
  const double fscale = std::max(1.0, scale);
  const double support = fscale;
  const int max_taps = static_cast<int>(std::ceil(support)) * 2 + 2;
  std::vector<int> lo(dn), hi(dn);
  std::vector<double> wts(static_cast<size_t>(dn) * max_taps);
  std::vector<double> total(dn);
  for (int o = 0; o < dn; ++o) {
    const double center = (o + 0.5) * scale;
    int l = std::max(static_cast<int>(std::floor(center - support)), 0);
    int hgh = std::min(static_cast<int>(std::ceil(center + support)), src_n);
    double* w = wts.data() + static_cast<size_t>(o) * max_taps;
    double tot = 0.0;
    for (int s = l; s < hgh; ++s) {
      const double x = std::abs((s + 0.5 - center) / fscale);
      const double wgt = x < 1.0 ? 1.0 - x : 0.0;
      w[s - l] = wgt;
      tot += wgt;
    }
    if (tot <= 0.0) {  // degenerate: nearest
      l = std::min(std::max(static_cast<int>(center), 0), src_n - 1);
      hgh = l + 1;
      w[0] = 1.0;
      tot = 1.0;
    }
    lo[o] = l;
    hi[o] = hgh;
    total[o] = tot;
  }
  if (horizontal) {
    for (int line = 0; line < sh; ++line) {
      const float* row = src + static_cast<size_t>(line) * sw;
      float* drow = dst + static_cast<size_t>(line) * dn;
      for (int o = 0; o < dn; ++o) {
        const double* w = wts.data() + static_cast<size_t>(o) * max_taps;
        double acc = 0.0;
        for (int s = lo[o]; s < hi[o]; ++s) acc += row[s] * w[s - lo[o]];
        drow[o] = static_cast<float>(acc / total[o]);
      }
    }
  } else {
    std::vector<double> acc(sw);
    for (int o = 0; o < dn; ++o) {
      const double* w = wts.data() + static_cast<size_t>(o) * max_taps;
      std::fill(acc.begin(), acc.end(), 0.0);
      for (int s = lo[o]; s < hi[o]; ++s) {
        const float* row = src + static_cast<size_t>(s) * sw;
        const double ws = w[s - lo[o]];
        for (int x = 0; x < sw; ++x) acc[x] += row[x] * ws;
      }
      float* drow = dst + static_cast<size_t>(o) * sw;
      for (int x = 0; x < sw; ++x)
        drow[x] = static_cast<float>(acc[x] / total[o]);
    }
  }
}

int report(const Refused& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, e.msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

}  // namespace

extern "C" {

int jpeg_gray(const char* path, uint8_t* out, long cap, int* wh, char* err,
              int errlen) {
  try {
    Decoder d;
    std::vector<uint8_t> file;
    decode(path, false, d, file);
    const Component& y = d.comps[0];
    const size_t ys = static_cast<size_t>(y.stride_blocks) * 8;
    if (static_cast<long>(d.width) * d.height > cap)
      refuse("output buffer too small");
    for (int r = 0; r < d.height; ++r)
      std::memcpy(out + static_cast<size_t>(r) * d.width,
                  y.plane.data() + r * ys, d.width);
    wh[0] = d.width;
    wh[1] = d.height;
    return 0;
  } catch (const Refused& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Refused{"out of memory"}, err, errlen);
  }
}

int jpeg_rgb(const char* path, uint8_t* out, long cap, int* wh, char* err,
             int errlen) {
  try {
    Decoder d;
    std::vector<uint8_t> file;
    decode(path, true, d, file);
    if (static_cast<long>(d.width) * d.height * 3 > cap)
      refuse("output buffer too small");
    to_rgb(d, out);
    wh[0] = d.width;
    wh[1] = d.height;
    return 0;
  } catch (const Refused& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Refused{"out of memory"}, err, errlen);
  }
}

int jpeg_gray_resize(const char* path, int long_side, int df, int pad_to,
                     float* out, int* meta, char* err, int errlen) {
  try {
    if (long_side <= 0 || df <= 0 || pad_to <= 0) refuse("bad arguments");
    Decoder d;
    std::vector<uint8_t> file;
    decode(path, false, d, file);
    const int w0 = d.width, h0 = d.height;
    // Same rounding as images.py::_resize_dims
    const double scale = static_cast<double>(long_side) / std::max(w0, h0);
    int nw = static_cast<int>(std::lround(w0 * scale));
    int nh = static_cast<int>(std::lround(h0 * scale));
    nw = std::max(df, (nw / df) * df);
    nh = std::max(df, (nh / df) * df);
    if (nw > pad_to || nh > pad_to) refuse("resized image exceeds pad_to");

    const Component& y = d.comps[0];
    const size_t ys = static_cast<size_t>(y.stride_blocks) * 8;
    std::vector<float> src(static_cast<size_t>(w0) * h0);
    for (int r = 0; r < h0; ++r) {
      const uint8_t* in = y.plane.data() + r * ys;
      float* o = src.data() + static_cast<size_t>(r) * w0;
      for (int x = 0; x < w0; ++x) o[x] = in[x] / 255.0f;
    }
    std::vector<uint8_t>().swap(file);
    std::vector<float> mid(static_cast<size_t>(h0) * nw);
    resample_axis(src.data(), w0, h0, mid.data(), nw, /*horizontal=*/true);
    std::vector<float> dst(static_cast<size_t>(nh) * nw);
    resample_axis(mid.data(), nw, h0, dst.data(), nh, /*horizontal=*/false);

    std::memset(out, 0, sizeof(float) * static_cast<size_t>(pad_to) * pad_to);
    for (int r = 0; r < nh; ++r)
      std::memcpy(out + static_cast<size_t>(r) * pad_to,
                  dst.data() + static_cast<size_t>(r) * nw,
                  sizeof(float) * nw);
    meta[0] = w0;
    meta[1] = h0;
    meta[2] = nw;
    meta[3] = nh;
    return 0;
  } catch (const Refused& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Refused{"out of memory"}, err, errlen);
  }
}

}  // extern "C"
