// Native image staging for the matching/refinement engines: JPEG/PNG decode
// -> grayscale -> Pillow-style triangle-filter resize -> zero-padded f32
// square, in one C call per image (ctypes releases the GIL, so the host
// thread pool decodes truly in parallel — the role of the reference's
// torch DataLoader workers, src/dataset/coarse_matching_dataset.py).
//
// The port's copy of the JAX package's native/imageloader.cpp, with the
// same decode_gray_resize contract (detectorfreesfm_tpu_torch/data/
// images.py::load_gray):
//   * nw, nh = round(dim * long_side / max(w, h)) snapped DOWN to the df
//     grid (min df)
//   * out is (pad_to, pad_to) float32 in [0, 1], image at the top-left
//   * meta out: [w0, h0, nw, nh]
// and two more entry points: image_size (w, h from the header alone) and
// decode_rgb (full-resolution uint8 RGB, for point colours).
//
// Build (data/images.py does this at first use, into build/native/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libimageloader.so imageloader.cpp
//       -ljpeg -lpng

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jmp, 1);
}

bool decode_jpeg(const uint8_t* data, size_t n, std::vector<uint8_t>& gray,
                 int& w, int& h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;  // JFIF: the Y channel directly
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  gray.resize(static_cast<size_t>(w) * h);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = gray.data() + static_cast<size_t>(cinfo.output_scanline) * w;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(const uint8_t* data, size_t n, std::vector<uint8_t>& gray,
                int& w, int& h) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, data, n)) return false;
  // Alpha / 16-bit PNGs: bail to the PIL path. libpng would composite the
  // alpha channel (PIL ignores it) and rescale 16-bit differently -> up to
  // ~0.9 pixel divergence; parity only holds for 8-bit opaque images.
  if (img.format & (PNG_FORMAT_FLAG_ALPHA | PNG_FORMAT_FLAG_LINEAR)) {
    png_image_free(&img);
    return false;
  }
  // Decode RGB and convert with PIL's ITU-R 601 fixed-point luma
  // ((R*19595 + G*38470 + B*7471 + 0x8000) >> 16). libpng's own GRAY
  // format uses BT.709 weights and diverges from the PIL path by >0.1.
  img.format = PNG_FORMAT_RGB;
  w = img.width;
  h = img.height;
  std::vector<uint8_t> rgb(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, rgb.data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  gray.resize(static_cast<size_t>(w) * h);
  for (size_t i = 0; i < gray.size(); ++i) {
    const uint32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    gray[i] = static_cast<uint8_t>(
        (r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
  }
  return true;
}

// Full-resolution RGB, as PIL's convert("RGB"): libjpeg's own YCbCr -> RGB
// (PIL decodes JPEGs the same way), PNG through libpng's simplified API.
// Alpha and 16-bit PNGs are refused, as in decode_png.
bool decode_jpeg_rgb(const uint8_t* data, size_t n, uint8_t* out,
                     size_t cap, int& w, int& h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  if (cinfo.output_components != 3 ||
      static_cast<size_t>(w) * h * 3 > cap) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png_rgb(const uint8_t* data, size_t n, uint8_t* out, size_t cap,
                    int& w, int& h) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, data, n)) return false;
  if (img.format & (PNG_FORMAT_FLAG_ALPHA | PNG_FORMAT_FLAG_LINEAR)) {
    png_image_free(&img);
    return false;
  }
  img.format = PNG_FORMAT_RGB;
  w = img.width;
  h = img.height;
  if (PNG_IMAGE_SIZE(img) > cap ||
      !png_image_finish_read(&img, nullptr, out, 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  return true;
}

bool header_size(const uint8_t* data, size_t n, int& w, int& h) {
  if (data[0] == 0xFF && data[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jmp)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, n);
    jpeg_read_header(&cinfo, TRUE);
    w = cinfo.image_width;
    h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  if (data[0] == 0x89 && data[1] == 'P') {
    png_image img;
    std::memset(&img, 0, sizeof(img));
    img.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&img, data, n)) return false;
    w = img.width;
    h = img.height;
    png_image_free(&img);
    return true;
  }
  return false;
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz <= 8) {
    std::fclose(f);
    return false;
  }
  buf.resize(sz);
  size_t rd = std::fread(buf.data(), 1, sz, f);
  std::fclose(f);
  return rd == static_cast<size_t>(sz);
}

// Pillow-compatible separable triangle (bilinear-with-antialias) resample.
// For each output coordinate: center = (i + 0.5) * scale; taps cover
// [center - support, center + support) with support = filterscale =
// max(1, scale); weights are triangle((s + 0.5 - center) / filterscale),
// normalized.
void resample_axis(const float* src, int sw, int sh, float* dst, int dw,
                   bool horizontal) {
  const int out_n = horizontal ? dw : dw;  // dw = size along resampled axis
  const int src_n = horizontal ? sw : sh;
  const double scale = static_cast<double>(src_n) / out_n;
  const double fscale = std::max(1.0, scale);
  const double support = fscale;
  const int max_taps = static_cast<int>(std::ceil(support)) * 2 + 2;
  std::vector<double> wts(max_taps);
  const int lines = horizontal ? sh : sw;
  for (int o = 0; o < out_n; ++o) {
    const double center = (o + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support));
    int hi = static_cast<int>(std::ceil(center + support));
    lo = std::max(lo, 0);
    hi = std::min(hi, src_n);
    double total = 0.0;
    for (int s = lo; s < hi; ++s) {
      double x = std::abs((s + 0.5 - center) / fscale);
      double wgt = x < 1.0 ? 1.0 - x : 0.0;
      wts[s - lo] = wgt;
      total += wgt;
    }
    if (total <= 0.0) {  // degenerate: nearest
      lo = std::min(std::max(static_cast<int>(center), 0), src_n - 1);
      hi = lo + 1;
      wts[0] = 1.0;
      total = 1.0;
    }
    for (int line = 0; line < lines; ++line) {
      double acc = 0.0;
      if (horizontal) {
        const float* row = src + static_cast<size_t>(line) * sw;
        for (int s = lo; s < hi; ++s) acc += row[s] * wts[s - lo];
        dst[static_cast<size_t>(line) * dw + o] =
            static_cast<float>(acc / total);
      } else {
        for (int s = lo; s < hi; ++s)
          acc += src[static_cast<size_t>(s) * sw + line] * wts[s - lo];
        dst[static_cast<size_t>(o) * sw + line] =
            static_cast<float>(acc / total);
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success; -1 open/read, -2 decode, -3 bad args.
int decode_gray_resize(const char* path, int long_side, int df, int pad_to,
                       float* out, int* meta) {
  if (long_side <= 0 || df <= 0 || pad_to <= 0 || !out || !meta) return -3;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz <= 8) {
    std::fclose(f);
    return -1;
  }
  std::vector<uint8_t> buf(sz);
  size_t rd = std::fread(buf.data(), 1, sz, f);
  std::fclose(f);
  if (rd != static_cast<size_t>(sz)) return -1;

  std::vector<uint8_t> gray;
  int w0 = 0, h0 = 0;
  bool ok = false;
  if (buf[0] == 0xFF && buf[1] == 0xD8) {
    ok = decode_jpeg(buf.data(), buf.size(), gray, w0, h0);
  } else if (buf[0] == 0x89 && buf[1] == 'P') {
    ok = decode_png(buf.data(), buf.size(), gray, w0, h0);
  }
  if (!ok || w0 <= 0 || h0 <= 0) return -2;

  // Same rounding as images.py::_resize_dims
  const double scale = static_cast<double>(long_side) / std::max(w0, h0);
  int nw = static_cast<int>(std::lround(w0 * scale));
  int nh = static_cast<int>(std::lround(h0 * scale));
  nw = std::max(df, (nw / df) * df);
  nh = std::max(df, (nh / df) * df);
  if (nw > pad_to || nh > pad_to) return -3;

  std::vector<float> src(static_cast<size_t>(w0) * h0);
  for (size_t i = 0; i < src.size(); ++i) src[i] = gray[i] / 255.0f;
  // horizontal pass: (h0, w0) -> (h0, nw); vertical: -> (nh, nw)
  std::vector<float> mid(static_cast<size_t>(h0) * nw);
  resample_axis(src.data(), w0, h0, mid.data(), nw, /*horizontal=*/true);
  std::vector<float> dst(static_cast<size_t>(nh) * nw);
  resample_axis(mid.data(), nw, h0, dst.data(), nh, /*horizontal=*/false);

  std::memset(out, 0, sizeof(float) * static_cast<size_t>(pad_to) * pad_to);
  for (int y = 0; y < nh; ++y)
    std::memcpy(out + static_cast<size_t>(y) * pad_to,
                dst.data() + static_cast<size_t>(y) * nw,
                sizeof(float) * nw);
  meta[0] = w0;
  meta[1] = h0;
  meta[2] = nw;
  meta[3] = nh;
  return 0;
}

// (w, h) of a JPEG or PNG from its header. 0 on success; -1 open/read,
// -2 not a JPEG/PNG or a bad header.
int image_size(const char* path, int* wh) {
  std::vector<uint8_t> buf;
  if (!wh || !read_file(path, buf)) return -1;
  int w = 0, h = 0;
  if (!header_size(buf.data(), buf.size(), w, h) || w <= 0 || h <= 0)
    return -2;
  wh[0] = w;
  wh[1] = h;
  return 0;
}

// Full-resolution (h, w, 3) uint8 RGB into out (cap bytes; image_size gives
// w and h). 0 on success; -1 open/read, -2 decode, -3 bad args.
int decode_rgb(const char* path, uint8_t* out, long cap, int* wh) {
  if (!out || !wh || cap <= 0) return -3;
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  int w = 0, h = 0;
  bool ok = false;
  if (buf[0] == 0xFF && buf[1] == 0xD8) {
    ok = decode_jpeg_rgb(buf.data(), buf.size(), out,
                         static_cast<size_t>(cap), w, h);
  } else if (buf[0] == 0x89 && buf[1] == 'P') {
    ok = decode_png_rgb(buf.data(), buf.size(), out,
                        static_cast<size_t>(cap), w, h);
  }
  if (!ok || w <= 0 || h <= 0) return -2;
  wh[0] = w;
  wh[1] = h;
  return 0;
}

}  // extern "C"
