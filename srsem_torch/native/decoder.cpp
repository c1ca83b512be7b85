// srsem native data loader: threaded JPEG/PNG decode + PIL-convention
// bicubic resize + center crop, exposed as a C ABI for ctypes.
//
// Why native: the 20k-pairs/min serving target needs ~666 decoded images/s
// (SURVEY.md §7 hard part #3). Python-side PIL decode holds large buffers
// and burns interpreter time per image; this library decodes, resizes and
// crops entirely in C++ worker threads and hands back exactly the
// (size, size, 3) uint8 the device pipeline uploads. The reference has no
// native code at all (SURVEY.md §2.9) — its equivalent is 8 DataLoader
// worker processes doing PIL decode.
//
// Resampling matches PIL's convention: separable Catmull-Rom-style bicubic
// (a = -0.5) with kernel support scaled by the downscale factor
// (antialiasing), shortest edge scaled to round(size / crop_pct), then a
// center crop of size x size.
//
// Build: see srsem/native/__init__.py (g++ -O3 -shared -fPIC ... -ljpeg -lpng).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h * w * 3
};

// ---------------- JPEG ---------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// fast_min_edge > 0 enables DCT-scaled decode (PIL Image.draft semantics):
// libjpeg decodes at the largest M/8 downscale whose output shortest edge
// still covers fast_min_edge, so the subsequent bicubic only ever
// downsamples. Skips most of the IDCT + color conversion on large inputs.
bool decode_jpeg(const uint8_t* data, size_t len, Image* out,
                 int fast_min_edge) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  if (fast_min_edge > 0) {
    const long edge = std::min(cinfo.image_width, cinfo.image_height);
    int num = 8;
    for (int n = 1; n < 8; ++n) {
      // libjpeg output dim at scale n/8 is ceil(dim * n / 8).
      if ((edge * n + 7) / 8 >= long(fast_min_edge)) {
        num = n;
        break;
      }
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------- PNG ----------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t len, pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "eof");
  }
  memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

bool decode_png(const uint8_t* data, size_t len, Image* out) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  // Constructed BEFORE setjmp: a png_error longjmp must not jump over a
  // non-trivial local's initialization (UB + leaks its heap block on
  // every corrupt PNG in a long-lived serve process).  Declared here, its
  // destructor runs on the normal return after the setjmp error branch.
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_set_expand(png);           // palette/gray/low-bit → 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  if (png_get_rowbytes(png, info) != size_t(out->w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  out->rgb.resize(size_t(out->w) * out->h * 3);
  rows.resize(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------- Resample (PIL-style bicubic, antialiased) --------------

double cubic_kernel(double x) {
  // PIL's bicubic: a = -0.5
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct AxisWeights {
  int bound_count;              // taps per output pixel
  std::vector<int> start;       // first source index per output pixel
  std::vector<double> weights;  // bound_count per output pixel
};

AxisWeights build_weights(int in_size, int out_size) {
  AxisWeights aw;
  const double scale = double(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2
  aw.bound_count = int(std::ceil(support)) * 2 + 1;
  aw.start.resize(out_size);
  aw.weights.assign(size_t(out_size) * aw.bound_count, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5));
    aw.start[xx] = xmin;
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double w = cubic_kernel((x - center + 0.5) / filterscale);
      aw.weights[size_t(xx) * aw.bound_count + (x - xmin)] = w;
      total += w;
    }
    if (total != 0.0) {
      for (int k = 0; k < xmax - xmin; ++k)
        aw.weights[size_t(xx) * aw.bound_count + k] /= total;
    }
  }
  return aw;
}

// Horizontal then vertical separable resample, float accumulation.
void resize_bicubic(const Image& in, int out_w, int out_h,
                    std::vector<float>* tmp, std::vector<uint8_t>* out) {
  AxisWeights wx = build_weights(in.w, out_w);
  AxisWeights wy = build_weights(in.h, out_h);
  tmp->assign(size_t(in.h) * out_w * 3, 0.f);
  for (int y = 0; y < in.h; ++y) {
    const uint8_t* src = in.rgb.data() + size_t(y) * in.w * 3;
    float* dst = tmp->data() + size_t(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const double* w = &wx.weights[size_t(xx) * wx.bound_count];
      int x0 = wx.start[xx];
      int taps = std::min(wx.bound_count, in.w - x0);
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < taps; ++k) {
        const uint8_t* p = src + size_t(x0 + k) * 3;
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      dst[xx * 3 + 0] = float(acc[0]);
      dst[xx * 3 + 1] = float(acc[1]);
      dst[xx * 3 + 2] = float(acc[2]);
    }
  }
  out->resize(size_t(out_h) * out_w * 3);
  for (int yy = 0; yy < out_h; ++yy) {
    const double* w = &wy.weights[size_t(yy) * wy.bound_count];
    int y0 = wy.start[yy];
    int taps = std::min(wy.bound_count, in.h - y0);
    uint8_t* dst = out->data() + size_t(yy) * out_w * 3;
    for (int xx = 0; xx < out_w * 3; ++xx) {
      double acc = 0;
      for (int k = 0; k < taps; ++k)
        acc += w[k] * (*tmp)[size_t(y0 + k) * out_w * 3 + xx];
      dst[xx] = uint8_t(std::clamp(int(std::lround(acc)), 0, 255));
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    fclose(f);
    return false;
  }
  buf->resize(size_t(n));
  size_t got = fread(buf->data(), 1, size_t(n), f);
  fclose(f);
  return got == size_t(n);
}

// Decode path → shortest-edge resize to round(size/crop_pct) → center crop
// size x size. Returns 0 on success. fast_jpeg != 0 enables DCT-scaled
// JPEG decode (see decode_jpeg); PNG always decodes at full resolution.
int decode_one(const char* path, int size, double crop_pct, int fast_jpeg,
               uint8_t* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf) || buf.size() < 8) return 1;
  Image img;
  bool ok = false;
  const int min_edge = fast_jpeg ? int(std::llrint(size / crop_pct)) : 0;
  if (buf[0] == 0xFF && buf[1] == 0xD8) {
    ok = decode_jpeg(buf.data(), buf.size(), &img, min_edge);
  } else if (buf[0] == 0x89 && buf[1] == 'P') {
    ok = decode_png(buf.data(), buf.size(), &img);
  } else {
    ok = decode_jpeg(buf.data(), buf.size(), &img, min_edge) ||
         decode_png(buf.data(), buf.size(), &img);
  }
  if (!ok || img.w <= 0 || img.h <= 0) return 2;

  // Python round() is round-half-to-EVEN; std::lround is half-away-from
  // -zero — they disagree on exact .5 (e.g. 224.5), which would shift the
  // intermediate size and the center crop by a pixel vs the PIL path
  // (srsem/data/preprocess.py:92-95).  std::llrint under the default
  // FE_TONEAREST mode rounds half-to-even, matching Python.
  const int scale_size = int(std::llrint(size / crop_pct));
  int new_w, new_h;
  if (img.w <= img.h) {
    new_w = scale_size;
    new_h = std::max(1, int(std::llrint(double(img.h) * scale_size / img.w)));
  } else {
    new_h = scale_size;
    new_w = std::max(1, int(std::llrint(double(img.w) * scale_size / img.h)));
  }
  std::vector<float> tmp;
  std::vector<uint8_t> resized;
  resize_bicubic(img, new_w, new_h, &tmp, &resized);

  const int left = (new_w - size) / 2;
  const int top = (new_h - size) / 2;
  if (left < 0 || top < 0) return 3;
  for (int y = 0; y < size; ++y) {
    memcpy(out + size_t(y) * size * 3,
           resized.data() + (size_t(top + y) * new_w + left) * 3,
           size_t(size) * 3);
  }
  return 0;
}

}  // namespace

extern "C" {

// Single image. Returns 0 on success. fast_jpeg != 0 enables DCT-scaled
// JPEG decode (PIL draft semantics — decoded image stays >= the resize
// target, bicubic still downsamples).
int srsem_decode(const char* path, int size, double crop_pct, int fast_jpeg,
                 uint8_t* out) {
  return decode_one(path, size, crop_pct, fast_jpeg, out);
}

// Batch: paths[n] → out[n * size*size*3]; status[n] receives per-image
// return codes (0 = ok). Worker threads split the range. Returns the number
// of failures.
int srsem_decode_batch(const char** paths, int n, int size, double crop_pct,
                       int fast_jpeg, uint8_t* out, int* status,
                       int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_one(paths[i], size, crop_pct, fast_jpeg,
                          out + size_t(i) * size * size * 3);
      status[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  int spawn = std::min(n_threads, n);
  threads.reserve(spawn);
  for (int t = 0; t < spawn; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
