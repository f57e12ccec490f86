// Native parallel PNG writer for FID sample dumps.
//
// The reference's task scripts write 10k-50k images per run through
// torchvision's (C++-backed) save_image loop
// (the reference's scripts/sample_diffusion_ddim.py:201-205,
// sample_diffusion_ldm_bedroom.py:133-141).  At production scale the
// Python/PIL encode loop is host-bound and serial; this library encodes and
// writes a whole device batch with a std::thread pool, overlapping PNG
// deflate with the next sampling batch.
//
// C ABI (ctypes-bound from eda_dm_tpu_torch/native/__init__.py):
//   edm_write_png_batch(data, n, h, w, c, paths, n_threads, compress_level)
//     data: n*h*w*c contiguous uint8, RGB/greyscale rows top-down
//     returns 0 on success, else the number of failed images.
//
// Build: g++ -O2 -shared -fPIC imgio.cpp -lpng -lz -o libedmimgio.so
// (eda_dm_tpu_torch/native/__init__.py builds it into _build/).

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

namespace {

bool write_one_png(const uint8_t* img, int h, int w, int c, const char* path,
                   int compress_level) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return false;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    std::fclose(fp);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {  // libpng error unwinds here
    png_destroy_write_struct(&png, &info);
    std::fclose(fp);
    return false;
  }

  png_init_io(png, fp);
  png_set_compression_level(png, compress_level);
  int color_type;
  switch (c) {
    case 1: color_type = PNG_COLOR_TYPE_GRAY; break;
    case 3: color_type = PNG_COLOR_TYPE_RGB; break;
    case 4: color_type = PNG_COLOR_TYPE_RGBA; break;
    default:
      png_destroy_write_struct(&png, &info);
      std::fclose(fp);
      return false;
  }
  png_set_IHDR(png, info, w, h, 8, color_type, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  std::vector<png_bytep> rows(h);
  const size_t stride = static_cast<size_t>(w) * c;
  for (int y = 0; y < h; ++y) {
    rows[y] = const_cast<png_bytep>(img + y * stride);
  }
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  std::fclose(fp);
  return true;
}

}  // namespace

extern "C" {

int edm_write_png_batch(const uint8_t* data, int n, int h, int w, int c,
                        const char** paths, int n_threads,
                        int compress_level) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  const size_t img_bytes = static_cast<size_t>(h) * w * c;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      if (!write_one_png(data + i * img_bytes, h, w, c, paths[i],
                         compress_level)) {
        failures.fetch_add(1);
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

}  // extern "C"
