// Native data loader: threaded PNG decode + resize + normalize.
//
// The port's copy of cistar_tpu/native/dataloader.cpp, the same code: the
// port builds and loads its own (data/native_loader.py) and imports nothing
// of the JAX package. The reference feeds its GANs with torch DataLoader
// worker processes doing PIL decode (CycleGAN/train.py:160-161, p2pHD
// custom_dataset_data_loader). This is the native equivalent: a C++ thread
// pool that decodes PNGs with libpng, converts to grayscale/RGB, bilinearly
// resizes, and writes normalized float32 NHWC directly into a
// caller-provided buffer (zero Python-side per-pixel work). Exposed via a
// plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC dataloader.cpp -lpng -lpthread \
//            -o libcistar_loader.so

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct DecodedImage {
  std::vector<uint8_t> data;  // HWC, 8-bit
  int h = 0, w = 0, c = 0;
  bool ok = false;
};

DecodedImage decode_png(const char* path) {
  DecodedImage img;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return img;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return img;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return img;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize to 8-bit RGB or gray
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  img.h = static_cast<int>(h);
  img.w = static_cast<int>(w);
  img.c = channels;
  img.data.resize(static_cast<size_t>(h) * w * channels);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = img.data.data() + static_cast<size_t>(y) * w * channels;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  img.ok = true;
  return img;
}

// bilinear resize + channel conversion + normalize to float32
void process_into(const DecodedImage& src, int oh, int ow, int oc,
                  float mean, float stdev, float* out) {
  const float sy = static_cast<float>(src.h) / oh;
  const float sx = static_cast<float>(src.w) / ow;
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < oh; ++y) {
    // half-pixel-centered sampling (PIL/torch convention)
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > src.h - 1) y0 = src.h - 1;
    int y1 = y0 + 1 > src.h - 1 ? src.h - 1 : y0 + 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > src.w - 1) x0 = src.w - 1;
      int x1 = x0 + 1 > src.w - 1 ? src.w - 1 : x0 + 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      float* dst = out + (static_cast<size_t>(y) * ow + x) * oc;
      for (int k = 0; k < oc; ++k) {
        auto sample = [&](int yy, int xx) -> float {
          const uint8_t* p =
              src.data.data() + (static_cast<size_t>(yy) * src.w + xx) * src.c;
          if (oc == 1 && src.c >= 3) {
            // ITU-R 601 luma, matching PIL convert("L")
            return 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
          }
          int kk = k < src.c ? k : src.c - 1;  // gray -> broadcast
          return static_cast<float>(p[kk]);
        };
        float v00 = sample(y0, x0), v01 = sample(y0, x1);
        float v10 = sample(y1, x0), v11 = sample(y1, x1);
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[k] = (v * inv255 - mean) / stdev;
      }
    }
  }
}

struct Loader {
  std::vector<std::string> paths;
  int oh, ow, oc;
  int n_threads;
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n, int out_h, int out_w,
                    int channels, int n_threads) {
  auto* l = new Loader();
  l->paths.reserve(n);
  for (int i = 0; i < n; ++i) l->paths.emplace_back(paths[i]);
  l->oh = out_h;
  l->ow = out_w;
  l->oc = channels;
  l->n_threads = n_threads > 0 ? n_threads : 4;
  return l;
}

// Fill out[bs, oh, ow, oc] with normalized images for the given indices.
// Returns number of successfully decoded images.
int loader_get_batch(void* handle, const int* indices, int bs, float* out,
                     float mean, float stdev) {
  auto* l = static_cast<Loader*>(handle);
  std::atomic<int> next(0), ok_count(0);
  const size_t stride = static_cast<size_t>(l->oh) * l->ow * l->oc;
  auto work = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= bs) break;
      int idx = indices[i];
      if (idx < 0 || idx >= static_cast<int>(l->paths.size())) continue;
      DecodedImage img = decode_png(l->paths[idx].c_str());
      if (!img.ok) continue;
      process_into(img, l->oh, l->ow, l->oc, mean, stdev, out + stride * i);
      ok_count.fetch_add(1);
    }
  };
  int nt = l->n_threads < bs ? l->n_threads : bs;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return ok_count.load();
}

int loader_size(void* handle) {
  return static_cast<int>(static_cast<Loader*>(handle)->paths.size());
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
