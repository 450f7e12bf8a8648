// Native sequence loader of vdo_slam_tpu_torch: a copy of the JAX package's
// native/loader.cpp with its prefetch race fixed (vdo_seq_get below).
//
// The reference's demo driver decodes every frame synchronously on the main
// thread with cv::imread / readOpticalFlow / a per-pixel ifstream mask parse
// (example/vdo_slam.cc:98-141, LoadMask at 253-450).  This library is the
// runtime-side replacement: libpng/zlib decode, a fast semantic-mask text
// parser, .flo parsing, and a background prefetch thread that keeps the next
// frame's tensors hot while the accelerator works on the current one.
//
// C ABI only (consumed via ctypes, io/native_loader.py):
//   vdo_png_info / vdo_png_read    — 8/16-bit gray or RGB(A) PNG -> float32
//   vdo_flo_info / vdo_flo_read    — Middlebury .flo -> float32 (H, W, 2)
//   vdo_mask_read                  — whitespace int matrix -> int32 (H, W)
//   vdo_seq_open / vdo_seq_get /
//   vdo_seq_close                  — prefetching sequence reader over the
//                                    reference's on-disk layout
//   vdo_seq_loads                  — frames the reader has decoded so far
//
// Build: g++ -O3 -shared -fPIC loader.cpp -lpng -lz -lpthread

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PngImage {
  int w = 0, h = 0, channels = 0, bitdepth = 0;
  std::vector<float> data;  // h * w * channels, raw sample values
};

bool read_png(const char* path, PngImage* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->bitdepth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (out->bitdepth < 8) png_set_expand_gray_1_2_4_to_8(png);
  // keep 16-bit as big-endian pairs; swap to host order
  if (out->bitdepth == 16) png_set_swap(png);
  png_read_update_info(png, info);
  out->channels = png_get_channels(png, info);

  const int rowbytes = png_get_rowbytes(png, info);
  std::vector<png_byte> raw((size_t)rowbytes * out->h);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) rows[y] = raw.data() + (size_t)y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  out->data.resize((size_t)out->h * out->w * out->channels);
  const size_t n = out->data.size();
  if (out->bitdepth == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(raw.data());
    for (size_t i = 0; i < n; ++i) out->data[i] = (float)p[i];
  } else {
    const uint8_t* p = raw.data();
    for (size_t i = 0; i < n; ++i) out->data[i] = (float)p[i];
  }
  return true;
}

bool read_flo(const char* path, std::vector<float>* out, int* w, int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  float magic = 0;
  if (std::fread(&magic, 4, 1, fp) != 1 || magic < 202021.0f ||
      magic > 202022.0f) {
    std::fclose(fp);
    return false;
  }
  int32_t ww = 0, hh = 0;
  if (std::fread(&ww, 4, 1, fp) != 1 || std::fread(&hh, 4, 1, fp) != 1) {
    std::fclose(fp);
    return false;
  }
  // reject corrupt headers before sizing the allocation off them
  if (ww <= 0 || hh <= 0 || ww > 65536 || hh > 65536) {
    std::fclose(fp);
    return false;
  }
  out->resize((size_t)ww * hh * 2);
  size_t got = std::fread(out->data(), 4, out->size(), fp);
  std::fclose(fp);
  *w = ww;
  *h = hh;
  return got == out->size();
}

// fast whitespace-separated integer matrix parse (semantic/%06d.txt)
bool read_mask_txt(const char* path, int32_t* out, size_t n) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (std::fread(buf.data(), 1, size, fp) != (size_t)size) {
    std::fclose(fp);
    return false;
  }
  std::fclose(fp);
  buf[size] = 0;
  const char* p = buf.data();
  const char* end = p + size;
  size_t k = 0;
  while (p < end && k < n) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
      ++p;
    if (p >= end) break;
    bool neg = (*p == '-');
    if (neg) ++p;
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    out[k++] = (int32_t)(neg ? -v : v);
  }
  return k == n;
}

struct Frame {
  std::vector<float> rgb;    // H*W (grayscale, [0,1])
  std::vector<float> depth;  // H*W raw sample values
  std::vector<float> flow;   // H*W*2
  std::vector<int32_t> mask; // H*W
  int idx = -1;
  bool ok = false;
};

struct SeqHandle {
  std::string dir;
  int n_frames = 0, H = 0, W = 0;
  Frame buf[2];  // frame i is produced into buf[i & 1]
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  // Both under mu.  A frame is pending from the moment it is requested
  // until the worker has published it into its buffer; the consumer never
  // requests a pending frame again (the original re-requested a frame in
  // flight, so the worker loaded it twice and the consumer could read the
  // buffer while it was being refilled).
  int request = -1;   // frame the worker should produce next, -1: none
  int inflight = -1;  // frame the worker is producing now, -1: none
  long loads = 0;     // frames the worker has taken up, under mu

  bool pending(int idx) const { return request == idx || inflight == idx; }

  bool load(int idx, Frame* f) {
    char name[64];
    std::snprintf(name, sizeof(name), "%06d", idx);
    PngImage img, dep;
    std::string p_rgb = dir + "/image_0/" + name + ".png";
    std::string p_dep = dir + "/depth/" + name + ".png";
    std::string p_flo = dir + "/flow/" + name + ".flo";
    std::string p_sem = dir + "/semantic/" + name + ".txt";
    if (!read_png(p_rgb.c_str(), &img)) return false;
    if (!read_png(p_dep.c_str(), &dep)) return false;
    // a smaller-than-configured image would send the copy loops below past
    // the decoded buffers; require exact dimensions like the .flo path does
    if (img.w != W || img.h != H || dep.w != W || dep.h != H) return false;
    const int n = H * W;
    f->rgb.resize(n);
    const float s = img.bitdepth == 16 ? 1.0f / 65535.0f : 1.0f / 255.0f;
    if (img.channels == 1) {
      for (int i = 0; i < n; ++i) f->rgb[i] = img.data[i] * s;
    } else {
      for (int i = 0; i < n; ++i) {
        const float* px = &img.data[(size_t)i * img.channels];
        f->rgb[i] = (0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2]) * s;
      }
    }
    f->depth.assign(dep.data.begin(), dep.data.begin() + n);
    int fw = 0, fh = 0;
    if (!read_flo(p_flo.c_str(), &f->flow, &fw, &fh) || fw != W || fh != H)
      return false;
    f->mask.resize(n);
    if (!read_mask_txt(p_sem.c_str(), f->mask.data(), n)) return false;
    return true;
  }

  void run() {
    while (true) {
      int idx;
      Frame* f;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || request >= 0; });
        if (stop.load()) return;
        idx = request;
        request = -1;
        inflight = idx;
        ++loads;
        // mark the buffer in flight under the lock: the consumer's fast
        // path never matches idx/ok against a buffer being filled
        f = &buf[idx & 1];
        f->idx = -1;
        f->ok = false;
      }
      const bool loaded = load(idx, f);
      {
        std::lock_guard<std::mutex> lk(mu);
        f->idx = idx;
        f->ok = loaded;
        inflight = -1;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int vdo_png_info(const char* path, int* w, int* h, int* channels,
                 int* bitdepth) {
  PngImage img;
  if (!read_png(path, &img)) return -1;
  *w = img.w;
  *h = img.h;
  *channels = img.channels;
  *bitdepth = img.bitdepth;
  return 0;
}

int vdo_png_read(const char* path, float* out, long capacity) {
  PngImage img;
  if (!read_png(path, &img)) return -1;
  if ((long)img.data.size() > capacity) return -2;
  std::memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  return (int)img.channels;
}

int vdo_flo_info(const char* path, int* w, int* h) {
  std::vector<float> tmp;
  return read_flo(path, &tmp, w, h) ? 0 : -1;
}

int vdo_flo_read(const char* path, float* out, long capacity) {
  std::vector<float> tmp;
  int w = 0, h = 0;
  if (!read_flo(path, &tmp, &w, &h)) return -1;
  if ((long)tmp.size() > capacity) return -2;
  std::memcpy(out, tmp.data(), tmp.size() * sizeof(float));
  return 0;
}

int vdo_mask_read(const char* path, int32_t* out, long n) {
  return read_mask_txt(path, out, (size_t)n) ? 0 : -1;
}

void* vdo_seq_open(const char* dir, int n_frames, int height, int width) {
  auto* h = new SeqHandle;
  h->dir = dir;
  h->n_frames = n_frames;
  h->H = height;
  h->W = width;
  // frame 0 is pending before the worker starts
  h->request = 0;
  h->worker = std::thread([h] { h->run(); });
  return h;
}

// Blocks until frame idx is decoded, copies it out, then prefetches idx+1.
// One consumer thread per handle.
int vdo_seq_get(void* handle, int idx, float* rgb, float* depth, float* flow,
                int32_t* mask) {
  auto* h = static_cast<SeqHandle*>(handle);
  if (idx < 0 || idx >= h->n_frames) return -1;
  Frame* f = &h->buf[idx & 1];
  bool have = false;
  {
    std::unique_lock<std::mutex> lk(h->mu);
    // a queued request for another frame of this buffer would refill it
    // under the copies below: drop it (it was only a prefetch)
    if (h->request >= 0 && h->request != idx && (h->request & 1) == (idx & 1))
      h->request = -1;
    if (!(f->idx == idx && f->ok) && !h->pending(idx)) {
      h->request = idx;
      h->cv.notify_all();
    }
    // wait for idx itself: no longer pending and published into its buffer
    h->cv.wait(lk, [&] {
      return h->stop.load() || (!h->pending(idx) && f->idx == idx);
    });
    have = f->ok && f->idx == idx;
  }
  if (!have) return -2;
  const size_t n = (size_t)h->H * h->W;
  std::memcpy(rgb, f->rgb.data(), n * sizeof(float));
  std::memcpy(depth, f->depth.data(), n * sizeof(float));
  std::memcpy(flow, f->flow.data(), n * 2 * sizeof(float));
  std::memcpy(mask, f->mask.data(), n * sizeof(int32_t));
  if (idx + 1 < h->n_frames) {
    std::lock_guard<std::mutex> lk(h->mu);
    const Frame* next = &h->buf[(idx + 1) & 1];
    if (!h->pending(idx + 1) && !(next->idx == idx + 1 && next->ok)) {
      h->request = idx + 1;
      h->cv.notify_all();
    }
  }
  return 0;
}

long vdo_seq_loads(void* handle) {
  auto* h = static_cast<SeqHandle*>(handle);
  std::lock_guard<std::mutex> lk(h->mu);
  return h->loads;
}

void vdo_seq_close(void* handle) {
  auto* h = static_cast<SeqHandle*>(handle);
  h->stop.store(true);
  h->cv.notify_all();
  if (h->worker.joinable()) h->worker.join();
  delete h;
}

}  // extern "C"
