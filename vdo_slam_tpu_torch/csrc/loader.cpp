// Native sequence loader of vdo_slam_tpu_torch: a copy of the JAX package's
// native/loader.cpp with its prefetch race fixed (vdo_seq_get below) and a
// PNG decoder of its own on zlib alone (read_png below), where the original
// links libpng.
//
// The reference's demo driver decodes every frame synchronously on the main
// thread with cv::imread / readOpticalFlow / a per-pixel ifstream mask parse
// (example/vdo_slam.cc:98-141, LoadMask at 253-450).  This library is the
// runtime-side replacement: PNG decode, a fast semantic-mask text parser,
// .flo parsing, and a background prefetch thread that keeps the next
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
// Build: g++ -O3 -shared -fPIC loader.cpp -lz -lpthread

#include <zlib.h>

#include <algorithm>
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

// ---------------------------------------------------------------------------
// PNG on zlib alone.  What it accepts, and what it gives back, is what the
// original's libpng reader gives (png_set_palette_to_rgb,
// png_set_expand_gray_1_2_4_to_8, png_set_swap, then png_read_image):
//   * gray at 1, 2, 4, 8 or 16 bits, gray+alpha, RGB and RGBA at 8 or 16,
//     palette at 1, 2, 4 or 8; interlaced (Adam7) or not;
//   * samples as raw values: 16-bit ones as 0..65535, every other as
//     0..255 (gray below 8 bits scaled up as libpng scales it, palette
//     entries looked up); `bitdepth` stays the file's;
//   * a palette image gives RGB, or RGBA where it has a tRNS chunk; a tRNS
//     chunk of a gray or RGB image is ignored, as libpng ignores it there.
// Refused (read_png returns false), as libpng refuses them: a bad
// signature, a critical chunk that is unknown, out of order or fails its
// CRC, a bad IHDR (size 0 or over 1e6, a depth the colour type does not
// allow, an unknown method), a palette image without PLTE, a row filter
// over 4, a zlib error, and too little image data.  An ancillary chunk that
// fails its CRC is skipped, as libpng skips it.
// ---------------------------------------------------------------------------

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         (uint32_t)p[3];
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(fp);
    return false;
  }
  out->resize((size_t)size);
  const bool ok = std::fread(out->data(), 1, out->size(), fp) == out->size();
  std::fclose(fp);
  return ok;
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo one row's filter in place; `prior` is the row above (unfiltered),
// zeros for the first row of an image or of an Adam7 pass.
bool unfilter(int type, uint8_t* row, const uint8_t* prior, size_t n,
              size_t bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (size_t i = 0; i < n; ++i) row[i] += prior[i];
      return true;
    case 3:
      for (size_t i = 0; i < n; ++i)
        row[i] += (uint8_t)(((i >= bpp ? row[i - bpp] : 0) + prior[i]) >> 1);
      return true;
    case 4:
      for (size_t i = 0; i < n; ++i)
        row[i] += (uint8_t)paeth(i >= bpp ? row[i - bpp] : 0, prior[i],
                                 i >= bpp ? prior[i - bpp] : 0);
      return true;
    default:
      return false;
  }
}

// Inflate `in` into exactly `n` bytes; whatever the stream holds past them
// is read (so its checksum is tested) and dropped.
bool inflate_exact(const std::vector<uint8_t>& in, std::vector<uint8_t>* out,
                   size_t n) {
  out->assign(n, 0);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = (uInt)in.size();
  zs.next_out = out->data();
  zs.avail_out = (uInt)n;
  uint8_t spill[256];
  int rc = Z_OK;
  while (rc == Z_OK) {
    if (zs.avail_out == 0) {  // image complete: drain the rest
      zs.next_out = spill;
      zs.avail_out = sizeof(spill);
    }
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc == Z_BUF_ERROR && zs.avail_in == 0) break;  // input ended
  }
  const size_t got = zs.total_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END && rc != Z_BUF_ERROR) return false;
  return got >= n;
}

bool read_png(const char* path, PngImage* out) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  std::vector<uint8_t> file;
  if (!read_file(path, &file) || file.size() < 8 ||
      std::memcmp(file.data(), kSig, 8) != 0)
    return false;
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  uint8_t pal[256][4];
  std::memset(pal, 0, sizeof(pal));
  for (auto& e : pal) e[3] = 255;
  int n_pal = 0;
  bool have_trns = false, seen_idat = false, seen_end = false;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  bool first = true;
  while (!seen_end) {
    if (pos + 12 > file.size()) return false;
    const uint32_t len = be32(&file[pos]);
    if (len > 0x7fffffffu || pos + 12 + (size_t)len > file.size())
      return false;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = &file[pos + 8];
    const bool crc_ok =
        crc32(crc32(0L, Z_NULL, 0), type, len + 4) == be32(data + len);
    const bool critical = (type[0] & 0x20) == 0;
    if (critical && !crc_ok) return false;
    const std::string t(reinterpret_cast<const char*>(type), 4);
    if (first != (t == "IHDR")) return false;  // IHDR first, once
    first = false;
    if (t == "IHDR") {
      if (len != 13) return false;
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      color = data[9];
      interlace = data[12];
      if (w == 0 || h == 0 || w > 1000000 || h > 1000000) return false;
      if (data[10] != 0 || data[11] != 0 || interlace > 1) return false;
      bool ok;
      switch (color) {
        case 0: ok = depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                     depth == 16; break;
        case 3: ok = depth == 1 || depth == 2 || depth == 4 || depth == 8;
                break;
        case 2: case 4: case 6: ok = depth == 8 || depth == 16; break;
        default: ok = false;
      }
      if (!ok) return false;
    } else if (t == "PLTE") {
      if (seen_idat || len % 3 != 0 || len == 0 || len > 768) return false;
      n_pal = (int)(len / 3);
      for (int i = 0; i < n_pal; ++i)
        for (int c = 0; c < 3; ++c) pal[i][c] = data[3 * i + c];
    } else if (t == "tRNS") {
      if (crc_ok && color == 3 && !seen_idat && len <= 256) {
        for (uint32_t i = 0; i < len; ++i) pal[i][3] = data[i];
        have_trns = len > 0;
      }
    } else if (t == "IDAT") {
      if (color == 3 && n_pal == 0) return false;
      seen_idat = true;
      idat.insert(idat.end(), data, data + len);
    } else if (t == "IEND") {
      seen_end = true;
    } else if (critical) {
      return false;
    }
    pos += 12 + (size_t)len;
  }
  if (!seen_idat) return false;

  const int in_ch = color == 0 ? 1 : color == 2 ? 3 : color == 3 ? 1
                    : color == 4 ? 2 : 4;
  const int bits_pp = in_ch * depth;
  const size_t bpp = (size_t)std::max(1, bits_pp / 8);
  // Adam7 passes (x0, y0, dx, dy); one pass covering all without interlace
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                   {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                   {0, 1, 1, 2}};
  static const int kPlain[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kAdam7 : kPlain;
  const int n_pass = interlace ? 7 : 1;
  size_t raw_size = 0;
  for (int k = 0; k < n_pass; ++k) {
    const size_t pw = w > (uint32_t)passes[k][0]
        ? (w - passes[k][0] + passes[k][2] - 1) / passes[k][2] : 0;
    const size_t ph = h > (uint32_t)passes[k][1]
        ? (h - passes[k][1] + passes[k][3] - 1) / passes[k][3] : 0;
    if (pw && ph) raw_size += ph * (1 + (pw * bits_pp + 7) / 8);
  }
  std::vector<uint8_t> raw;
  if (!inflate_exact(idat, &raw, raw_size)) return false;

  out->w = (int)w;
  out->h = (int)h;
  out->bitdepth = depth;
  out->channels = color == 3 ? (have_trns ? 4 : 3) : in_ch;
  out->data.assign((size_t)w * h * out->channels, 0.0f);
  const int gray_scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4
                         ? 17 : 1;
  size_t off = 0;
  for (int k = 0; k < n_pass; ++k) {
    const int x0 = passes[k][0], y0 = passes[k][1];
    const int dx = passes[k][2], dy = passes[k][3];
    const size_t pw = w > (uint32_t)x0 ? (w - x0 + dx - 1) / dx : 0;
    const size_t ph = h > (uint32_t)y0 ? (h - y0 + dy - 1) / dy : 0;
    if (!pw || !ph) continue;
    const size_t rb = (pw * bits_pp + 7) / 8;
    std::vector<uint8_t> zeros(rb, 0);
    const uint8_t* prior = zeros.data();
    for (size_t y = 0; y < ph; ++y) {
      uint8_t* row = &raw[off + 1];
      if (!unfilter(raw[off], row, prior, rb, bpp)) return false;
      prior = row;
      off += 1 + rb;
      float* dst_row = &out->data[((y0 + y * dy) * w) * out->channels];
      for (size_t i = 0; i < pw; ++i) {
        float* dst = dst_row + (x0 + i * dx) * out->channels;
        if (depth == 16) {
          for (int c = 0; c < in_ch; ++c)
            dst[c] = (float)((row[2 * (i * in_ch + c)] << 8) |
                             row[2 * (i * in_ch + c) + 1]);
          continue;
        }
        if (depth == 8 && color != 3) {
          for (int c = 0; c < in_ch; ++c) dst[c] = (float)row[i * in_ch + c];
          continue;
        }
        // one sample per pixel: gray below 8 bits, or a palette index
        const size_t bit = i * depth;
        const int v = (row[bit >> 3] >> (8 - depth - (int)(bit & 7))) &
                      ((1 << depth) - 1);
        if (color == 3) {
          for (int c = 0; c < out->channels; ++c) dst[c] = (float)pal[v][c];
        } else {
          dst[0] = (float)(v * gray_scale);
        }
      }
    }
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
