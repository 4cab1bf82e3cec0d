// Native frame loader of stabstitch2_tpu_torch.
//
// The package's own copy of the JAX package's loader, with the same C ABI
// and the same pixels. It provides:
//   - batched JPEG decode (+ optional bilinear resize) on a pthread pool,
//   - a ring-buffer prefetcher that decodes ahead of the consumer so the
//     device never waits on host IO.
//
// Pixel conventions match cv2: BGR channel order, uint8 HWC; the resize is
// half-pixel-convention bilinear (cv2.INTER_LINEAR).
//
// C ABI only, bound with ctypes (data/native.py); built with the host
// compiler on first use (utils/native_build.py).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to BGR uint8. Returns 0 on success.
int decode_jpeg_bgr(const char* path, std::vector<uint8_t>& out, int* w,
                    int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_EXT_BGR;  // cv2-compatible order
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const int stride = *w * 3;
  out.resize(static_cast<size_t>(stride) * *h);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Half-pixel bilinear resize (cv2.INTER_LINEAR semantics), BGR uint8 HWC.
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = p00 + 3;
      const uint8_t* p10 = p00 + static_cast<size_t>(sw) * 3;
      const uint8_t* p11 = p10 + 3;
      uint8_t* d = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                  wy * ((1 - wx) * p10[c] + wx * p11[c]);
        d[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

struct BatchJob {
  const char** paths;
  int n;
  int hi_w, hi_h;    // expected native size (0 = take from first image)
  int lo_w, lo_h;    // 0 = no resized copy
  uint8_t* out_hi;   // [n, hi_h, hi_w, 3] or nullptr
  uint8_t* out_lo;   // [n, lo_h, lo_w, 3] or nullptr
  std::atomic<int> next{0};
  std::atomic<int> errors{0};
};

void batch_worker(BatchJob* job) {
  std::vector<uint8_t> buf;
  for (;;) {
    int i = job->next.fetch_add(1);
    if (i >= job->n) return;
    int w = 0, h = 0;
    if (decode_jpeg_bgr(job->paths[i], buf, &w, &h) != 0 ||
        (job->hi_w && (w != job->hi_w || h != job->hi_h))) {
      job->errors.fetch_add(1);
      continue;
    }
    if (job->out_hi) {
      std::memcpy(job->out_hi + static_cast<size_t>(i) * w * h * 3,
                  buf.data(), static_cast<size_t>(w) * h * 3);
    }
    if (job->out_lo && job->lo_w > 0) {
      resize_bilinear(buf.data(), w, h,
                      job->out_lo + static_cast<size_t>(i) * job->lo_w *
                                        job->lo_h * 3,
                      job->lo_w, job->lo_h);
    }
  }
}

}  // namespace

extern "C" {

// Probe one JPEG's dimensions. Returns 0 on success.
int fl_probe(const char* path, int* w, int* h) {
  std::vector<uint8_t> buf;
  return decode_jpeg_bgr(path, buf, w, h);
}

// Decode n JPEGs (all hi_w x hi_h) into out_hi, and bilinear-resize each to
// lo_w x lo_h into out_lo (either output may be null). Returns the number
// of failed frames.
int fl_decode_batch(const char** paths, int n, int hi_w, int hi_h,
                    uint8_t* out_hi, int lo_w, int lo_h, uint8_t* out_lo,
                    int threads) {
  BatchJob job;
  job.paths = paths;
  job.n = n;
  job.hi_w = hi_w;
  job.hi_h = hi_h;
  job.lo_w = lo_w;
  job.lo_h = lo_h;
  job.out_hi = out_hi;
  job.out_lo = out_lo;
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(batch_worker, &job);
  batch_worker(&job);
  for (auto& t : pool) t.join();
  return job.errors.load();
}

// ---------------------------------------------------------------------------
// Ring-buffer prefetcher: a background thread decodes ahead of the consumer.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int hi_w, hi_h, lo_w, lo_h, ring;
  std::vector<uint8_t> hi_ring, lo_ring;
  std::vector<int> status;        // -1 pending, 0 ok, >0 error
  std::atomic<int> consumed{0};
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::thread worker;
  std::atomic<bool> stop{false};

  size_t hi_frame() const { return static_cast<size_t>(hi_w) * hi_h * 3; }
  size_t lo_frame() const { return static_cast<size_t>(lo_w) * lo_h * 3; }

  void run() {
    std::vector<uint8_t> buf;
    for (int i = 0; i < static_cast<int>(paths.size()) && !stop.load(); ++i) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [&] {
          return stop.load() || i - consumed.load() < ring;
        });
        if (stop.load()) return;
      }
      int w = 0, h = 0;
      int slot = i % ring;
      int err = decode_jpeg_bgr(paths[i].c_str(), buf, &w, &h);
      if (!err && w == hi_w && h == hi_h) {
        std::memcpy(hi_ring.data() + slot * hi_frame(), buf.data(), hi_frame());
        if (lo_w) {
          resize_bilinear(buf.data(), w, h,
                          lo_ring.data() + slot * lo_frame(), lo_w, lo_h);
        }
      } else {
        err = err ? err : 3;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        status[i] = err;
      }
      cv_consume.notify_all();
    }
  }
};

void* fl_prefetch_open(const char** paths, int n, int hi_w, int hi_h,
                       int lo_w, int lo_h, int ring) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->hi_w = hi_w;
  p->hi_h = hi_h;
  p->lo_w = lo_w;
  p->lo_h = lo_h;
  p->ring = ring < 2 ? 2 : ring;
  p->hi_ring.resize(p->hi_frame() * p->ring);
  if (lo_w) p->lo_ring.resize(p->lo_frame() * p->ring);
  p->status.assign(n, -1);
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocking fetch of frame i (must be consumed in order). Returns 0 on ok.
int fl_prefetch_get(void* handle, int i, uint8_t* out_hi, uint8_t* out_lo) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_consume.wait(lk, [&] { return p->status[i] != -1; });
  }
  int err = p->status[i];
  int slot = i % p->ring;
  if (!err) {
    if (out_hi) std::memcpy(out_hi, p->hi_ring.data() + slot * p->hi_frame(),
                            p->hi_frame());
    if (out_lo && p->lo_w)
      std::memcpy(out_lo, p->lo_ring.data() + slot * p->lo_frame(),
                  p->lo_frame());
  }
  p->consumed.store(i + 1);
  p->cv_produce.notify_all();
  return err;
}

void fl_prefetch_close(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_produce.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
