// Frame prep in one pass: each image of a batch is resampled with banded
// bilinear taps straight into its slot of the served (B, S, S, 3) float32
// array, with the serving epilogue fused into the store.
//
// Two entry points share one per-row core:
//   fastprep_square     every image fills its (S, S) slot; each value is
//                       stored as (v - mean[c]) / std[c] (an f32 subtract,
//                       then an IEEE divide), the torchvision normalisation;
//   fastprep_letterbox  every image fills an (nh, nw) window of its slot at
//                       (dh, dw); the rows and columns around it are the
//                       gray pad value.
// An image whose resampled size equals its own ((nh, nw) == (h, w)) is
// copied: scale-1 taps are the identity.
//
// The arithmetic is that of native/resize.cpp row_pass / col_pass, element
// for element: the row taps of an output row are evaluated into a one-line
// scratch (first tap assigned, zero-weight taps after it skipped), then the
// column taps are summed in tap order into three RGB accumulators. So the
// result is bit-equal to resize_bilinear_f32 followed by the NumPy epilogue,
// without its (oh, w, c) scratch plane, its second pass and the epilogue's
// own passes over the batch.
//
// Output rows of all images of a call are handed out in small blocks to
// the hardware's threads (at most 8, one under 64 rows: the rule of
// resize.cpp), in one parallel region: the calling thread and helper
// threads that the library starts once and keeps. Images are HWC float32,
// 3 channels, contiguous; taps are the (n, span) index and weight tables
// of edgeml_tpu_torch/data/loader.py _linear_taps.

#include <pthread.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <system_error>
#include <thread>
#include <vector>

extern "C" {

// One image and where it goes in its slot. Taps may be null for a copy.
struct PrepImage {
  const float* img;  // (h, w, 3)
  int64_t h, w;
  int64_t nh, nw;  // resampled size
  int64_t dh, dw;  // top-left corner of the window in the slot
  const int32_t* jh;  // row taps (nh, span_h)
  const float* wh;
  int64_t span_h;
  const int32_t* jw;  // column taps (nw, span_w)
  const float* ww;
  int64_t span_w;
};

}  // extern "C"

namespace {

constexpr int64_t kBlock = 16;  // output rows a thread takes at a time

bool copies(const PrepImage& im) { return im.nh == im.h && im.nw == im.w; }

// Output row o of an image's window into dst (nw * 3 floats): the row taps
// into line (w * 3 floats), then the column taps.
void resample_row(const PrepImage& im, int64_t o, float* line, float* dst) {
  const int64_t len = im.w * 3;
  const int64_t sh = im.span_h, sw = im.span_w;
  const float w0 = im.wh[o * sh];
  const float* src0 = im.img + (int64_t)im.jh[o * sh] * len;
  for (int64_t i = 0; i < len; ++i) line[i] = w0 * src0[i];
  for (int64_t t = 1; t < sh; ++t) {
    const float wt = im.wh[o * sh + t];
    if (wt == 0.0f) continue;
    const float* src = im.img + (int64_t)im.jh[o * sh + t] * len;
    for (int64_t i = 0; i < len; ++i) line[i] += wt * src[i];
  }
  for (int64_t x = 0; x < im.nw; ++x) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int64_t t = 0; t < sw; ++t) {
      const float wt = im.ww[x * sw + t];
      const float* s = line + (int64_t)im.jw[x * sw + t] * 3;
      a0 += wt * s[0];
      a1 += wt * s[1];
      a2 += wt * s[2];
    }
    dst[x * 3] = a0;
    dst[x * 3 + 1] = a1;
    dst[x * 3 + 2] = a2;
  }
}

// The epilogue of a normalised row: mean and std repeated along the row, so
// the loop is one subtract and one divide per element and vectorises.
void normalise(const float* src, float* dst, int64_t n, const float* mean,
               const float* stdv) {
  for (int64_t i = 0; i < n; ++i) dst[i] = (src[i] - mean[i]) / stdv[i];
}

struct Batch {
  const PrepImage* ims;
  int64_t size;
  float* out;
  const float* mean;  // (size * 3) repeated per pixel, or null: letterbox
  const float* stdv;
  float pad;
};

void prep_row(const Batch& b, int64_t r, float* line) {
  const int64_t row_len = b.size * 3;
  const PrepImage& im = b.ims[r / b.size];
  const int64_t o = r % b.size - im.dh;
  float* row = b.out + r * row_len;
  if (o < 0 || o >= im.nh) {
    std::fill(row, row + row_len, b.pad);
    return;
  }
  std::fill(row, row + im.dw * 3, b.pad);
  std::fill(row + (im.dw + im.nw) * 3, row + row_len, b.pad);
  float* dst = row + im.dw * 3;
  const int64_t n = im.nw * 3;
  if (copies(im)) {
    const float* src = im.img + o * n;
    if (b.mean)
      normalise(src, dst, n, b.mean, b.stdv);
    else
      std::memcpy(dst, src, n * sizeof(float));
    return;
  }
  resample_row(im, o, line, dst);
  if (b.mean) normalise(dst, dst, n, b.mean, b.stdv);
}

int check(const PrepImage* ims, int64_t n, int64_t size) {
  if (n < 0 || size <= 0) return 1;
  for (int64_t i = 0; i < n; ++i) {
    const PrepImage& im = ims[i];
    if (!im.img || im.h <= 0 || im.w <= 0 || im.nh <= 0 || im.nw <= 0 ||
        im.dh < 0 || im.dw < 0 || im.dh + im.nh > size ||
        im.dw + im.nw > size)
      return 2;
    if (!copies(im) && (!im.jh || !im.wh || !im.jw || !im.ww ||
                        im.span_h <= 0 || im.span_w <= 0))
      return 3;
  }
  return 0;
}

// Helper threads kept for the life of the process: starting a thread costs
// ~0.2 ms on some hosts, several times the work of a frame's row block. The
// first call that wants helpers starts them. One call at a time uses them;
// a call that finds them busy (another loader thread's) runs on its own
// thread alone.
class Pool {
 public:
  // fn() on the calling thread and on up to `helpers` pool threads; returns
  // when every copy has returned.
  void run(int helpers, const std::function<void()>& fn) {
    std::unique_lock<std::mutex> own(busy_, std::try_to_lock);
    if (!own.owns_lock() || helpers <= 0) {
      fn();
      return;
    }
    {
      std::lock_guard<std::mutex> lk(m_);
      for (; started_ < helpers; ++started_) {
        try {
          std::thread(&Pool::loop, this).detach();
        } catch (const std::system_error&) {  // out of threads: fewer help
          break;
        }
      }
      job_ = &fn;
      ++generation_;
      wanted_ = std::min(helpers, started_);
    }
    wake_.notify_all();
    fn();
    std::unique_lock<std::mutex> lk(m_);
    wanted_ = 0;  // the rows are gone: a helper not yet awake stays asleep
    done_.wait(lk, [&] { return running_ == 0; });
    job_ = nullptr;
  }

 private:
  void loop() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m_);
    for (;;) {
      wake_.wait(lk, [&] { return wanted_ > 0 && generation_ != seen; });
      seen = generation_;
      --wanted_;
      ++running_;
      const std::function<void()>* fn = job_;
      lk.unlock();
      (*fn)();
      lk.lock();
      if (--running_ == 0) done_.notify_all();
    }
  }

  std::mutex busy_, m_;
  std::condition_variable wake_, done_;
  const std::function<void()>* job_ = nullptr;
  uint64_t generation_ = 0;
  int wanted_ = 0, running_ = 0, started_ = 0;
};

// Never destroyed (its threads are detached and outlive any destructor); a
// forked child, which has none of the threads, starts a pool of its own.
Pool* pool = new Pool;
const int forked_child_gets_a_new_pool =
    pthread_atfork(nullptr, nullptr, [] { pool = new Pool; });

int run(const Batch& b, int64_t n) {
  int64_t widest = 1;
  for (int64_t i = 0; i < n; ++i) widest = std::max(widest, b.ims[i].w);
  const int64_t rows = n * b.size;
  std::atomic<int64_t> next{0};
  const std::function<void()> work = [&]() {
    std::vector<float> line(widest * 3);
    for (;;) {
      const int64_t r0 = next.fetch_add(kBlock);
      if (r0 >= rows) return;
      const int64_t r1 = std::min(rows, r0 + kBlock);
      for (int64_t r = r0; r < r1; ++r) prep_row(b, r, line.data());
    }
  };
  unsigned hc = std::thread::hardware_concurrency();
  const int nthreads = hc ? (int)std::min(hc, 8u) : 1;
  pool->run(rows < 64 ? 0 : nthreads - 1, work);
  return 0;
}

}  // namespace

extern "C" {

// ims[n] -> out (n, size, size, 3): each image resampled to (size, size)
// and normalised per channel. Returns 0 on success.
int fastprep_square(const PrepImage* ims, int64_t n, float* out,
                    int64_t size, const float* mean, const float* stdv) {
  if (int rc = check(ims, n, size)) return rc;
  for (int64_t i = 0; i < n; ++i)
    if (ims[i].nh != size || ims[i].nw != size || ims[i].dh || ims[i].dw)
      return 4;
  std::vector<float> m(size * 3), s(size * 3);
  for (int64_t i = 0; i < size * 3; ++i) {
    m[i] = mean[i % 3];
    s[i] = stdv[i % 3];
  }
  return run(Batch{ims, size, out, m.data(), s.data(), 0.0f}, n);
}

// ims[n] -> out (n, size, size, 3): each image resampled into its window,
// the rest of its slot filled with pad. Returns 0 on success.
int fastprep_letterbox(const PrepImage* ims, int64_t n, float* out,
                       int64_t size, float pad) {
  if (int rc = check(ims, n, size)) return rc;
  return run(Batch{ims, size, out, nullptr, nullptr, pad}, n);
}
}
