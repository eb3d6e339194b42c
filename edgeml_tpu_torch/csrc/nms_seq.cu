// Sequential greedy NMS for Hopper (sm_90a): the literal select-max /
// suppress loop over UNSORTED candidates, one segment (an image's level of
// RPN proposals, or one image) per block.
//
// Replaces: edgeml_tpu/ops/nms_pallas.py _nms_kernel (the Pallas TPU kernel
// that keeps the score row, the four box planes and the alive mask in VMEM
// and runs max_det steps of argmax + IoU suppression on the VPU). Plain
// PyTorch version: edgeml_tpu_torch/ops/nms_seq.py suppress_mask_seq_plain;
// the two are bit-identical.
//
// Each step picks the live candidate of largest score (the LOWEST index among
// equal maxima, as jnp.argmax does: RPN scores are sigmoids and many saturate
// to exactly 1.0), stops if that score is not > 0, records the pick, and
// kills every live candidate whose IoU with the pick is > thr (the pick
// itself included, since its IoU with itself is 1). At most max_keep steps
// run; the loop also ends as soon as nothing is alive, which gives the same
// result as running on.
//
// What bounds it on this card: the serial chain of steps. The work is ~15
// f32 operations per live candidate per step plus an argmax over K, tiny
// against the card's rates; each step's pick depends on the previous step's
// suppression, so the time is (steps) x (one block-wide argmax and two
// barriers). The bound reported by chip_smoke.py counts the operations of
// the steps this data needs.
//
// Design: one block of 1024 threads per segment. Thread t holds candidate t
// (box, area, score, alive) in registers, and the boxes and areas are also
// in shared memory (20 KB) so that every thread can read the pick's box
// after the argmax. Each step: a warp argmax on the key (score descending,
// index ascending) with shuffles, the 32 warp winners through shared memory
// to warp 0, a barrier, then each thread updates its own alive flag. All
// segments of a batch run in one launch (RPN: images x 5 levels).
//
// Exact arithmetic: IoU op for op as in the TPU kernel (max/min, subtract,
// clamp, multiply; area_pick + area - inter, clamp at 1e-12, IEEE divide,
// `iou <= thr` with the f32-rounded threshold), with explicitly rounded
// intrinsics, and the library is built with -fmad=false and without
// --use_fast_math. area = (x2 - x1) * (y2 - y1), unclamped, as the TPU
// kernel's caller builds it. Inputs are assumed finite.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// (v, j) beats (w, i) when v > w, or v == w and j < i.
__device__ __forceinline__ void take_better(float& v, int& j, float ov,
                                            int oj) {
  if (ov > v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& j) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oj = __shfl_down_sync(kFull, j, off);
    take_better(v, j, ov, oj);
  }
}

__global__ void __launch_bounds__(kThreads)
seq_nms_kernel(const float* __restrict__ boxes,
               const float* __restrict__ scores, uint8_t* __restrict__ kept,
               int32_t* __restrict__ picks, int k, int max_keep, float thr) {
  __shared__ float sx1[kMaxK], sy1[kMaxK], sx2[kMaxK], sy2[kMaxK];
  __shared__ float sarea[kMaxK];
  __shared__ float wval[32];
  __shared__ int widx[32];
  __shared__ float pick_val;
  __shared__ int pick_idx;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t seg = blockIdx.x;
  const bool own = t < k;

  float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, area = 0.f;
  float score = -CUDART_INF_F;
  bool alive = false;
  if (own) {
    const float* bx = boxes + (seg * k + t) * 4;
    x1 = bx[0];
    y1 = bx[1];
    x2 = bx[2];
    y2 = bx[3];
    area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    score = scores[seg * k + t];
    alive = score > 0.f;
    sx1[t] = x1;
    sy1[t] = y1;
    sx2[t] = x2;
    sy2[t] = y2;
    sarea[t] = area;
  }
  bool mine = false;  // candidate t was picked
  int step = 0;
  for (; step < max_keep; ++step) {
    float v = alive ? score : -CUDART_INF_F;
    int j = t;
    warp_argmax(v, j);
    if (lane == 0) {
      wval[warp] = v;
      widx[warp] = j;
    }
    __syncthreads();  // warp winners (and, at step 0, the shared boxes)
    if (warp == 0) {
      v = wval[lane];
      j = widx[lane];
      warp_argmax(v, j);
      if (lane == 0) {
        pick_val = v;
        pick_idx = j;
      }
    }
    __syncthreads();  // the pick
    const float m = pick_val;
    const int p = pick_idx;
    if (!(m > 0.f)) break;  // uniform: every thread read the same m
    if (t == 0) picks[seg * max_keep + step] = p;
    if (t == p) mine = true;
    if (alive) {
      const float ix1 = fmaxf(sx1[p], x1);
      const float iy1 = fmaxf(sy1[p], y1);
      const float ix2 = fminf(sx2[p], x2);
      const float iy2 = fminf(sy2[p], y2);
      const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.f),
                                    fmaxf(__fsub_rn(iy2, iy1), 0.f));
      const float denom =
          fmaxf(__fsub_rn(__fadd_rn(sarea[p], area), inter), 1e-12f);
      alive = __fdiv_rn(inter, denom) <= thr;
    }
  }
  for (int s = step + t; s < max_keep; s += blockDim.x) {
    picks[seg * max_keep + s] = -1;
  }
  if (own) kept[seg * k + t] = static_cast<uint8_t>(mine);
}

}  // namespace

extern "C" {

// boxes: (segments, k, 4) f32 xyxy, contiguous, on the current device.
// scores: (segments, k) f32; entries <= 0 never participate.
// kept: (segments, k) bool bytes. picks: (segments, max_keep) int32, the
// picked indices in pick order, -1 after the last pick.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch (0 on success).
int nms_seq_suppress(const void* boxes, const void* scores, void* kept,
                     void* picks, int segments, int k, int max_keep,
                     float thr, void* stream) {
  if (segments < 0 || k < 1 || k > kMaxK || max_keep < 0)
    return (int)cudaErrorInvalidValue;
  if (segments == 0) return 0;
  seq_nms_kernel<<<segments, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(kept), static_cast<int32_t*>(picks), k, max_keep,
      thr);
  return (int)cudaGetLastError();
}

const char* nms_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
