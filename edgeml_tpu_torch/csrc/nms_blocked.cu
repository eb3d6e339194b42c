// Blocked greedy-NMS suppressor for Hopper (sm_90a): the exact greedy keep
// mask of class-offset boxes sorted by descending score, for candidate
// counts K up to 2048, one image per block.
//
// Replaces: edgeml_tpu/ops/nms_fused.py _kernel_blocked (the Pallas TPU
// kernel that builds the suppression relation in 256-row bands in VMEM and
// decides each band with one matvec against the decided prefix plus an
// in-band MXU fixpoint). Plain PyTorch version: edgeml_tpu_torch/ops/
// nms_fused.py greedy_keep_mask_blocked_plain (the reference's blocked
// fixpoint); it and the global greedy_keep_mask_plain are bit-identical to
// this kernel.
//
// What bounds it on this card: f32 CUDA-core arithmetic. At K = 2048 each
// image has K(K-1)/2 ~ 2.1e6 IoU pairs (~15 f32 operations each, one an IEEE
// division) against ~40 KB of input and 2 KB of output, far above the memory
// roofline. The greedy recurrence itself is sequential in candidate order.
//
// Design: one block of 1024 threads per image. All K boxes and areas sit in
// shared memory (40 KB at K = 2048). The full relation as bits would be
// 2048 x 64 words = 512 KB, beyond the 227 KB a block can have, so it is
// built one band of 256 targets at a time, and each band is decided before
// the next is built (the TPU kernel's banding, for the same reason):
//   Build: target i owns one 32-bit word per 32 suppressors j < band end;
//   bit (j - 32w) of word w is set iff j < i and iou(j, i) > thr. Words are
//   stored transposed, word-major with a row stride of 257, so the lanes of
//   a warp (consecutive targets, one word) write consecutive banks and, in
//   the walk, the lanes (one word each, one target) read distinct banks. A
//   band is 64 x 257 x 4 B = 65,792 B; words wholly at or after the target
//   are skipped.
//   Walk: one warp decides the band's 256 candidates in order. The kept
//   bits of all K candidates live in registers, two words per lane (words l
//   and l + 32), so kept_i = valid_i && !any(row_i & kept) is two shared
//   loads, two ANDs and one __any_sync per candidate. Since kept holds the
//   decided prefix and the earlier candidates of this band, this is the
//   sequential greedy definition: the unique answer the TPU kernel reaches
//   as a prefix matvec plus an in-band fixpoint.
// Shared memory: 65,792 + 5 x 4 x K + 256 + K bytes = 109,056 B at K = 2048.
//
// Exact arithmetic: as in nms_fused.cu, IoU is evaluated op for op as in
// the reference with explicitly rounded intrinsics (min/max, subtract,
// clamp, multiply, add, subtract, clamp, IEEE divide, strict compare with
// the f32-rounded threshold), and the library is built with -fmad=false and
// without --use_fast_math. Class offsets are applied by the caller. Inputs
// are assumed finite (fminf/fmaxf do not propagate NaN).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 2048;
constexpr int kBand = 256;
constexpr int kThreads = 1024;
constexpr int kMaxWords = kMaxK / 32;  // 64: two kept words per lane
constexpr int kStride = kBand + 1;     // padded row of the transposed band

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void __launch_bounds__(kThreads)
blocked_keep_kernel(const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ out, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* band = reinterpret_cast<uint32_t*>(smem);  // kMaxWords x kStride
  float* x1 = reinterpret_cast<float*>(band + kMaxWords * kStride);
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  uint32_t* kept_words = reinterpret_cast<uint32_t*>(area + k);  // 64
  uint8_t* vld = reinterpret_cast<uint8_t*>(kept_words + kMaxWords);  // k

  const size_t img = blockIdx.x;
  const float* bx = boxes + img * (size_t)k * 4;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float a = bx[4 * i], b = bx[4 * i + 1];
    const float c = bx[4 * i + 2], d = bx[4 * i + 3];
    x1[i] = a;
    y1[i] = b;
    x2[i] = c;
    y2[i] = d;
    area[i] = box_area(a, b, c, d);
    vld[i] = valid[img * (size_t)k + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  uint32_t kept_lo = 0u, kept_hi = 0u;  // kept words lane, lane + 32 (warp 0)
  for (int b0 = 0; b0 < k; b0 += kBand) {
    const int nb = min(kBand, k - b0);
    const int nw = (b0 + nb + 31) >> 5;  // words of suppressors j < b0 + nb

    // Build the band: one 32-bit word per (word w, target i).
    const int total = nw * nb;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int w = t / nb;
      const int il = t - w * nb;
      const int i = b0 + il;
      const int j0 = w << 5;
      uint32_t bits = 0u;
      if (j0 < i) {
        const float ax1 = x1[i], ay1 = y1[i], ax2 = x2[i], ay2 = y2[i];
        const float aa = area[i];
        const int jn = min(32, i - j0);
        for (int s = 0; s < jn; ++s) {
          const int j = j0 + s;
          const float ix = __fsub_rn(fminf(x2[j], ax2), fmaxf(x1[j], ax1));
          const float iy = __fsub_rn(fminf(y2[j], ay2), fmaxf(y1[j], ay1));
          const float inter = __fmul_rn(fmaxf(ix, 0.0f), fmaxf(iy, 0.0f));
          const float denom =
              fmaxf(__fsub_rn(__fadd_rn(area[j], aa), inter), 1e-12f);
          const float iou = __fdiv_rn(inter, denom);
          bits |= static_cast<uint32_t>(iou > thr) << s;
        }
      }
      band[w * kStride + il] = bits;
    }
    __syncthreads();

    // Walk the band in greedy (score) order with one warp.
    if (threadIdx.x < 32) {
      for (int il = 0; il < nb; ++il) {
        const uint32_t r0 = lane < nw ? band[lane * kStride + il] : 0u;
        const uint32_t r1 =
            lane + 32 < nw ? band[(lane + 32) * kStride + il] : 0u;
        const bool hit = __any_sync(
            0xffffffffu, ((r0 & kept_lo) | (r1 & kept_hi)) != 0u);
        const int i = b0 + il;
        if (!hit && vld[i]) {
          const int w = i >> 5;
          const uint32_t bit = 1u << (i & 31);
          if (lane == w) kept_lo |= bit;
          if (lane + 32 == w) kept_hi |= bit;
        }
      }
    }
    __syncthreads();  // the next band overwrites this one
  }

  if (threadIdx.x < 32) {
    kept_words[lane] = kept_lo;
    kept_words[lane + 32] = kept_hi;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    out[img * (size_t)k + i] =
        static_cast<uint8_t>((kept_words[i >> 5] >> (i & 31)) & 1u);
  }
}

size_t shared_bytes(int k) {
  return (size_t)kMaxWords * kStride * 4 + 5 * (size_t)k * 4 +
         kMaxWords * 4 + k;
}

}  // namespace

extern "C" {

// boxes: (batch, k, 4) f32 xyxy, contiguous, on the current device.
// valid: (batch, k) bool bytes. out: (batch, k) bool bytes. 1 <= k <= 2048.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// the cudaError_t of the launch (0 on success).
int nms_blocked_greedy_keep(const void* boxes, const void* valid, void* out,
                            int batch, int k, float thr, void* stream) {
  if (batch < 0 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = shared_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  blocked_keep_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(out), k, thr);
  return (int)cudaGetLastError();
}

const char* nms_blocked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
