// Eval BatchNorm and its activation in one pass over a conv's output, in
// place, for Hopper (sm_90a):
//
//   y[n, c, :, :] = act(((y - m[c]) * rsqrt(v[c] + eps)) * g[c] + b[c])
//
// with act one of none, ReLU, ReLU6, hardswish or SiLU.
//
// Replaces: no TPU kernel (XLA fuses the reference's eval norm and its
// activation into the conv's epilogue by itself). Added because PyTorch runs
// the same formula as nine launches after each conv (fill, add, rsqrt, sub,
// mul, mul, add, then sigmoid and mul for SiLU; five full passes over the
// activations for ReLU): on YOLOv5n at batch 1 the host spends ~10-13 us
// issuing each of them, and on Faster R-CNN's box head each pass moves
// 16,000 x 256 x 7 x 7 f32 (803 MB) twice. Plain PyTorch version:
// edgeml_tpu_torch/ops/norm_act.py norm_act_plain, the op sequence itself;
// the two are bit-identical on the card.
//
// Every op rounds where PyTorch's CUDA kernels round: in f32 each op is one
// correctly rounded __fsub_rn / __fmul_rn / __fadd_rn (the build passes
// -fmad=false, so nothing contracts into an FMA); in bf16 each op is computed
// in f32 and rounded to bf16 (nearest even) before the next, as ATen's bf16
// elementwise kernels store each result. rsqrt is rsqrtf (ATen's rsqrt
// kernel calls it too); SiLU's sigmoid is 1 / (1 + expf(-x)) with an IEEE
// division, then x times it; hardswish is x * clamp(x + 3, 0, 6) / 6, where
// the division by the scalar 6 is a multiply by f32(1/6), as ATen's CUDA
// division by a host scalar computes it. ReLU and the clamps pass NaN through
// (they test for it first, as torch.relu and torch.clamp do).
//
// What bounds it on this card: bytes. Each element is read once and written
// once (in place); the arithmetic is a few flops an element and one rsqrtf
// a channel (per thread, or per element on the flat path). At 3.35 TB/s a
// box-head layer (16,000 x 256 x 7 x 7 f32) needs 0.48 ms (this kernel: 0.53
// ms on an H100 80GB HBM3 at 700 W); a YOLOv5n block at batch 1 (at most 1.6
// M f32) under 4 us, where the time is the launch and its tail.
//
// Design. The port's conv outputs are channels-last on the card (cuDNN keeps
// the layout of the permuted NHWC input through the trunk and the box head),
// so the main mapping walks y as rows of C channels:
//   rows: channels-last y with C a multiple of a 16-byte vector (4 f32, 8
//   bf16) and C / vector <= 256 (YOLOv5's 16-256 channels, the FPN's and the
//   box head's 256). A block's width is a multiple of the vectors a row, and
//   so is every stride of its loop, so each thread always meets the same 4
//   (or 8) channels: their four values and rsqrts sit in registers, loaded
//   once. A thread loads 4 vectors of 16 bytes before it computes and stores
//   any (four loads in flight a thread); neighbouring threads touch
//   neighbouring 16 bytes.
//   flat: everything else (contiguous NCHW, odd channel counts, C = 1):
//   thread t takes elements t + k * threads of its block's chunk, 4 loaded
//   before any is computed, and finds each element's channel as (i / HW) % C
//   (i % C channels-last) in 64-bit indices; the channel's values are read
//   through L1 and the rsqrt taken per element. No main path takes it (the
//   smoke found every served conv output channels-last), so it is kept plain.
// In place is safe: the caller hands over the conv's fresh output, which
// nothing else holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2, kHardswish = 3, kSilu = 4 };

constexpr int kUnroll = 4;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;
// ATen divides by a host scalar as a multiply by the f32 reciprocal
constexpr float kSixth = 1.0f / 6.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// One op's result stored in E: unchanged for f32, rounded for bf16.
template <typename E>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename E>
__device__ __forceinline__ E store_as(float x);
template <>
__device__ __forceinline__ float store_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 store_as<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Channel {
  float m, inv, g, b;
};

template <typename E>
__device__ __forceinline__ Channel load_channel(const E* __restrict__ m,
                                                const E* __restrict__ v,
                                                const E* __restrict__ g,
                                                const E* __restrict__ b,
                                                float eps, int64_t c) {
  Channel p;
  p.m = to_f32(m[c]);
  p.g = to_f32(g[c]);
  p.b = to_f32(b[c]);
  p.inv = rnd<E>(rsqrtf(rnd<E>(__fadd_rn(to_f32(v[c]), eps))));
  return p;
}

// torch.clamp(x, lo, hi) on the card: NaN first, then min(max(x, lo), hi).
__device__ __forceinline__ float clamp06(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 6.0f);
}

template <typename E, int kAct>
__device__ __forceinline__ float activate(float x) {
  if constexpr (kAct == kRelu) {
    return isnan(x) ? x : fmaxf(x, 0.0f);
  } else if constexpr (kAct == kRelu6) {
    return clamp06(x);
  } else if constexpr (kAct == kHardswish) {
    const float t = clamp06(rnd<E>(__fadd_rn(x, 3.0f)));
    return rnd<E>(__fmul_rn(rnd<E>(__fmul_rn(x, t)), kSixth));
  } else if constexpr (kAct == kSilu) {
    const float s = rnd<E>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))));
    return rnd<E>(__fmul_rn(x, s));
  } else {
    return x;
  }
}

template <typename E, int kAct>
__device__ __forceinline__ float norm_act(float y, const Channel& p) {
  float t = rnd<E>(__fsub_rn(y, p.m));
  t = rnd<E>(__fmul_rn(t, p.inv));
  t = rnd<E>(__fmul_rn(t, p.g));
  t = rnd<E>(__fadd_rn(t, p.b));
  return activate<E, kAct>(t);
}

// One 16-byte vector of kPer consecutive channels of one pixel: four f32, or
// eight bf16 (two a 32-bit lane, the low half the element at the lower
// address); p holds the kPer channels' values.
template <typename E, int kAct>
struct Vec;
template <int kAct>
struct Vec<float, kAct> {
  static __device__ __forceinline__ uint4 apply(uint4 q, const Channel* p) {
    q.x = __float_as_uint(norm_act<float, kAct>(__uint_as_float(q.x), p[0]));
    q.y = __float_as_uint(norm_act<float, kAct>(__uint_as_float(q.y), p[1]));
    q.z = __float_as_uint(norm_act<float, kAct>(__uint_as_float(q.z), p[2]));
    q.w = __float_as_uint(norm_act<float, kAct>(__uint_as_float(q.w), p[3]));
    return q;
  }
};
template <int kAct>
struct Vec<bf16, kAct> {
  static __device__ __forceinline__ uint32_t lane(uint32_t q,
                                                  const Channel& lo,
                                                  const Channel& hi) {
    const float a = norm_act<bf16, kAct>(__uint_as_float(q << 16), lo);
    const float b = norm_act<bf16, kAct>(__uint_as_float(q & 0xffff0000u), hi);
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  static __device__ __forceinline__ uint4 apply(uint4 q, const Channel* p) {
    q.x = lane(q.x, p[0], p[1]);
    q.y = lane(q.y, p[2], p[3]);
    q.z = lane(q.z, p[4], p[5]);
    q.w = lane(q.w, p[6], p[7]);
    return q;
  }
};

// Channels-last y as rows of C channels, C / kPer vectors a row. The block's
// width is a multiple of that, and so is every stride of the loop, so a
// thread always meets the same kPer channels: it loads their values and
// takes their rsqrts once, into registers.
template <typename E, int kAct>
__global__ void __launch_bounds__(kThreads)
norm_act_rows(E* __restrict__ y, const E* __restrict__ m,
              const E* __restrict__ v, const E* __restrict__ g,
              const E* __restrict__ b, float eps, int64_t vecs,
              int vecs_per_row) {
  constexpr int kPer = 16 / (int)sizeof(E);
  const int64_t c0 = (int64_t)(threadIdx.x % vecs_per_row) * kPer;
  Channel p[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) p[k] = load_channel(m, v, g, b, eps, c0 + k);
  uint4* base = reinterpret_cast<uint4*>(y);
  const int64_t chunk = (int64_t)blockDim.x * kUnroll;
  for (int64_t i0 = (int64_t)blockIdx.x * chunk + threadIdx.x; i0 < vecs;
       i0 += (int64_t)gridDim.x * chunk) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * blockDim.x;
      if (i < vecs) q[u] = base[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * blockDim.x;
      if (i < vecs) base[i] = Vec<E, kAct>::apply(q[u], p);
    }
  }
}

// Thread t of block k takes elements k * chunk + t + u * kThreads.
template <typename E, int kAct>
__global__ void __launch_bounds__(kThreads)
norm_act_flat(E* __restrict__ y, const E* __restrict__ m,
              const E* __restrict__ v, const E* __restrict__ g,
              const E* __restrict__ b, float eps, int64_t total, int64_t c,
              int64_t inner) {
  constexpr int64_t kChunk = (int64_t)kThreads * kUnroll;
  for (int64_t i0 = (int64_t)blockIdx.x * kChunk + threadIdx.x; i0 < total;
       i0 += (int64_t)gridDim.x * kChunk) {
    float q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * kThreads;
      if (i < total) q[u] = to_f32(y[i]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * kThreads;
      if (i < total) {
        const Channel p = load_channel(m, v, g, b, eps, (i / inner) % c);
        y[i] = store_as<E>(norm_act<E, kAct>(q[u], p));
      }
    }
  }
}

template <typename E, int kAct>
int launch(void* y, const void* m, const void* v, const void* g,
           const void* b, float eps, int64_t n, int c, int64_t hw,
           bool channels_last, cudaStream_t st) {
  E* yy = static_cast<E*>(y);
  const E* mm = static_cast<const E*>(m);
  const E* vv = static_cast<const E*>(v);
  const E* gg = static_cast<const E*>(g);
  const E* bb = static_cast<const E*>(b);
  constexpr int kPer = 16 / (int)sizeof(E);
  const int64_t total = n * c * hw;
  const int vecs_per_row = c / kPer;
  if (channels_last && c % kPer == 0 && vecs_per_row <= kThreads &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0) {
    const int threads = kThreads / vecs_per_row * vecs_per_row;
    const int64_t vecs = total / kPer;
    const int64_t per_block = (int64_t)threads * kUnroll;
    int64_t blocks = (vecs + per_block - 1) / per_block;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    norm_act_rows<E, kAct><<<(unsigned)blocks, threads, 0, st>>>(
        yy, mm, vv, gg, bb, eps, vecs, vecs_per_row);
    return (int)cudaGetLastError();
  }
  // the channel of element i: (i / hw) % c, or i % c channels-last
  int64_t blocks = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  norm_act_flat<E, kAct><<<(unsigned)blocks, kThreads, 0, st>>>(
      yy, mm, vv, gg, bb, eps, total, (int64_t)c, channels_last ? 1 : hw);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_act(int act, void* y, const void* m, const void* v,
                 const void* g, const void* b, float eps, int64_t n, int c,
                 int64_t hw, bool cl, cudaStream_t st) {
  switch (act) {
    case kNone:
      return launch<E, kNone>(y, m, v, g, b, eps, n, c, hw, cl, st);
    case kRelu:
      return launch<E, kRelu>(y, m, v, g, b, eps, n, c, hw, cl, st);
    case kRelu6:
      return launch<E, kRelu6>(y, m, v, g, b, eps, n, c, hw, cl, st);
    case kHardswish:
      return launch<E, kHardswish>(y, m, v, g, b, eps, n, c, hw, cl, st);
    default:
      return launch<E, kSilu>(y, m, v, g, b, eps, n, c, hw, cl, st);
  }
}

}  // namespace

extern "C" {

// y: (n, c, hw) f32 (dtype 0) or bf16 (1), contiguous (channels_last 0) or
// channels-last, (n, hw, c) in memory (1), overwritten with the result; m, v, g, b: (c,) contiguous, of y's type; eps: the norm's epsilon
// already rounded to that type. act: 0 none, 1 ReLU, 2 ReLU6, 3 hardswish,
// 4 SiLU. Launches on `stream`, does not synchronise, allocates nothing;
// returns the cudaError_t of the launch.
int norm_act_launch(void* y, const void* m, const void* v, const void* g,
                    const void* b, float eps, long long n, int c,
                    long long hw, int channels_last, int dtype, int act,
                    void* stream) {
  if (n < 0 || c < 1 || hw < 0 || channels_last < 0 || channels_last > 1 ||
      dtype < 0 || dtype > 1 || act < kNone || act > kSilu)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || hw == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cl = channels_last != 0;
  if (dtype == 0)
    return dispatch_act<float>(act, y, m, v, g, b, eps, n, c, hw, cl, st);
  return dispatch_act<bf16>(act, y, m, v, g, b, eps, n, c, hw, cl, st);
}

const char* norm_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
