// Row gather for Hopper (sm_90a): out[b, j, :] = src[b, idx[b, j], :],
// optionally times scale[b, idx[b, j]], one warp per output row.
//
// Replaces: tools/gather_pallas_kernel.py _kernel_plain / _kernel_scaled
// (the Pallas TPU kernel that stages the source in VMEM chunks of 7 MB and
// copies whole rows by scalar-prefetched indices). Plain PyTorch version:
// edgeml_tpu_torch/ops/gather.py gather_rows_plain (torch.gather, times the
// gathered scale); the two are bit-identical.
//
// What bounds it on this card: bytes. A row gather does no arithmetic beyond
// one multiply per element, so its least time is the rows it reads and
// writes (K rows of C elements per image, plus the indices and the scales)
// over the 3.35 TB/s of HBM3. The TPU kernel's chunking exists because VMEM
// cannot hold a 25,200 x 80 source; here nothing is staged: each warp reads
// its source row straight from device memory (through L1/L2), so there is no
// chunk loop and no masked scale lookup.
//
// Design: one warp per output row (b, j). Every lane reads the row's index
// (one broadcast load) and, when scaled, the row's scale (one more), then
// the lanes stride over the C channels, so neighbouring lanes touch
// neighbouring addresses. The output type is the promotion of the source and
// scale types (f32 or bf16); a product is formed in f32 and rounded once to
// the output type (__float2bfloat16_rn for bf16), which is what PyTorch's
// bf16 multiply does, so the scaled bf16 gather equals torch's
// gather-then-multiply bit for bit. Indices must lie in [0, N) (the TPU
// kernel's contract as well): the kernel does not check them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (output rows) per block of 256 threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename O>
__device__ __forceinline__ O from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Same-type copy keeps the bits (no round trip through f32).
template <typename O, typename S>
__device__ __forceinline__ O convert(S v) {
  return from_f32<O>(to_f32(v));
}
template <>
__device__ __forceinline__ float convert<float, float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16
convert<__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 v) {
  return v;
}

template <typename S, typename SC, typename O, typename I, bool kScaled>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const S* __restrict__ src, const I* __restrict__ idx,
                   const SC* __restrict__ scale, O* __restrict__ out,
                   int64_t rows, int k, int c, int64_t n,
                   int64_t src_bstride, int64_t src_rstride) {
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t b = row / k;
  const int64_t i = (int64_t)idx[row];
  const S* s = src + b * src_bstride + i * src_rstride;
  O* o = out + row * (int64_t)c;
  if constexpr (kScaled) {
    // the scale in the output type first (JAX casts scale to the promoted
    // type), then one f32 product rounded once
    const float sc = to_f32(convert<O>(scale[b * n + i]));
    for (int ch = lane; ch < c; ch += 32) {
      o[ch] = from_f32<O>(__fmul_rn(to_f32(convert<O>(s[ch])), sc));
    }
  } else {
    for (int ch = lane; ch < c; ch += 32) o[ch] = convert<O>(s[ch]);
  }
}

template <typename S, typename SC, typename O, typename I, bool kScaled>
int launch(const void* src, const void* idx, const void* scale, void* out,
           int batch, int k, int c, int64_t n, int64_t src_bstride,
           int64_t src_rstride, cudaStream_t stream) {
  const int64_t rows = (int64_t)batch * k;
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  gather_rows_kernel<S, SC, O, I, kScaled><<<(unsigned)blocks, kWarps * 32,
                                             0, stream>>>(
      static_cast<const S*>(src), static_cast<const I*>(idx),
      static_cast<const SC*>(scale), static_cast<O*>(out), rows, k, c, n,
      src_bstride, src_rstride);
  return (int)cudaGetLastError();
}

template <typename I>
int dispatch(int src_type, int scale_type, const void* src, const void* idx,
             const void* scale, void* out, int batch, int k, int c, int64_t n,
             int64_t sb, int64_t sr, cudaStream_t st) {
  using bf = __nv_bfloat16;
  // type codes: 0 = f32, 1 = bf16; scale_type -1 = no scale
  if (scale_type < 0) {
    if (src_type == 0)
      return launch<float, float, float, I, false>(src, idx, nullptr, out,
                                                   batch, k, c, n, sb, sr, st);
    return launch<bf, bf, bf, I, false>(src, idx, nullptr, out, batch, k, c,
                                        n, sb, sr, st);
  }
  if (src_type == 0 && scale_type == 0)
    return launch<float, float, float, I, true>(src, idx, scale, out, batch,
                                                k, c, n, sb, sr, st);
  if (src_type == 1 && scale_type == 1)
    return launch<bf, bf, bf, I, true>(src, idx, scale, out, batch, k, c, n,
                                       sb, sr, st);
  if (src_type == 1 && scale_type == 0)
    return launch<bf, float, float, I, true>(src, idx, scale, out, batch, k,
                                             c, n, sb, sr, st);
  return launch<float, bf, float, I, true>(src, idx, scale, out, batch, k, c,
                                           n, sb, sr, st);
}

}  // namespace

extern "C" {

// src: (batch, n, c) rows of c contiguous elements, row stride src_rstride
// and image stride src_bstride (in elements; 0 broadcasts one source to
// every image). idx: (batch, k) int32 (idx_type 0) or int64 (1), contiguous.
// scale: (batch, n) contiguous, or null with scale_type -1. out: (batch, k,
// c) contiguous in the promoted type. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
int gather_rows_launch(const void* src, const void* idx, const void* scale,
                       void* out, int batch, int k, int c, long long n,
                       long long src_bstride, long long src_rstride,
                       int src_type, int scale_type, int idx_type,
                       void* stream) {
  if (batch < 0 || k < 0 || c < 1 || n < 1 || src_type < 0 || src_type > 1 ||
      scale_type < -1 || scale_type > 1 || idx_type < 0 || idx_type > 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_type == 0)
    return dispatch<int32_t>(src_type, scale_type, src, idx, scale, out,
                             batch, k, c, n, src_bstride, src_rstride, st);
  return dispatch<int64_t>(src_type, scale_type, src, idx, scale, out, batch,
                           k, c, n, src_bstride, src_rstride, st);
}

const char* gather_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
