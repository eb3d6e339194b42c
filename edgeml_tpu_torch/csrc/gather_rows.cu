// Row gather for Hopper (sm_90a): out[b, j, :] = src[b, idx[b, j], :],
// optionally times scale[b, idx[b, j]], a thread per 16 bytes of output.
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
// over the 3.35 TB/s of HBM3: 0.0126 ms for YOLOv5's scaled f32 tail (64 x
// 1024 rows of 320 bytes), 0.0004 ms for Faster R-CNN's candidate rows (16 x
// 2048 rows of 16 bytes). The second is below the cost of a launch, so at
// that size the time is the launch and the tail of one wave of blocks.
//
// Design. The output is flat: (b, j, channel) in order. Two kernels index it
// the same way and differ in the unit a thread moves:
//   vectors: where a row's bytes are a multiple of 16 and the source base,
//   both source strides and the output are 16-byte aligned, thread t moves
//   vector t of the output: row = t / vectors_per_row, one 16-byte load, up
//   to 8 multiplies, one 16-byte store. Neighbouring threads write
//   neighbouring 16 bytes (stores fully coalesced) and read neighbouring 16
//   bytes of one source row, and no lane idles at any C (C = 4 f32 is one
//   vector a row, C = 80 f32 twenty, C = 80 bf16 ten). Source, scale and
//   output share one type on this path.
//   elements: everything else (C = 1, C = 91, views that start off a 16-byte
//   boundary, a source and a scale of different types) moves one element a
//   thread with the same flat indexing.
// The caller states which kernel the strides and addresses allow; the entry
// point checks it again and refuses a vector launch that would be misaligned.
// The flat index is 32 bits wide where the output has fewer than 2^31
// elements (one 32-bit division a thread) and 64 bits otherwise. Blocks of
// 256 threads, the grid sized to the work up to 65,536 blocks, a grid-stride
// loop beyond. Nothing is staged: the rows are read once, scattered, straight
// from device memory through L2, so shared memory, cp.async or TMA would add
// a hop and no reuse; the TPU kernel's chunk loop existed only because VMEM
// could not hold a 25,200 x 80 source.
//
// The output type is the promotion of the source and scale types (f32 or
// bf16); a product is formed in f32 and rounded once to the output type
// (round to nearest even for bf16), which is what PyTorch's bf16 multiply
// does, so the scaled bf16 gather equals torch's gather-then-multiply bit
// for bit. Indices must lie in [0, N) (the TPU kernel's contract as well):
// the kernels do not check them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

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

// One 32-bit lane of a vector times the scale: one f32, or two bf16 (the
// low half is the element at the lower address), each product formed in f32
// and rounded once.
template <typename E>
__device__ __forceinline__ uint32_t scale_lane(uint32_t q, float sc);
template <>
__device__ __forceinline__ uint32_t scale_lane<float>(uint32_t q, float sc) {
  return __float_as_uint(__fmul_rn(__uint_as_float(q), sc));
}
template <>
__device__ __forceinline__ uint32_t scale_lane<__nv_bfloat16>(uint32_t q,
                                                             float sc) {
  const float lo = __uint_as_float(q << 16);
  const float hi = __uint_as_float(q & 0xffff0000u);
  const uint32_t rlo =
      __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(lo, sc)));
  const uint32_t rhi =
      __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(hi, sc)));
  return rlo | (rhi << 16);
}

// Thread t moves element t of the flat output.
template <typename S, typename SC, typename O, typename I, typename T,
          bool kScaled>
__global__ void __launch_bounds__(kThreads)
gather_elements_kernel(const S* __restrict__ src, const I* __restrict__ idx,
                       const SC* __restrict__ scale, O* __restrict__ out,
                       T total, T k, T c, int64_t n, int64_t src_bstride,
                       int64_t src_rstride) {
  const T step = (T)gridDim.x * (T)kThreads;
  for (T t = (T)blockIdx.x * (T)kThreads + (T)threadIdx.x; t < total;
       t += step) {
    const T row = t / c;
    const T ch = t - row * c;
    const int64_t b = (int64_t)(row / k);
    const int64_t i = (int64_t)idx[row];
    const S v = src[b * src_bstride + i * src_rstride + (int64_t)ch];
    if constexpr (kScaled) {
      // the scale in the output type first (JAX casts scale to the promoted
      // type), then one f32 product rounded once
      const float sc = to_f32(convert<O>(scale[b * n + i]));
      out[t] = from_f32<O>(__fmul_rn(to_f32(convert<O>(v)), sc));
    } else {
      out[t] = convert<O>(v);
    }
  }
}

// Thread t moves 16-byte vector t of the flat output. Source, scale and
// output are of type E; every address it forms is 16-byte aligned.
template <typename E, typename I, typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads)
gather_vectors_kernel(const E* __restrict__ src, const I* __restrict__ idx,
                      const E* __restrict__ scale, E* __restrict__ out,
                      T total, T k, T vecs_per_row, int64_t n,
                      int64_t src_bstride, int64_t src_rstride) {
  constexpr int kPer = 16 / (int)sizeof(E);  // elements in a vector
  const T step = (T)gridDim.x * (T)kThreads;
  for (T t = (T)blockIdx.x * (T)kThreads + (T)threadIdx.x; t < total;
       t += step) {
    const T row = t / vecs_per_row;
    const T v = t - row * vecs_per_row;
    const int64_t b = (int64_t)(row / k);
    const int64_t i = (int64_t)idx[row];
    uint4 q = *reinterpret_cast<const uint4*>(
        src + b * src_bstride + i * src_rstride + (int64_t)v * kPer);
    if constexpr (kScaled) {
      const float sc = to_f32(scale[b * n + i]);
      q.x = scale_lane<E>(q.x, sc);
      q.y = scale_lane<E>(q.y, sc);
      q.z = scale_lane<E>(q.z, sc);
      q.w = scale_lane<E>(q.w, sc);
    }
    reinterpret_cast<uint4*>(out)[t] = q;
  }
}

unsigned grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename S, typename SC, typename O, typename I, bool kScaled>
int launch_elements(const void* src, const void* idx, const void* scale,
                    void* out, int batch, int k, int c, int64_t n,
                    int64_t sb, int64_t sr, cudaStream_t stream) {
  const int64_t total = (int64_t)batch * k * c;
  const S* s = static_cast<const S*>(src);
  const I* ix = static_cast<const I*>(idx);
  const SC* sc = static_cast<const SC*>(scale);
  O* o = static_cast<O*>(out);
  if (total < (int64_t)1 << 31) {
    gather_elements_kernel<S, SC, O, I, uint32_t, kScaled>
        <<<grid_for(total), kThreads, 0, stream>>>(
            s, ix, sc, o, (uint32_t)total, (uint32_t)k, (uint32_t)c, n, sb,
            sr);
  } else {
    gather_elements_kernel<S, SC, O, I, int64_t, kScaled>
        <<<grid_for(total), kThreads, 0, stream>>>(
            s, ix, sc, o, total, (int64_t)k, (int64_t)c, n, sb, sr);
  }
  return (int)cudaGetLastError();
}

template <typename E, typename I, bool kScaled>
int launch_vectors(const void* src, const void* idx, const void* scale,
                   void* out, int batch, int k, int c, int64_t n, int64_t sb,
                   int64_t sr, cudaStream_t stream) {
  const int64_t vpr = (int64_t)c * (int64_t)sizeof(E) / 16;
  const int64_t total = (int64_t)batch * k * vpr;
  const E* s = static_cast<const E*>(src);
  const I* ix = static_cast<const I*>(idx);
  const E* sc = static_cast<const E*>(scale);
  E* o = static_cast<E*>(out);
  if (total < (int64_t)1 << 31) {
    gather_vectors_kernel<E, I, uint32_t, kScaled>
        <<<grid_for(total), kThreads, 0, stream>>>(
            s, ix, sc, o, (uint32_t)total, (uint32_t)k, (uint32_t)vpr, n, sb,
            sr);
  } else {
    gather_vectors_kernel<E, I, int64_t, kScaled>
        <<<grid_for(total), kThreads, 0, stream>>>(s, ix, sc, o, total,
                                                   (int64_t)k, vpr, n, sb, sr);
  }
  return (int)cudaGetLastError();
}

template <typename I>
int dispatch(int src_type, int scale_type, bool vectors, const void* src,
             const void* idx, const void* scale, void* out, int batch, int k,
             int c, int64_t n, int64_t sb, int64_t sr, cudaStream_t st) {
  using bf = __nv_bfloat16;
  // type codes: 0 = f32, 1 = bf16; scale_type -1 = no scale
  if (vectors) {
    if (scale_type < 0) {
      if (src_type == 0)
        return launch_vectors<float, I, false>(src, idx, nullptr, out, batch,
                                               k, c, n, sb, sr, st);
      return launch_vectors<bf, I, false>(src, idx, nullptr, out, batch, k,
                                          c, n, sb, sr, st);
    }
    if (src_type == 0)
      return launch_vectors<float, I, true>(src, idx, scale, out, batch, k,
                                            c, n, sb, sr, st);
    return launch_vectors<bf, I, true>(src, idx, scale, out, batch, k, c, n,
                                       sb, sr, st);
  }
  if (scale_type < 0) {
    if (src_type == 0)
      return launch_elements<float, float, float, I, false>(
          src, idx, nullptr, out, batch, k, c, n, sb, sr, st);
    return launch_elements<bf, bf, bf, I, false>(src, idx, nullptr, out,
                                                 batch, k, c, n, sb, sr, st);
  }
  if (src_type == 0 && scale_type == 0)
    return launch_elements<float, float, float, I, true>(
        src, idx, scale, out, batch, k, c, n, sb, sr, st);
  if (src_type == 1 && scale_type == 1)
    return launch_elements<bf, bf, bf, I, true>(src, idx, scale, out, batch,
                                                k, c, n, sb, sr, st);
  if (src_type == 1 && scale_type == 0)
    return launch_elements<bf, float, float, I, true>(
        src, idx, scale, out, batch, k, c, n, sb, sr, st);
  return launch_elements<float, bf, float, I, true>(src, idx, scale, out,
                                                    batch, k, c, n, sb, sr,
                                                    st);
}

}  // namespace

extern "C" {

// src: (batch, n, c) rows of c contiguous elements, row stride src_rstride
// and image stride src_bstride (in elements; 0 broadcasts one source to
// every image). idx: (batch, k) int32 (idx_type 0) or int64 (1), contiguous.
// scale: (batch, n) contiguous, or null with scale_type -1. out: (batch, k,
// c) contiguous in the promoted type. vectors: 1 for the 16-byte kernel
// (refused unless source and scale share a type, a row's bytes and both
// strides' bytes are multiples of 16 and src and out are 16-byte aligned),
// 0 for the per-element kernel. Launches on `stream`, does not synchronise,
// allocates nothing; returns the cudaError_t of the launch.
int gather_rows_launch(const void* src, const void* idx, const void* scale,
                       void* out, int batch, int k, int c, long long n,
                       long long src_bstride, long long src_rstride,
                       int src_type, int scale_type, int idx_type,
                       int vectors, void* stream) {
  if (batch < 0 || k < 0 || c < 1 || n < 1 || src_type < 0 || src_type > 1 ||
      scale_type < -1 || scale_type > 1 || idx_type < 0 || idx_type > 1 ||
      vectors < 0 || vectors > 1)
    return (int)cudaErrorInvalidValue;
  if (vectors) {
    const long long es = src_type == 0 ? 4 : 2;
    if ((scale_type >= 0 && scale_type != src_type) || (c * es) % 16 != 0 ||
        (src_bstride * es) % 16 != 0 || (src_rstride * es) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  if (batch == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_type == 0)
    return dispatch<int32_t>(src_type, scale_type, vectors != 0, src, idx,
                             scale, out, batch, k, c, n, src_bstride,
                             src_rstride, st);
  return dispatch<int64_t>(src_type, scale_type, vectors != 0, src, idx, scale,
                           out, batch, k, c, n, src_bstride, src_rstride, st);
}

const char* gather_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
