// Per-sample SGD regression fit for Hopper (sm_90a): the whole dependent
// chain of steps in one launch.
//
//   for s in 0 .. steps - 1:  i = order[s]
//     err = x[i] . w + b - y[i]
//     w  -= eta[s] * (err * x[i] + alpha * w);   b -= eta[s] * err
//
// Replaces: edgeml_tpu/estimators/linear.py _sgd_fit (an XLA lax.scan over
// epochs of a lax.scan over samples; no Pallas kernel there). Eager PyTorch
// would pay some ten launches a step, 237,720 steps for a fold of 3,962
// images over 60 epochs. Plain PyTorch version:
// edgeml_tpu_torch/ops/sgd.py sgd_fit_plain (the same steps as torch ops).
// The step sizes eta[s] = eta0 / s^power_t are one f32 table computed on the
// host and read by both versions, so the two differ only in the dot's
// summation order.
//
// What bounds it on this card: neither bytes nor operations but the chain.
// The work is ~7F f32 operations a step (0.24 GFLOP for a fold, 3.6 us at
// the 67 TFLOP/s f32 rate) and the samples are read from L2 (2.3 MB, once
// per epoch), but every step needs the previous step's w. So the time is
// steps x the latency of one step: a dot over F, a reduction, an update.
//
// Design: one block of one warp per fit. Lane l owns features l, l + 32,
// ...: its slice of w and of the current row live in registers (PER =
// ceil(F / 32) rounded up to a power of two, F <= 1024), so the dot is PER
// multiply-adds per lane and a 5-level xor butterfly (every lane ends with
// the same total: the same additions, commuted), with no shared memory and
// no barrier. The next step's row, target and step size are loaded while the
// current step computes, and the index after it one step earlier still, so
// the loads' latency overlaps the chain. Arithmetic is op by op in the plain
// version's order (__fmul_rn / __fadd_rn, and -fmad=false for the rest).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int PER>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int i,
                                         int f, int lane, float (&r)[PER]) {
  const float* row = x + (int64_t)i * f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = lane + 32 * k;
    r[k] = j < f ? row[j] : 0.0f;
  }
}

template <int PER>
__global__ void __launch_bounds__(32)
    sgd_scan_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const int32_t* __restrict__ order,
                    const float* __restrict__ eta, long long steps, int f,
                    float alpha, float* __restrict__ out) {
  const int lane = threadIdx.x;
  float w[PER], xc[PER], xn[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) w[k] = 0.0f;
  float b = 0.0f;
  if (steps > 0) {
    int i_next = steps > 1 ? order[1] : 0;
    int i_cur = order[0];
    load_row<PER>(x, i_cur, f, lane, xc);
    float y_cur = y[i_cur];
    float eta_cur = eta[0];
    for (long long s = 0; s < steps; ++s) {
      float y_next = 0.0f, eta_next = 0.0f;
      int i_after = 0;
      if (s + 1 < steps) {
        load_row<PER>(x, i_next, f, lane, xn);
        y_next = y[i_next];
        eta_next = eta[s + 1];
        if (s + 2 < steps) i_after = order[s + 2];
      }
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < PER; ++k) part = __fadd_rn(part, __fmul_rn(xc[k], w[k]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      const float err = __fsub_rn(__fadd_rn(part, b), y_cur);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const float g = __fadd_rn(__fmul_rn(err, xc[k]), __fmul_rn(alpha, w[k]));
        w[k] = __fsub_rn(w[k], __fmul_rn(eta_cur, g));
      }
      b = __fsub_rn(b, __fmul_rn(eta_cur, err));
#pragma unroll
      for (int k = 0; k < PER; ++k) xc[k] = xn[k];
      y_cur = y_next;
      eta_cur = eta_next;
      i_next = i_after;
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = lane + 32 * k;
    if (j < f) out[j] = w[k];
  }
  if (lane == 0) out[f] = b;
}

template <int PER>
cudaError_t launch(const float* x, const float* y, const int32_t* order,
                   const float* eta, long long steps, int f, float alpha,
                   float* out, cudaStream_t st) {
  sgd_scan_kernel<PER><<<1, 32, 0, st>>>(x, y, order, eta, steps, f, alpha, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, f) f32 row-major; y: (n,) f32; order: (steps,) int32 sample indices
// in [0, n) (unchecked); eta: (steps,) f32 step sizes; out: (f + 1,) f32,
// w then b. 1 <= f <= 1024. Launches one block of 32 threads on `stream`,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch.
int sgd_scan_launch(const void* x, const void* y, const void* order,
                    const void* eta, long long steps, int f, float alpha,
                    void* out, void* stream) {
  if (f < 1 || f > 1024 || steps < 0) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const int32_t* o = static_cast<const int32_t*>(order);
  const float* e = static_cast<const float*>(eta);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = (f + 31) / 32;
  if (per <= 1) return (int)launch<1>(xf, yf, o, e, steps, f, alpha, of, st);
  if (per <= 2) return (int)launch<2>(xf, yf, o, e, steps, f, alpha, of, st);
  if (per <= 4) return (int)launch<4>(xf, yf, o, e, steps, f, alpha, of, st);
  if (per <= 8) return (int)launch<8>(xf, yf, o, e, steps, f, alpha, of, st);
  if (per <= 16) return (int)launch<16>(xf, yf, o, e, steps, f, alpha, of, st);
  return (int)launch<32>(xf, yf, o, e, steps, f, alpha, of, st);
}

const char* sgd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
