// Blocked greedy-NMS suppressor for Hopper (sm_90a): the exact greedy keep
// mask of class-offset boxes sorted by descending score, for candidate
// counts K up to 2048, one thread-block cluster of 8 blocks per image.
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
// roofline: 0.0075 ms for 16 images, 0.0300 ms for 64 at the card's 67
// TFLOP/s. The greedy recurrence itself is sequential in candidate order.
//
// What held the band-serial, one-block-per-image form back, and what this
// design does about it. That form (the TPU kernel's banding carried over)
// took the same 0.84 ms for 16 images as for 64 on an NVIDIA H100 at 700 W
// (build 0.49-0.65 ms, walk 0.16-0.20 ms): it was the latency of one block,
// which built a band on one SM, then walked it with one warp while 31 warps
// waited, eight times in a row, on 16 or 64 of the card's 132 SMs.
//   Build everywhere at once. The relation needs no kept bit, so block r of
//   the cluster owns band r (targets 256 r .. 256 r + 255) and builds its
//   bits against every suppressor below the band's end in its own shared
//   memory, while the other seven blocks build theirs on seven other SMs:
//   16 images fill 128 SMs. A warp takes 32 consecutive targets (their boxes
//   in registers) and one word of 32 suppressors (one broadcast 16-byte load
//   a suppressor). Words are stored word-major with a row stride of 257, so
//   lanes write consecutive banks and the walk reads distinct banks.
//   Band r holds (r + 1/2)/32 of an image's pairs, so the last block builds
//   15 times what the first does. That is left as it is: band r is not
//   needed before bands 0 .. r-1 are decided, so the late blocks' longer
//   builds run beside the early blocks' walks, and the early blocks leave
//   their SMs. What it costs: the last block's build is the kernel's span at
//   16 images (52 of 60 thousand cycles on that card with class-offset
//   boxes); tiles of equal pair count dealt across the cluster, read back
//   through distributed shared memory, would bring that build to 4/7.5 of
//   it.
//   Less work per pair, exactly. Class offsets make most pairs disjoint, so
//   a word is built in two passes. First, without a branch, four compares a
//   pair mark the suppressors whose box can meet the target's in both axes
//   (a superset of the pairs with a positive intersection). For every other
//   pair the intersection is +-0, the quotient +-0 and 0 > thr false for
//   every thr >= 0, so its bit is 0 with nothing computed; for thr < 0 (and
//   a NaN thr) every pair is marked. Then the marked pairs alone get the
//   reference's arithmetic, and of those only the ones within 2^-20 of the
//   threshold take the division (see suppresses()). Invalid candidates never
//   suppress and are never kept, so everything at or after the end of the
//   valid prefix is neither built nor walked; an invalid candidate inside
//   the prefix is dropped in the walk.
//   Walk only what is serial. When the kept words of bands 0 .. r-1 have
//   arrived, 256 threads of block r test its 256 targets against them in
//   parallel (one AND-OR reduction a target, one ballot a word). One warp
//   then resolves the band's own 256 x 256 triangle in 8 groups of 32
//   targets, a lane a target: the group's rows against the band's earlier
//   kept words in parallel (loaded a group ahead), and its 32 x 32 diagonal
//   as the fixpoint kw = cand & ~hit(kw) iterated from kw = cand by ballots
//   (the plain version's iteration; a pass settles every target whose
//   suppressors are settled, so it ends after the longest suppression chain
//   of the group, a few passes, and at most 33).
//   Hand-over. Block r writes its 8 kept words into the shared memory of the
//   blocks after it (distributed shared memory), each as one aligned 64-bit
//   store that carries the word and a mark, so no fence or counter orders
//   anything; a thread a word of block r' spins on its own slot until the
//   mark is there. Blocks push and never read remote memory, so a block may
//   exit as soon as its stores have landed. One cluster barrier at the start
//   makes sure every block is resident and has cleared its slots before the
//   first remote write.
// Shared memory of a block: boxes 32,768 + areas 8,192 + kept slots 512 +
// band 65,792 + free words, prefix end and valid bytes 292 = 107,556 B, and
// 512 threads, so that two blocks share an SM when 64 images bring 512
// blocks: an H100 then holds 30 clusters at once. Blocks of 1024 threads
// build faster with an SM to themselves (the build is bound by instruction
// rate and latency), but an H100 holds only 15 such clusters, one short of
// a batch of 16, so there is one block size.
//
// Exact arithmetic: as in nms_fused.cu, IoU is evaluated op for op as in
// the reference with explicitly rounded intrinsics (min/max, subtract,
// clamp, multiply, add, subtract, clamp, IEEE divide, strict compare with
// the f32-rounded threshold) wherever the outcome is not certain without
// it, and the library is built with -fmad=false and without
// --use_fast_math. Class offsets are applied by the caller. Inputs are
// assumed finite (fminf/fmaxf do not propagate NaN).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 2048;
constexpr int kBand = 256;                  // targets of a block
constexpr int kCluster = kMaxK / kBand;     // 8 blocks per image
constexpr int kThreads = 512;               // two blocks to an SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = kMaxK / 32;       // 64
constexpr int kBandWords = kBand / 32;      // 8
constexpr int kStride = kBand + 1;          // padded row of the band
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBandWords == 8, "the build splits an item as (q >> 3, q & 7)");

constexpr size_t kSharedBytes =
    (size_t)kMaxK * 16 + (size_t)kMaxK * 4 + (size_t)kMaxWords * kStride * 4 +
    kMaxWords * 8 + kBandWords * 4 + 4 + kBand;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// The threshold with the margins that decide most compares without the
// division; see suppresses().
struct Threshold {
  float thr, lo, hi;
  bool margins;
};

__device__ __forceinline__ Threshold make_threshold(float thr) {
  Threshold t;
  t.thr = thr;
  t.lo = __fmul_rn(thr, 1.0f - 4.76837158203125e-07f);  // thr (1 - 2^-21)
  t.hi = __fmul_rn(thr, 1.0f + 4.76837158203125e-07f);  // thr (1 + 2^-21)
  t.margins = thr >= 1e-9f && thr <= 1e9f;  // products below stay normal
  return t;
}

// fl(inter / denom) > thr, with the reference's op order for inter and
// denom. The division is skipped where its outcome is certain. With the
// exact quotient x = inter / denom, rounding is monotone and thr is a float,
// so fl(x) > thr iff x reaches the float above thr (up to the rounding of
// the midpoint), and fl(x) <= thr whenever x <= thr. hi = fl(fl(thr (1 +
// 2^-21)) denom) carries two roundings of at most 2^-24 each, so inter > hi
// gives x > thr (1 + 2^-21)(1 - 2^-24)^2 > thr (1 + 2^-22) >= thr + 2
// ulp(thr): true. lo = fl(fl(thr (1 - 2^-21)) denom) likewise gives, for
// inter < lo, x < thr (1 - 2^-21)(1 + 2^-24)^2 < thr: false. Only inside
// the band of relative width 2^-20 around thr denom (and for a thr outside
// [1e-9, 1e9], where a product could leave the normal range, or a NaN) is
// the IEEE division taken; a product that overflows to +inf makes both
// compares say what the division would (x < thr).
__device__ __forceinline__ bool suppresses(const float4 s, float s_area,
                                           const float4 t, float t_area,
                                           const Threshold th) {
  const float ix = __fsub_rn(fminf(s.z, t.z), fmaxf(s.x, t.x));
  const float iy = __fsub_rn(fminf(s.w, t.w), fmaxf(s.y, t.y));
  const float inter = __fmul_rn(fmaxf(ix, 0.0f), fmaxf(iy, 0.0f));
  const float denom =
      fmaxf(__fsub_rn(__fadd_rn(s_area, t_area), inter), 1e-12f);
  if (th.margins) {
    if (inter > __fmul_rn(th.hi, denom)) return true;
    if (inter < __fmul_rn(th.lo, denom)) return false;
  }
  return __fdiv_rn(inter, denom) > th.thr;
}

__global__ void __launch_bounds__(kThreads, 2)
blocked_keep_kernel(const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ out, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);           // kMaxK
  float* area = reinterpret_cast<float*>(sbox + kMaxK);     // kMaxK
  unsigned long long* kept =  // {1, word} of each band before this one
      reinterpret_cast<unsigned long long*>(area + kMaxK);  // kMaxWords
  uint32_t* band = reinterpret_cast<uint32_t*>(kept + kMaxWords);
  uint32_t* free_words = band + kMaxWords * kStride;  // kBandWords
  int* prefix_end = reinterpret_cast<int*>(free_words + kBandWords);
  uint8_t* vld = reinterpret_cast<uint8_t*>(prefix_end + 1);  // kBand

  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const size_t img = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = r * kBand;
  const uint8_t* vimg = valid + img * (size_t)k;
  uint8_t* oimg = out + img * (size_t)k;

  if (tid < kMaxWords) kept[tid] = 0ull;
  if (tid == 0) *prefix_end = 0;
  __syncthreads();
  // ke: one past the last valid candidate of the image
  int last = 0;
  for (int i = tid; i < k; i += kThreads) {
    if (vimg[i]) last = i + 1;
  }
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, o));
  if (lane == 0 && last > 0) atomicMax(prefix_end, last);
  __syncthreads();
  const int ke = *prefix_end;
  // every block of the cluster is resident and has cleared its kept slots
  cluster.sync();

  if (b0 >= ke) {  // nothing valid in this band or after it
    for (int i = b0 + tid; i < min(k, b0 + kBand); i += kThreads) oimg[i] = 0;
    return;
  }
  const int nb = min(kBand, ke - b0);    // targets of this band
  const int below = b0 + nb;             // suppressors j < below
  const int ngroups = (nb + 31) >> 5;    // groups of 32 targets
  const int w0 = r * kBandWords;         // first word of the band itself
  const int last_rank = (ke - 1) / kBand;

  const float* bx = boxes + img * (size_t)k * 4;
  for (int i = tid; i < below; i += kThreads) {
    const float a = bx[4 * i], b = bx[4 * i + 1];
    const float c = bx[4 * i + 2], d = bx[4 * i + 3];
    sbox[i] = make_float4(a, b, c, d);
    area[i] = box_area(a, b, c, d);
  }
  if (tid < kBand) vld[tid] = tid < nb ? vimg[b0 + tid] : (uint8_t)0;
  __syncthreads();

  // Build: a warp per (word w, group tg): bit s of band[w][32 tg + lane] is
  // set iff j = 32 w + s < i = b0 + 32 tg + lane and iou(j, i) > thr. The
  // items are the full words below the band (every group) and the triangle
  // w0 <= w <= w0 + tg of the band's own words, dealt round robin.
  const bool skip_disjoint = thr >= 0.0f;
  const Threshold th = make_threshold(thr);
  const int nfull = w0 * kBandWords;
  const int nitems = nfull + ngroups * (ngroups + 1) / 2;
  for (int q = warp; q < nitems; q += kWarps) {
    int w, tg;
    if (q < nfull) {
      w = q >> 3;
      tg = q & 7;
      if (tg >= ngroups) continue;
    } else {
      int t = q - nfull;
      tg = 0;
      while (t > tg) t -= ++tg;
      w = w0 + t;
    }
    const int il = (tg << 5) + lane;
    uint32_t bits = 0u;
    if (il < nb) {
      const float4 t = sbox[b0 + il];
      const float t_area = area[b0 + il];
      const int j0 = w << 5;
      // First, without a branch, the suppressors whose box can meet the
      // target's in both axes (four compares): a superset of those with
      // intersection > 0. fl(min(x2) - max(x1)) > 0 needs each x2 above the
      // other box's x1, and likewise in y; for every other pair one
      // clamped side is 0, the intersection +-0, the quotient +-0 and the
      // compare with thr >= 0 false. In the band's last word rows at or
      // past the valid prefix are read as they lie in shared memory and
      // masked off below.
      uint32_t m = 0u;
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const float4 sj = sbox[j0 + s];
        m |= (uint32_t)(sj.z > t.x && t.z > sj.x && sj.w > t.y &&
                        t.w > sj.y) << s;
      }
      if (!skip_disjoint) m = kFull;
      // the diagonal word: j0 = b0 + 32 tg, so j < i iff s < lane
      if (w == w0 + tg) m &= (1u << lane) - 1u;
      // Then the exact IoU of those alone.
      while (m != 0u) {
        const int s = __ffs(m) - 1;
        m &= m - 1u;
        bits |= (uint32_t)suppresses(sbox[j0 + s], area[j0 + s], t, t_area,
                                     th) << s;
      }
    }
    band[w * kStride + il] = bits;
  }
  __syncthreads();

  // The kept words of bands 0 .. r-1, pushed here by their blocks: a thread
  // a word waits for its slot to be marked.
  if (tid < w0) {
    const volatile unsigned long long* slot = kept + tid;
    while ((*slot >> 32) == 0ull) {
    }
  }
  if (r > 0) __syncthreads();

  // Prefix test: a thread per target against the decided bands.
  if (tid < kBand) {
    uint32_t hit = 0u;
#pragma unroll 8
    for (int w = 0; w < w0; ++w)
      hit |= band[w * kStride + tid] & (uint32_t)kept[w];
    const uint32_t fw = __ballot_sync(kFull, vld[tid] != 0 && hit == 0u);
    if (lane == 0) free_words[warp] = fw;
  }
  __syncthreads();
  if (warp != 0) return;

  // Walk the band's own triangle, 32 targets at a time, a lane a target.
  uint32_t kb[kBandWords];  // this band's kept words, the same in every lane
  uint32_t row[kBandWords];  // the current group's in-band words
#pragma unroll
  for (int g = 0; g < kBandWords; ++g) kb[g] = 0u;
  row[0] = band[w0 * kStride + lane];
#pragma unroll
  for (int g = 0; g < kBandWords; ++g) {
    if (g < ngroups) {
      uint32_t nxt[kBandWords];
      if (g + 1 < kBandWords && g + 1 < ngroups) {
#pragma unroll
        for (int w = 0; w <= g + 1; ++w) {
          nxt[w] = band[(w0 + w) * kStride + ((g + 1) << 5) + lane];
        }
      }
      uint32_t hit = 0u;
#pragma unroll
      for (int w = 0; w < g; ++w) hit |= row[w] & kb[w];
      const uint32_t diag = row[g];
      const uint32_t cand = __ballot_sync(kFull, hit == 0u) & free_words[g];
      // the group's own 32 x 32 triangle: the one kw with bit s = cand_s
      // and no kept suppressor in diag_s, iterated from kw = cand; a pass
      // settles every target whose suppressors are settled, the first
      // undecided one at least
      uint32_t kw = cand, prev;
      do {
        prev = kw;
        kw = __ballot_sync(kFull, (diag & prev) == 0u) & cand;
      } while (kw != prev);
      kb[g] = kw;
      if (g + 1 < kBandWords && g + 1 < ngroups) {
#pragma unroll
        for (int w = 0; w <= g + 1; ++w) row[w] = nxt[w];
      }
    }
  }

  // Hand the band's kept words to the blocks after this one, a lane a block.
  // A slot is one aligned 64-bit store that carries the word and its mark
  // together, so no fence orders it and nothing is read back.
  const int dst = r + 1 + lane;
  if (dst <= last_rank) {
    volatile unsigned long long* remote = cluster.map_shared_rank(kept, dst);
#pragma unroll
    for (int g = 0; g < kBandWords; ++g)
      remote[w0 + g] = (1ull << 32) | (unsigned long long)kb[g];
  }
#pragma unroll
  for (int g = 0; g < kBandWords; ++g) {
    const int i = b0 + (g << 5) + lane;
    if (i < k) oimg[i] = static_cast<uint8_t>((kb[g] >> lane) & 1u);
  }
  // the remote stores have landed before this block gives up its SM; this
  // comes after them and delays no reader
  __threadfence();
}

cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blocked_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSharedBytes);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3((unsigned)batch * kCluster, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = kSharedBytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
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
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      configure(&cfg, attr, batch, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, blocked_keep_kernel,
                           static_cast<const float*>(boxes),
                           static_cast<const uint8_t*>(valid),
                           static_cast<uint8_t*>(out), k, thr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The number of clusters (images) the current device holds at once.
int nms_blocked_max_active_clusters(int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(&cfg, attr, 1, nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, blocked_keep_kernel,
                                             &cfg);
}

const char* nms_blocked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
