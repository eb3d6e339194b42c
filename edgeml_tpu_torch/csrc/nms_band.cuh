// Banded greedy-NMS building blocks for Hopper (sm_90a), shared by the three
// suppressor kernels of this directory: nms_fused.cu (K <= 1024, a cluster
// of 4 blocks per image), nms_blocked.cu (K <= 2048, a cluster of 8) and
// nms_seq.cu (unsorted RPN segments, K <= 1024, a cluster of 4).
//
// The greedy keep mask of candidates in a fixed order (here: sorted
// positions 0, 1, 2, ...) is
//
//     kept[i] = cand[i] && no kept j < i with R(j, i),
//
// where R is the suppression relation. It is computed in bands of 256
// positions, one block of a thread-block cluster per band:
//
//   Build (build_band). Block r builds the relation bits of its 256 targets
//   against every suppressor below the band's end, in its own shared memory,
//   at the same time as the other blocks build theirs. A warp takes 32
//   consecutive targets (their boxes in registers) and one word of 32
//   suppressors (one broadcast 16-byte load a suppressor). Words are stored
//   word-major with a row stride of 257, so lanes write consecutive banks
//   and the walk reads distinct banks. A word is built in two passes: four
//   compares a pair mark the suppressors whose box can meet the target's in
//   both axes (a superset of the pairs with a positive intersection); for
//   every other pair the intersection is +-0, the quotient +-0, and both
//   predicates below are false for every thr >= 0, so its bit is 0 with
//   nothing computed (for thr < 0 or a NaN thr every pair is marked). The
//   marked pairs alone get the reference's arithmetic, and of those only
//   the ones within 2^-20 of the threshold take the division (suppresses()).
//   Where most pairs overlap (boxes of one class, an RPN level's proposals)
//   the first pass rejects nothing and the per-pair loop diverges across
//   lanes, so a warp whose last word had a lane with half its pairs marked
//   takes the next word straight through: all 32 pairs with the margins,
//   the division only for the pairs they leave undecided. A disjoint pair
//   needs no first pass there: its inter = 0 is below lo denom, so false.
//   Band r holds (r + 1/2) / (2 x cluster) of an image's pairs; late bands
//   are needed late, so their longer builds overlap the early walks.
//
//   Prefix test (wait_prefix, prefix_test). Block r waits for the kept
//   words of bands 0 .. r-1, which the earlier blocks push into its shared
//   memory, then 256 threads test its 256 targets against them in parallel
//   (one AND-OR reduction a target, one ballot a word).
//
//   Walk (walk_band). One warp resolves the band's own 256 x 256 triangle in
//   8 groups of 32 targets, a lane a target: the group's rows against the
//   band's earlier kept words in parallel (loaded a group ahead), and its
//   32 x 32 diagonal as the fixpoint kw = cand & ~hit(kw) iterated from
//   kw = cand by ballots (a pass settles every target whose suppressors are
//   settled, so it ends after the longest suppression chain of the group, a
//   few passes, and at most 33).
//
//   Hand-over (push_kept). Block r writes its 8 kept words into the shared
//   memory of the blocks after it (distributed shared memory), each as one
//   aligned 64-bit store that carries the word and a mark, so no fence or
//   counter orders anything; a thread a word of the receiving block spins
//   on its own slot until the mark is there. Blocks push and never read
//   remote memory, so a block may exit as soon as its stores have landed.
//   One cluster barrier before the first remote write makes sure every
//   block is resident and has cleared its slots.
//
// Exact arithmetic: IoU is evaluated op for op as in the reference with
// explicitly rounded intrinsics (min/max, subtract, clamp, multiply, add,
// subtract, clamp at 1e-12, IEEE divide, compare with the f32-rounded
// threshold) wherever the outcome is not certain without it; the library
// is built with -fmad=false and without --use_fast_math. Inputs are assumed
// finite (fminf/fmaxf do not propagate NaN). Two predicates:
//   q > thr        the sorted suppressors' reference (nms_fused.py), and
//   !(q <= thr)    the sequential loop's (nms_pallas.py), which differs only
//                  for a NaN thr: every pair suppresses, a box itself too.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nms_band {

namespace cg = cooperative_groups;

constexpr int kBand = 256;              // targets of a block
constexpr int kBandWords = kBand / 32;  // 8
constexpr int kStride = kBand + 1;      // padded row of the band
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBandWords == 8, "the build splits an item as (q >> 3, q & 7)");

// max(x2 - x1, 0) * max(y2 - y1, 0): the sorted suppressors' area.
__device__ __forceinline__ float area_clamped(float x1, float y1, float x2,
                                             float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// (x2 - x1) * (y2 - y1), unclamped: the sequential loop's area.
__device__ __forceinline__ float area_signed(float x1, float y1, float x2,
                                            float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
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

// R(s, t): fl(inter / denom) > thr (kNotLessEq false) or !(fl(inter /
// denom) <= thr) (kNotLessEq true), with the reference's op order for inter
// and denom. The division is skipped where its outcome is certain. With
// the exact quotient x = inter / denom (denom >= 1e-12 > 0, whatever the
// sign of the areas), rounding is monotone and thr is a float, so fl(x) >
// thr iff x reaches the float above thr (up to the rounding of the
// midpoint), and fl(x) <= thr whenever x <= thr. hi = fl(fl(thr (1 +
// 2^-21)) denom) carries two roundings of at most 2^-24 each, so inter > hi
// gives x > thr (1 + 2^-21)(1 - 2^-24)^2 > thr (1 + 2^-22) >= thr + 2
// ulp(thr): true. lo = fl(fl(thr (1 - 2^-21)) denom) likewise gives, for
// inter < lo, x < thr (1 - 2^-21)(1 + 2^-24)^2 < thr: false. The margins
// are used only for thr in [1e-9, 1e9], where thr is not NaN and q is
// never NaN, so the two predicates agree there. Inside the band of
// relative width 2^-20 around thr denom, outside that range of thr, and for
// a NaN thr, the IEEE division is taken; a product that overflows to +inf
// makes both compares say what the division would (x < thr).
template <bool kNotLessEq>
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
  const float q = __fdiv_rn(inter, denom);
  return kNotLessEq ? !(q <= th.thr) : q > th.thr;
}

// Build: a warp per (word w, group tg): bit s of band[w][32 tg + lane] is
// set iff j = 32 w + s < i = b0 + 32 tg + lane and R(j, i). The items are
// the full words below the band (every group) and the triangle w0 <= w <=
// w0 + tg of the band's own words, dealt round robin. With kSticky, the
// bits of `sticky` (suppressors that R does not remove themselves) are set
// in every later target's row as well. sbox and area hold every position
// below b0 + nb; rows at or past it in the band's last word are read as
// they lie in shared memory and masked off by j < i.
template <bool kNotLessEq, bool kSticky>
__device__ __forceinline__ void build_band(const float4* sbox,
                                           const float* area, uint32_t* band,
                                           const uint32_t* sticky, int b0,
                                           int nb, int w0, float thr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ngroups = (nb + 31) >> 5;
  // disjoint pairs have quotient +-0, which suppresses under neither
  // predicate for thr >= 0 (false for a NaN thr)
  const bool skip_disjoint = thr >= 0.0f;
  const Threshold th = make_threshold(thr);
  const int nfull = w0 * kBandWords;
  const int nitems = nfull + ngroups * (ngroups + 1) / 2;
  bool dense = false;  // this warp's last word: most pairs could overlap
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
    const int j0 = w << 5;
    uint32_t bits = 0u;
    int marked = 0;  // pairs that could overlap (the lane's, this word)
    if (il < nb) {
      const float4 t = sbox[b0 + il];
      const float t_area = area[b0 + il];
      // the diagonal word: j0 = b0 + 32 tg, so j < i iff s < lane
      const uint32_t earlier = w == w0 + tg ? (1u << lane) - 1u : kFull;
      uint32_t todo;  // the pairs that take the exact predicate
      if (dense) {
        // Most pairs overlap: every pair straight through, the margins
        // deciding it (a disjoint pair has inter = 0 < lo denom: false, as
        // the first pass would have it).
        uint32_t ge_lo = 0u, overlap = 0u;
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          const float4 sj = sbox[j0 + s];
          const float ix = __fsub_rn(fminf(sj.z, t.z), fmaxf(sj.x, t.x));
          const float iy = __fsub_rn(fminf(sj.w, t.w), fmaxf(sj.y, t.y));
          const float inter = __fmul_rn(fmaxf(ix, 0.0f), fmaxf(iy, 0.0f));
          const float denom = fmaxf(
              __fsub_rn(__fadd_rn(area[j0 + s], t_area), inter), 1e-12f);
          bits |= (uint32_t)(inter > __fmul_rn(th.hi, denom)) << s;
          ge_lo |= (uint32_t)(inter >= __fmul_rn(th.lo, denom)) << s;
          overlap |= (uint32_t)(inter > 0.0f) << s;
        }
        bits &= earlier;
        todo = ge_lo & ~bits & earlier;
        marked = __popc(overlap & earlier);
      } else {
        // First, without a branch, the suppressors whose box can meet the
        // target's in both axes (four compares): a superset of those with
        // intersection > 0. fl(min(x2) - max(x1)) > 0 needs each x2 above
        // the other box's x1, and likewise in y; for every other pair one
        // clamped side is 0, so the intersection is +-0.
        uint32_t m = 0u;
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          const float4 sj = sbox[j0 + s];
          m |= (uint32_t)(sj.z > t.x && t.z > sj.x && sj.w > t.y &&
                          t.w > sj.y) << s;
        }
        if (!skip_disjoint) m = kFull;
        todo = m & earlier;
        marked = __popc(todo);
      }
      // Then the exact predicate of those alone.
      while (todo != 0u) {
        const int s = __ffs(todo) - 1;
        todo &= todo - 1u;
        bits |= (uint32_t)suppresses<kNotLessEq>(sbox[j0 + s], area[j0 + s],
                                                 t, t_area, th) << s;
      }
      if (kSticky) bits |= sticky[w] & earlier;
    }
    band[w * kStride + il] = bits;
    // straight through pays off when some lane has half its pairs marked;
    // it needs the margins
    dense = th.margins && __reduce_max_sync(kFull, marked) >= 16;
  }
}

// The kept words of bands 0 .. r-1 (r = w0 / 8), pushed here by their
// blocks: a thread a word waits for its slot to be marked. Ends with a
// barrier when there is anything to wait for.
__device__ __forceinline__ void wait_prefix(const unsigned long long* kept,
                                            int w0) {
  if ((int)threadIdx.x < w0) {
    const volatile unsigned long long* slot = kept + threadIdx.x;
    while ((*slot >> 32) == 0ull) {
    }
  }
  if (w0 > 0) __syncthreads();
}

// Prefix test: a thread per target against the decided bands. free_words
// gets, for each group of 32 targets, the candidates (cand_t) that no kept
// suppressor of an earlier band removes. Threads 0 .. 255 only.
__device__ __forceinline__ void prefix_test(const uint32_t* band,
                                            const unsigned long long* kept,
                                            int w0, bool cand_t,
                                            uint32_t* free_words) {
  const int tid = threadIdx.x;
  if (tid < kBand) {
    uint32_t hit = 0u;
#pragma unroll 8
    for (int w = 0; w < w0; ++w)
      hit |= band[w * kStride + tid] & (uint32_t)kept[w];
    const uint32_t fw = __ballot_sync(kFull, cand_t && hit == 0u);
    if ((tid & 31) == 0) free_words[tid >> 5] = fw;
  }
}

// Walk the band's own triangle, 32 targets at a time, a lane a target; one
// warp. kb receives the band's kept words, the same in every lane.
__device__ __forceinline__ void walk_band(const uint32_t* band, int w0,
                                          int ngroups,
                                          const uint32_t* free_words,
                                          uint32_t (&kb)[kBandWords]) {
  const int lane = threadIdx.x & 31;
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
}

// Hand the band's kept words to the blocks r + 1 .. last_rank, a lane a
// block; one warp. A slot is one aligned 64-bit store that carries the word
// and its mark together, so no fence orders it and nothing is read back.
__device__ __forceinline__ void push_kept(cg::cluster_group& cluster,
                                          unsigned long long* kept, int r,
                                          int last_rank,
                                          const uint32_t (&kb)[kBandWords]) {
  const int dst = r + 1 + (int)(threadIdx.x & 31);
  if (dst <= last_rank) {
    volatile unsigned long long* remote = cluster.map_shared_rank(kept, dst);
#pragma unroll
    for (int g = 0; g < kBandWords; ++g)
      remote[r * kBandWords + g] = (1ull << 32) | (unsigned long long)kb[g];
  }
}

// ---- the sorted suppressor: class-offset boxes sorted by descending score,
// a cluster of kCluster blocks per image, K <= 256 kCluster ----------------

template <int kCluster>
constexpr size_t sorted_shared_bytes() {
  constexpr int kMaxK = kCluster * kBand;
  constexpr int kMaxWords = kMaxK / 32;
  return (size_t)kMaxK * 16 + (size_t)kMaxK * 4 +
         (size_t)kMaxWords * kStride * 4 + kMaxWords * 8 + kBandWords * 4 +
         4 + kBand;
}

// Shared memory of a block: boxes 16 K + areas 4 K + kept slots 8 K/32 +
// band 32 x 257 x K/1024 ... (K = 256 kCluster); see sorted_shared_bytes().
template <int kCluster, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sorted_keep_kernel(const float* __restrict__ boxes,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ out, int k, float thr) {
  constexpr int kMaxK = kCluster * kBand;
  constexpr int kMaxWords = kMaxK / 32;
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
  const int w0 = r * kBandWords;         // first word of the band itself
  const int last_rank = (ke - 1) / kBand;

  const float* bx = boxes + img * (size_t)k * 4;
  for (int i = tid; i < below; i += kThreads) {
    const float a = bx[4 * i], b = bx[4 * i + 1];
    const float c = bx[4 * i + 2], d = bx[4 * i + 3];
    sbox[i] = make_float4(a, b, c, d);
    area[i] = area_clamped(a, b, c, d);
  }
  if (tid < kBand) vld[tid] = tid < nb ? vimg[b0 + tid] : (uint8_t)0;
  __syncthreads();

  build_band<false, false>(sbox, area, band, nullptr, b0, nb, w0, thr);
  __syncthreads();
  wait_prefix(kept, w0);
  prefix_test(band, kept, w0, tid < kBand && vld[tid] != 0, free_words);
  __syncthreads();
  if (warp != 0) return;

  uint32_t kb[kBandWords];
  walk_band(band, w0, (nb + 31) >> 5, free_words, kb);
  push_kept(cluster, kept, r, last_rank, kb);
#pragma unroll
  for (int g = 0; g < kBandWords; ++g) {
    const int i = b0 + (g << 5) + lane;
    if (i < k) oimg[i] = static_cast<uint8_t>((kb[g] >> lane) & 1u);
  }
  // the remote stores have landed before this block gives up its SM; this
  // comes after them and delays no reader
  __threadfence();
}

// Launch configuration of a cluster kernel: kCluster blocks per item.
template <typename Kernel>
cudaError_t configure(Kernel kernel, int cluster, size_t smem,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int items, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3((unsigned)items * cluster, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The number of clusters (items) the current device holds at once.
template <typename Kernel>
int max_active_clusters(Kernel kernel, int cluster, size_t smem,
                        int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(kernel, cluster, smem, &cfg, attr, 1, nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// Launch the sorted suppressor: boxes (batch, k, 4) f32 xyxy, valid and out
// (batch, k) bool bytes, 1 <= k <= 256 kCluster.
template <int kCluster, int kMinBlocks>
int launch_sorted(const void* boxes, const void* valid, void* out, int batch,
                  int k, float thr, void* stream) {
  if (batch < 0 || k < 1 || k > kCluster * kBand)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  auto kernel = sorted_keep_kernel<kCluster, kMinBlocks>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(kernel, kCluster,
                              sorted_shared_bytes<kCluster>(), &cfg, attr,
                              batch, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(boxes),
                           static_cast<const uint8_t*>(valid),
                           static_cast<uint8_t*>(out), k, thr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace nms_band
