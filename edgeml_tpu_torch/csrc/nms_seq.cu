// Sequential greedy NMS for Hopper (sm_90a): the answer of the literal
// select-max / suppress loop over UNSORTED candidates, one segment (an
// image's level of RPN proposals, or one image) per thread-block cluster of
// 4 blocks, K <= 1024 per segment; above that the literal loop itself, one
// block per segment (seq_wide_kernel, at the end of this file).
//
// Replaces: edgeml_tpu/ops/nms_pallas.py _nms_kernel (the Pallas TPU kernel
// that keeps the score row, the four box planes and the alive mask in VMEM
// and runs max_det steps of argmax + IoU suppression on the VPU). Plain
// PyTorch version: edgeml_tpu_torch/ops/nms_seq.py suppress_mask_seq_plain
// (the loop itself); the two are bit-identical in kept and picks.
//
// The loop: each step picks the live candidate of largest score (the
// LOWEST index among equal maxima, as jnp.argmax does: RPN scores are
// sigmoids and many saturate to exactly 1.0), stops if nothing is live
// (score > 0), records the pick, and kills every live candidate i with
// !(iou(p, i) <= thr), the pick included; at most max_keep steps.
//
// What bounds it on this card: f32 CUDA-core arithmetic over the pairs of
// live candidates (~15 operations a pair), against ~21 KB of input a
// segment. chip_smoke.py's bound counts the loop's own work, 17 operations
// per (step, live candidate), so that it compares across designs.
//
// What held the first form back: it ran the loop as written, one
// 1024-thread block per segment, and every pick was a block-wide argmax
// with two barriers, ~1,840 cycles; the segment with the most picks (774 on
// the RPN path) set the span: clock64() stamps on an NVIDIA H100 at 700 W
// gave the pick loop 99.9% of 1.43 M cycles, 0.72 ms a batch of 16 images.
//
// The same answer in the sorted form. Let c_0, c_1, ... be the live
// candidates in key order (score descending, index ascending). The live set
// only shrinks, so the loop picks in strictly decreasing key order, and a
// candidate is picked iff it is still live when it becomes the largest,
// that is iff no earlier pick removes it: kept[c_t] iff no kept c_s, s < t,
// with R(c_s, c_t), R(p, i) = !(iou(p, i) <= thr). That is the greedy keep
// mask of the sorted candidates (the reference's own fixpoint, ops/nms.py
// suppress_mask), computed here with nms_band.cuh's banded walk, with these
// traps held exactly:
//   * the order is part of this kernel: keys (score bits << 32 | ~index,
//     distinct, positive floats ordered by their bits) are sorted in shared
//     memory; dead candidates (score <= 0 or NaN) are key 0 and sort last;
//   * the predicate is the loop's !(q <= thr), not q > thr (they differ for
//     a NaN thr: every pair suppresses, a box itself too), with the areas
//     unclamped, (x2 - x1) * (y2 - y1), and the loop's IoU op for op;
//   * sticky picks: a pick p with !R(p, p) (zero or negative width or
//     height, or thr >= 1) is never killed, so the loop picks it again at
//     every later step and nothing after it. Its relation row gets every
//     later target, so the walk keeps nothing after it, and the picks row
//     ends p, p, ..., p up to max_keep;
//   * the cap: only the first max_keep kept candidates in key order are
//     picked and kept (the reference's cumsum cap, with the sticky rule);
//     max_keep = 0 gives all-False masks.
//
// Design: every block of the cluster reads the segment's K scores and puts
// their keys in order itself. It first compacts the live keys in index
// order (a ballot and a popcount a word of 32) and checks whether they
// already descend: the RPN's candidates come from a top-k, so they do, and
// the order costs two barriers. Otherwise it sorts the keys with a bitonic
// network of 55 steps, two keys a thread in registers (shuffles for strides
// below 32, shared memory for 64 and up), which took 14-33 k cycles of the
// critical block in clock64() stamps on an NVIDIA H100 at 700 W (up to 87 k
// when the block sharing its SM builds), against 32-84 k for ranking by
// counting and 33-160 k for the network in shared memory, both tried
// first. Block r owns
// sorted positions 256 r .. 256 r + 255: it loads the boxes and original
// indices of every position below its band's end, computes the areas and
// the sticky bits, builds its band's relation bits against every earlier
// position (nms_band.cuh: the exact predicate where boxes can overlap, the
// division only within 2^-20 of the threshold; sticky rows OR-ed in), waits for the kept words of bands
// 0 .. r-1, tests its targets against them in parallel, resolves its own
// triangle with the per-group ballot fixpoint, applies the cap (the picks
// before it are the popcount of the words that arrived), pushes its capped
// kept words to the later blocks, and writes its kept flags at the original
// indices and its picks at their pick numbers. The block of the last live
// band writes the tail of picks: -1, or the sticky last pick. Blocks past
// the live prefix exit after the cluster barrier. All segments of a batch
// run in one launch (RPN: images x 5 levels).
// Shared memory of a block: sorted boxes 16,384 + band 32,896 (the sort
// keys live there first) + areas 4,096 + original indices 4,096 + kept
// slots 256 + sticky words 128 + free words and live count 36 = 57,892 B,
// and 512 threads, two blocks to an SM (64 registers a thread; at three to
// an SM, 40 registers, it spilled and an RPN batch took 0.171 ms against
// 0.127 at two, with the earlier sort in shared memory): the card holds 62
// clusters at once, so the 80 segments of an RPN batch of 16 run in two
// waves.
//
// Inputs are assumed finite.

#include <math_constants.h>

#include "nms_band.cuh"

namespace {

using namespace nms_band;

constexpr int kCluster = 4;
constexpr int kMaxK = kCluster * kBand;  // 1024
constexpr int kMaxWords = kMaxK / 32;    // 32
constexpr int kMinBlocks = 2;            // two blocks to an SM
constexpr size_t kBandBytes = (size_t)kMaxWords * kStride * 4;
constexpr size_t kSharedBytes = (size_t)kMaxK * 16 + kBandBytes +
                                (size_t)kMaxK * 4 + (size_t)kMaxK * 4 +
                                kMaxWords * 8 + kMaxWords * 4 +
                                kBandWords * 4 + 4;

static_assert((size_t)kMaxK * 16 + kMaxWords * 8 <= kBandBytes,
              "the keys and their counts fit in the band's memory");
static_assert(kMaxK == 2 * kThreads, "a thread holds two sort keys");

__global__ void __launch_bounds__(kThreads, kMinBlocks)
seq_keep_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores,
                uint8_t* __restrict__ kept_out, int32_t* __restrict__ picks,
                int k, int max_keep, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);  // by sorted position
  uint32_t* band = reinterpret_cast<uint32_t*>(sbox + kMaxK);
  // before the build, the band's memory holds the keys in index order, the
  // live keys compacted, and the live counts of each word of 32
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(band);
  unsigned long long* compact = keys + kMaxK;
  uint32_t* live_words = reinterpret_cast<uint32_t*>(compact + kMaxK);
  int* live_before = reinterpret_cast<int*>(live_words + kMaxWords);
  float* area = reinterpret_cast<float*>(band + kMaxWords * kStride);
  int* sidx = reinterpret_cast<int*>(area + kMaxK);  // original index
  unsigned long long* kept =  // {1, word} of each band before this one
      reinterpret_cast<unsigned long long*>(sidx + kMaxK);
  uint32_t* sticky = reinterpret_cast<uint32_t*>(kept + kMaxWords);
  uint32_t* free_words = sticky + kMaxWords;  // kBandWords
  int* live_count = reinterpret_cast<int*>(free_words + kBandWords);

  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const size_t seg = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* sc = scores + seg * (size_t)k;
  const float* bx = boxes + seg * (size_t)k * 4;
  uint8_t* kout = kept_out + seg * (size_t)k;
  int32_t* pout = picks + seg * (size_t)max_keep;

  if (tid < kMaxWords) kept[tid] = 0ull;
  // Keys: a live candidate beats another iff its key is larger (positive
  // floats order as their bits; the lower index wins a tie); dead ones are
  // 0 and beat nothing. Padded with 0 to kMaxK. Block r also clears the
  // kept flags of the candidates 256 r .. 256 r + 255 that are never
  // picked.
  for (int i = tid; i < kMaxK; i += kThreads) {
    unsigned long long key = 0ull;
    if (i < k) {
      const float s = sc[i];
      if (s > 0.0f) {
        key = ((unsigned long long)__float_as_uint(s) << 32) |
              (unsigned long long)(0xffffffffu - (unsigned)i);
      }
      if ((key == 0ull || max_keep == 0) && (i >> 8) == r) kout[i] = 0;
    }
    keys[i] = key;
    const uint32_t word = __ballot_sync(kFull, key != 0ull);
    if (lane == 0) live_words[i >> 5] = word;
  }
  __syncthreads();
  if (warp == 0) {  // live candidates before each word of 32
    const int c = __popc(live_words[lane]);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += n;
    }
    live_before[lane] = incl - c;
    if (lane == 31) *live_count = incl;
  }
  __syncthreads();
  const int ke = max_keep > 0 ? *live_count : 0;  // sorted positions built
  // every block of the cluster is resident and has cleared its kept slots
  cluster.sync();

  const int b0 = r * kBand;
  if (b0 >= ke) {
    if (r == 0) {  // nothing live: no pick
      for (int s = tid; s < max_keep; s += kThreads) pout[s] = -1;
    }
    return;
  }
  const int nb = min(kBand, ke - b0);  // targets of this band
  const int below = b0 + nb;           // suppressors j < below
  const int w0 = r * kBandWords;       // first word of the band itself
  const int last_rank = (ke - 1) / kBand;

  // The live keys in index order (a live candidate's position is the number
  // of live candidates before it). The RPN's candidates come from a top-k,
  // so these usually are in key order already; then they are the order.
  for (int i = tid; i < kMaxK; i += kThreads) {
    const uint32_t word = live_words[i >> 5];
    const uint32_t below_i = word & ((1u << (i & 31)) - 1u);
    if ((word >> (i & 31)) & 1u)
      compact[live_before[i >> 5] + __popc(below_i)] = keys[i];
  }
  __syncthreads();
  bool in_order = true;
  for (int p = tid; p + 1 < ke; p += kThreads)
    in_order &= compact[p] > compact[p + 1];
  const unsigned long long* order = compact;
  if (!__syncthreads_and(in_order)) {
    // Else a bitonic sort of the kMaxK keys, descending: sorted positions
    // 0 .. ke-1 are the live candidates in key order. Thread (warp w, lane
    // l) holds positions 64 w + l and 64 w + 32 + l in registers; of the 55
    // steps, the 10 with a stride of 64 or more exchange through shared
    // memory, stride 32 pairs a thread's own two keys, and smaller strides
    // pair lanes by shuffles.
    const int e0 = (warp << 6) + lane;
    unsigned long long v0 = keys[e0], v1 = keys[e0 + 32];
    for (int size = 2; size <= kMaxK; size <<= 1) {
      const bool desc0 = (e0 & size) == 0, desc1 = ((e0 + 32) & size) == 0;
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (stride >= 64) {
          keys[e0] = v0;
          keys[e0 + 32] = v1;
          __syncthreads();
          const int a = 2 * tid - (tid & (stride - 1));  // a pair a thread
          const unsigned long long ka = keys[a], kb = keys[a + stride];
          if ((a & size) == 0 ? ka < kb : ka > kb) {
            keys[a] = kb;
            keys[a + stride] = ka;
          }
          __syncthreads();
          v0 = keys[e0];
          v1 = keys[e0 + 32];
        } else if (stride == 32) {
          if (desc0 ? v0 < v1 : v0 > v1) {
            const unsigned long long t = v0;
            v0 = v1;
            v1 = t;
          }
        } else {
          // the lower position of a pair keeps the larger key in a
          // descending run, the smaller in an ascending one
          const bool lower = (lane & stride) == 0;
          const unsigned long long p0 = __shfl_xor_sync(kFull, v0, stride);
          const unsigned long long p1 = __shfl_xor_sync(kFull, v1, stride);
          v0 = lower == desc0 ? max(v0, p0) : min(v0, p0);
          v1 = lower == desc1 ? max(v1, p1) : min(v1, p1);
        }
      }
    }
    keys[e0] = v0;
    keys[e0 + 32] = v1;
    __syncthreads();
    order = keys;
  }

  // The boxes, areas and original indices of the sorted positions below
  // the band's end, and the sticky positions: those that R does not remove
  // themselves (a warp a word).
  const Threshold th = make_threshold(thr);
  for (int p = tid; p < ((below + 31) & ~31); p += kThreads) {
    bool st = false;
    if (p < below) {
      const int i = (int)(0xffffffffu - (unsigned)order[p]);
      const float4 b = make_float4(bx[4 * i], bx[4 * i + 1], bx[4 * i + 2],
                                   bx[4 * i + 3]);
      const float a = area_signed(b.x, b.y, b.z, b.w);
      sbox[p] = b;
      area[p] = a;
      sidx[p] = i;
      st = !suppresses<true>(b, a, b, a, th);
    }
    const uint32_t word = __ballot_sync(kFull, st);
    if (lane == 0) sticky[p >> 5] = word;
  }
  __syncthreads();

  build_band<true, true>(sbox, area, band, sticky, b0, nb, w0, thr);
  __syncthreads();
  wait_prefix(kept, w0);
  prefix_test(band, kept, w0, tid < nb, free_words);
  __syncthreads();
  if (warp != 0) return;

  uint32_t kb[kBandWords];
  walk_band(band, w0, (nb + 31) >> 5, free_words, kb);
  // The cap: the picks before this band are the kept bits that arrived;
  // this band's follow in order up to max_keep.
  int before = lane < w0 ? __popc((uint32_t)kept[lane]) : 0;
  before = __reduce_add_sync(kFull, before);
  int room = max_keep - before;
#pragma unroll
  for (int g = 0; g < kBandWords; ++g) {
    uint32_t w = room > 0 ? kb[g] : 0u;
    while (__popc(w) > room) w &= ~(0x80000000u >> __clz(w));
    kb[g] = w;
    room -= __popc(w);
  }
  push_kept(cluster, kept, r, last_rank, kb);

  int n = before;  // pick number of the group's first kept position
  int last = -1;   // the band's last kept position
#pragma unroll
  for (int g = 0; g < kBandWords; ++g) {
    const int p = b0 + (g << 5) + lane;
    if (p < below) {
      const int orig = sidx[p];
      const uint32_t bit = (kb[g] >> lane) & 1u;
      kout[orig] = static_cast<uint8_t>(bit);
      if (bit) pout[n + __popc(kb[g] & ((1u << lane) - 1u))] = orig;
    }
    n += __popc(kb[g]);
    if (kb[g] != 0u) last = b0 + (g << 5) + 31 - __clz(kb[g]);
  }
  if (r == last_rank && n < max_keep) {
    // The loop ran out of live candidates after n picks, or its last pick
    // is sticky and is picked at every remaining step.
    for (int w = w0 - 1; w >= 0 && last < 0; --w) {
      const uint32_t word = (uint32_t)kept[w];
      if (word != 0u) last = (w << 5) + 31 - __clz(word);
    }
    const int fill =
        last >= 0 && ((sticky[last >> 5] >> (last & 31)) & 1u) ? sidx[last]
                                                                : -1;
    for (int s = n + lane; s < max_keep; s += 32) pout[s] = fill;
  }
  // the remote stores have landed before this block gives up its SM
  __threadfence();
}


// ---------------------------------------------------------------------------
// K > 1024: the literal loop, one block of 1024 threads per segment.
//
// The reference's Pallas kernel takes any K. Above the cluster kernel's 1024
// this form runs the loop as written (the first form's design, widened):
// thread t owns candidates t, t + 1024, t + 2048, ... (ceil(K / 1024) of
// them); each step is an argmax on the key (score descending, index ascending)
// over the live candidates, first over a thread's own in index order, then
// across the warp with shuffles and across the 32 warp winners in warp 0, two
// barriers a step, then each thread updates its own candidates. A candidate's
// state lives in its byte of the kept output (bit 0 live, bit 1 picked) and
// only its owner touches it; the last pass leaves the picked bit. The boxes
// and areas are in shared memory while they fit (20 bytes a candidate, up to
// kWideSmemK candidates) and are read from global memory above that, the
// pick's area computed again by the same ops. Bounded by the serial steps:
// each costs one block-wide argmax over K / 1024 candidates a thread and two
// barriers, as the first form's did.

constexpr int kWideThreads = 1024;
constexpr int kWideSmemK = 10240;  // 200 KB of boxes and areas

__device__ __forceinline__ void wide_take(float& v, int& j, float ov, int oj) {
  if (ov > v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

__device__ __forceinline__ void wide_warp_argmax(float& v, int& j) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oj = __shfl_down_sync(kFull, j, off);
    wide_take(v, j, ov, oj);
  }
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__global__ void __launch_bounds__(kWideThreads)
seq_wide_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores, uint8_t* __restrict__ kept,
                int32_t* __restrict__ picks, int k, int max_keep, float thr,
                bool boxes_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + (boxes_in_smem ? k : 0));
  __shared__ float wval[32];
  __shared__ int widx[32];
  __shared__ float pick_val;
  __shared__ int pick_idx;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t seg = blockIdx.x;
  const float* sc = scores + seg * (size_t)k;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + seg * (size_t)k;
  uint8_t* state = kept + seg * (size_t)k;
  int32_t* pout = picks + seg * (size_t)max_keep;

  for (int i = t; i < k; i += kWideThreads) {
    state[i] = sc[i] > 0.0f ? 1 : 0;
    if (boxes_in_smem) {
      const float4 b = bx[i];
      sbox[i] = b;
      sarea[i] = box_area(b);
    }
  }
  int step = 0;
  for (; step < max_keep; ++step) {
    float v = -CUDART_INF_F;
    int j = k;
    for (int i = t; i < k; i += kWideThreads) {
      if (state[i] & 1) wide_take(v, j, sc[i], i);
    }
    wide_warp_argmax(v, j);
    if (lane == 0) {
      wval[warp] = v;
      widx[warp] = j;
    }
    __syncthreads();  // warp winners (and, at step 0, the shared boxes)
    if (warp == 0) {
      v = wval[lane];
      j = widx[lane];
      wide_warp_argmax(v, j);
      if (lane == 0) {
        pick_val = v;
        pick_idx = j;
      }
    }
    __syncthreads();  // the pick
    const float m = pick_val;
    const int p = pick_idx;
    if (!(m > 0.f)) break;  // uniform: every thread read the same m
    if (t == 0) pout[step] = p;
    const float4 pb = boxes_in_smem ? sbox[p] : bx[p];
    const float parea = boxes_in_smem ? sarea[p] : box_area(pb);
    for (int i = t; i < k; i += kWideThreads) {
      uint8_t st = state[i];
      if (!(st & 1)) continue;
      const float4 b = boxes_in_smem ? sbox[i] : bx[i];
      const float area = boxes_in_smem ? sarea[i] : box_area(b);
      const float ix1 = fmaxf(pb.x, b.x);
      const float iy1 = fmaxf(pb.y, b.y);
      const float ix2 = fminf(pb.z, b.z);
      const float iy2 = fminf(pb.w, b.w);
      const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.f),
                                    fmaxf(__fsub_rn(iy2, iy1), 0.f));
      const float denom =
          fmaxf(__fsub_rn(__fadd_rn(parea, area), inter), 1e-12f);
      if (i == p) st |= 2;
      if (!(__fdiv_rn(inter, denom) <= thr)) st &= 2;
      state[i] = st;
    }
  }
  for (int s = step + t; s < max_keep; s += kWideThreads) pout[s] = -1;
  for (int i = t; i < k; i += kWideThreads) state[i] = state[i] >> 1;
}

}  // namespace

extern "C" {

// boxes: (segments, k, 4) f32 xyxy, contiguous, on the current device.
// scores: (segments, k) f32; entries <= 0 never participate.
// kept: (segments, k) bool bytes. picks: (segments, max_keep) int32, the
// picked indices in pick order, -1 after the last pick. 1 <= k <= 1024.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch (0 on success).
int nms_seq_suppress(const void* boxes, const void* scores, void* kept,
                     void* picks, int segments, int k, int max_keep,
                     float thr, void* stream) {
  if (segments < 0 || k < 1 || k > kMaxK || max_keep < 0)
    return (int)cudaErrorInvalidValue;
  if (segments == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      configure(seq_keep_kernel, kCluster, kSharedBytes, &cfg, attr,
                segments, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, seq_keep_kernel,
                           static_cast<const float*>(boxes),
                           static_cast<const float*>(scores),
                           static_cast<uint8_t*>(kept),
                           static_cast<int32_t*>(picks), k, max_keep, thr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The same contract for any k >= 1 (the literal loop, one block of 1024
// threads per segment): meant for k > 1024, which the entry point above
// refuses.
int nms_seq_suppress_wide(const void* boxes, const void* scores, void* kept,
                          void* picks, int segments, int k, int max_keep,
                          float thr, void* stream) {
  if (segments < 0 || k < 1 || max_keep < 0)
    return (int)cudaErrorInvalidValue;
  if (segments == 0) return 0;
  const bool in_smem = k <= kWideSmemK;
  const size_t smem = in_smem ? (size_t)k * 20 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      seq_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kWideSmemK * 20));
  if (err != cudaSuccess) return (int)err;
  seq_wide_kernel<<<segments, kWideThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(kept), static_cast<int32_t*>(picks), k, max_keep,
      thr, in_smem);
  return (int)cudaGetLastError();
}

// The number of clusters (segments) the current device holds at once.
int nms_seq_max_active_clusters(int* clusters) {
  return max_active_clusters(seq_keep_kernel, kCluster, kSharedBytes,
                             clusters);
}

const char* nms_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
