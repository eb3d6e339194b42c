// Greedy-NMS suppressor for Hopper (sm_90a): the exact greedy keep mask of
// class-offset boxes sorted by descending score, for candidate counts K up
// to 1024, one thread-block cluster of 4 blocks per image.
//
// Replaces: edgeml_tpu/ops/nms_fused.py _kernel (the Pallas TPU kernel that
// builds the whole (K, K) suppression relation in VMEM as bf16 and solves
// the greedy fixpoint with MXU matvecs). Plain PyTorch version:
// edgeml_tpu_torch/ops/nms_fused.py greedy_keep_mask_plain (the reference's
// global fixpoint); it, the blocked greedy_keep_mask_blocked_plain and this
// kernel are bit-identical. Keep rule: kept[i] iff valid[i] and no kept
// j < i with iou(j, i) > thr, areas clamped at 0.
//
// What bounds it on this card: f32 CUDA-core arithmetic. At K = 1024 each
// image has K(K-1)/2 ~ 5.2e5 IoU pairs (~15 f32 operations each, one an IEEE
// division) against ~20 KB of input and 1 KB of output, far above the memory
// roofline: 0.0075 ms for 64 images at the card's 67 TFLOP/s. The greedy
// recurrence itself is sequential in candidate order.
//
// What held the first form back. That form was one 1024-thread block per
// image, the whole relation built with every division taken, then one warp
// walking all K candidates in order (a shared load and an __any_sync each).
// Its clock64() stamps on an NVIDIA H100 at 700 W (64 images, K = 1024):
// load 0.1%, build 6%, walk 94% of a span of 0.61 M cycles; 0.31 ms a batch
// of 64 on 64 of the 132 SMs.
//
// Design: nms_blocked.cu's, from nms_band.cuh, as a cluster of 4. Block r
// owns band r (targets 256 r .. 256 r + 255) and builds its bits against
// every suppressor below the band's end in its own shared memory (four
// compares a pair, then the reference's arithmetic for the pairs that can
// overlap, or every pair straight through where most overlap, the division
// only within 2^-20 of the threshold), while the other three build theirs;
// nothing at or after the end of the valid prefix is built or walked. When
// the kept words of bands 0 .. r-1 have arrived, 256 threads test the
// band's targets against them in parallel and one warp resolves the band's
// triangle in 8 groups of 32 with a ballot fixpoint a group; the band's
// kept words are pushed into the later blocks' shared memory as {mark,
// word} 64-bit stores.
// Shared memory of a block: boxes 16,384 + areas 4,096 + kept slots 256 +
// band 32,896 + free words, prefix end and valid bytes 292 = 53,924 B, and
// 512 threads, two blocks to an SM (64 registers a thread; at three to an
// SM the build spilled and ran 45% slower): the card holds 62 clusters at
// once, so the 64 images of a YOLOv5 batch run in two waves (62 and 2).
//
// Class offsets are applied by the caller. Inputs are assumed finite.

#include "nms_band.cuh"

namespace {

constexpr int kCluster = 4;     // blocks per image: K <= 1024
constexpr int kMinBlocks = 2;
const auto kKernel = nms_band::sorted_keep_kernel<kCluster, kMinBlocks>;

}  // namespace

extern "C" {

// boxes: (batch, k, 4) f32 xyxy, contiguous, on the current device.
// valid: (batch, k) bool bytes. out: (batch, k) bool bytes. 1 <= k <= 1024.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// the cudaError_t of the launch (0 on success).
int nms_fused_greedy_keep(const void* boxes, const void* valid, void* out,
                          int batch, int k, float thr, void* stream) {
  return nms_band::launch_sorted<kCluster, kMinBlocks>(boxes, valid, out,
                                                       batch, k, thr, stream);
}

// The number of clusters (images) the current device holds at once.
int nms_fused_max_active_clusters(int* clusters) {
  return nms_band::max_active_clusters(
      kKernel, kCluster, nms_band::sorted_shared_bytes<kCluster>(), clusters);
}

const char* nms_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
