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
// What held the band-serial, one-block-per-image form back: that form (the
// TPU kernel's banding carried over) took the same 0.84 ms for 16 images as
// for 64 on an NVIDIA H100 at 700 W (build 0.49-0.65 ms, walk 0.16-0.20
// ms): it was the latency of one block, which built a band on one SM, then
// walked it with one warp while 31 warps waited, eight times in a row, on
// 16 or 64 of the card's 132 SMs.
//
// Design: nms_band.cuh's banded walk as a cluster of 8 (the build, its two
// passes and the margins that skip the division, the prefix test, the
// per-group fixpoint walk and the pushed 64-bit hand-over are described
// there; nms_fused.cu is the same kernel as a cluster of 4). Every band is
// built at once on its own SM, so 16 images fill 128 SMs. Band r holds
// (r + 1/2)/32 of an image's pairs, so the last block builds 15 times what
// the first does; that is left as it is: band r is not needed before bands
// 0 .. r-1 are decided, so the late blocks' longer builds run beside the
// early blocks' walks, and the early blocks leave their SMs. What it costs:
// the last block's build is the kernel's span at 16 images (52 of 60
// thousand cycles on that card with class-offset boxes); tiles of equal
// pair count dealt across the cluster, read back through distributed shared
// memory, would bring that build to 4/7.5 of it.
// Shared memory of a block: boxes 32,768 + areas 8,192 + kept slots 512 +
// band 65,792 + free words, prefix end and valid bytes 292 = 107,556 B, and
// 512 threads, so that two blocks share an SM when 64 images bring 512
// blocks: an H100 then holds 30 clusters at once. Blocks of 1024 threads
// build faster with an SM to themselves (the build is bound by instruction
// rate and latency), but an H100 holds only 15 such clusters, one short of
// a batch of 16, so there is one block size.
//
// Keep rule: kept[i] iff valid[i] and no kept j < i with iou(j, i) > thr,
// areas clamped at 0, the arithmetic exact as nms_band.cuh says. Class
// offsets are applied by the caller. Inputs are assumed finite.

#include "nms_band.cuh"

namespace {

constexpr int kCluster = 8;     // blocks per image: K <= 2048
constexpr int kMinBlocks = 2;   // two blocks to an SM
const auto kKernel = nms_band::sorted_keep_kernel<kCluster, kMinBlocks>;

}  // namespace

extern "C" {

// boxes: (batch, k, 4) f32 xyxy, contiguous, on the current device.
// valid: (batch, k) bool bytes. out: (batch, k) bool bytes. 1 <= k <= 2048.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// the cudaError_t of the launch (0 on success).
int nms_blocked_greedy_keep(const void* boxes, const void* valid, void* out,
                            int batch, int k, float thr, void* stream) {
  return nms_band::launch_sorted<kCluster, kMinBlocks>(boxes, valid, out,
                                                       batch, k, thr, stream);
}

// The number of clusters (images) the current device holds at once.
int nms_blocked_max_active_clusters(int* clusters) {
  return nms_band::max_active_clusters(
      kKernel, kCluster, nms_band::sorted_shared_bytes<kCluster>(), clusters);
}

const char* nms_blocked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
