// Greedy NMS for Hopper (sm_90a), one block a row, with no wait on the host.
//
// The JAX package's NMS is XLA, not a Pallas kernel: the fixed point of
//   keep[i] = valid[i] and not any(j < i, keep[j], iou(j, i) > threshold)
// over boxes sorted by score, iterated to convergence
// (objectpermanence_tpu/ops/nms.py::nms_mask). Greedy NMS is that fixed
// point, and it is unique, so this kernel walks the boxes in order once:
// box i is kept when no kept box before it overlaps it. The plain version,
// ops/nms.py::_fixed_point, iterates instead and needs the host to look at
// the rows once a round; this kernel needs nothing of the host.
//
// Design. One block of kThreads threads a row (an image and level of the
// RPN, an image of the class NMS). The boxes go in blocks of 64, a word of
// bits:
//  1. All threads fill a shared tile: for each box i of the block and each
//     word w from the block's own on, the bits of the boxes k = 64w + t,
//     k > i, that box i overlaps. A warp's lanes take consecutive i and one
//     w, so they read the same box k at once.
//  2. Warp 0 walks the block's 64 boxes. `removed` (shared, a word each 64
//     boxes) starts with the invalid boxes and those past the row; box i is
//     kept when its bit is clear, and then box i's tile words are ORed into
//     the later blocks' words, each word by one lane. The block's own word
//     is held in a register by every lane, so the walk reads no word that
//     a lane writes.
// A row costs about N^2/2 IoUs and N steps of one warp; nothing in it depends
// on how many boxes suppress.
//
// The IoU is ops/boxes.py::pairwise_iou_xyxy's, operation by operation, in
// float32 with each rounding where PyTorch's elementwise kernels round (no
// contraction into fused multiply-adds, IEEE division), so the keep mask is
// the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // 227 KB: the most shared memory a block may have

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// pairwise_iou_xyxy(a, b) > threshold
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float threshold) {
  const float xa = fmaxf(a.x, b.x), ya = fmaxf(a.y, b.y);
  const float xb = fminf(a.z, b.z), yb = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(xb, xa), 0.f), fmaxf(__fsub_rn(yb, ya), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area(b)), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  return iou > threshold;
}

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep, int n, int words, float threshold) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;          // words
  unsigned long long* tile = smem + words;     // 64 x words, row r at r * words
  const float4* row_boxes = boxes + (size_t)blockIdx.x * n;
  const uint8_t* row_valid = valid + (size_t)blockIdx.x * n;
  uint8_t* row_keep = keep + (size_t)blockIdx.x * n;
  const int lane = threadIdx.x & 31;

  for (int w = threadIdx.x; w < words; w += kThreads) {
    unsigned long long bits = 0;
    for (int t = 0; t < 64; ++t) {
      const int k = 64 * w + t;
      if (k >= n || !row_valid[k]) bits |= 1ull << t;
    }
    removed[w] = bits;
  }

  for (int block = 0; block < words; ++block) {
    const int span = words - block;  // the words of boxes from this block on
    for (int item = threadIdx.x; item < 64 * span; item += kThreads) {
      const int r = item & 63, w = block + (item >> 6);
      const int i = 64 * block + r;
      unsigned long long bits = 0;
      if (i < n) {
        const float4 a = row_boxes[i];
        const float area_a = area(a);
        const int first = max(64 * w, i + 1), last = min(64 * w + 64, n);
        for (int k = first; k < last; ++k)
          if (overlaps(a, area_a, row_boxes[k], threshold)) bits |= 1ull << (k - 64 * w);
      }
      tile[r * words + w] = bits;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      unsigned long long own = removed[block];
      const int rows = min(64, n - 64 * block);
      for (int r = 0; r < rows; ++r) {
        const bool kept = !((own >> r) & 1ull);
        if (lane == 0) row_keep[64 * block + r] = kept;
        if (kept) {
          const unsigned long long* bits = tile + r * words;
          own |= bits[block];
          for (int w = block + 1 + lane; w < words; w += 32) removed[w] |= bits[w];
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

size_t smem_bytes(int words) { return sizeof(unsigned long long) * (size_t)words * 65; }

}  // namespace

// The largest row the kernel takes: its tile and words fit a block's shared memory.
extern "C" int nms_greedy_max_boxes() {
  int words = 1;
  while (smem_bytes(words + 1) <= (size_t)kSmemLimit) ++words;
  return 64 * words;
}

// boxes (rows, n, 4) float32 xyxy, sorted by score within each row; valid
// (rows, n) uint8; keep (rows, n) uint8, written whole: 1 where greedy NMS
// keeps the box. All device pointers, contiguous.
extern "C" int nms_greedy_f32(const void* boxes, const void* valid, void* keep, int rows, int n,
                              float threshold, void* stream) {
  if (rows < 0 || n < 0 || n > nms_greedy_max_boxes())
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return (int)cudaSuccess;
  const int words = (n + 63) / 64;
  const size_t smem = smem_bytes(words);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_greedy_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, words, threshold);
  return (int)cudaGetLastError();
}
