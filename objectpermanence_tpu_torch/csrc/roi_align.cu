// Multilevel RoIAlign forward and backward for Hopper (sm_90a): float32 or
// bfloat16 features, float32 weights, sums and output.
//
// Replaces the Pallas TPU kernels of objectpermanence_tpu/ops/pallas_roi_align.py:
// `_pallas_roi_align_tiled_batched` (K7, `roi_align_pallas_batched`, the
// detector's whole-batch RoIAlign), and, called with one image,
// `_pallas_roi_align` (K5, `roi_align_pallas`) and `_pallas_roi_align_tiled`
// (K6, `roi_align_pallas_tiled`); its backward
// `_pallas_roi_align_tiled_batched_bwd` (K8, the features' gradient of
// `roi_align_pallas_batched`, float32, below the forward); and
// `_pallas_roi_align_windowed` (K9, `roi_align_pallas_windowed`, the 800 px
// pyramid's RoIAlign, after K8). For image b and roi n,
// pooled from its assigned FPN level l only:
//   out[b, n, c, py, px] = mean over the s x s samples (iy, ix) of bin (py, px)
//                          of the bilinear value of level l, channel c,
// with torchvision's `aligned=False` edges: the roi scaled to the level, its
// sides at least 1 pixel; a sample outside [-1, H] x [-1, W] contributes 0,
// inside one its coordinates clamp to [0, H-1] x [0, W-1] and the upper tap to
// H-1 (W-1). The plain version is ops/roi_align.py::multilevel_roi_align.
//
// Design. This is a gather with per-roi geometry, not a product: the TPU
// kernels' interpolation matrices and level packing exist only to feed its
// matrix unit and are not carried over. One block per (channel chunk, roi,
// image), one thread per channel of the chunk. The block first computes the
// roi's pooled*s sample rows and columns (indices, weights, inside flags)
// into shared memory, then each thread walks the bins: every tap is one row
// of the NHWC level, so the 32 threads of a warp read 128 contiguous bytes.
// The output tile (chunk x pooled x pooled) is staged in shared memory and
// written out as one contiguous run, since each thread's own 49 values are
// 196 bytes apart from its neighbour's. The sample coordinates round as
// XLA's do: the bin size is the side times the float32 reciprocal of
// `pooled`, a coordinate `lo + g * bin` is one fused multiply-add, and every
// other step is one rounding with no contraction (`__fmul_rn`, `__fsub_rn`),
// so a sample falls on the same side of a pixel edge in the kernel, the
// plain version and JAX.
//
// Bound. At the detector's native shape (30 images x 300 rois, C=256, the
// 256x320 pyramid P2-P5) the function must read the pixels its rois reach,
// at most the 209 MB pyramid, and write the 451 MB output: at most 0.197 ms
// at 3.35 TB/s, 0.135 ms for the output alone; its 0.9 GFLOP of taps are
// negligible (scripts/kernel_bounds.py; chip_smoke.py counts the pixels of
// each run's rois). This kernel does not approach it:
// each roi re-reads 4 taps x 196 samples of every channel, about 0.8 MB per
// roi and 7 GB per call, mostly hits in the 50 MB L2, which holds one
// image's 7 MB pyramid while the blocks of that image run (blocks run image
// by image, roi by roi, in launch order). Reusing taps shared by neighbouring
// samples, or one block per roi tile with the level slice in shared memory,
// is later work.
//
// bfloat16. The forwards (K5-K7, K9) also read bfloat16 NHWC levels: each
// tap is widened to float32 exactly, and the weights, sums and output stay
// float32, so the bf16 mode computes the float32 function of the bf16 values
// (the caller casts the output to the pyramid's dtype). The TPU kernels
// instead round their interpolation weights to bf16; the port does not.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kChunk = 128;     // channels per block, one per thread
constexpr int kMaxSamples = 32; // pooled * sampling_ratio per axis

// bfloat16 features are carried as their 16 bits; a load widens them to
// float32 exactly (the bf16 bits are the float's upper half)
using bf16_bits = unsigned short;

__device__ __forceinline__ float load_feature(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_feature(const bf16_bits* p) {
  return __uint_as_float(static_cast<unsigned int>(__ldg(p)) << 16);
}

template <typename T>
struct LevelsT {
  T* feat[kMaxLevels];  // NHWC (B, H_l, W_l, C), contiguous
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
  int num;
};
using GradLevels = LevelsT<float>;

// K9's window (size 0: none, K5-K8): the widened window size and the y and
// x alignment quanta, as ops/roi_align_window.py::Window computes them.
struct Window {
  int size;
  int quant_y;
  int quant_x;
};

// Every direction places the samples alike: rows 0..k-1 of the table are
// the roi's y samples, of the second its x samples, each with its two taps
// and their weights (1 - frac, frac; 0 for a tap K9's window drops).
// Threads 0..2k-1 each fill one entry; the caller synchronises.
struct SampleTable {
  int i0[2][kMaxSamples];
  int i1[2][kMaxSamples];
  float w0[2][kMaxSamples];
  float w1[2][kMaxSamples];
  int inside[2][kMaxSamples];
};

// Returns 1 where K9's window drops a tap of nonzero weight of a sample
// inside the level on this axis (the roi is then out of contract), else 0.
__device__ __forceinline__ int fill_samples(SampleTable& t, const float* roi, float scale,
                                            int H, int W, int pooled, int s,
                                            Window win = Window{0, 1, 1}) {
  const int k = pooled * s;
  if (threadIdx.x >= 2 * k) return 0;
  const int axis = threadIdx.x < k ? 0 : 1;  // 0: y, 1: x
  const int j = threadIdx.x - axis * k;
  const float lo = __fmul_rn(roi[axis == 0 ? 1 : 0], scale);
  const float hi = __fmul_rn(roi[axis == 0 ? 3 : 2], scale);
  const float bin = __fmul_rn(fmaxf(__fsub_rn(hi, lo), 1.0f), __frcp_rn((float)pooled));
  const float g = __fadd_rn((float)(j / s), __fdiv_rn((float)(j % s) + 0.5f, (float)s));
  const float coord = __fmaf_rn(g, bin, lo);
  const int extent = axis == 0 ? H : W;
  const float cl = fminf(fmaxf(coord, 0.0f), (float)(extent - 1));
  const int i0 = (int)floorf(cl);
  const int i1 = min(i0 + 1, extent - 1);
  const float frac = __fsub_rn(cl, (float)i0);
  const int inside = coord >= -1.0f && coord <= (float)extent;
  float w0 = __fsub_rn(1.0f, frac), w1 = frac;
  int bad = 0;
  if (win.size > 0) {
    // the window's origin: one tap before the corner, inside the level
    // zero-padded to the quantum, floored to the quantum
    const int quant = axis == 0 ? win.quant_y : win.quant_x;
    const int padded = (max(extent, win.size) + quant - 1) / quant * quant;
    int origin = min(max((int)floorf(lo) - 1, 0), max(padded - win.size, 0));
    origin = origin / quant * quant;
    const int rel0 = i0 - origin, rel1 = i1 - origin;
    if (rel0 < 0 || rel0 >= win.size) w0 = 0.0f;
    if (rel1 < 0 || rel1 >= win.size) w1 = 0.0f;
    bad = inside && (rel0 < 0 || rel0 > win.size - 1 || (frac > 0.0f && rel1 > win.size - 1));
  }
  t.i0[axis][j] = i0;
  t.i1[axis][j] = i1;
  t.w0[axis][j] = w0;
  t.w1[axis][j] = w1;
  t.inside[axis][j] = inside;
  return bad;
}

__device__ __forceinline__ int clamp_level(int l, int num) {
  return l < 0 ? 0 : (l >= num ? num - 1 : l);  // out-of-range indices clamp, as in JAX
}

// One roi's (chunk x pooled x pooled) output tile: K5-K7 with no window,
// K9 with one. With `out_of_contract`, the first chunk's block adds 1 to it
// when its roi is out of contract.
template <typename T>
__device__ __forceinline__ void pool_roi(const LevelsT<const T>& lv, const float* __restrict__ rois,
                                         const int* __restrict__ levels, float* __restrict__ out,
                                         int N, int C, int pooled, int s, Window win,
                                         unsigned long long* out_of_contract) {
  __shared__ SampleTable t;
  extern __shared__ float tile[];  // kChunk * pooled * pooled

  const int c0 = blockIdx.x * kChunk;
  const long roi = (long)blockIdx.z * N + blockIdx.y;
  const int b = blockIdx.z;
  const int bins = pooled * pooled;

  const int l = clamp_level(levels[roi], lv.num);
  const int H = lv.h[l], W = lv.w[l];
  const int bad = __syncthreads_or(fill_samples(t, rois + roi * 4, lv.scale[l], H, W, pooled, s,
                                                win));
  if (out_of_contract != nullptr && bad && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(out_of_contract, 1ull);

  const int c = c0 + threadIdx.x;
  if (c < C) {
    const T* f = lv.feat[l] + (long)b * H * W * C + c;
    const float inv = 1.0f / (float)(s * s);
    for (int py = 0; py < pooled; ++py) {
      for (int px = 0; px < pooled; ++px) {
        float acc = 0.0f;
        for (int iy = 0; iy < s; ++iy) {
          const int jy = py * s + iy;
          if (!t.inside[0][jy]) continue;
          const long r0 = (long)t.i0[0][jy] * W, r1 = (long)t.i1[0][jy] * W;
          const float hy = t.w0[0][jy], ly = t.w1[0][jy];
          for (int ix = 0; ix < s; ++ix) {
            const int jx = px * s + ix;
            if (!t.inside[1][jx]) continue;
            const int x0 = t.i0[1][jx], x1 = t.i1[1][jx];
            const float hx = t.w0[1][jx], lx = t.w1[1][jx];
            // each product and sum rounded once, in the plain version's order
            float v = __fmul_rn(load_feature(f + (r0 + x0) * C), __fmul_rn(hy, hx));
            v = __fadd_rn(v, __fmul_rn(load_feature(f + (r0 + x1) * C), __fmul_rn(hy, lx)));
            v = __fadd_rn(v, __fmul_rn(load_feature(f + (r1 + x0) * C), __fmul_rn(ly, hx)));
            v = __fadd_rn(v, __fmul_rn(load_feature(f + (r1 + x1) * C), __fmul_rn(ly, lx)));
            acc = __fadd_rn(acc, v);
          }
        }
        tile[threadIdx.x * bins + py * pooled + px] = __fmul_rn(acc, inv);
      }
    }
  }
  __syncthreads();

  // out[b, n, c0 : c0 + chunk, :, :] is one contiguous run
  const int count = min(kChunk, C - c0) * bins;
  float* dst = out + (roi * C + c0) * bins;
  for (int i = threadIdx.x; i < count; i += kChunk) dst[i] = tile[i];
}

template <typename T>
__global__ void __launch_bounds__(kChunk)
roi_align_kernel(LevelsT<const T> lv, const float* __restrict__ rois,
                 const int* __restrict__ levels, float* __restrict__ out, int N, int C,
                 int pooled, int s) {
  pool_roi<T>(lv, rois, levels, out, N, C, pooled, s, Window{0, 1, 1}, nullptr);
}

// K8, the transpose of roi_align_kernel in the features:
//   dF_l[b, y, x, c] += sum over the samples of bin (py, px) whose taps fall on
//                       (y, x) of w_tap * dOut[b, n, c, py, px] / s^2,
// over each roi's assigned level only; a sample outside the level adds
// nothing, and a clamped tap lands where the forward read it. dF arrives
// zeroed, NHWC. Rois and levels get no gradient.
//
// Design. The same grid and the same sample table (built by fill_samples,
// so every sample rounds as in the forward) as the forward: one block per
// (128-channel chunk, roi, image), one thread per channel. The roi's dOut
// tile (chunk x pooled x pooled, one contiguous run) is read into shared
// memory first, so the loads are coalesced. Each thread then walks its 49
// bins x s^2 samples and adds each sample's four weighted shares to its
// taps with atomicAdd: a tap is one NHWC row, so a warp's 32 adds fall on
// 128 contiguous bytes. Rois overlap, and the taps of neighbouring samples
// coincide, so the sums need atomics; their order, and so the result's last
// bits, change from run to run.
//
// Bound. At the training shape (8 images x 320 rois, C=256, the 256 x 320
// pyramid) the function must read the 128 MB dOut and write the 55.7 MB of
// dF: 0.055 ms at 3.35 TB/s (scripts/kernel_bounds.py). This kernel issues
// 4 atomics per sample and channel, 4 x 196 x 256 per roi and about 0.5 G
// per call, which resolve in the 50 MB L2; that, not device memory, is what
// limits it. Per-level tiles reduced in shared memory, or rois sorted by
// pixel, are later work.
__global__ void __launch_bounds__(kChunk)
roi_align_backward_kernel(GradLevels lv, const float* __restrict__ rois,
                          const int* __restrict__ levels, const float* __restrict__ dout,
                          int N, int C, int pooled, int s) {
  __shared__ SampleTable t;
  extern __shared__ float tile[];  // kChunk * pooled * pooled

  const int c0 = blockIdx.x * kChunk;
  const long roi = (long)blockIdx.z * N + blockIdx.y;
  const int b = blockIdx.z;
  const int bins = pooled * pooled;

  const int l = clamp_level(levels[roi], lv.num);
  const int H = lv.h[l], W = lv.w[l];
  fill_samples(t, rois + roi * 4, lv.scale[l], H, W, pooled, s);
  // dOut[b, n, c0 : c0 + chunk, :, :] is one contiguous run
  const int count = min(kChunk, C - c0) * bins;
  const float* src = dout + (roi * C + c0) * bins;
  for (int i = threadIdx.x; i < count; i += kChunk) tile[i] = __ldg(src + i);
  __syncthreads();

  const int c = c0 + threadIdx.x;
  if (c >= C) return;
  float* g = lv.feat[l] + (long)b * H * W * C + c;
  const float inv = 1.0f / (float)(s * s);
  for (int py = 0; py < pooled; ++py) {
    for (int px = 0; px < pooled; ++px) {
      const float d = __fmul_rn(tile[threadIdx.x * bins + py * pooled + px], inv);
      for (int iy = 0; iy < s; ++iy) {
        const int jy = py * s + iy;
        if (!t.inside[0][jy]) continue;
        const long r0 = (long)t.i0[0][jy] * W, r1 = (long)t.i1[0][jy] * W;
        const float hy = t.w0[0][jy], ly = t.w1[0][jy];
        for (int ix = 0; ix < s; ++ix) {
          const int jx = px * s + ix;
          if (!t.inside[1][jx]) continue;
          const int x0 = t.i0[1][jx], x1 = t.i1[1][jx];
          const float hx = t.w0[1][jx], lx = t.w1[1][jx];
          atomicAdd(g + (r0 + x0) * C, __fmul_rn(d, __fmul_rn(hy, hx)));
          atomicAdd(g + (r0 + x1) * C, __fmul_rn(d, __fmul_rn(hy, lx)));
          atomicAdd(g + (r1 + x0) * C, __fmul_rn(d, __fmul_rn(ly, hx)));
          atomicAdd(g + (r1 + x1) * C, __fmul_rn(d, __fmul_rn(ly, lx)));
        }
      }
    }
  }
}

// K9, the windowed RoIAlign: K7's function with every tap outside its roi's
// window dropped, as `_window_interp_weights` drops it. The TPU kernel copies
// each roi's (win x win x chunk) window into VMEM and runs two products; on
// Hopper a 56-64 px window of 128 channels is 1.6-2 MB, far over an SM's
// 227 KB of shared memory, so the window is not copied: K9 is K7's gather
// (one block per (channel chunk, roi, image), taps read from the NHWC level
// in HBM) with the window in its sample table. fill_samples computes each
// axis's window origin from the roi exactly as JAX does (integers from the
// same float32 corner) and zeroes the weight of a tap outside [0, win). A
// roi whose window drops a tap of nonzero weight is out of contract; the
// block of its first channel chunk adds 1 to `out_of_contract` (an int64 on
// the device, read by the host when it wants the count), so counting needs
// no host sync per dispatch.
//
// Bound. At the 800 px recipe's chunk (8 images x 300 rois, C=256, P2-P5 of
// 200 x 272 down to 25 x 34) the function must read every channel of the
// pixels its rois reach inside their windows and write the 120 MB float32
// output (0.036 ms at 3.35 TB/s alone); chip_smoke.py counts those pixels
// on each run's rois (`roi_pixels_read`) for scripts/kernel_bounds.py. The
// whole pyramid, 592 MB in float32 and 296 MB in bfloat16, is more than
// that. The kernel's own traffic is K7's, 4 taps x 196 samples of every
// channel per roi, mostly from L2. The plain version is
// ops/roi_align_window.py::multilevel_roi_align_windowed.
template <typename T>
__global__ void __launch_bounds__(kChunk)
roi_align_windowed_kernel(LevelsT<const T> lv, const float* __restrict__ rois,
                          const int* __restrict__ levels, float* __restrict__ out, int N, int C,
                          int pooled, int s, Window win, unsigned long long* out_of_contract) {
  pool_roi<T>(lv, rois, levels, out, N, C, pooled, s, win, out_of_contract);
}

template <typename T>
bool fill_levels(LevelsT<T>& lv, const void* const* ptrs, const int* heights, const int* widths,
                 const float* scales, int num_levels) {
  lv.num = num_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < num_levels;
    lv.feat[i] = used ? static_cast<T*>(const_cast<void*>(ptrs[i])) : nullptr;
    lv.h[i] = used ? heights[i] : 0;
    lv.w[i] = used ? widths[i] : 0;
    lv.scale[i] = used ? scales[i] : 0.0f;
    if (used && (lv.h[i] < 1 || lv.w[i] < 1)) return false;
  }
  return true;
}

bool valid_launch(int num_levels, int B, int N, int C, int pooled, int sampling_ratio) {
  return num_levels >= 1 && num_levels <= kMaxLevels && B >= 1 && N >= 1 && C >= 1 &&
         pooled >= 1 && sampling_ratio >= 1 && pooled * sampling_ratio <= kMaxSamples &&
         B <= 65535 && N <= 65535 && sizeof(float) * kChunk * pooled * pooled <= 48 * 1024;
}

template <typename T>
int launch_forward(const void* const* feats, const int* heights, const int* widths,
                   const float* scales, int num_levels, const void* rois, const void* levels,
                   void* out, int B, int N, int C, int pooled, int sampling_ratio, Window win,
                   void* out_of_contract, void* stream) {
  LevelsT<const T> lv;
  if (!valid_launch(num_levels, B, N, C, pooled, sampling_ratio) ||
      !fill_levels(lv, feats, heights, widths, scales, num_levels) ||
      (win.size != 0 && (win.size < 1 || win.quant_y < 1 || win.quant_x < 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kChunk * pooled * pooled;
  const dim3 grid((C + kChunk - 1) / kChunk, N, B);
  const auto r = static_cast<const float*>(rois);
  const auto l = static_cast<const int*>(levels);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (win.size == 0)
    roi_align_kernel<T><<<grid, kChunk, smem, st>>>(lv, r, l, o, N, C, pooled, sampling_ratio);
  else
    roi_align_windowed_kernel<T><<<grid, kChunk, smem, st>>>(
        lv, r, l, o, N, C, pooled, sampling_ratio, win,
        static_cast<unsigned long long*>(out_of_contract));
  return (int)cudaGetLastError();
}

}  // namespace

// K5-K7. feats: host array of num_levels device pointers, each NHWC
// (B, H_l, W_l, C), float32 (_f32) or bfloat16 (_bf16); heights, widths,
// scales: host arrays; rois (B, N, 4) float32 and levels (B, N) int32 on the
// device; out (B, N, C, pooled, pooled) float32. Returns the launch's
// cudaError_t (0 on success).
#define FORWARD_ARGS                                                                  \
  const void *const *feats, const int *heights, const int *widths, const float *scales, \
      int num_levels, const void *rois, const void *levels, void *out, int B, int N, int C, \
      int pooled, int sampling_ratio
#define FORWARD_PASS \
  feats, heights, widths, scales, num_levels, rois, levels, out, B, N, C, pooled, sampling_ratio

extern "C" int roi_align_forward_f32(FORWARD_ARGS, void* stream) {
  return launch_forward<float>(FORWARD_PASS, Window{0, 1, 1}, nullptr, stream);
}

extern "C" int roi_align_forward_bf16(FORWARD_ARGS, void* stream) {
  return launch_forward<bf16_bits>(FORWARD_PASS, Window{0, 1, 1}, nullptr, stream);
}

// K9. As the forward, plus the window (its widened size, y and x quanta:
// ops/roi_align_window.py::Window) and out_of_contract, a device int64 that
// each out-of-contract roi adds 1 to, or null to count nothing.
extern "C" int roi_align_windowed_forward_f32(FORWARD_ARGS, int win, int quant_y, int quant_x,
                                              void* out_of_contract, void* stream) {
  return launch_forward<float>(FORWARD_PASS, Window{win, quant_y, quant_x}, out_of_contract,
                               stream);
}

extern "C" int roi_align_windowed_forward_bf16(FORWARD_ARGS, int win, int quant_y, int quant_x,
                                               void* out_of_contract, void* stream) {
  return launch_forward<bf16_bits>(FORWARD_PASS, Window{win, quant_y, quant_x}, out_of_contract,
                                   stream);
}

// K8. grads: host array of num_levels device pointers, each a zeroed NHWC
// (B, H_l, W_l, C) float32 buffer that receives dF; heights, widths, scales,
// rois and levels as for the forward; dout (B, N, C, pooled, pooled) float32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int roi_align_backward_f32(void* const* grads, const int* heights,
                                      const int* widths, const float* scales, int num_levels,
                                      const void* rois, const void* levels, const void* dout,
                                      int B, int N, int C, int pooled, int sampling_ratio,
                                      void* stream) {
  GradLevels lv;
  if (!valid_launch(num_levels, B, N, C, pooled, sampling_ratio) ||
      !fill_levels(lv, grads, heights, widths, scales, num_levels))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kChunk * pooled * pooled;
  const dim3 grid((C + kChunk - 1) / kChunk, N, B);
  roi_align_backward_kernel<<<grid, kChunk, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<const float*>(dout), N, C, pooled, sampling_ratio);
  return (int)cudaGetLastError();
}
