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
// pyramid's RoIAlign, the forward with a window). For image b and roi n,
// pooled from its assigned FPN level l only:
//   out[b, n, c, py, px] = mean over the s x s samples (iy, ix) of bin (py, px)
//                          of the bilinear value of level l, channel c,
// with torchvision's `aligned=False` edges: the roi scaled to the level, its
// sides at least 1 pixel; a sample outside [-1, H] x [-1, W] contributes 0,
// inside one its coordinates clamp to [0, H-1] x [0, W-1] and the upper tap to
// H-1 (W-1). The plain version is ops/roi_align.py::multilevel_roi_align.
//
// Forward design (K5-K7, K9). This is a gather with per-roi geometry, not a
// product: the TPU kernels' interpolation matrices and level packing exist
// only to feed its matrix unit and are not carried over. One block per
// (channel slice, roi, image):
//  1. The roi's k = pooled * s sample rows and columns (taps, weights, inside
//     flags) go into a table, as fill_samples computes them for every
//     direction.
//  2. The taps are monotone in the sample index, so a roi touches at most 2k
//     distinct rows and 2k distinct columns of its level, whatever its size
//     or window (at 7 x 2: a tile of at most 28 x 28 pixels; the detector's
//     rois average 47 pixels at the native geometry and 108 at 800 px). One
//     warp per axis lists them in order with a prefix sum over the samples.
//     Then, once per roi rather than once per channel, each of the k * k
//     samples gets its four weight products and its four taps' places in
//     the tile, and each pixel of the tile its offset in the level.
//  3. The compact tile (rows used x columns used x a pass of channels) is
//     copied into shared memory. The level is read in place through its
//     element strides, so the detector's NCHW pyramid and a channels_last one
//     are both read without a copy: for NCHW (a tap row contiguous in x) the
//     threads run along the tile's pixels, for channels_last along the
//     channels. float32 goes by cp.async; bfloat16 (2 bytes, below
//     cp.async's least size) by loads issued eight at a time, and stays bf16
//     in shared memory. The next pass's copy overlaps the pass's writes.
//  4. The tile keeps channels in pairs, so one load gives a thread both
//     channels of its pair at a tap, and a pair's pixels at an odd pitch, so
//     the 32 pairs of a warp fall in different banks. Each thread takes a
//     pair and a share of the bins (a warp: one bin at a time, so the sample
//     tables are broadcasts) and sums each sample's four taps in the plain
//     version's order, each product and sum rounded once: the result is
//     bit-for-bit the plain version's. The detector's sampling ratio, 2, is
//     compiled in, so a bin's 16 taps are loaded before its sums.
//  5. The pass's (channels x pooled x pooled) output goes through shared
//     memory and out as one contiguous run.
// How many channels a pass holds follows from the roi's tile and the plan's
// tile bytes (ops/roi_align_kernel.py::launch_plan sets the slice, the
// threads and the shared memory; roi_align_forward_last_plan reports what a
// launch used). The sample coordinates round as XLA's do: the bin size is the
// side times the float32 reciprocal of `pooled`, a coordinate `lo + g * bin`
// is one fused multiply-add, and every other step is one rounding with no
// contraction (`__fmul_rn`, `__fsub_rn`), so a sample falls on the same side
// of a pixel edge in the kernel, the plain version and JAX.
//
// Bound. At the detector's native shape (30 images x 300 rois, C=256, the
// 256x320 pyramid P2-P5) the function must read the pixels its rois reach,
// at most the 209 MB pyramid, and write the 451 MB output: at most 0.197 ms
// at 3.35 TB/s, 0.135 ms for the output alone; its 0.9 GFLOP of taps are
// negligible (scripts/kernel_bounds.py; chip_smoke.py counts the pixels of
// each run's rois). The kernel copies each roi's tile from L2 (rois of one
// image share its 7 MB of levels, which stay in the 50 MB L2 while that
// image's blocks run; overlapping rois each copy their own), then sums 4
// taps per sample and channel from shared memory with 8 float32 operations
// that the plain version's rounding forbids to fuse. The copy, the sums and
// the output's writes each take a share of the time and overlap little
// (scripts/roi_align_phases.py measures each by ablation).
//
// bfloat16. The forwards also read bfloat16 levels: each tap is widened to
// float32 exactly, and the weights, sums and output stay float32, so the bf16
// mode computes the float32 function of the bf16 values (the caller casts the
// output to the pyramid's dtype). The TPU kernels instead round their
// interpolation weights to bf16; the port does not.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kChunk = 128;       // K8: channels per block, one per thread
constexpr int kMaxSamples = 32;   // pooled * sampling_ratio per axis
constexpr int kMaxThreads = 256;  // the forward's block, at most

// bfloat16 features are carried as their 16 bits; load_pair widens them to
// float32 exactly (the bf16 bits are the float's upper half)
using bf16_bits = unsigned short;

template <typename T>
struct LevelsT {
  T* feat[kMaxLevels];  // NHWC (B, H_l, W_l, C), contiguous
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
  int num;
};
using GradLevels = LevelsT<float>;

// The forwards' levels (B, C, H_l, W_l) in any layout, by element strides.
// A pixel's offset within one (image, channel) plane, y * sy + x * sx, fits
// 32 bits (the wrapper checks).
template <typename T>
struct StridedLevels {
  const T* feat[kMaxLevels];
  long long sb[kMaxLevels];
  long long sc[kMaxLevels];
  int sy[kMaxLevels];
  int sx[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
  int num;
};

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

// --- the forward (K5-K7, K9) -------------------------------------------------

// The compact tile of one roi: per axis its distinct taps in ascending order
// and each sample's two taps as places in that list.
struct CompactTile {
  int idx0[2][kMaxSamples];
  int idx1[2][kMaxSamples];
  int taps[2][2 * kMaxSamples];
  int n[2];
};

// One warp lists one axis's distinct taps. Both taps are nondecreasing in the
// sample j and i0 <= i1 <= i0 + 1, so every value below i1[j-1] was listed by
// sample j-1 or before: i0[j] is new iff it exceeds i1[j-1], i1[j] iff it
// exceeds both, and a prefix sum of the new values gives the places.
__device__ __forceinline__ void compact_axis(const SampleTable& t, CompactTile& ct, int axis,
                                             int k) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < k;
  const int i0 = live ? t.i0[axis][lane] : 0, i1 = live ? t.i1[axis][lane] : 0;
  int prev = __shfl_up_sync(0xffffffffu, i1, 1);
  if (lane == 0) prev = -1;
  const int new0 = live && i0 > prev;
  const int new1 = live && i1 > max(prev, i0);
  int upto = new0 + new1;  // inclusive prefix sum: values listed through sample j
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, upto, d);
    if (lane >= d) upto += v;
  }
  const int upto0 = upto - new1;
  if (live) {
    // i0 below i1[j-1] (then i0 = i1[j-1] - 1) sits one before the last listed
    ct.idx0[axis][lane] = upto0 - 1 - (i0 < prev ? 1 : 0);
    ct.idx1[axis][lane] = upto - 1;
    if (new0) ct.taps[axis][upto0 - 1] = i0;
    if (new1) ct.taps[axis][upto - 1] = i1;
  }
  const int n = __shfl_sync(0xffffffffu, upto, k - 1);
  if (lane == 0) ct.n[axis] = n;
}

// The tile holds channels in pairs: element (c, p) of a pass at
// ((c / 2) * pitch + p) * 2 + c % 2, so one 8-byte (float32) or 4-byte
// (bfloat16) load gives a thread both channels of its pair. The pitch, in
// pairs, is odd: the 32 pairs of a warp at one pixel fall in different banks.
__host__ __device__ __forceinline__ int tile_pitch(int pixels) { return pixels | 1; }

__host__ __device__ __forceinline__ int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Bytes of the tile of `channels` channels.
__host__ __device__ __forceinline__ int tile_bytes_of(int channels, int pitch, int itemsize) {
  return align16((channels + 1) / 2 * pitch * 2 * itemsize);
}

// Bytes of a pass of `channels` channels: their tile, then their output.
__host__ __device__ __forceinline__ int pass_bytes(int channels, int pitch, int itemsize,
                                                   int bins) {
  return tile_bytes_of(channels, pitch, itemsize) + channels * bins * 4;
}

// Before the tile region: the four weight products of each of the k x k
// samples (float4), their four taps' places in the tile (uint2), and the
// level offset of each pixel of the largest tile (int).
__host__ __device__ __forceinline__ int table_bytes(int k) { return 40 * k * k; }

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Copies channels [0, count) of the tile: channel c's pixel p from
// src + c * sc + pixoff[p]. Consecutive threads take consecutive pixels or,
// with `channel_fastest`, consecutive channels.
template <typename T>
__device__ __forceinline__ void stage(T* tile, int pitch, const T* __restrict__ src,
                                      long long sc, const int* pixoff, int pixels, int count,
                                      bool channel_fastest) {
  const int inner = channel_fastest ? count : pixels;
  const int total = count * pixels;
  const int step = blockDim.x;
  const int d_in = step % inner, d_out = step / inner;
  int a = threadIdx.x % inner, o = threadIdx.x / inner;
  if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < total; i += step) {
      const int c = channel_fastest ? a : o, p = channel_fastest ? o : a;
      copy_async(tile + ((c >> 1) * pitch + p) * 2 + (c & 1), src + c * sc + pixoff[p]);
      a += d_in;
      o += d_out;
      if (a >= inner) a -= inner, ++o;
    }
  } else {
    // eight loads in flight per thread before their stores
    for (int i = threadIdx.x; i < total; i += 8 * step) {
      T v[8];
      int at[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        at[u] = -1;
        if (i + u * step < total) {
          const int c = channel_fastest ? a : o, p = channel_fastest ? o : a;
          v[u] = __ldg(src + c * sc + pixoff[p]);
          at[u] = ((c >> 1) * pitch + p) * 2 + (c & 1);
        }
        a += d_in;
        o += d_out;
        if (a >= inner) a -= inner, ++o;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (at[u] >= 0) tile[at[u]] = v[u];
    }
  }
}

// A pair's two channels at one tap, widened to float32.
__device__ __forceinline__ float2 load_pair(const float* pair, int tap) {
  return *reinterpret_cast<const float2*>(pair + 2 * tap);
}
__device__ __forceinline__ float2 load_pair(const bf16_bits* pair, int tap) {
  const unsigned v = *reinterpret_cast<const unsigned*>(pair + 2 * tap);
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// A sample's entry in the tap table: its four taps' places in the tile, two
// a word (12 bits each), the inside flag in bit 31 of y.
constexpr unsigned kTap = 0xfffu;

struct Taps {
  float2 v[4];  // a pair's two channels at the sample's four taps
};

template <typename T>
__device__ __forceinline__ Taps load_taps(const T* pair, uint2 at) {
  return Taps{{load_pair(pair, at.x & kTap), load_pair(pair, (at.x >> 16) & kTap),
               load_pair(pair, at.y & kTap), load_pair(pair, (at.y >> 16) & kTap)}};
}

// One sample of a pair's two channels: its four taps times their weights,
// each product and sum rounded once, in the plain version's order.
__device__ __forceinline__ float2 weigh(const Taps& f, float4 w) {
  float2 u;
  u.x = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(f.v[0].x, w.x), __fmul_rn(f.v[1].x, w.y)),
                            __fmul_rn(f.v[2].x, w.z)), __fmul_rn(f.v[3].x, w.w));
  u.y = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(f.v[0].y, w.x), __fmul_rn(f.v[1].y, w.y)),
                            __fmul_rn(f.v[2].y, w.z)), __fmul_rn(f.v[3].y, w.w));
  return u;
}

__device__ __forceinline__ float2 add_if(float2 acc, float2 u, unsigned inside) {
  // a sample outside the level adds nothing
  return inside ? make_float2(__fadd_rn(acc.x, u.x), __fadd_rn(acc.y, u.y)) : acc;
}

// One bin's sums over its s x s samples for a pair of channels, in the
// samples' order. With the sampling ratio S known when compiled, every
// sample's taps are loaded before the sums, so the loads overlap; S = 0
// takes `s` as it comes.
template <int S, typename T>
__device__ __forceinline__ float2 pool_bin(const T* pair, const uint2* taps,
                                           const float4* weights, int k, int s, int py, int px) {
  float2 acc = make_float2(0.0f, 0.0f);
  if constexpr (S > 0) {
    Taps f[S * S];
    uint2 at[S * S];
#pragma unroll
    for (int i = 0; i < S * S; ++i) {
      at[i] = taps[(py * S + i / S) * k + px * S + i % S];
      f[i] = load_taps(pair, at[i]);
    }
#pragma unroll
    for (int i = 0; i < S * S; ++i)
      acc = add_if(acc, weigh(f[i], weights[(py * S + i / S) * k + px * S + i % S]),
                   at[i].y >> 31);
  } else {
    for (int iy = 0; iy < s; ++iy) {
      for (int ix = 0; ix < s; ++ix) {
        const int j = (py * s + iy) * k + px * s + ix;
        const uint2 at = taps[j];
        acc = add_if(acc, weigh(load_taps(pair, at), weights[j]), at.y >> 31);
      }
    }
  }
  return acc;
}

// K9, the windowed RoIAlign: the forward with every tap outside its roi's
// window dropped, as `_window_interp_weights` drops it. The TPU kernel copies
// each roi's (win x win x chunk) window into VMEM and runs two products; here
// fill_samples computes each axis's window origin from the roi exactly as
// JAX does (integers from the same float32 corner) and zeroes the weight of a
// tap outside [0, win), and the block copies the same compact tile as the
// exact forward (a dropped tap is copied and weighted 0), so the window costs
// nothing. A roi whose window drops a tap of nonzero weight is out of
// contract; the block of its first channel slice adds 1 to
// `out_of_contract` (an int64 on the device, read by the host when it wants
// the count), so counting needs no host sync per dispatch. The plain version
// is ops/roi_align_window.py::multilevel_roi_align_windowed.
//
// K9's bound. At the 800 px recipe's chunk (8 images x 300 rois, C=256,
// P2-P5 of 200 x 272 down to 25 x 34) the function must read every channel
// of the pixels its rois reach inside their windows, about 6% of the
// pyramid, and write the 120 MB float32 output (0.036 ms at 3.35 TB/s
// alone); chip_smoke.py counts those pixels on each run's rois
// (`roi_pixels_read`) for scripts/kernel_bounds.py. The kernel reads only
// its rois' tiles, in place: no pass over the whole pyramid (592 MB in
// float32, 296 MB in bfloat16).

// One roi's (slice x pooled x pooled) output: K5-K7 with no window, K9 with
// one. With `out_of_contract`, the first slice's block adds 1 to it when its
// roi is out of contract. `tile_bytes` is the plan's room for a pass; the
// block's threads are a power of two, 64 to kMaxThreads; S, as pool_bin's.
template <typename T, int S>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_forward_kernel(StridedLevels<T> lv, const float* __restrict__ rois,
                         const int* __restrict__ levels, float* __restrict__ out, int N, int C,
                         int pooled, int s, int slice, int tile_bytes, Window win,
                         unsigned long long* out_of_contract) {
  __shared__ SampleTable t;
  __shared__ CompactTile ct;
  extern __shared__ __align__(16) unsigned char smem[];

  const int k = pooled * s, bins = pooled * pooled, threads = blockDim.x;
  float4* weights = reinterpret_cast<float4*>(smem);
  uint2* taps = reinterpret_cast<uint2*>(smem + 16 * k * k);
  int* pixoff = reinterpret_cast<int*>(smem + 24 * k * k);
  unsigned char* region = smem + table_bytes(k);

  const long roi = (long)blockIdx.z * N + blockIdx.y;
  const int l = clamp_level(levels[roi], lv.num);
  const int bad = __syncthreads_or(
      fill_samples(t, rois + roi * 4, lv.scale[l], lv.h[l], lv.w[l], pooled, s, win));
  if (out_of_contract != nullptr && bad && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(out_of_contract, 1ull);
  if (threadIdx.x < 64) compact_axis(t, ct, threadIdx.x >> 5, k);
  __syncthreads();

  const int ny = ct.n[0], nx = ct.n[1], pixels = ny * nx;
  for (int j = threadIdx.x; j < k * k; j += threads) {
    const int jy = j / k, jx = j - jy * k;
    const float hy = t.w0[0][jy], ly = t.w1[0][jy], hx = t.w0[1][jx], lx = t.w1[1][jx];
    weights[j] = make_float4(__fmul_rn(hy, hx), __fmul_rn(hy, lx), __fmul_rn(ly, hx),
                             __fmul_rn(ly, lx));
    const int r0 = ct.idx0[0][jy] * nx, r1 = ct.idx1[0][jy] * nx;
    const int x0 = ct.idx0[1][jx], x1 = ct.idx1[1][jx];
    const unsigned inside = t.inside[0][jy] && t.inside[1][jx];
    taps[j] = make_uint2((r0 + x0) | (r0 + x1) << 16, (r1 + x0) | (r1 + x1) << 16 | inside << 31);
  }
  const int sy = lv.sy[l], sx = lv.sx[l];
  for (int p = threadIdx.x; p < pixels; p += threads) {
    const int cy = p / nx;
    pixoff[p] = ct.taps[0][cy] * sy + ct.taps[1][p - cy * nx] * sx;
  }
  const int pitch = tile_pitch(pixels);
  // channels a pass holds: a power of two, 2 to twice the block's threads,
  // at most the slice rounded up
  int per_pass = 2;
  while (per_pass < slice && per_pass < 2 * threads &&
         pass_bytes(2 * per_pass, pitch, sizeof(T), bins) <= tile_bytes)
    per_pass *= 2;
  T* tile = reinterpret_cast<T*>(region);
  float* otile = reinterpret_cast<float*>(region + tile_bytes_of(per_pass, pitch, sizeof(T)));
  const int c_begin = blockIdx.x * slice, c_end = min(C, c_begin + slice);
  const long long sc = lv.sc[l];
  const T* base = lv.feat[l] + blockIdx.z * lv.sb[l];
  const bool channel_fastest = sc == 1 && sx != 1;
  // thread: one pair of channels of the pass and every `groups`-th bin
  const int pairs = per_pass / 2;
  const int m = threadIdx.x & (pairs - 1);
  const int group = threadIdx.x / pairs, groups = threads / pairs;
  const float inv = 1.0f / (float)(s * s);
  __syncthreads();  // weights, taps, pixoff

  int c0 = c_begin;
  stage(tile, pitch, base + c0 * sc, sc, pixoff, pixels, min(per_pass, c_end - c0),
        channel_fastest);
  while (true) {
    const int count = min(per_pass, c_end - c0), next = c0 + count;
    if constexpr (sizeof(T) == 4) copy_wait();
    __syncthreads();
    if (2 * m < count) {
      const T* pair = tile + 2 * m * pitch;
      for (int bin = group; bin < bins; bin += groups) {
        const int py = bin / pooled, px = bin - py * pooled;
        const float2 acc = pool_bin<S>(pair, taps, weights, k, s, py, px);
        otile[2 * m * bins + bin] = __fmul_rn(acc.x, inv);
        if (2 * m + 1 < count) otile[(2 * m + 1) * bins + bin] = __fmul_rn(acc.y, inv);
      }
    }
    __syncthreads();
    if (next < c_end)  // the next pass's copy overlaps this pass's writes
      stage(tile, pitch, base + next * sc, sc, pixoff, pixels, min(per_pass, c_end - next),
            channel_fastest);
    // out[b, n, c0 : c0 + count, :, :] is one contiguous run
    float* dst = out + (roi * C + c0) * bins;
    for (int i = threadIdx.x; i < count * bins; i += threads) dst[i] = otile[i];
    if (next >= c_end) break;
    c0 = next;
  }
}

// K8, the transpose of the forward in the features:
//   dF_l[b, y, x, c] += sum over the samples of bin (py, px) whose taps fall on
//                       (y, x) of w_tap * dOut[b, n, c, py, px] / s^2,
// over each roi's assigned level only; a sample outside the level adds
// nothing, and a clamped tap lands where the forward read it. dF arrives
// zeroed, NHWC. Rois and levels get no gradient.
//
// Design. The forward's sample table (built by fill_samples, so every sample
// rounds as in the forward), and one block per
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

// strides: num_levels x (b, c, y, x) element strides. False where a level is
// empty or a plane's pixel offsets do not fit 32 bits.
template <typename T>
bool fill_strided(StridedLevels<T>& lv, const void* const* ptrs, const int* heights,
                  const int* widths, const float* scales, const long long* strides,
                  int num_levels) {
  lv.num = num_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < num_levels;
    lv.feat[i] = used ? static_cast<const T*>(ptrs[i]) : nullptr;
    lv.h[i] = used ? heights[i] : 0;
    lv.w[i] = used ? widths[i] : 0;
    lv.scale[i] = used ? scales[i] : 0.0f;
    const long long* st = strides + 4 * i;
    lv.sb[i] = used ? st[0] : 0;
    lv.sc[i] = used ? st[1] : 0;
    lv.sy[i] = used ? (int)st[2] : 0;
    lv.sx[i] = used ? (int)st[3] : 0;
    if (!used) continue;
    if (lv.h[i] < 1 || lv.w[i] < 1 || st[0] < 0 || st[1] < 0 || st[2] < 0 || st[3] < 0 ||
        (long long)(lv.h[i] - 1) * st[2] + (long long)(lv.w[i] - 1) * st[3] > 0x7fffffffLL)
      return false;
  }
  return true;
}

// The plan a forward launch takes (ops/roi_align_kernel.py::launch_plan):
// channels per block, threads, dynamic shared memory bytes, and the bytes of
// it a pass of channels may use.
struct Plan {
  int slice;
  int threads;
  int smem;
  int tile_bytes;
};

// The plan of the last forward launch, and its grid's channel slices.
int g_last_plan[5] = {0, 0, 0, 0, 0};

// Whether `plan` holds the largest tile (2k x 2k pixels) of one channel.
bool plan_fits(const Plan& plan, int pooled, int s, int itemsize) {
  const int k = pooled * s;
  const bool pow2 = plan.threads >= 64 && plan.threads <= kMaxThreads &&
                    (plan.threads & (plan.threads - 1)) == 0;
  return pow2 && plan.slice >= 1 &&
         plan.tile_bytes >= pass_bytes(2, tile_pitch(4 * k * k), itemsize, pooled * pooled) &&
         plan.smem >= table_bytes(k) + plan.tile_bytes;
}

template <typename T>
int launch_forward(const void* const* feats, const int* heights, const int* widths,
                   const float* scales, const long long* strides, int num_levels,
                   const void* rois, const void* levels, void* out, int B, int N, int C,
                   int pooled, int sampling_ratio, const int* plan_in, Window win,
                   void* out_of_contract, void* stream) {
  StridedLevels<T> lv;
  const Plan plan{plan_in[0], plan_in[1], plan_in[2], plan_in[3]};
  if (num_levels < 1 || num_levels > kMaxLevels || B < 1 || N < 1 || C < 1 || pooled < 1 ||
      sampling_ratio < 1 || pooled * sampling_ratio > kMaxSamples || B > 65535 || N > 65535 ||
      !plan_fits(plan, pooled, sampling_ratio, sizeof(T)) ||
      !fill_strided(lv, feats, heights, widths, scales, strides, num_levels) ||
      (win.size != 0 && (win.size < 1 || win.quant_y < 1 || win.quant_x < 1)))
    return (int)cudaErrorInvalidValue;
  // the detector's sampling ratio, 2, compiled in; any other at run time
  const auto kernel =
      sampling_ratio == 2 ? roi_align_forward_kernel<T, 2> : roi_align_forward_kernel<T, 0>;
  // as much of the SM's memory as shared memory as it has: the blocks that
  // fit hide each other's copies and barriers
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && plan.smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + plan.slice - 1) / plan.slice, N, B);
  kernel<<<grid, plan.threads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<float*>(out), N, C, pooled, sampling_ratio, plan.slice, plan.tile_bytes, win,
      static_cast<unsigned long long*>(out_of_contract));
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    const int last[5] = {plan.slice, plan.threads, plan.smem, plan.tile_bytes, (int)grid.x};
    for (int i = 0; i < 5; ++i) g_last_plan[i] = last[i];
  }
  return (int)err;
}

}  // namespace

// K5-K7. feats: host array of num_levels device pointers, each a level
// (B, C, H_l, W_l) in any layout, float32 (_f32) or bfloat16 (_bf16);
// heights, widths, scales: host arrays; strides: host array of num_levels x
// (b, c, y, x) element strides; rois (B, N, 4) float32 and levels (B, N)
// int32 on the device; out (B, N, C, pooled, pooled) float32; plan: host
// array (slice, threads, smem, tile_bytes) from launch_plan. Returns the
// launch's cudaError_t (0 on success).
#define FORWARD_ARGS                                                                      \
  const void *const *feats, const int *heights, const int *widths, const float *scales,   \
      const long long *strides, int num_levels, const void *rois, const void *levels,      \
      void *out, int B, int N, int C, int pooled, int sampling_ratio, const int *plan
#define FORWARD_PASS                                                                    \
  feats, heights, widths, scales, strides, num_levels, rois, levels, out, B, N, C, pooled, \
      sampling_ratio, plan

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

// The last successful forward launch's plan and grid: out[5] = (slice,
// threads, smem, tile_bytes, channel slices of the grid).
extern "C" void roi_align_forward_last_plan(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = g_last_plan[i];
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
