// Multilevel RoIAlign forward and backward for Hopper (sm_90a): float32 or
// bfloat16 features, float32 weights and sums; the forwards' output float32,
// the backward's dF in the features' dtype.
//
// Replaces the Pallas TPU kernels of objectpermanence_tpu/ops/pallas_roi_align.py:
// `_pallas_roi_align_tiled_batched` (K7, `roi_align_pallas_batched`, the
// detector's whole-batch RoIAlign), and, called with one image,
// `_pallas_roi_align` (K5, `roi_align_pallas`) and `_pallas_roi_align_tiled`
// (K6, `roi_align_pallas_tiled`); its backward
// `_pallas_roi_align_tiled_batched_bwd` (K8, the features' gradient of
// `roi_align_pallas_batched`, below the forward); and
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxPooled = 9;      // the wrappers' largest `pooled`
constexpr int kMaxSamples = 32;    // pooled * sampling_ratio per axis
constexpr int kMaxThreads = 256;   // the forward's block, at most
constexpr int kBinThreads = 256;   // K8's binning block: 8 tiles, a warp each
constexpr int kBackThreads = 512;  // K8's tile block, at most
constexpr int kTileH = 16;         // rows of a K8 dF tile: a thread's accumulators

// bfloat16 features are carried as their 16 bits; load_pair widens them to
// float32 exactly (the bf16 bits are the float's upper half)
using bf16_bits = unsigned short;

// Levels (B, C, H_l, W_l) in any layout, by element strides: the forwards
// read them (P = const T*), K8 writes dF into them (P = T*). A pixel's
// offset within one (image, channel) plane, y * sy + x * sx, fits 32 bits
// (the wrapper checks).
template <typename P>
struct Strided {
  P feat[kMaxLevels];
  long long sb[kMaxLevels];
  long long sc[kMaxLevels];
  int sy[kMaxLevels];
  int sx[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
  int num;
};
template <typename T>
using StridedLevels = Strided<const T*>;

// K8's tiles: each level cut into tiles of kTileH x tile_w pixels, numbered
// level by level, row-major within a level.
struct Tiling {
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int tiles_x[kMaxLevels];       // tile columns of each level
  int base[kMaxLevels + 1];      // its first tile; base[num]: the tiles of an image
  int num;
  int tile_w;
  int tiles;                     // base[num]
};

// K9's window (size 0: none, K5-K8): the widened window size and the y and
// x alignment quanta, as ops/roi_align_window.py::Window computes them.
struct Window {
  int size;
  int quant_y;
  int quant_x;
};

// One sample of a roi on one axis: its two taps (clamped to the level), their
// weights (1 - frac, frac; 0 for a tap K9's window drops), whether it lies
// inside the level on this axis, and `bad`, 1 where K9's window drops a tap of
// nonzero weight of a sample inside the level. `first` and `last` are the
// roi's sides on the axis (y1, y2 or x1, x2) in image coordinates, `rcp` the
// float32 reciprocal of `pooled`, `g` the sample's offset in bins
// (sample_offset); a window of size 0 is none.
struct Sample {
  int i0, i1;
  float w0, w1;
  int inside, bad;
};

// Sample j's offset in bins: bin j / s, then (j % s + 0.5) / s of it.
__device__ __forceinline__ float sample_offset(int j, int s) {
  return __fadd_rn((float)(j / s), __fdiv_rn((float)(j % s) + 0.5f, (float)s));
}

__device__ __forceinline__ Sample sample_at(float first, float last, float scale, int extent,
                                            float rcp, float g, int win_size, int quant) {
  const float lo = __fmul_rn(first, scale);
  const float hi = __fmul_rn(last, scale);
  const float bin = __fmul_rn(fmaxf(__fsub_rn(hi, lo), 1.0f), rcp);
  const float coord = __fmaf_rn(g, bin, lo);
  const float cl = fminf(fmaxf(coord, 0.0f), (float)(extent - 1));
  Sample e;
  e.i0 = (int)floorf(cl);
  e.i1 = min(e.i0 + 1, extent - 1);
  const float frac = __fsub_rn(cl, (float)e.i0);
  e.inside = coord >= -1.0f && coord <= (float)extent;
  e.w0 = __fsub_rn(1.0f, frac);
  e.w1 = frac;
  e.bad = 0;
  if (win_size > 0) {
    // the window's origin: one tap before the corner, inside the level
    // zero-padded to the quantum, floored to the quantum
    const int padded = (max(extent, win_size) + quant - 1) / quant * quant;
    int origin = min(max((int)floorf(lo) - 1, 0), max(padded - win_size, 0));
    origin = origin / quant * quant;
    const int rel0 = e.i0 - origin, rel1 = e.i1 - origin;
    if (rel0 < 0 || rel0 >= win_size) e.w0 = 0.0f;
    if (rel1 < 0 || rel1 >= win_size) e.w1 = 0.0f;
    e.bad = e.inside && (rel0 < 0 || rel0 > win_size - 1 || (frac > 0.0f && rel1 > win_size - 1));
  }
  return e;
}

// Every direction places the samples alike: rows 0..k-1 of the table are
// the roi's y samples, of the second its x samples, each with its two taps
// and their weights (sample_at).
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
  const Sample e = sample_at(roi[axis == 0 ? 1 : 0], roi[axis == 0 ? 3 : 2], scale,
                             axis == 0 ? H : W, __frcp_rn((float)pooled), sample_offset(j, s),
                             win.size, axis == 0 ? win.quant_y : win.quant_x);
  t.i0[axis][j] = e.i0;
  t.i1[axis][j] = e.i1;
  t.w0[axis][j] = e.w0;
  t.w1[axis][j] = e.w1;
  t.inside[axis][j] = e.inside;
  return e.bad;
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
//   dF_l[b, c, y, x] = sum, over the rois n of image b assigned to level l
//                      and the samples of their bins (py, px) whose taps fall
//                      on (y, x), of w_tap * dOut[b, n, c, py, px] / s^2;
// a sample outside the level adds nothing, and a clamped tap lands where the
// forward read it. Rois and levels get no gradient. It replaces
// `_pallas_roi_align_tiled_batched_bwd`, whose grid keeps each (image,
// channel chunk)'s whole dF level resident while it walks the roi blocks in
// order and adds `wy^T (dOut . wx)` for each.
//
// Design. A Hopper block cannot hold a level (P2 at 64 channels is 1.3 MB),
// so each block owns a tile of dF instead, kTileH rows x tile_w columns of
// one level of one image (a tile row is one 32-byte sector of dF: 8 float32
// or 16 bf16 values) and a slice of 32 channels, and visits the rois that
// reach it, in roi order. Two kernels, no atomics on dF:
//  1. Binning (roi_align_backward_bin_kernel, one block per (8 tiles,
//     image)): each roi's samples by sample_at, so they round as the
//     forward's; the first and last tap of its inside samples on each axis
//     bound its footprint (the taps are monotone in the sample). Each tile's
//     warp lists the rois whose footprint meets its tile, 32 at a time in
//     index order, so every list is in roi order. The blocks of an image
//     also write each roi's table: its samples (taps and weights, zero
//     outside the level) and its footprint.
//  2. The tile kernel (roi_align_backward_kernel): the tile's list goes to
//     shared memory; a ring of kStages rois' dOut slices (slice x pooled x
//     pooled, one contiguous run, 16 bytes a copy) and tables arrives by
//     cp.async ahead of use, and the block builds, from a roi's table, its
//     weights restricted to the tile, Ax (pooled x tile_w) and Ay (pooled x
//     kTileH). The contribution is the separable product Ay^T (dOut_c Ax):
//     a warp owns one column x of the tile and the 32 channels, a thread the
//     kTileH sums of its (channel, column) in registers; it forms v[py] =
//     sum_px dOut_c[py, px] Ax[px, x] over the px whose samples reach x,
//     then adds Ay[py, y] v[py] to the rows of the footprint. A warp whose
//     column the roi misses skips it. One barrier a roi; the next roi's
//     weights are built while this roi's sums run.
//  3. Each sum has one owner and takes the rois in list order, so dF is the
//     same bit for bit from run to run. At the end the tile goes through
//     shared memory and out once, in dF's dtype (bf16 rounded once from the
//     float32 sum), through the level's element strides with the threads
//     along x, four values a store where a row allows; a tile no roi reaches
//     writes zeros. No zero pass and no layout copy.
// The plan (back_plan below, mirrored by
// ops/roi_align_kernel.py::backward_launch_plan) sets tile_w, the slice, the
// threads and the shared memory; roi_align_backward_last_plan reports the
// last launch's.
//
// Bound. At the training shape (8 images x 320 rois, C=256, the 256 x 320
// pyramid) the function must read the 128 MB dOut and write the 55.7 MB of
// dF: 0.055 ms at 3.35 TB/s (scripts/kernel_bounds.py); at 800 px (4 x 320,
// bf16 dF) 0.063 ms. This design reads a roi's dOut once for each tile its
// footprint meets (chip_smoke.py logs that factor and the longest list).
// What holds it above the bound (scripts/roi_align_backward_phases.py, by
// ablation): the sums, the weights, the copies and the barrier a roi each
// take a share, and at 800 px the blocks of the tiles no roi reaches, which
// only write zeros; per roi and tile the block does little work between two
// barriers, so the SM issues well below its rate.

// A sample's entry in K8's table: its two taps and their weights, zero where
// the sample lies outside the level.
__device__ __forceinline__ int4 table_entry(const Sample& e) {
  return make_int4(e.i0, e.i1, __float_as_int(e.inside ? e.w0 : 0.0f),
                   __float_as_int(e.inside ? e.w1 : 0.0f));
}

// A level's sizes and tiles, read with static indices (a kernel that indexes
// its parameter arrays with a run-time level copies them to local memory).
struct LevelOf {
  int level, first_tile, tiles_x, h, w;
  float scale;
};

__device__ __forceinline__ LevelOf level_of_tile(const Tiling& tg, int tile) {
  LevelOf o{0, 0, 1, 1, 1, 0.0f};
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (i < tg.num && tile >= tg.base[i])
      o = LevelOf{i, tg.base[i], tg.tiles_x[i], tg.h[i], tg.w[i], tg.scale[i]};
  return o;
}

// A footprint's span of tiles on one axis, first | last << 16 (first >
// last: no sample inside, an empty span), and whether it holds tile t.
__device__ __forceinline__ int pack_span(int first, int last) { return first | last << 16; }
__device__ __forceinline__ bool holds(int span, int t) {
  return (span & 0xffff) <= t && t <= (span >> 16);
}

// One roi's footprint on one axis, in pixels: from the first tap of its
// first sample inside the level to the second tap of its last ((1, 0): no
// sample inside). The samples' coordinates and taps are monotone in j, so
// every tap of weight lies in between; most rois lie inside, and the two
// ends are the only samples placed. offs: the k samples' offsets.
__device__ __forceinline__ int2 footprint(float first, float last, float scale, int extent,
                                          float rcp, const float* offs, int k) {
  int lo = 0, hi = k - 1;
  Sample a = sample_at(first, last, scale, extent, rcp, offs[lo], 0, 1);
  while (!a.inside && lo < k - 1)
    a = sample_at(first, last, scale, extent, rcp, offs[++lo], 0, 1);
  if (!a.inside) return make_int2(1, 0);
  Sample z = sample_at(first, last, scale, extent, rcp, offs[hi], 0, 1);
  while (!z.inside && hi > lo) z = sample_at(first, last, scale, extent, rcp, offs[--hi], 0, 1);
  return make_int2(a.i0, z.i1);
}

__device__ __forceinline__ int span_of(int2 f, int size) {
  return f.x > f.y ? pack_span(1, 0) : pack_span(f.x / size, f.y / size);
}

// counts (B, tiles), lists (B, tiles, N): the rois of each tile in index
// order; table (B, N, 2k + 1): each roi's samples (k on y, then k on x) and
// its footprint (y first, last, x first, last). The rois of image b go
// through shared memory kBinThreads at a time; block x of the image writes
// its share of their samples, places every roi's footprint (the image's
// first block also stores them), then gives each of its warps a tile: the
// lanes test 32 rois at once, and a ballot ranks those that meet the tile,
// so the list comes out in roi order.
__global__ void __launch_bounds__(kBinThreads)
roi_align_backward_bin_kernel(Tiling tg, const float* __restrict__ rois,
                              const int* __restrict__ levels, int N, int pooled, int s,
                              int* __restrict__ counts, int* __restrict__ lists,
                              int4* __restrict__ table) {
  __shared__ float4 box[kBinThreads];
  __shared__ int4 print[kBinThreads];  // level, y span, x span of each roi of the chunk
  __shared__ float offs[kMaxSamples];  // the samples' offsets in bins
  __shared__ float lscale[kMaxLevels];
  __shared__ int lh[kMaxLevels], lw[kMaxLevels];

  const int b = blockIdx.y, k = pooled * s, row = 2 * k + 1;
  const float rcp = __frcp_rn((float)pooled);
  if (threadIdx.x < k) offs[threadIdx.x] = sample_offset(threadIdx.x, s);
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (threadIdx.x == i) lscale[i] = tg.scale[i], lh[i] = tg.h[i], lw[i] = tg.w[i];
  const int lane = threadIdx.x & 31, tiles = tg.tiles;
  const int tile = blockIdx.x * (kBinThreads / 32) + (threadIdx.x >> 5);
  const LevelOf at = level_of_tile(tg, tile);
  const int t_rel = tile - at.first_tile, t_y = t_rel / at.tiles_x, t_x = t_rel - t_y * at.tiles_x;
  int* list = lists + ((long long)b * tiles + tile) * N;
  int count = 0;
  for (int r0 = 0; r0 < N; r0 += kBinThreads) {
    const int m = min(kBinThreads, N - r0);
    if (threadIdx.x < m) {
      const long long roi = (long long)b * N + r0 + threadIdx.x;
      const float4 bx = reinterpret_cast<const float4*>(rois)[roi];
      box[threadIdx.x] = bx;
      print[threadIdx.x].x = clamp_level(levels[roi], tg.num);
    }
    __syncthreads();
    int4* entries = table + ((long long)b * N + r0) * row;
    for (int e = blockIdx.x * kBinThreads + threadIdx.x; e < m * 2 * k;
         e += gridDim.x * kBinThreads) {
      const int r = e / (2 * k), axis = (e - r * 2 * k) / k, j = e - r * 2 * k - axis * k;
      const int l = print[r].x;
      const float4 bx = box[r];
      entries[r * row + axis * k + j] =
          table_entry(sample_at(axis == 0 ? bx.y : bx.x, axis == 0 ? bx.w : bx.z, lscale[l],
                                axis == 0 ? lh[l] : lw[l], rcp, offs[j], 0, 1));
    }
    if (threadIdx.x < m) {
      const int l = print[threadIdx.x].x;
      const float4 bx = box[threadIdx.x];
      const int2 fy = footprint(bx.y, bx.w, lscale[l], lh[l], rcp, offs, k);
      const int2 fx = footprint(bx.x, bx.z, lscale[l], lw[l], rcp, offs, k);
      print[threadIdx.x] = make_int4(l, span_of(fy, kTileH), span_of(fx, tg.tile_w), 0);
      if (blockIdx.x == 0) entries[threadIdx.x * row + 2 * k] = make_int4(fy.x, fy.y, fx.x, fx.y);
    }
    __syncthreads();
    if (tile < tiles) {
      for (int r = lane; r < ((m + 31) & ~31); r += 32) {
        bool meets = false;
        if (r < m) {
          const int4 f = print[r];
          meets = f.x == at.level && holds(f.y, t_y) && holds(f.z, t_x);
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, meets);
        if (meets) list[count + __popc(ballot & ((1u << lane) - 1))] = r0 + r;
        count += __popc(ballot);
      }
    }
    __syncthreads();
  }
  if (tile < tiles && lane == 0) counts[(long long)b * tiles + tile] = count;
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// dF's elements as the kernel writes them: float32, or bf16 rounded once
// to nearest even; one, or four consecutive along x.
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16_bits* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_four(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_four(bf16_bits* p, float4 v) {
  const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v.x)) |
                      (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.y)) << 16;
  const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(v.z)) |
                      (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.w)) << 16;
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

constexpr int kStages = 4;       // K8's ring of rois in flight: dOut slices and sample tables
constexpr int kListChunk = 1024;  // a tile's rois staged in shared memory at a time

// K8's shared memory for `slice` channels of tiles tile_w wide: a ring of
// kStages dOut slices (pitch pooled^2 | 1, odd, so a warp's 32 channels fall
// in 32 banks) and of sample tables (2k + 1 entries); two buffers of Ax and
// Ay; then, over them, the finished tile (pitch kTileH * tile_w + 1).
struct BackLayout {
  int dout, table, ax, ay, total;
  __host__ __device__ BackLayout(int slice, int tile_w, int pooled, int s) {
    const int k = pooled * s;
    dout = 0;
    table = dout + align16(kStages * slice * ((pooled * pooled) | 1) * 4);
    ax = table + kStages * (2 * k + 1) * 16;
    ay = ax + align16(2 * pooled * tile_w * 4);
    const int pipeline = ay + 2 * pooled * kTileH * 4;
    const int staged = slice * (kTileH * tile_w + 1) * 4;
    total = pipeline > staged ? pipeline : staged;
  }
};

// Issues the copies of one roi's dOut slice (`live` channels x `bins`, one
// contiguous run at src) into dst at pitch dpitch: 16 bytes a copy where the
// run lands unpadded (bins odd) and aligned (`wide`), else 4.
__device__ __forceinline__ void copy_dout(float* dst, const float* src, int live, int bins,
                                          int dpitch, bool wide) {
  if (wide) {
    for (int i = threadIdx.x; i < live * bins / 4; i += blockDim.x)
      copy_async16(dst + 4 * i, src + 4 * i);
    return;
  }
  for (int i = threadIdx.x; i < live * bins; i += blockDim.x) {
    const int c = i / bins;
    copy_async(dst + c * dpitch + i - c * bins, src + i);
  }
}

__device__ __forceinline__ void copy_table(int4* dst, const int4* src, int entries) {
  for (int i = threadIdx.x; i < entries; i += blockDim.x) copy_async16(dst + i, src + i);
}

// A roi's weights restricted to the tile at (y0, x0), from its sample table
// e (k y samples, then k x samples): ax[px][x] and ay[py][y] sum the taps of
// bin px's (py's) samples that fall on x0 + x (y0 + y).
__device__ __forceinline__ void build_weights(const int4* e, float* ax, float* ay, int k,
                                              int pooled, int s, int tw, int y0, int x0) {
  for (int i = threadIdx.x; i < pooled * (tw + kTileH); i += blockDim.x) {
    const bool on_x = i < pooled * tw;
    const int width = on_x ? tw : kTileH, at = on_x ? i : i - pooled * tw;
    const int p = at / width, q = at - p * width, tap = (on_x ? x0 : y0) + q;
    const int4* axis = e + (on_x ? k : 0);
    float a = 0.0f;
    for (int j = p * s; j < p * s + s; ++j) {
      const int4 t = axis[j];
      if (t.x == tap) a += __int_as_float(t.z);
      if (t.y == tap) a += __int_as_float(t.w);
    }
    (on_x ? ax : ay)[p * width + q] = a;
  }
}

// One roi's share of a thread's sums, channel c (d: its dOut, pooled x
// pooled) at column x of the tile at (y0, x0): for each row y, the sum over
// py of ay[py][y] * v[py], v[py] = sum over px of dOut_c[py][px] *
// ax[px][x]. fp: the roi's footprint (y first, last, x first, last); the
// rows and columns it misses hold zero weights and are skipped, a column for
// the whole warp. The detector's pooled size, 7, is compiled in (P = 7);
// any other takes P = 0 and unrolls to kMaxPooled.
template <int P>
__device__ __forceinline__ void add_roi(float (&acc)[kTileH], const float* ax, const float* ay,
                                        int4 fp, const float* d, int pooled, int tw, int x,
                                        int y0, int x0, bool live) {
  constexpr int kP = P > 0 ? P : kMaxPooled;
  if (P > 0) pooled = P;
  if (x0 + x < fp.z || x0 + x > fp.w) return;
  float a[kP];
  bool any = false;
#pragma unroll
  for (int px = 0; px < kP; ++px) {
    a[px] = px < pooled ? ax[px * tw + x] : 0.0f;
    any |= a[px] != 0.0f;
  }
  if (!any || !live) return;  // `any` is the same across the warp
  float v[kP];
#pragma unroll
  for (int py = 0; py < kP; ++py) v[py] = 0.0f;
#pragma unroll
  for (int px = 0; px < kP; ++px) {
    if (a[px] == 0.0f) continue;
#pragma unroll
    for (int py = 0; py < kP; ++py)
      if (py < pooled) v[py] = __fmaf_rn(d[py * pooled + px], a[px], v[py]);
  }
  const int r0 = fp.x - y0, r1 = fp.y - y0;  // the footprint's rows in the tile
  const float4* ay4 = reinterpret_cast<const float4*>(ay);
#pragma unroll
  for (int q = 0; q < kTileH / 4; ++q) {
    if (4 * q > r1 || 4 * q + 3 < r0) continue;
#pragma unroll
    for (int py = 0; py < kP; ++py) {
      if (py >= pooled) break;
      const float4 w = ay4[py * (kTileH / 4) + q];
      acc[4 * q] = __fmaf_rn(w.x, v[py], acc[4 * q]);
      acc[4 * q + 1] = __fmaf_rn(w.y, v[py], acc[4 * q + 1]);
      acc[4 * q + 2] = __fmaf_rn(w.z, v[py], acc[4 * q + 2]);
      acc[4 * q + 3] = __fmaf_rn(w.w, v[py], acc[4 * q + 3]);
    }
  }
}

// dF of one (channel slice, tile, image): blockIdx = (slice, tile, image).
// A warp owns one column x of the tile and 32 channels of the slice, a
// thread one channel; the block has tile_w x slice / 32 warps. Roi j of the
// list: its dOut slice and its table in ring slot j % kStages, copied
// kStages - 1 rois ahead (the table one roi earlier still, for the
// weights), its weights in buffer j & 1. P: add_roi's.
template <typename T, int P>
__global__ void __launch_bounds__(kBackThreads)
roi_align_backward_kernel(Strided<T*> out, Tiling tg, const float* __restrict__ dout,
                          const int* __restrict__ counts, const int* __restrict__ lists,
                          const int4* __restrict__ table, int N, int C, int pooled, int s,
                          int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ids[kListChunk];
  const int k = pooled * s, row = 2 * k + 1, bins = pooled * pooled, dpitch = bins | 1;
  const int tw = tg.tile_w, b = blockIdx.z, tile = blockIdx.y;
  const BackLayout lay(slice, tw, pooled, s);
  float* dbuf = reinterpret_cast<float*>(smem + lay.dout);
  int4* tbuf = reinterpret_cast<int4*>(smem + lay.table);
  float* axs = reinterpret_cast<float*>(smem + lay.ax);
  float* ays = reinterpret_cast<float*>(smem + lay.ay);

  const LevelOf lv = level_of_tile(tg, tile);
  const int rel = tile - lv.first_tile, ty = rel / lv.tiles_x;
  const int y0 = ty * kTileH, x0 = (rel - ty * lv.tiles_x) * tw;
  const int c0 = blockIdx.x * slice, live = min(slice, C - c0);
  const int warp = threadIdx.x >> 5;
  const int x = warp % tw, c = (warp / tw) * 32 + (threadIdx.x & 31);
  const long long cell = (long long)b * tg.tiles + tile;
  const int count = counts[cell];
  const int* list = lists + cell * N;
  const float* dsrc = dout + ((long long)b * N * C + c0) * bins;  // + n * C * bins
  const int4* tsrc = table + (long long)b * N * row;              // + n * row
  const bool wide = dpitch == bins && (C * bins) % 4 == 0 && (live * bins) % 4 == 0 &&
                    (reinterpret_cast<unsigned long long>(dout) & 15) == 0;

  float acc[kTileH];
#pragma unroll
  for (int y = 0; y < kTileH; ++y) acc[y] = 0.0f;

  // the list, kListChunk rois at a time in shared memory; within a chunk,
  // group g holds roi g's dOut and roi g + 1's table (group 0 also roi 0's)
  for (int h0 = 0; h0 < count; h0 += kListChunk) {
    const int m = min(kListChunk, count - h0);
    __syncthreads();  // the last chunk's buffers are read
    for (int j = threadIdx.x; j < m; j += blockDim.x) ids[j] = __ldg(list + h0 + j);
    __syncthreads();
    copy_table(tbuf, tsrc + (long long)ids[0] * row, row);
    for (int g = 0; g < kStages - 1; ++g) {
      if (g < m) copy_dout(dbuf + g * slice * dpitch, dsrc + (long long)ids[g] * C * bins, live,
                           bins, dpitch, wide);
      if (g + 1 < m) copy_table(tbuf + (g + 1) * row, tsrc + (long long)ids[g + 1] * row, row);
      copy_commit();
    }
    copy_wait_group<kStages - 2>();  // group 0
    __syncthreads();
    build_weights(tbuf, axs, ays, k, pooled, s, tw, y0, x0);
    for (int i = 0; i < m; ++i) {
      // roi i's footprint, from its table (group i - 1, or group 0 for roi 0,
      // seen since the last barrier); read before the barrier below, after
      // which roi i + kStages's table is copied over it
      const int4 fp = tbuf[(i % kStages) * row + 2 * k];
      copy_wait_group<kStages - 2>();  // group i: roi i's dOut, roi i + 1's table
      __syncthreads();  // roi i's weights; every read of roi i - 1's buffers and roi i's table done
      const int g = i + kStages - 1;
      if (g < m)
        copy_dout(dbuf + (g % kStages) * slice * dpitch, dsrc + (long long)ids[g] * C * bins,
                  live, bins, dpitch, wide);
      if (g + 1 < m)
        copy_table(tbuf + ((g + 1) % kStages) * row, tsrc + (long long)ids[g + 1] * row, row);
      copy_commit();
      if (i + 1 < m)
        build_weights(tbuf + ((i + 1) % kStages) * row, axs + ((i + 1) & 1) * pooled * tw,
                      ays + ((i + 1) & 1) * pooled * kTileH, k, pooled, s, tw, y0, x0);
      add_roi<P>(acc, axs + (i & 1) * pooled * tw, ays + (i & 1) * pooled * kTileH, fp,
                 dbuf + (i % kStages) * slice * dpitch + c * dpitch, pooled, tw, x, y0, x0,
                 c < live);
    }
    copy_wait_group<0>();
  }

  // the tile through shared memory (a tile no roi reaches: zeros), then out once
  const int area = kTileH * tw, pitch = area + 1;
  float* staged = reinterpret_cast<float*>(smem);
  if (count > 0) {
    __syncthreads();
#pragma unroll
    for (int y = 0; y < kTileH; ++y) staged[c * pitch + y * tw + x] = acc[y];
    __syncthreads();
  }
  const float inv = 1.0f / (float)(s * s);
  long long sc = 0, sb = 0;
  int sy = 0, sx = 0;
  T* feat = nullptr;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {  // static indices, as in level_of_tile
    if (i != lv.level) continue;
    sc = out.sc[i], sb = out.sb[i], sy = out.sy[i], sx = out.sx[i];
    feat = out.feat[i];
  }
  const int H = lv.h, W = lv.w;
  T* base = feat + b * sb + c0 * sc;
  if (sx == 1 && (W | sy | tw) % 4 == 0 && sc % 4 == 0 && sb % 4 == 0 &&
      (reinterpret_cast<unsigned long long>(feat) & 15) == 0) {
    // four consecutive pixels of a row a thread, threads along x
    const int quads = tw / 4;
    for (int i = threadIdx.x; i < live * kTileH * quads; i += blockDim.x) {
      const int cc = i / (kTileH * quads), p = i - cc * kTileH * quads;
      const int yy = p / quads, xx = 4 * (p - yy * quads);
      if (y0 + yy >= H || x0 + xx >= W) continue;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (count > 0) {
        const float* src = staged + cc * pitch + yy * tw + xx;
        v = make_float4(__fmul_rn(src[0], inv), __fmul_rn(src[1], inv), __fmul_rn(src[2], inv),
                        __fmul_rn(src[3], inv));
      }
      store_four(base + cc * sc + (y0 + yy) * sy + x0 + xx, v);
    }
    return;
  }
  for (int i = threadIdx.x; i < live * area; i += blockDim.x) {
    const int cc = i / area, p = i - cc * area, yy = p / tw, xx = p - yy * tw;
    if (y0 + yy < H && x0 + xx < W)
      store_one(base + cc * sc + (y0 + yy) * sy + (x0 + xx) * sx,
                count > 0 ? __fmul_rn(staged[cc * pitch + p], inv) : 0.0f);
  }
}

// strides: num_levels x (b, c, y, x) element strides. False where a level is
// empty or a plane's pixel offsets do not fit 32 bits.
template <typename P>
bool fill_strided(Strided<P>& lv, const void* const* ptrs, const int* heights,
                  const int* widths, const float* scales, const long long* strides,
                  int num_levels) {
  lv.num = num_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < num_levels;
    lv.feat[i] = used ? static_cast<P>(const_cast<void*>(ptrs[i])) : nullptr;
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

namespace {

// K8's plan: channels of a block, tile width, threads, dynamic shared
// memory bytes.
struct BackPlan {
  int slice;
  int tile_w;
  int threads;
  int smem;
};

// The plan of the last K8 launch, its grid's channel slices and tiles.
int g_last_back_plan[7] = {0, 0, 0, 0, 0, 0, 0};

// K8's plan for dF elements of `itemsize` bytes (2 or 4) at pooled x s, the
// one owner of its layout: 32 channels a block (a warp's lanes), a tile row
// of dF one 32-byte sector, a warp a tile column, and BackLayout's bytes.
// ops/roi_align_kernel.py::backward_launch_plan mirrors it (the card tests
// hold the two equal through roi_align_backward_plan). smem 0: it does not
// fit a block beside the static roi list.
BackPlan back_plan(int pooled, int s, int itemsize) {
  BackPlan plan{32, 32 / itemsize, 0, 0};
  plan.threads = plan.slice * plan.tile_w;
  const int smem = BackLayout(plan.slice, plan.tile_w, pooled, s).total;
  plan.smem = smem + kListChunk * (int)sizeof(int) <= 232448 ? smem : 0;
  return plan;
}

// True where the caller's plan (slice, tile_w, threads, smem) is K8's own.
bool plan_is_own(const int* plan, int pooled, int s, int itemsize) {
  const BackPlan own = back_plan(pooled, s, itemsize);
  return own.smem > 0 && plan[0] == own.slice && plan[1] == own.tile_w &&
         plan[2] == own.threads && plan[3] == own.smem;
}

// False where a level is empty or the tiles of an image exceed the grid.
bool fill_tiling(Tiling& tg, const int* heights, const int* widths, const float* scales,
                 int num_levels, int tile_w) {
  tg.num = num_levels;
  tg.tile_w = tile_w;
  tg.base[0] = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool used = i < num_levels;
    tg.h[i] = used ? heights[i] : 0;
    tg.w[i] = used ? widths[i] : 0;
    tg.scale[i] = used ? scales[i] : 0.0f;
    tg.tiles_x[i] = used ? (tg.w[i] + tile_w - 1) / tile_w : 0;
    const long long tiles = used ? (long long)tg.tiles_x[i] * ((tg.h[i] + kTileH - 1) / kTileH) : 0;
    if (used && (tg.h[i] < 1 || tg.w[i] < 1 || tg.base[i] + tiles > 65535)) return false;
    tg.base[i + 1] = tg.base[i] + (int)tiles;
  }
  tg.tiles = tg.base[num_levels];
  return true;
}

int launch_bins(const Tiling& tg, const void* rois, const void* levels, int B, int N, int pooled,
                int s, void* counts, void* lists, void* table, cudaStream_t stream) {
  const dim3 grid((tg.tiles + kBinThreads / 32 - 1) / (kBinThreads / 32), B);
  roi_align_backward_bin_kernel<<<grid, kBinThreads, 0, stream>>>(
      tg, static_cast<const float*>(rois), static_cast<const int*>(levels), N, pooled, s,
      static_cast<int*>(counts), static_cast<int*>(lists), static_cast<int4*>(table));
  return (int)cudaGetLastError();
}

bool valid_backward(int num_levels, int B, int N, int pooled, int s) {
  return num_levels >= 1 && num_levels <= kMaxLevels && B >= 1 && B <= 65535 && N >= 1 &&
         pooled >= 1 && pooled <= kMaxPooled && s >= 1 && pooled * s <= kMaxSamples;
}

template <typename T>
int launch_backward(void* const* grads, const long long* strides, const void* dout, int C,
                    const int* heights, const int* widths, const float* scales, int num_levels,
                    const void* rois, const void* levels, int B, int N, int pooled, int s,
                    const int* plan_in, void* counts, void* lists, void* table, void* stream) {
  const BackPlan plan = back_plan(pooled, s, (int)sizeof(T));
  Strided<T*> out;
  Tiling tg;
  if (!valid_backward(num_levels, B, N, pooled, s) || C < 1 ||
      !plan_is_own(plan_in, pooled, s, (int)sizeof(T)) ||
      !fill_strided(out, const_cast<const void* const*>(grads), heights, widths, scales, strides,
                    num_levels) ||
      !fill_tiling(tg, heights, widths, scales, num_levels, plan.tile_w))
    return (int)cudaErrorInvalidValue;
  const auto cs = static_cast<cudaStream_t>(stream);
  int err = launch_bins(tg, rois, levels, B, N, pooled, s, counts, lists, table, cs);
  if (err != 0) return err;
  // the detector's pooled size, 7, compiled in; any other at run time
  const auto kernel =
      pooled == 7 ? roi_align_backward_kernel<T, 7> : roi_align_backward_kernel<T, 0>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)  // the static roi list comes on top of these bytes
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C + plan.slice - 1) / plan.slice, tg.tiles, B);
  kernel<<<grid, plan.threads, plan.smem, cs>>>(
      out, tg, static_cast<const float*>(dout), static_cast<const int*>(counts),
      static_cast<const int*>(lists), static_cast<const int4*>(table), N, C, pooled, s,
      plan.slice);
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    const int last[7] = {plan.slice, kTileH, plan.tile_w, plan.threads, plan.smem, (int)grid.x,
                         (int)grid.y};
    for (int i = 0; i < 7; ++i) g_last_back_plan[i] = last[i];
  }
  return (int)e;
}

}  // namespace

// K8's binning and table alone. heights, widths, scales: host arrays of the
// levels'; rois (B, N, 4) float32 and levels (B, N) int32 on the device;
// plan: host array (slice, tile_w, threads, smem) from backward_launch_plan,
// refused unless it is back_plan's (tile_w 8: float32 dF, 16: bf16); counts
// (B, tiles) int32, lists (B, tiles, N) int32 and table (B, N, 2k + 1) int4
// (k = pooled * sampling_ratio), device scratch that receives the bins. Returns the launch's cudaError_t (0 on success).
#define BACKWARD_ARGS                                                                     \
  const int *heights, const int *widths, const float *scales, int num_levels,             \
      const void *rois, const void *levels, int B, int N, int pooled, int sampling_ratio,  \
      const int *plan, void *counts, void *lists, void *table
#define BACKWARD_PASS                                                                  \
  heights, widths, scales, num_levels, rois, levels, B, N, pooled, sampling_ratio, plan, \
      counts, lists, table

extern "C" int roi_align_backward_bins(BACKWARD_ARGS, void* stream) {
  Tiling tg;
  if (!valid_backward(num_levels, B, N, pooled, sampling_ratio) ||
      !(plan[1] == 8 || plan[1] == 16) ||
      !plan_is_own(plan, pooled, sampling_ratio, 32 / plan[1]) ||
      !fill_tiling(tg, heights, widths, scales, num_levels, plan[1]))
    return (int)cudaErrorInvalidValue;
  return launch_bins(tg, rois, levels, B, N, pooled, sampling_ratio, counts, lists, table,
                     static_cast<cudaStream_t>(stream));
}

// K8: the binning, then the tile kernel. grads: host array of num_levels
// device pointers, each dF's level (B, C, H_l, W_l) in any layout, float32
// (_f32) or bfloat16 (_bf16), written in full; strides: host array of
// num_levels x (b, c, y, x) element strides; dout (B, N, C, pooled, pooled)
// float32; the rest as for roi_align_backward_bins.
extern "C" int roi_align_backward_f32(void* const* grads, const long long* strides,
                                      const void* dout, int C, BACKWARD_ARGS, void* stream) {
  return launch_backward<float>(grads, strides, dout, C, BACKWARD_PASS, stream);
}

extern "C" int roi_align_backward_bf16(void* const* grads, const long long* strides,
                                       const void* dout, int C, BACKWARD_ARGS, void* stream) {
  return launch_backward<bf16_bits>(grads, strides, dout, C, BACKWARD_PASS, stream);
}

// K8's own plan for dF elements of `itemsize` bytes at pooled x
// sampling_ratio: out[5] = (slice, tile_h, tile_w, threads, smem). Returns
// cudaErrorInvalidValue where K8 does not take it or it does not fit a
// block, else 0.
extern "C" int roi_align_backward_plan(int pooled, int sampling_ratio, int itemsize, int* out) {
  if (!(itemsize == 2 || itemsize == 4) || !valid_backward(1, 1, 1, pooled, sampling_ratio))
    return (int)cudaErrorInvalidValue;
  const BackPlan plan = back_plan(pooled, sampling_ratio, itemsize);
  if (plan.smem == 0) return (int)cudaErrorInvalidValue;
  const int own[5] = {plan.slice, kTileH, plan.tile_w, plan.threads, plan.smem};
  for (int i = 0; i < 5; ++i) out[i] = own[i];
  return 0;
}

// The last successful K8 launch's plan and grid: out[7] = (slice, tile_h,
// tile_w, threads, smem, channel slices, tiles of an image).
extern "C" void roi_align_backward_last_plan(int* out) {
  for (int i = 0; i < 7; ++i) out[i] = g_last_back_plan[i];
}
