// LSTM recurrence forward and backward for Hopper (sm_90a), fp32.
//
// Replaces three Pallas TPU kernels of objectpermanence_tpu/ops/pallas_scan.py:
//   K2 `_lstm_fwd_pallas` (kernel `_lstm_fwd_kernel`): from xproj (T, B, 4H) and
//      w_hh (H, 4H), run T dependent steps gates = xproj[t] + h @ w_hh, the cell
//      with gates [i, f, g, o], and emit h and c of every step;
//   K4 `lstm_scan_pallas` (kernel `_lstm_kernel`): the same recurrence, emitting
//      h only (the forward kernel below with `cs == nullptr`);
//   K3 `_lstm_bwd_pallas` (kernel `_lstm_bwd_kernel`): walk time in reverse,
//      recompute the gates from xproj[t] and h_prev[t], carry (dh, dc) back one
//      step, emit dgates (= dxproj) and accumulate dW_hh += h_prev^T dgates.
// All sequences are time-major, all weights gate-major as in the JAX package
// (column g * H + u for gate g of unit u). Carries are fp32 and start at zero.
// No biases. The input projection xproj = x @ w_ih and the products for dW_ih
// and dx stay outside, as XLA computed them outside Pallas.
//
// Forward design (K2, K4). At the training batch (16 videos) a tile of videos
// per block would put a handful of blocks on the card, each re-reading w_hh
// (4 MB at H = 512) from L2 at every step. Instead the grid splits the HIDDEN
// UNITS: block n owns units [n*U, n*U + U) for every video and every step, and
// keeps the four gate columns of w_hh for its units in shared memory for the
// whole sequence (H x 4U floats: 32 KB at H = 512, U = 4, 128 blocks). Steps
// exchange h through device memory: each block writes its units' h, a
// grid-wide barrier (cooperative launch, so all blocks are co-resident; the
// wrapper raises if they do not fit), and each block reads the whole h_prev of
// a tile of videos into shared memory. Within a block, 64 (video, unit) pairs
// each take one quarter of the contraction over k, the four partial sums are
// added in a fixed order, and one thread per pair runs the cell; it owns that
// (video, unit)'s c for all steps.
//
// Backward design (K3). Of the TPU kernel's three products only one depends
// on the backward carry, so K3 is three launches on one stream (four when
// (C) is split):
//   (A) the gates of all T steps before the reverse walk, in parallel over
//       (t, b): act(xproj + h_prev @ w_hh) as one tiled product of (T*B, H) by
//       (H, 4H), written into dxproj (`tile_product_kernel<false, true>`);
//   (B) the carry loop (`lstm_bwd_loop_kernel`), a cooperative grid of G video
//       groups x S unit slices. Block (g, s) owns the videos of group g and
//       the units of slice s: it keeps the ROWS of w_hh of its units in shared
//       memory (U x 4H floats, one copy), and dc of its (video, unit) pairs and
//       the warps' parts of their dh in shared memory for all steps. Per step:
//       the cell, elementwise from the stored gates, overwrites the gates of
//       its pairs in dxproj with dgates; a barrier among the group's S blocks
//       only (the recurrence never mixes videos), with the next step's cell
//       inputs prefetched by cp.async between its arrival and its wait; the
//       group's dgates of the step staged in one pass of 16-byte cp.async.cg
//       copies (L1-bypassing: other blocks wrote them in this launch);
//       dh_prev of its pairs = dgates @ w_hh[units]^T, a float4 loop over the
//       4H columns split over the block's threads (lanes of a warp take
//       consecutive units, two each, so the dgates loads are broadcasts),
//       summed by butterfly shuffles, and over the warps in a fixed order by
//       the next cell. The barrier counters live in the wrapper's scratch;
//   (C) dW_hh = h_prev^T @ dgates over all T*B rows after the loop, the same
//       tiled product (`tile_product_kernel<true, false>`): each block owns one
//       tile of dW_hh and a split of the rows, adding them in order; the
//       splits' partial tiles (in the scratch) are then added in split order
//       (`sum_splits_kernel`), so that 64 tiles at H = 512 fill the card.
// No atomics on data: each sum is taken in the same order on every run, so
// two calls give bitwise-equal outputs. The plan (`make_bwd_plan`) picks G
// and S from a cost model of a step (FMAs, shared-memory reads of the rows,
// staging bytes, barrier arrivals) among the grids that fit one block per SM;
// if none fits, the entry returns cudaErrorCooperativeLaunchTooLarge and the
// wrapper raises. At B = 16 it picks G = 4 x S = 32 at H = 512 (16 units,
// 128 KB of rows, and 4 videos a block, 32 KB of dgates staged a step) and G
// = 8 x S = 16 at H = 256.
//
// Bound. At B = 16, T = 300, H = 512 the forward does 2.5 GFLOP (0.15 ms at
// the card's 67 TFLOP/s fp32) and moves 15 MB (4.6 us at 3.35 TB/s): bound by
// operations; the backward three times the operations. The forward is far
// from that: every step costs a grid barrier and an L2 round trip for h. In
// the backward, (A) and (C) are 10 GFLOP each at that shape, at about 40% of
// the fp32 peak in these tiles; the loop's 300 steps are each a group
// barrier, an L2 round trip and about 131 K FMAs a block, latency more than
// throughput (`scripts/lstm_scan_phases.py` splits its time). fp32 parity
// with the JAX reference rules out TF32 tensor cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 4;                   // the contraction is split in 4
constexpr int kPairs = kThreads / kSlices;   // 64 (video, unit) pairs per pass
constexpr int kMaxUnits = 64;                // U is a power of two dividing kPairs

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& w) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

// acc.c += d.c * w.c for each component c: a dot product's four column phases
__device__ __forceinline__ void fma4_dot(float4& acc, const float4& d, const float4& w) {
  acc.x = fmaf(d.x, w.x, acc.x);
  acc.y = fmaf(d.y, w.y, acc.y);
  acc.z = fmaf(d.z, w.z, acc.z);
  acc.w = fmaf(d.w, w.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// Floats of hsm [BT][H + 1], rounded up to whole float4s so what follows it
// stays 16-byte aligned.
__host__ __device__ inline int hsm_floats(int H, int U) {
  return ((kPairs / U) * (H + 1) + 3) / 4 * 4;
}

// Shared memory of the forward: red [kSlices][kPairs] and ws [H][U] in float4s
// (ws: the four gate columns of each owned unit), then hsm.
__host__ __device__ inline size_t fwd_smem_bytes(int H, int U) {
  return sizeof(float4) * ((size_t)kSlices * kPairs + (size_t)H * U) +
         sizeof(float) * (size_t)hsm_floats(H, U);
}

// Copy the gate columns of units [u0, u0 + U) into ws[k * U + u] = (i, f, g, o).
__device__ __forceinline__ void load_columns(const float* __restrict__ w_hh, float4* ws, int H,
                                             int U, int u0) {
  for (int i = threadIdx.x; i < H * U; i += kThreads) {
    const int k = i / U, col = u0 + i % U;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < H) {
      const float* row = w_hh + (size_t)k * 4 * H + col;
      w = make_float4(__ldg(row), __ldg(row + H), __ldg(row + 2 * H), __ldg(row + 3 * H));
    }
    ws[i] = w;
  }
}

// Stage rows [b0, b0 + nb) of a (B, width) slab, columns [c0, c0 + H), into
// hsm[bl][k] (row stride H + 1, so the pairs of a warp hit distinct banks).
// `coherent` loads bypass L1: the slab was written by other blocks in this
// launch, before the last grid barrier.
template <bool coherent>
__device__ __forceinline__ void stage_rows(const float* src, int width, int c0, int nb, int H,
                                           float* hsm) {
  for (int i = threadIdx.x; i < nb * H; i += kThreads) {
    const int bl = i / H, k = i % H;
    const float* p = src + (size_t)bl * width + c0 + k;
    hsm[bl * (H + 1) + k] = coherent ? __ldcg(p) : __ldg(p);
  }
}

// Partial gates of pair (bl, u) over this thread's quarter of k.
__device__ __forceinline__ float4 partial_gates(const float* hsm, const float4* ws, int H, int U,
                                                int bl, int u, int k_lo, int k_hi) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* hrow = hsm + bl * (H + 1);
  for (int k = k_lo; k < k_hi; ++k) fma4(acc, hrow[k], ws[k * U + u]);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* __restrict__ xproj,  // (T, B, 4H)
                const float* __restrict__ w_hh,   // (H, 4H)
                float* hs,                        // (T, B, H), also the h exchange
                float* cs,                        // (T, B, H), or nullptr: h only (K4)
                float* c_state,                   // (B, H) carry when cs is nullptr
                int T, int B, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float4* red = smem4;
  float4* ws = red + kSlices * kPairs;
  float* hsm = reinterpret_cast<float*>(ws + H * U);

  const int BT = kPairs / U;
  const int tid = threadIdx.x;
  const int p = tid % kPairs, slice = tid / kPairs;
  const int bl = p / U, u = p % U;
  const int unit = blockIdx.x * U + u;
  const int kc = (H + kSlices - 1) / kSlices;
  const int k_lo = min(H, slice * kc), k_hi = min(H, k_lo + kc);
  const size_t G = 4 * (size_t)H;

  load_columns(w_hh, ws, H, U, blockIdx.x * U);

  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      __syncthreads();  // the previous tile's hsm and red are consumed
      if (t > 0) stage_rows<true>(hs + ((size_t)(t - 1) * B + b0) * H, H, 0, nb, H, hsm);
      __syncthreads();
      // at t == 0 the carry h is zero, and so is its product
      red[slice * kPairs + p] = (t > 0 && bl < nb) ? partial_gates(hsm, ws, H, U, bl, u, k_lo, k_hi)
                                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
      if (slice == 0 && bl < nb && unit < H) {
        float4 s = red[p];
        for (int q = 1; q < kSlices; ++q) add4(s, red[q * kPairs + p]);
        const int b = b0 + bl;
        const float* xp = xproj + ((size_t)t * B + b) * G + unit;
        const float gi = sigmoid_f(__ldg(xp) + s.x);
        const float gf = sigmoid_f(__ldg(xp + H) + s.y);
        const float gg = tanhf(__ldg(xp + 2 * H) + s.z);
        const float go = sigmoid_f(__ldg(xp + 3 * H) + s.w);
        const size_t o = ((size_t)t * B + b) * H + unit;
        float* c_here = cs ? cs + o : c_state + (size_t)b * H + unit;
        const float c_prev = t == 0 ? 0.f : (cs ? cs[o - (size_t)B * H] : *c_here);
        const float c = gf * c_prev + gi * gg;
        *c_here = c;
        hs[o] = go * tanhf(c);
      }
    }
    grid.sync();  // h of step t is in device memory for every block
  }
}

// ---------------------------------------------------------------- K3 ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Barrier among the blocks that share `counter`, in two halves so that a
// block can issue work that needs no other block between them: the k-th
// arrival of each block, then a wait until all have arrived k times
// (target = blocks x k). The blocks are co-resident (cooperative launch), as
// cooperative groups' grid barrier requires.
__device__ __forceinline__ void group_arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // release: the block's writes before the __syncthreads are visible to a
    // block that acquires the count
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
  }
}
__device__ __forceinline__ void group_wait(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

constexpr int kTileK = 8;
constexpr int kMaxSplits = 16;

// C (M, N) = A (M, K) @ Bm (K, N), all row-major fp32; with kTransA, A is
// given as its transpose (K, M). With kGates, C = the activated gates of
// xproj + A @ Bm (N = 4H, columns gate-major: sigmoid, sigmoid, tanh,
// sigmoid). Split over k: block z sums rows [z * k_rows, (z + 1) * k_rows)
// into C + z * M * N (`sum_splits_kernel` adds the splits in order). Tiles
// of 128 x 128 x 8 in shared memory, the next tile's loads in registers
// while this one's FMAs run; 16 x 16 threads, each an 8 x 8 register tile of
// rows (ii * 16 + ty) * 4 + c and columns (jj * 16 + tx) * 4 + d. Each
// output sums its k in order, in one thread. Two blocks an SM (128
// registers; ptxas spills a few bytes) ran faster than one.
template <bool kTransA, bool kGates>
__global__ void __launch_bounds__(kThreads, 2)
tile_product_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ xproj, float* __restrict__ C, int M, int N,
                    int K, int k_rows, int H) {
  constexpr int BM = 128, BN = 128;
  constexpr int TI = BM / 64, TJ = BN / 64;  // float4s of rows and columns a thread
  constexpr int LA = BM * kTileK / kThreads, LB = BN * kTileK / kThreads;
  __shared__ __align__(16) float As[kTileK][BM + 4];
  __shared__ __align__(16) float Bs[kTileK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = blockIdx.z * k_rows, k_hi = min(K, k_lo + k_rows);
  C += (size_t)blockIdx.z * M * N;
  float ra[LA], rb[LB];

  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < LA; ++r) {
      const int e = tid + r * kThreads;
      const int m = kTransA ? e % BM : e / kTileK, k = kTransA ? e / BM : e % kTileK;
      const int gm = m0 + m, gk = k0 + k;
      ra[r] = (gm < M && gk < k_hi)
                  ? __ldg(kTransA ? A + (size_t)gk * M + gm : A + (size_t)gm * K + gk)
                  : 0.f;
    }
#pragma unroll
    for (int r = 0; r < LB; ++r) {
      const int e = tid + r * kThreads;
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      rb[r] = (gk < k_hi && gn < N) ? __ldg(Bm + (size_t)gk * N + gn) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < LA; ++r) {
      const int e = tid + r * kThreads;
      const int m = kTransA ? e % BM : e / kTileK, k = kTransA ? e / BM : e % kTileK;
      As[k][m] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < LB; ++r) {
      const int e = tid + r * kThreads;
      Bs[e / BN][e % BN] = rb[r];
    }
  };

  float acc[TI][4][TJ][4];
#pragma unroll
  for (int ii = 0; ii < TI; ++ii)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj)
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[ii][c][jj][d] = 0.f;

  load(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += kTileK) {
    store();
    __syncthreads();
    if (k0 + kTileK < k_hi) load(k0 + kTileK);  // in flight during this tile's FMAs
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float4 a[TI], b[TJ];
#pragma unroll
      for (int ii = 0; ii < TI; ++ii)
        a[ii] = *reinterpret_cast<const float4*>(&As[k][(ii * 16 + ty) * 4]);
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(&Bs[k][(jj * 16 + tx) * 4]);
#pragma unroll
      for (int ii = 0; ii < TI; ++ii) {
        const float av[4] = {a[ii].x, a[ii].y, a[ii].z, a[ii].w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj) {
            acc[ii][c][jj][0] = fmaf(av[c], b[jj].x, acc[ii][c][jj][0]);
            acc[ii][c][jj][1] = fmaf(av[c], b[jj].y, acc[ii][c][jj][1]);
            acc[ii][c][jj][2] = fmaf(av[c], b[jj].z, acc[ii][c][jj][2]);
            acc[ii][c][jj][3] = fmaf(av[c], b[jj].w, acc[ii][c][jj][3]);
          }
      }
    }
    __syncthreads();
  }

  // N is a multiple of 4 (N = 4H), so a column group of 4 is in or out whole
#pragma unroll
  for (int ii = 0; ii < TI; ++ii)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gm = m0 + (ii * 16 + ty) * 4 + c;
      if (gm >= M) continue;
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const int gn = n0 + (jj * 16 + tx) * 4;
        if (gn >= N) continue;
        float v[4] = {acc[ii][c][jj][0], acc[ii][c][jj][1], acc[ii][c][jj][2],
                      acc[ii][c][jj][3]};
        if (kGates) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(xproj + (size_t)gm * N + gn));
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const float z = xv[d] + v[d];
            v[d] = (gn + d) / H == 2 ? tanhf(z) : sigmoid_f(z);
          }
        }
        *reinterpret_cast<float4*>(C + (size_t)gm * N + gn) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
}

// How K3's carry loop is laid out (`make_bwd_plan`).
struct BwdPlan {
  int groups;   // G video groups
  int slices;   // S unit slices; the grid is G x S blocks, all co-resident
  int videos;   // Bg = ceil(B / G) videos of a group
  int units;    // U = ceil(H / S) units of a slice
  int lanes;    // UL, unit lanes of a warp in the dh product (a power of two <= 32);
                // a lane takes units u and u + UL of each 2 UL
  int width;    // UW, units of the resident rows, U rounded up to 2 UL (zero rows)
  int stage;    // VS, videos of dgates staged at once
  size_t smem;  // dynamic shared memory bytes of a block
  int splits;      // (C) splits over the T*B rows, and rows of each
  int split_rows;
  size_t scratch;  // bytes: (C)'s partial sums when split, then G barrier counters
};

// Shared memory of the loop: wt [H][UW] float4, dgs [VS][4H], red
// [kWarps][Bg][UW], dcs [Bg][U], cb [2][7][Bg][U] floats.
inline size_t loop_smem_bytes(int H, int Bg, int U, int UW, int VS) {
  return sizeof(float4) * (size_t)H * UW +
         sizeof(float) * ((size_t)VS * 4 * H + (size_t)kWarps * Bg * UW + 15 * (size_t)Bg * U);
}

__global__ void __launch_bounds__(kThreads)
lstm_bwd_loop_kernel(const float* __restrict__ c_prev,  // (T, B, H)
                     const float* __restrict__ cs,      // (T, B, H)
                     const float* __restrict__ dh_out,  // (T, B, H)
                     const float* __restrict__ w_hh,    // (H, 4H)
                     float* dxproj,      // (T, B, 4H): in the gates, out dgates; the exchange
                     unsigned* counters,  // (G,) zeroed: the group barriers
                     int T, int B, int H, BwdPlan p) {
  extern __shared__ float4 smem4[];
  const int U = p.units, UW = p.width, UL = p.lanes, Bg = p.videos, VS = p.stage;
  const int S = p.slices;
  const int g = blockIdx.x / S, s = blockIdx.x % S;
  const int b0 = g * Bg, nb = min(Bg, B - b0);
  const int u0 = s * U, nu = min(U, H - u0);
  const int np = nb * nu, PB = Bg * U;  // pairs of the block, and their slots
  const size_t G4 = 4 * (size_t)H;
  float4* wt = smem4;  // wt[j4 * UW + u] = w_hh[u0 + u, 4 j4 .. 4 j4 + 3]
  float* dgs = reinterpret_cast<float*>(wt + (size_t)H * UW);  // [VS][4H]
  float* red = dgs + (size_t)VS * G4;  // [kWarps][Bg][UW]: each warp's part of dh
  float* dcs = red + kWarps * Bg * UW;  // [Bg][U]: dc of the pairs
  float* cb = dcs + PB;  // [2][7][Bg][U]: i, f, g, o, dh_out, c, c_prev of a step
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int parts = kThreads / UL, part = tid / UL;  // the dh product's split of j4

  for (int i = tid; i < H * UW; i += kThreads) {
    const int j4 = i / UW, u = i % UW;
    wt[i] = u < nu ? __ldg(reinterpret_cast<const float4*>(w_hh + (size_t)(u0 + u) * G4) + j4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < kWarps * Bg * UW; i += kThreads) red[i] = 0.f;
  for (int i = tid; i < PB; i += kThreads) dcs[i] = 0.f;

  // the cell's inputs of step t into cb[buf]; nothing of it depends on the carry
  auto prefetch = [&](int t, int buf) {
    float* dst = cb + (size_t)buf * 7 * PB;
    for (int q = tid; q < np; q += kThreads) {
      const int v = q / nu, u = q % nu, slot = v * U + u;
      const size_t row = (size_t)t * B + b0 + v;
      const float* gate = dxproj + row * G4 + u0 + u;
      const size_t o = row * H + u0 + u;
      for (int k = 0; k < 4; ++k) cp_async4(dst + k * PB + slot, gate + k * H);
      cp_async4(dst + 4 * PB + slot, dh_out + o);
      cp_async4(dst + 5 * PB + slot, cs + o);
      cp_async4(dst + 6 * PB + slot, c_prev + o);
    }
    cp_async_commit();
  };

  prefetch(T - 1, 0);
  for (int t = T - 1; t >= 0; --t) {  // the carry loop
    const int buf = (T - 1 - t) & 1;
    cp_async_wait_all();
    __syncthreads();  // the cell's inputs and the last step's parts of dh are in place
    const float* in = cb + (size_t)buf * 7 * PB;
    for (int q = tid; q < np; q += kThreads) {
      const int v = q / nu, u = q % nu, slot = v * U + u;
      const float gi = in[slot], gf = in[PB + slot], gg = in[2 * PB + slot];
      const float go = in[3 * PB + slot];
      float dh = red[v * UW + u];  // the warps' parts, in order
      for (int w = 1; w < kWarps; ++w) dh += red[(w * Bg + v) * UW + u];
      const float dh_total = in[4 * PB + slot] + dh;
      const float tanh_c = tanhf(in[5 * PB + slot]);
      const float dc = dcs[slot] + dh_total * go * (1.0f - tanh_c * tanh_c);
      float* dx = dxproj + ((size_t)t * B + b0 + v) * G4 + u0 + u;
      dx[0] = dc * gg * gi * (1.0f - gi);
      dx[H] = dc * in[6 * PB + slot] * gf * (1.0f - gf);
      dx[2 * H] = dc * gi * (1.0f - gg * gg);
      dx[3 * H] = dh_total * tanh_c * go * (1.0f - go);
      dcs[slot] = dc * gf;
    }
    if (t == 0) break;  // no earlier step to carry into
    group_arrive(counters + g);
    prefetch(t - 1, buf ^ 1);  // the next cell's inputs, while the group arrives
    group_wait(counters + g, (unsigned)S * (unsigned)(T - t));
    // dh_prev[v, u] = sum_j dgates[t, v, j] w_hh[u0 + u, j], VS videos at a time
    for (int c0 = 0; c0 < nb; c0 += VS) {
      const int vs = min(VS, nb - c0);
      const float* src = dxproj + ((size_t)t * B + b0 + c0) * G4;
      for (int i = tid; i < vs * H; i += kThreads)
        cp_async16(dgs + 4 * i, src + 4 * i);
      cp_async_commit();
      cp_async_wait_all();  // the chunk of dgates
      __syncthreads();
      const float4* dg4 = reinterpret_cast<const float4*>(dgs);
      for (int u = tid % UL; u < UW; u += 2 * UL) {
        for (int v0 = 0; v0 < vs; v0 += 4) {
          // rows past the chunk repeat its last one (loads without branches,
          // so the unrolled loads issue together); their sums are dropped
          const float4* rows[4];
#pragma unroll
          for (int vv = 0; vv < 4; ++vv) rows[vv] = dg4 + min(v0 + vv, vs - 1) * H;
          float4 pa[4], pb[4];  // units u and u + UL: the four column phases of each video
#pragma unroll
          for (int vv = 0; vv < 4; ++vv) pa[vv] = pb[vv] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
          for (int j4 = part; j4 < H; j4 += parts) {
            const float4 wa = wt[j4 * UW + u], wb = wt[j4 * UW + u + UL];
#pragma unroll
            for (int vv = 0; vv < 4; ++vv) {
              const float4 d = rows[vv][j4];
              fma4_dot(pa[vv], d, wa);
              fma4_dot(pb[vv], d, wb);
            }
          }
          float acc[8];
#pragma unroll
          for (int vv = 0; vv < 4; ++vv) {
            acc[vv] = (pa[vv].x + pa[vv].y) + (pa[vv].z + pa[vv].w);
            acc[4 + vv] = (pb[vv].x + pb[vv].y) + (pb[vv].z + pb[vv].w);
          }
          // the warp's parts of each unit, by butterfly; the cell adds the warps
          for (int off = 16; off >= UL; off >>= 1)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
          if (lane < UL) {
#pragma unroll
            for (int vv = 0; vv < 4; ++vv)
              if (v0 + vv < vs) {
                float* r = red + (warp * Bg + c0 + v0 + vv) * UW + u;
                r[0] = acc[vv];
                r[UL] = acc[4 + vv];
              }
          }
        }
      }
      __syncthreads();  // red is complete, dgs may be reused
    }
  }
}

struct Plan {
  int units;   // U, hidden units per block
  int blocks;  // ceil(H / U), all co-resident
  size_t smem;
};

cudaError_t device_limits(int* sms, int* smem_max) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err;
}

// Whether one block of `kernel` with `smem` bytes fits an SM (and allow it).
cudaError_t fits_one_per_sm(const void* kernel, size_t smem, bool* fits) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  *fits = per_sm >= 1;
  return err;
}

// K2/K4: smallest power-of-two U whose grid fits one block per SM; returns
// an error when no U fits, since a cooperative grid must be co-resident.
cudaError_t make_fwd_plan(int H, Plan* plan) {
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  for (int U = 1; U <= kMaxUnits; U *= 2) {
    const size_t smem = fwd_smem_bytes(H, U);
    const int blocks = (H + U - 1) / U;
    if (smem > (size_t)smem_max || blocks > sms) continue;
    bool fits = false;
    err = fits_one_per_sm((const void*)lstm_fwd_kernel, smem, &fits);
    if (err != cudaSuccess) return err;
    if (fits) {
      *plan = Plan{U, blocks, smem};
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// K3's loop: among the G x S grids of at most one block per SM whose shared
// memory fits, the one with the least modelled cost of a step, in SM clocks:
// the dh product's FMAs (128 a clock) or its shared-memory reads of the rows
// (128 bytes a clock), whichever is more, the staged dgates' bytes at 64 a
// clock from L2 plus a round trip (~1000 clocks) per staged chunk, and 20
// clocks per arrival at the group's barrier counter. Ties go to fewer blocks.
cudaError_t make_bwd_plan(int H, int B, int T, BwdPlan* plan) {
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  double best = 0.0;
  bool found = false;
  for (int S = 1; S <= H && S <= sms; ++S) {  // unit slices
    const int U = (H + S - 1) / S;
    if ((H + U - 1) / U != S) continue;  // S = ceil(H / U) for one U only
    int UL = 1;
    while (2 * UL < U && UL < 32) UL *= 2;
    const int UW = (U + 2 * UL - 1) / (2 * UL) * (2 * UL);
    for (int G = 1; G <= B; ++G) {  // video groups
      const int Bg = (B + G - 1) / G;
      if ((B + Bg - 1) / Bg != G) continue;
      if (G * S > sms) break;
      int VS = Bg;
      while (VS > 0 && loop_smem_bytes(H, Bg, U, UW, VS) > (size_t)smem_max) --VS;
      if (VS == 0) continue;
      const int chunks = (Bg + VS - 1) / VS;
      const double fma = (double)Bg * UW * 4 * H / 128.0;
      const double rows = (double)((Bg + 3) / 4) * UW * H * 16 / 128.0;
      const double cost = (fma > rows ? fma : rows) + (double)Bg * 16 * H / 64.0 +
                          1000.0 * chunks + 20.0 * S;
      if (!found || cost < best || (cost == best && G * S < plan->groups * plan->slices)) {
        *plan = BwdPlan{G, S, Bg, U, UL, UW, VS, loop_smem_bytes(H, Bg, U, UW, VS), 1, 0, 0};
        best = cost;
        found = true;
      }
    }
  }
  if (!found) return cudaErrorCooperativeLaunchTooLarge;
  // (C): at most two blocks of 128 x 128 per SM (one wave), in splits of
  // >= 256 rows
  const long rows = (long)T * B;
  const int tiles = ((H + 127) / 128) * ((4 * H + 127) / 128);
  int splits = 2 * sms / tiles;
  splits = (int)std::max(1L, std::min<long>({(long)splits, (long)kMaxSplits, rows / 256}));
  plan->split_rows = (int)((rows + splits - 1) / splits + kTileK - 1) / kTileK * kTileK;
  plan->splits = (int)((rows + plan->split_rows - 1) / plan->split_rows);
  plan->scratch = (plan->splits > 1 ? sizeof(float) * plan->splits * (size_t)H * 4 * H : 0) +
                  sizeof(unsigned) * plan->groups;
  bool fits = false;
  err = fits_one_per_sm((const void*)lstm_bwd_loop_kernel, plan->smem, &fits);
  if (err != cudaSuccess) return err;
  return fits ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

// (A): dxproj = act(xproj + h_prev @ w_hh), M = T*B rows.
cudaError_t launch_gates(const float* xproj, const float* h_prev, const float* w_hh,
                         float* dxproj, int M, int H, cudaStream_t stream) {
  const int N = 4 * H;
  const dim3 grid((N + 127) / 128, (M + 127) / 128);
  tile_product_kernel<false, true>
      <<<grid, kThreads, 0, stream>>>(h_prev, w_hh, xproj, dxproj, M, N, H, H, H);
  return cudaGetLastError();
}

// out = the sum of `splits` arrays of n4 float4s, in order.
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float4* __restrict__ parts, float4* __restrict__ out, int n4,
                  int splits) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += gridDim.x * kThreads) {
    float4 s = parts[i];
    for (int z = 1; z < splits; ++z) add4(s, parts[(size_t)z * n4 + i]);
    out[i] = s;
  }
}

// (C): dw_hh = h_prev^T @ dgates over the M = T*B rows, in 128 x 128 tiles,
// split over the rows into plan.splits parts of plan.split_rows (summed in
// `partial`, then in order) so that the tiles x splits fill the card.
cudaError_t launch_dw(const float* h_prev, const float* dgates, float* dw_hh, float* partial,
                      int M, int H, const BwdPlan& plan, int sms, cudaStream_t stream) {
  const int N = 4 * H;
  const dim3 grid((N + 127) / 128, (H + 127) / 128, plan.splits);
  float* out = plan.splits > 1 ? partial : dw_hh;
  tile_product_kernel<true, false>
      <<<grid, kThreads, 0, stream>>>(h_prev, dgates, nullptr, out, H, N, M, plan.split_rows, H);
  if (plan.splits > 1) {
    const int n4 = H * N / 4;
    sum_splits_kernel<<<min(2 * sms, (n4 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(dw_hh), n4,
        plan.splits);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entries, loaded with ctypes. Pointers are device pointers to
// contiguous fp32 tensors in the layouts documented on the kernels. Each
// returns a cudaError_t (0 on success); the launch does not synchronise.

// How the kernels would be launched at hidden width H (and, for K3, batch
// B and T steps): out[0..7] = units per block, blocks, shared memory bytes,
// video groups, unit slices, videos staged at once, unit lanes, scratch
// bytes. The forward has one group, no staging and no scratch (out[5..7] =
// 0). `backward` picks K3's plan (its loop's grid).
extern "C" int lstm_scan_plan(int H, int B, int T, int backward, int* out) {
  if (H < 1 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (backward) {
    BwdPlan plan;
    const cudaError_t err = make_bwd_plan(H, B, T, &plan);
    if (err != cudaSuccess) return (int)err;
    const int values[8] = {plan.units, plan.groups * plan.slices, (int)plan.smem, plan.groups,
                           plan.slices, plan.stage, plan.lanes, (int)plan.scratch};
    for (int i = 0; i < 8; ++i) out[i] = values[i];
    return 0;
  }
  Plan plan;
  const cudaError_t err = make_fwd_plan(H, &plan);
  if (err != cudaSuccess) return (int)err;
  const int values[8] = {plan.units, plan.blocks, (int)plan.smem, 1, plan.blocks, 0, 0, 0};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
}

// K2 (cs given) and K4 (cs == nullptr, c carried in c_state (B, H)).
extern "C" int lstm_scan_forward_f32(const void* xproj, const void* w_hh, void* hs, void* cs,
                                     void* c_state, int T, int B, int H, void* stream) {
  if (T < 1 || B < 1 || H < 1 || (cs == nullptr && c_state == nullptr))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = make_fwd_plan(H, &plan);
  if (err != cudaSuccess) return (int)err;
  const float* xp = static_cast<const float*>(xproj);
  const float* w = static_cast<const float*>(w_hh);
  float* h_out = static_cast<float*>(hs);
  float* c_out = static_cast<float*>(cs);
  float* c_st = static_cast<float*>(c_state);
  int U = plan.units;
  void* args[] = {&xp, &w, &h_out, &c_out, &c_st, &T, &B, &H, &U};
  err = cudaLaunchCooperativeKernel((const void*)lstm_fwd_kernel, dim3(plan.blocks),
                                    dim3(kThreads), args, plan.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K3: launches on `stream` (A) the gates, (B) the carry loop, (C) dW_hh
// (and the sum of its splits). scratch holds the plan's scratch bytes
// (`lstm_scan_plan` out[7]); the counters in it are zeroed here.
extern "C" int lstm_scan_backward_f32(const void* xproj, const void* h_prev, const void* c_prev,
                                      const void* cs, const void* dh_out, const void* w_hh,
                                      void* dxproj, void* dw_hh, void* scratch, int T, int B,
                                      int H, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return (int)err;
  BwdPlan plan;
  err = make_bwd_plan(H, B, T, &plan);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(xproj);
  const float* hp = static_cast<const float*>(h_prev);
  const float* cp = static_cast<const float*>(c_prev);
  const float* c = static_cast<const float*>(cs);
  const float* dh = static_cast<const float*>(dh_out);
  const float* w = static_cast<const float*>(w_hh);
  float* dx = static_cast<float*>(dxproj);
  float* dw = static_cast<float*>(dw_hh);
  float* partial = static_cast<float*>(scratch);
  unsigned* counters = reinterpret_cast<unsigned*>(
      static_cast<char*>(scratch) + plan.scratch - sizeof(unsigned) * plan.groups);
  err = cudaMemsetAsync(counters, 0, sizeof(unsigned) * plan.groups, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_gates(xp, hp, w, dx, T * B, H, st);
  void* args[] = {&cp, &c, &dh, &w, &dx, &counters, &T, &B, &H, &plan};
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel((const void*)lstm_bwd_loop_kernel,
                                      dim3(plan.groups * plan.slices), dim3(kThreads), args,
                                      plan.smem, st);
  if (err == cudaSuccess) err = launch_dw(hp, dx, dw, partial, T * B, H, plan, sms, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
