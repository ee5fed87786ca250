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
// Forward design (K2, K4): a weight-stationary cooperative grid of G video
// groups x S unit slices, at most one block per SM, like K1's. Block (g, s)
// owns the videos of group g (Bg = ceil(B / G)) and the units of slice s (U =
// ceil(H / S)), and keeps the four gate columns of w_hh for its units in
// shared memory for all T steps (H x U float4s: 128 KB at H = 512, U = 16).
// The recurrence never mixes videos, so a step ends with a barrier among the
// S blocks of a group only (K3's `group_arrive` / `group_wait`, a counter per
// group in the scratch, zeroed by the entry before each launch). h crosses
// between blocks through a slab per group in the scratch, (H, BgP) with BgP =
// Bg rounded up to 4, double-buffered by step parity: a block stages its
// group's slab of the last step in chunks of KC rows with 16-byte
// cp.async.cg copies (around L1: other blocks wrote it in this launch),
// double-buffered when a chunk does not cover H. A thread owns a register
// tile of V videos x one unit's four gates, over 1 / KS of the contraction
// over k; the lanes of a warp take consecutive units of the same videos, so
// the h loads are broadcasts and the weight loads contiguous. Each thread's
// parts go to shared memory, and the cells are spread over all the block's
// threads, each adding a pair's KS parts in order of k (the chunks were added
// in order too), with no atomics: two calls are bitwise equal. c of each
// (video, unit) stays in shared memory for all steps (cs, K2's output, is
// written, never read), and the next step's xproj is copied into shared
// memory by cp.async between the block's arrival at the group barrier and
// its wait, so the cell waits on no load. The plan (`make_fwd_plan`,
// mirrored for the CPU by `ops/lstm_scan.py::forward_launch_plan`) picks G,
// S, V, KS and KC from a cost model of a step (issue slots and shared-memory
// wavefronts of the contraction, staged bytes and chunks, cells, arrivals at
// the barrier); where no grid's shared memory holds the batch, the entry
// launches the grid over P passes of ceil(B / P) videos. At B = 16 it picks
// G = 4 x S = 32 at H = 512 (4 videos and 16 units a block, 8 KB of h staged
// a step, V = 2, KS = 8) and G = 16 x S = 8 at H = 256 (one video, V = 1,
// KS = 4); at the eval batch tiles of more videos fill the card instead of
// passes (B = 64: V = 8 and 4; B = 400: G = 3 x S = 40 and G = 13 x S = 8,
// V = 16).
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
// operations; the backward three times the operations. At that batch a
// forward step is a group barrier, an L2 round trip for h and 131 K FMAs a
// block, latency more than throughput; at the eval batch (B = 400: 252 GFLOP,
// 3.76 ms at H = 512) the FMA rate sets it. In the backward, (A) and (C) are
// 10 GFLOP each at B = 16, at about 40% of the fp32 peak in these tiles; the
// loop's 300 steps are each a group barrier, an L2 round trip and about 131 K
// FMAs a block, latency more than throughput (`scripts/lstm_scan_phases.py`
// splits the time of both by phase). fp32 parity with the JAX reference rules
// out TF32 tensor cores.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ------------------------------------------------------------- K2, K4 ----

constexpr int kMaxKSplit = 8;  // parts of a split contraction over k
constexpr int kMaxTile = 16;   // videos of a thread's register tile

// Threads of a round a part of k takes: the round's tasks rounded up to whole
// warps, so that the working threads are the first KS x per_round.
__host__ __device__ inline int fwd_per_round(int tasks, int KS) {
  return max(32, min(kThreads / KS, (tasks + 31) / 32 * 32));
}

// How K2/K4 are laid out (`make_fwd_plan`; mirrored for the CPU by
// `ops/lstm_scan.py::forward_launch_plan`).
struct FwdPlan {
  int groups;       // G video groups of a pass
  int slices;       // S unit slices; the grid is G x S blocks, all co-resident
  int videos;       // Bg = ceil(Bp / G) videos of a group
  int padded;       // BgP, Bg rounded up to 4: a row of a group's h slab
  int units;        // U = ceil(H / S) units of a slice
  int tile;         // V videos of a thread's register tile (1, 2, 4, 8 or 16)
  int splits;       // KS parts of the contraction over k (1, 2, 4 or 8)
  int chunk;        // KC rows of h staged at once (a multiple of 8)
  int stage;        // floats of the stage area
  int passes;       // P launches, each over Bp = ceil(B / P) videos
  int pass_videos;  // Bp
  size_t smem;      // dynamic shared memory bytes of a block
  size_t scratch;   // bytes: the h slabs [2][G][H][BgP] floats, then G counters
};

// Floats of the stage area: one chunk of h when a chunk covers H, else two
// (double-buffered); at least the parts of the contraction, which use it
// after the last chunk (V float4s for each of a round's KS x per_round
// threads).
inline int fwd_stage_floats(int H, int BgP, int KC, int V, int KS, int tasks) {
  const long chunks = (long)(KC >= H ? 1 : 2) * KC * BgP;
  const long parts = 4L * V * KS * fwd_per_round(tasks, KS);
  return (int)((std::max(chunks, parts) + 3) / 4 * 4);
}

// Shared memory of the forward: ws [H][U] float4, the stage area, csm
// [BgP][U] (c of the block's pairs), hloc [BgP][U + 1] (their h of the step,
// for the slab) and xs [4][BgP][U] (their xproj of the step).
inline size_t fwd_smem_bytes(int H, int U, int BgP, int stage) {
  const size_t floats = (size_t)stage + (size_t)BgP * U + (size_t)BgP * (U + 1) +
                        4 * (size_t)BgP * U;
  return (sizeof(float4) * (size_t)H * U + sizeof(float) * floats + 15) / 16 * 16;
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

// Rows [k0, k0 + rows) of a group's (H, BgP) slab of h into dst (rows, BgP),
// around L1: other blocks wrote the slab in this launch.
__device__ __forceinline__ void stage_chunk(const float* slab, int k0, int rows, int BgP,
                                            float* dst) {
  const float* src = slab + (size_t)k0 * BgP;
  const int n4 = rows * BgP / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

template <int V>
__device__ __forceinline__ void load_h(const float* p, float (&h)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      h[4 * i] = q.x;
      h[4 * i + 1] = q.y;
      h[4 * i + 2] = q.z;
      h[4 * i + 3] = q.w;
    }
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    h[0] = q.x;
    h[1] = q.y;
  } else {
    h[0] = p[0];
  }
}

// Block (g, s) of pass `b_begin`: videos [b0, b0 + nv) of group g, units
// [u0, u0 + nu) of slice s, all T steps. Per step t: (rounds of) the
// contraction of h(t - 1), staged from the group's slab, with the columns in
// ws, each thread's parts into the stage area; the cells of the round's
// (video, unit) pairs over all threads, each adding its parts in order of k;
// h(t) into the slab of parity t & 1; the arrival at the group's barrier,
// the next step's xproj copied into xs, and the wait.
template <int V>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const float* __restrict__ xproj,  // (T, B, 4H)
                const float* __restrict__ w_hh,   // (H, 4H)
                float* __restrict__ hs,           // (T, B, H)
                float* __restrict__ cs,           // (T, B, H), or nullptr: h only (K4)
                float* slab,                      // [2][G][H][BgP]: the h exchange
                unsigned* counters,               // (G,) zeroed: the group barriers
                int T, int B, int H, int b_begin, FwdPlan p) {
  extern __shared__ float4 smem4[];
  const int S = p.slices, U = p.units, BgP = p.padded, KS = p.splits, KC = p.chunk;
  const int g = blockIdx.x / S, s = blockIdx.x % S;
  const int b0 = b_begin + g * p.videos;
  const int nv = max(0, min(p.videos, min(B, b_begin + p.pass_videos) - b0));
  const int u0 = s * U, nu = min(U, H - u0);
  const size_t G4 = 4 * (size_t)H;
  float4* ws = smem4;
  float* stage = reinterpret_cast<float*>(ws + (size_t)H * U);
  float4* red = reinterpret_cast<float4*>(stage);  // [KS][V][per_round]: the parts
  float* csm = stage + p.stage;                // [BgP][U]: c of the pairs
  float* hloc = csm + (size_t)BgP * U;         // [BgP][U + 1]: h(t) of the pairs
  float* xs = hloc + (size_t)BgP * (U + 1);    // [4][BgP][U]: xproj(t) of the pairs
  const int hstride = U + 1;
  const int tid = threadIdx.x;
  const int tasks = U * ((nv + V - 1) / V);  // (tile of V videos, unit), units fastest
  // a round's tasks on KS x per_round threads, packed into the first warps
  const int per_round = fwd_per_round(tasks, KS);
  const int ks = tid / per_round, lt = tid % per_round;
  const int nchunks = (H + KC - 1) / KC;
  const int buf = KC * BgP;
  const size_t parity = (size_t)p.groups * H * BgP;
  float* group_slab = slab + (size_t)g * H * BgP;
  unsigned* counter = counters + g;

  load_columns(w_hh, ws, H, U, u0);
  for (int i = tid; i < BgP * U; i += kThreads) csm[i] = 0.f;

  // xproj(t) of the block's pairs into xs, units fastest (coalesced); nothing
  // of it depends on the carry
  const int pairs = nv * nu;
  auto prefetch_x = [&](int t) {
    for (int q = tid; q < 4 * pairs; q += kThreads) {
      const int gate = q / pairs, r = q % pairs, vg = r / nu, ul = r % nu;
      cp_async4(xs + ((size_t)gate * BgP + vg) * U + ul,
                xproj + ((size_t)t * B + b0 + vg) * G4 + (size_t)gate * H + u0 + ul);
    }
    cp_async_commit();
  };

  prefetch_x(0);
  __syncthreads();  // ws and csm are in place
  for (int t = 0; t < T; ++t) {
    const float* h_prev = group_slab + ((t - 1) & 1) * parity;
    for (int base = 0; base < tasks; base += per_round) {
      if (base > 0) __syncthreads();  // the last round is done with the stage area
      const int task = base + lt;
      const bool active = ks < KS && task < tasks;
      const int vt = task / U, ul = task % U;
      if (t > 0) {  // at t == 0 the carry h is zero, and so is its product
        float4 acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        stage_chunk(h_prev, 0, min(KC, H), BgP, stage);
        for (int c = 0; c < nchunks; ++c) {
          const int k0 = c * KC, rows = min(KC, H - k0);
          if (c + 1 < nchunks) {
            stage_chunk(h_prev, k0 + KC, min(KC, H - k0 - KC), BgP, stage + ((c + 1) & 1) * buf);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          if (active) {
            const int part = (rows + KS - 1) / KS;
            const int r_lo = min(rows, ks * part), r_hi = min(rows, r_lo + part);
            const float* hsrc = stage + (c & 1) * buf + vt * V;
            const float4* wcol = ws + (size_t)k0 * U + ul;
#pragma unroll 4
            for (int r = r_lo; r < r_hi; ++r) {
              const float4 w = wcol[(size_t)r * U];
              float h[V];
              load_h<V>(hsrc + r * BgP, h);
#pragma unroll
              for (int v = 0; v < V; ++v) fma4(acc[v], h[v], w);
            }
          }
          __syncthreads();  // chunk c's buffer is free for chunk c + 2
        }
        if (active) {
#pragma unroll
          for (int v = 0; v < V; ++v) red[(ks * V + v) * per_round + lt] = acc[v];
        }
      }
      cp_async_wait<0>();  // xs of this step
      __syncthreads();     // the parts and xs are in place
      // the cells of the round's pairs, over all threads: pair q is video v of
      // the round's task q % nt (units fastest, so the stores coalesce)
      const int nt = min(per_round, tasks - base);
      for (int q = tid; q < nt * V; q += kThreads) {
        const int tl = q % nt, v = q / nt;
        const int cell_task = base + tl, cu = cell_task % U;
        const int vg = cell_task / U * V + v;
        if (vg >= nv || cu >= nu) continue;
        float4 gsum = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t > 0) {  // the parts, added in order of k
          gsum = red[v * per_round + tl];
          for (int q2 = 1; q2 < KS; ++q2) add4(gsum, red[(q2 * V + v) * per_round + tl]);
        }
        const float* x = xs + (size_t)vg * U + cu;
        const size_t gate_stride = (size_t)BgP * U;
        const float gi = sigmoid_f(x[0] + gsum.x);
        const float gf = sigmoid_f(x[gate_stride] + gsum.y);
        const float gg = tanhf(x[2 * gate_stride] + gsum.z);
        const float go = sigmoid_f(x[3 * gate_stride] + gsum.w);
        float* c_here = csm + vg * U + cu;
        const float c = gf * *c_here + gi * gg;
        *c_here = c;
        const float h = go * tanhf(c);
        const size_t o = ((size_t)t * B + b0 + vg) * H + u0 + cu;
        hs[o] = h;
        if (cs != nullptr) cs[o] = c;
        hloc[vg * hstride + cu] = h;
      }
    }
    if (t + 1 == T) break;
    __syncthreads();  // hloc holds h(t) of the block's pairs
    // h(t) of the owned units into the group's slab, along the videos (zeros
    // past the group's last video)
    float* h_next = group_slab + (t & 1) * parity;
    const int q4 = BgP / 4;
    for (int i = tid; i < nu * q4; i += kThreads) {
      const int hu = i / q4, v4 = i % q4 * 4;
      float hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = v4 + j < nv ? hloc[(v4 + j) * hstride + hu] : 0.f;
      *reinterpret_cast<float4*>(h_next + (size_t)(u0 + hu) * BgP + v4) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
    }
    group_arrive(counter);
    prefetch_x(t + 1);  // in flight while the group arrives
    group_wait(counter, (unsigned)S * (unsigned)(t + 1));
  }
}

// ---------------------------------------------------------------- K3 ----

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

const void* fwd_kernel(int V) {
  switch (V) {
    case 16: return (const void*)lstm_fwd_kernel<16>;
    case 8: return (const void*)lstm_fwd_kernel<8>;
    case 4: return (const void*)lstm_fwd_kernel<4>;
    case 2: return (const void*)lstm_fwd_kernel<2>;
    default: return (const void*)lstm_fwd_kernel<1>;
  }
}

// SM clocks of one forward step of a block, roughly. Per round of tasks: the
// contraction, H / KS rows a thread, each row costing the larger of the
// busiest scheduler's instructions and the shared memory's wavefronts (one a
// clock; a load of 16 bytes a lane takes one a quarter-warp, of 8 bytes one a
// half-warp, of 4 one a warp: the weights' float4 and the h of V videos),
// which fits the card's times of seven tiles within 15%
// (`scripts/lstm_scan_phases.py`); the staged bytes of h at 64 a clock from
// L2 (overlapping the contraction when chunked) and 200 clocks a chunk for
// its block barriers. Per step: the cells, 300 clocks and 20 a part of k for
// each cell a thread takes; an L2 round trip (1000) and 20 clocks per arrival
// at the group's barrier. Integers, so that the CPU's mirror ties exactly
// where this does.
long fwd_step_clocks(int H, int U, int Bg, int BgP, int S, int V, int KS, int KC) {
  const long tasks = (long)U * ((Bg + V - 1) / V);
  const long per_round = fwd_per_round((int)std::min(tasks, (long)kThreads), KS);
  const long rounds = (tasks + per_round - 1) / per_round;
  const long active = std::min(tasks, per_round);
  const long warps = KS * ((active + 31) / 32);
  const long lanes = std::min(active, 32L);
  const long quarters = (lanes + 7) / 8;
  const long h_wf = V == 1 ? 1 : V == 2 ? (lanes + 15) / 16 : V / 4 * quarters;
  // the busiest scheduler's instructions a row: ceil(warps / 4) warps x (4V
  // FMAs, the loads of w and of h, 3 more), at 1.5 clocks each, or 2 where a
  // warp has its scheduler alone (nothing hides its latencies)
  const long per_sched = (warps + 3) / 4;
  const long issue = per_sched * (4L * V + 1 + (V <= 2 ? 1 : V / 4) + 3);
  const long per_row = std::max(issue * (per_sched == 1 ? 4 : 3) / 2, warps * (quarters + h_wf));
  const long contraction = (long)((H + KS - 1) / KS) * per_row;
  const long staged = (long)BgP * 4 * H / 64;
  const long chunks = (H + KC - 1) / KC;
  const long round = std::max(contraction, staged) + 200 * chunks;
  const long cells = ((long)Bg * U + kThreads - 1) / kThreads * (300 + 20L * KS);
  return rounds * round + cells + 1000 + 20L * S;
}

// K2/K4: the fewest passes P whose videos a grid can hold, then among the
// G x S grids of at most one block per SM whose shared memory fits, and the
// tiles V x KS and chunks KC each can take, the one of least
// `fwd_step_clocks`; ties go to fewer blocks, then to more parts of k. A
// chunk is the most rows of h (a multiple of 8) whose buffers fit. Returns
// cudaErrorCooperativeLaunchTooLarge when no grid fits (H too wide).
cudaError_t make_fwd_plan(int H, int B, FwdPlan* plan) {
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  const int H8 = (H + 7) / 8 * 8;
  bool found = false;
  long best = 0;
  for (int P = 1; !found && P < 2 * B; P *= 2) {
    const int Bp = (B + P - 1) / P;
    const int passes = (B + Bp - 1) / Bp;
    for (int S = 1; S <= H && S <= sms; ++S) {  // unit slices
      const int U = (H + S - 1) / S;
      if ((H + U - 1) / U != S) continue;  // S = ceil(H / U) for one U only
      if (sizeof(float4) * (size_t)H * U > (size_t)smem_max) continue;
      for (int G = 1; G <= Bp && G * S <= sms; ++G) {  // video groups
        const int Bg = (Bp + G - 1) / G;
        if ((Bp + Bg - 1) / Bg != G) continue;
        const int BgP = (Bg + 3) / 4 * 4;
        for (int V = 1; V <= kMaxTile && (V == 1 || V <= Bg); V *= 2) {
          const long tasks = (long)U * ((Bg + V - 1) / V);
          for (int KS = 1; KS <= kMaxKSplit && (KS == 1 || tasks * KS <= kThreads); KS *= 2) {
            int KC = H8, stage = 0;
            size_t smem = 0;
            for (; KC >= 8; KC = KC > 256 ? 256 : KC / 2 / 8 * 8) {
              stage = fwd_stage_floats(H, BgP, KC, V, KS, (int)tasks);
              smem = fwd_smem_bytes(H, U, BgP, stage);
              if (smem <= (size_t)smem_max) break;
            }
            if (KC < 8) continue;
            const long cost = fwd_step_clocks(H, U, Bg, BgP, S, V, KS, KC);
            const int blocks = G * S;
            const int best_blocks = found ? plan->groups * plan->slices : 0;
            if (!found || cost < best ||
                (cost == best && (blocks < best_blocks ||
                                  (blocks == best_blocks && KS > plan->splits)))) {
              const size_t scratch = sizeof(float) * 2 * (size_t)G * H * BgP +
                                     sizeof(unsigned) * (size_t)G;
              *plan = FwdPlan{G, S, Bg, BgP, U, V, KS, KC, stage, passes, Bp, smem, scratch};
              best = cost;
              found = true;
            }
          }
        }
      }
    }
  }
  if (!found) return cudaErrorCooperativeLaunchTooLarge;
  bool fits = false;
  err = fits_one_per_sm(fwd_kernel(plan->tile), plan->smem, &fits);
  if (err != cudaSuccess) return err;
  return fits ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
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

// How the kernels would be launched at hidden width H, batch B (and, for
// K3, T steps): out[0..11] = units per block, blocks, shared memory bytes,
// video groups, unit slices, the staging (K3: videos of dgates at once; the
// forward: rows of h a chunk), unit lanes (K3; 0 for the forward), scratch
// bytes, the forward's register tile of videos and parts of k (0 for K3),
// passes (launches over batch slices; 1 for K3) and videos of a group.
// `backward` picks K3's plan (its loop's grid).
extern "C" int lstm_scan_plan(int H, int B, int T, int backward, int* out) {
  if (H < 1 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (backward) {
    BwdPlan plan;
    const cudaError_t err = make_bwd_plan(H, B, T, &plan);
    if (err != cudaSuccess) return (int)err;
    const int values[12] = {plan.units, plan.groups * plan.slices, (int)plan.smem, plan.groups,
                            plan.slices, plan.stage, plan.lanes, (int)plan.scratch, 0, 0, 1,
                            plan.videos};
    for (int i = 0; i < 12; ++i) out[i] = values[i];
    return 0;
  }
  FwdPlan plan;
  const cudaError_t err = make_fwd_plan(H, B, &plan);
  if (err != cudaSuccess) return (int)err;
  const int values[12] = {plan.units, plan.groups * plan.slices, (int)plan.smem, plan.groups,
                          plan.slices, plan.chunk, 0, (int)plan.scratch, plan.tile,
                          plan.splits, plan.passes, plan.videos};
  for (int i = 0; i < 12; ++i) out[i] = values[i];
  return 0;
}

// K2 (cs given) and K4 (cs == nullptr): the plan's passes, each one
// cooperative launch over Bp videos on `stream`. scratch holds the plan's
// scratch bytes (`lstm_scan_plan` out[7]): the h slabs, and the counters of
// the group barriers, zeroed here before each pass.
extern "C" int lstm_scan_forward_f32(const void* xproj, const void* w_hh, void* hs, void* cs,
                                     void* scratch, int T, int B, int H, void* stream) {
  if (T < 1 || B < 1 || H < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  FwdPlan plan;
  cudaError_t err = make_fwd_plan(H, B, &plan);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(xproj);
  const float* w = static_cast<const float*>(w_hh);
  float* h_out = static_cast<float*>(hs);
  float* c_out = static_cast<float*>(cs);
  float* slab = static_cast<float*>(scratch);
  unsigned* counters = reinterpret_cast<unsigned*>(
      static_cast<char*>(scratch) + plan.scratch - sizeof(unsigned) * plan.groups);
  for (int pass = 0; pass < plan.passes; ++pass) {
    int b_begin = pass * plan.pass_videos;
    err = cudaMemsetAsync(counters, 0, sizeof(unsigned) * plan.groups, st);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&xp, &w, &h_out, &c_out, &slab, &counters, &T, &B, &H, &b_begin, &plan};
    err = cudaLaunchCooperativeKernel(fwd_kernel(plan.tile), dim3(plan.groups * plan.slices),
                                      dim3(kThreads), args, plan.smem, st);
    if (err != cudaSuccess) return (int)err;
  }
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
