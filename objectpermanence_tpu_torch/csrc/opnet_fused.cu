// Fused OPNet forward for Hopper (sm_90a): float32, and the bf16 operand
// mode.
//
// Replaces the Pallas TPU kernel `_opnet_kernel` / `opnet_fused_forward` in
// objectpermanence_tpu/ops/pallas_scan.py. It computes the whole OPNet
// forward over all T steps in one launch: the who-to-attend LSTM step
// (gates1 = xproj1[t] + h1 @ W1_hh), the attention logits h1 @ W_att and
// their softmax over the O object slots, the soft box selection
// sel_f = sum_o boxes[t, o, f] * p_o, the video LSTM step
// (gates2 = sel @ W2_ih + h2 @ W2_hh) and the box head h2 @ W_head.
// xproj1 = scene @ W1_ih is one large product computed outside the kernel.
// Bias-free LSTMs, gate order [i, f, g, o], carries in fp32 from zero.
//
// Design: a weight-stationary cooperative grid. W1_hh (H1 x 4H1) and W2_hh
// (H2 x 4H2) are 5.2 MB in fp32 at the flagship width (256/512), far more
// than one SM's 227 KB, so no block can hold them; a block that owns videos
// must re-read them from L2 at every step (201 GB per call at B=512, T=300
// in fp32 for a tile of 4 videos per block). Instead the grid is G x S
// blocks, all co-resident (cudaLaunchCooperativeKernel), at most one per SM:
// block (g, s) owns the videos of group g (Bg = ceil(B / G) of them) and
// the units of slice s (U1 = ceil(H1 / S) of the who-to-attend LSTM, U2 =
// ceil(H2 / S) of the video LSTM). It copies the four gate columns of its
// units of W1_hh, W2_hh and W2_ih (and their rows of W_att and W_head) into
// shared memory once and keeps them for all T steps, in the operand type
// (fp32 G=4, S=32: 32 + 128 KB; bf16 G=8, S=16: the same bytes for twice the
// units). Each step has four phases:
//   A(t) the who-to-attend LSTM units of block (g, s) for all videos of g,
//        and the slice's share of the logits, h1(t)[units] @ W_att[units];
//   B(t) the logits as the sum of the S shares (in slice order), the softmax
//        and the selection, a warp a video, writing logits[:, :, t] and sel(t);
//   C(t) the video LSTM units of block (g, s), from sel(t) and h2(t - 1), and
//        the slice's share of the box head;
//   D(t) the box head as the sum of the S shares, writing y[:, t].
// They run as two phases a step, each closed by one grid barrier:
//   X_t = {C(t - 1), A(t)} | Y_t = {B(t), D(t - 1)} |
// with a prologue (A(0)) and an epilogue (C(T - 1), D(T - 1)): 2T + 1
// barriers. h1 and h2 are double-buffered in device memory by step parity,
// each as (G, H, BgP): group g's rows of k are contiguous, so a block stages
// its group's h in chunks of KC rows with 16-byte cp.async.cg copies,
// double-buffered. sel and the shares have one buffer each. Every read of
// data that another block wrote in this launch (h, sel, the shares) bypasses
// L1 (cp.async.cg, __ldcg): a stale L1 line would show only on the card. c1
// and c2 stay in device memory, each element read and written by the one
// thread that owns its (video, unit); the read is issued before the
// contraction, as is xproj1's.
//
// Inner loop: a thread owns a register tile of V videos x one unit's four
// gates (V = 8 in C and 4 in A at the flagship: 32 and 16 accumulators);
// per k it reads one unit's gates from shared memory (16 bytes in fp32, 8 in
// bf16, widened exactly) and V/4 float4s of h, and does 4V FMAs. The lanes
// of a warp take consecutive units of the same videos, so the h loads are
// broadcasts and the weight loads contiguous. When the group is small (B =
// 16 at the CLI's batch: 4 videos a group) V is 1 and the contraction over k
// is split into KS <= 8 parts. Parts and chunks are added in a fixed order:
// a run's result does not depend on timing. The launch plan (`make_plan`)
// picks S and G from the operand size, the opt-in shared memory and a cost
// model (FMAs, staging bytes, chunk barriers, rounds of tasks), with G <= B;
// the entry returns cudaErrorCooperativeLaunchTooLarge if the grid cannot be
// co-resident and the wrapper raises.
//
// bf16 operands (`compute_dtype=jnp.bfloat16` in JAX, pallas_scan.py:462-482):
// the five weight matrices, the boxes and xproj1 arrive as bf16 (the wrapper
// rounds them; xproj1 is the float32 product of the rounded W1_ih, rounded)
// and stay bf16 in shared memory. Each load widens them to float32 exactly,
// and the carries, every product's sum, the softmax and both outputs stay
// float32, as in JAX, where the float32 carries times the bf16 weights
// promote to float32. So the bf16 mode is the float32 function of the bf16
// values: the plain version rounds the same operands and runs its float32
// loop.
//
// Bound and traffic. At B=512, T=300 the forward needs 2.84 MFLOP per
// frame, 436 GFLOP in all: about 6.5 ms at the card's 67 TFLOP/s fp32 rate,
// while the bytes it must move take about 0.02 ms: bound by operations (5.2
// M FMA per block per step, 20.6 us at one SM's 128 FMA a clock). fp32
// parity rules out TF32 tensor cores; in the bf16 mode the products take a
// float32 carry, so the bound is the same fp32 one. The weights cross L2
// once per launch (5.2 MB); what crosses L2 every step is h: each block
// stages Bg x (H1 + H2) floats of its group, 128 x 128 x 768 x 4 B = 50 MB
// a step in fp32 (25 MB in bf16, where Bg = 64), about 15 GB (7.5 GB) a
// call, plus the shares, S x B x (O + 4) floats written and read a step
// (1.6 MB at S=32). 601 grid barriers cost about 3 us each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxObjects = 32;   // one lane per object slot
constexpr int kMaxFeat = 8;
constexpr int kMaxSplit = 8;      // parts of a split contraction

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// bf16 values are carried as their 16 bits; a load widens them to float32
// exactly (the bf16 bits are the float's upper half)
using bf16_bits = unsigned short;

// one unit's four gates [i, f, g, o] in the operand type
template <typename E> struct Gates;
template <> struct Gates<float> { using type = float4; };
template <> struct Gates<bf16_bits> { using type = uint2; };

__device__ __forceinline__ float4 widen(const float4& w) { return w; }
__device__ __forceinline__ float4 widen(const uint2& v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16_bits* p) {
  return __uint_as_float(static_cast<unsigned int>(__ldg(p)) << 16);
}

template <typename E>
__device__ __forceinline__ float4 load4(const E* p) {
  return widen(__ldg(reinterpret_cast<const typename Gates<E>::type*>(p)));
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& w) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// 16 bytes from device memory to shared memory, around L1 (.cg)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// A thread's work in an LSTM phase: V videos x one unit, over 1 / KS of the
// contraction.
struct Tile {
  int V, KS;
};

// Everything a launch needs: operands, scratch, and the plan.
struct Params {
  const void* xproj1;    // (B, T, 4*H1) unit-major
  const void* boxes;     // (B, T, O, F)
  const void* w1_hh;     // (H1, 4*H1) unit-major
  const void* w_att_t;   // (O, H1)
  const void* w2_ih;     // (F, 4*H2) unit-major
  const void* w2_hh;     // (H2, 4*H2) unit-major
  const void* w_head_t;  // (4, H2)
  float* y;              // (B, T, 4)
  float* logits;         // (B, O, T)
  float* h1;             // [2][G][H1][BgP], by step parity
  float* h2;             // [2][G][H2][BgP]
  float* c1;             // (B, H1)
  float* c2;             // (B, H2)
  float* sel;            // (B, kMaxFeat)
  float* plog;           // (S, B, O): each slice's share of the logits
  float* phead;          // (S, B, 4): each slice's share of the box head
  int B, T, O, F, H1, H2;
  int groups, slices, Bg, BgP, U1, U2, KC;
  Tile ta, tc;  // the register tiles of phases A and C
  // byte offsets into dynamic shared memory
  int off_ws2, off_wih, off_watt, off_whead, off_stage, off_sel, off_hloc;
};

// floats of the scratch buffer: h1, h2 (two parities each), c1, c2, sel,
// plog (room for kMaxObjects slots), phead
inline size_t scratch_floats(const Params& p) {
  return 2 * (size_t)p.groups * p.BgP * (p.H1 + p.H2) + (size_t)p.B * (p.H1 + p.H2) +
         (size_t)p.B * kMaxFeat + (size_t)p.slices * p.B * (kMaxObjects + 4);
}

// The block's views of dynamic shared memory.
template <typename E>
struct Smem {
  using G4 = typename Gates<E>::type;
  G4* ws1;       // [H1][U1] gates of the owned units of W1_hh
  G4* ws2;       // [H2][U2] ... of W2_hh
  G4* wih;       // [kMaxFeat][U2] ... of W2_ih
  float* watt;   // [kMaxObjects][U1] rows of W_att for the owned units, widened
  float* whead;  // [4][U2] rows of W_head, widened
  float* stage;  // h chunks, [nbuf][KC][BgP]; then the parts of a split contraction
  float* sel;    // [BgP][kMaxFeat] sel of the group
  float* hloc;   // [BgP][U + 1] h of the owned units, for the shares and the slab
};

// Copy the gate columns of units [u0, u0 + U) of a (rows, 4H) unit-major
// matrix into ws[k * U + u] (zeros past H).
template <typename E>
__device__ void load_slice(const E* __restrict__ w, typename Gates<E>::type* ws, int rows,
                           int H, int U, int u0) {
  using G4 = typename Gates<E>::type;
  for (int i = threadIdx.x; i < rows * U; i += kThreads) {
    const int k = i / U, u = u0 + i % U;
    G4 v = {};
    if (u < H) v = __ldg(reinterpret_cast<const G4*>(w + ((size_t)k * H + u) * 4));
    ws[i] = v;
  }
}

// Columns [u0, u0 + U) of a (rows, H) matrix, widened: dst[r * U + u] (zeros past H).
template <typename E>
__device__ void load_rows(const E* __restrict__ w, float* dst, int rows, int H, int U, int u0) {
  for (int i = threadIdx.x; i < rows * U; i += kThreads) {
    const int r = i / U, u = u0 + i % U;
    dst[i] = u < H ? load1(w + (size_t)r * H + u) : 0.f;
  }
}

// Rows [k0, k0 + rows) of a group's (H, BgP) slab of h into dst (rows, BgP).
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

// One LSTM phase of block (g, s): the gates of its U units for the nv videos
// of its group at step `step`, the cell update, h(step) into the group's
// slab, and the slice's share of the product that reads h next (the logits
// for the who-to-attend LSTM, the box head for the video LSTM) into `part`.
// kAtt: the who-to-attend LSTM (input projection from xproj1); otherwise the
// video LSTM (input projection sel @ W2_ih, from shared memory).
struct Lstm {
  int H, U, u0;
  const float* h_prev;  // group's slab of step - 1, nullptr at step 0
  float* h_next;        // group's slab of this step
  float* c;             // (B, H)
  float* part;          // (S, B, NO) shares of the next product
  int NO;               // its outputs a video (O or 4)
  int b0, nv;
  Tile tile;
};

template <typename E, int V, bool kAtt>
__device__ void lstm_phase(const Params& p, const Lstm& L, int step, const Smem<E>& sm) {
  using G4 = typename Gates<E>::type;
  const G4* ws = kAtt ? sm.ws1 : sm.ws2;
  const int tid = threadIdx.x;
  const int KS = L.tile.KS;
  const int per_round = kThreads / KS;
  const int ks = tid / per_round, lt = tid % per_round;
  const int tasks = L.U * ((L.nv + V - 1) / V);
  const int nchunks = L.h_prev ? (L.H + p.KC - 1) / p.KC : 0;
  const int buf = p.KC * p.BgP;
  const int hstride = L.U + 1;

  __syncthreads();  // the previous phase is done with the stage area and hloc
  for (int base = 0; base < tasks; base += per_round) {
    if (base > 0) __syncthreads();  // the last round is done with the stage area
    if (nchunks > 0) stage_chunk(L.h_prev, 0, min(p.KC, L.H), p.BgP, sm.stage);
    if constexpr (!kAtt) {  // sel(step) of the group, written by phase B
      if (base == 0) {
        for (int i = tid; i < L.nv * p.F; i += kThreads) {
          const int v = i / p.F, f = i % p.F;
          sm.sel[v * kMaxFeat + f] = __ldcg(p.sel + (size_t)(L.b0 + v) * kMaxFeat + f);
        }
      }
    }
    const int task = base + lt;
    const bool active = task < tasks;
    const int vt = task / L.U, ul = task % L.U;  // units fastest across the lanes
    const int u = L.u0 + ul;
    bool owner[V];  // this thread updates cell v (the first part of a split one)
    float4 acc[V];
    float4 xin[V];
    float c_prev[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int vg = vt * V + v;
      owner[v] = active && ks == 0 && u < L.H && vg < L.nv;
      acc[v] = xin[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      c_prev[v] = 0.f;
      if (!owner[v]) continue;
      // inputs of the cell update, loaded under the contraction
      const size_t b = L.b0 + vg;
      if constexpr (kAtt)
        xin[v] = load4(static_cast<const E*>(p.xproj1) + ((b * p.T + step) * L.H + u) * 4);
      if (step > 0) c_prev[v] = L.c[b * L.H + u];
    }

    if (nchunks == 0) __syncthreads();  // sel is in shared memory
    for (int c = 0; c < nchunks; ++c) {
      const int k0 = c * p.KC, rows = min(p.KC, L.H - k0);
      if (c + 1 < nchunks) {
        stage_chunk(L.h_prev, k0 + p.KC, min(p.KC, L.H - k0 - p.KC), p.BgP,
                    sm.stage + ((c + 1) & 1) * buf);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const int part = (rows + KS - 1) / KS;
        const int r_lo = min(rows, ks * part), r_hi = min(rows, r_lo + part);
        const float* hs = sm.stage + (c & 1) * buf + vt * V;
        const G4* wcol = ws + (size_t)k0 * L.U + ul;
#pragma unroll 4
        for (int r = r_lo; r < r_hi; ++r) {
          const float4 w = widen(wcol[(size_t)r * L.U]);
          float h[V];
          load_h<V>(hs + r * p.BgP, h);
#pragma unroll
          for (int v = 0; v < V; ++v) fma4(acc[v], h[v], w);
        }
      }
      __syncthreads();  // chunk c's buffer is free for chunk c + 2
    }

    if constexpr (V == 1) {
      if (KS > 1) {  // the split parts, added in order of k through the stage area
        float4* red = reinterpret_cast<float4*>(sm.stage);  // free after the last chunk
        if (active && ks > 0) red[(ks - 1) * per_round + lt] = acc[0];
        __syncthreads();
        if (active && ks == 0)
          for (int q = 1; q < KS; ++q) add4(acc[0], red[(q - 1) * per_round + lt]);
      }
    }

    float4 wi[kMaxFeat];  // this unit's column of W2_ih (zeros past F)
    if constexpr (!kAtt) {
#pragma unroll
      for (int f = 0; f < kMaxFeat; ++f)
        wi[f] = f < p.F ? widen(sm.wih[f * L.U + ul]) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!owner[v]) continue;
      const int vg = vt * V + v;
      float4 x = xin[v];
      if constexpr (!kAtt) {
        const float4* sv = reinterpret_cast<const float4*>(sm.sel + vg * kMaxFeat);
        const float4 s0 = sv[0], s1 = sv[1];
        const float sf[kMaxFeat] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int f = 0; f < kMaxFeat; ++f)
          if (f < p.F) fma4(x, sf[f], wi[f]);
      }
      const float gi = sigmoid_f(x.x + acc[v].x);
      const float gf = sigmoid_f(x.y + acc[v].y);
      const float gg = tanhf(x.z + acc[v].z);
      const float go = sigmoid_f(x.w + acc[v].w);
      const float cn = gf * c_prev[v] + gi * gg;
      L.c[(size_t)(L.b0 + vg) * L.H + u] = cn;
      sm.hloc[vg * hstride + ul] = go * tanhf(cn);
    }
  }

  __syncthreads();
  const int nu = max(0, min(L.U, L.H - L.u0));
  // h(step) of the owned units into the group's slab, along the videos
  for (int i = tid; i < nu * L.nv; i += kThreads) {
    const int ul = i / L.nv, vg = i % L.nv;
    L.h_next[(size_t)(L.u0 + ul) * p.BgP + vg] = sm.hloc[vg * hstride + ul];
  }
  // this slice's share of the next product: its units' h times their rows
  const float* wout = kAtt ? sm.watt : sm.whead;
  const int slice = blockIdx.x % p.slices;
  for (int i = tid; i < L.nv * L.NO; i += kThreads) {
    const int o = i / L.nv, v = i % L.nv;
    const float* hv = sm.hloc + v * hstride;
    const float* wo = wout + o * L.U;
    float acc = 0.f;
    for (int k = 0; k < nu; ++k) acc = fmaf(hv[k], wo[k], acc);
    L.part[((size_t)slice * p.B + L.b0 + v) * L.NO + o] = acc;
  }
}

template <typename E, bool kAtt>
__device__ __forceinline__ void lstm_dispatch(const Params& p, const Lstm& L, int step,
                                              const Smem<E>& sm) {
  switch (L.tile.V) {
    case 8: lstm_phase<E, 8, kAtt>(p, L, step, sm); break;
    case 4: lstm_phase<E, 4, kAtt>(p, L, step, sm); break;
    case 2: lstm_phase<E, 2, kAtt>(p, L, step, sm); break;
    default: lstm_phase<E, 1, kAtt>(p, L, step, sm); break;
  }
}

// Sum over the S slices of q[s * stride] in slice order, the loads of up to
// 32 slices issued before the first add (they come from L2).
__device__ __forceinline__ float sum_shares(const float* q, size_t stride, int S) {
  float total = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = s0 + i < S ? __ldcg(q + (s0 + i) * stride) : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) total += part[i];
  }
  return total;
}

// Phase Y_t for the videos blockIdx.x + gridDim.x * i of this block, a warp
// each for B(t), the logits as the sum of the slices' shares (in slice
// order), the softmax over the slots (a lane each) and the soft selection,
// and a warp each for D(t - 1), the box head as the sum of the slices' shares.
template <typename E>
__device__ void select_and_head(const Params& p, int t) {
  const E* boxes = static_cast<const E*>(p.boxes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int videos = blockIdx.x < p.B ? (p.B - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  for (int task = warp; task < 2 * videos; task += kWarps) {
    const int b = blockIdx.x + (task >> 1) * gridDim.x;
    if ((task & 1) == 0 && t < p.T) {
      const bool live = lane < p.O;
      float bx[kMaxFeat];
      const E* row = boxes + (((size_t)b * p.T + t) * p.O + lane) * p.F;
#pragma unroll
      for (int f = 0; f < kMaxFeat; ++f) bx[f] = live && f < p.F ? load1(row + f) : 0.f;
      float l = -INFINITY;
      if (live) {
        l = sum_shares(p.plog + (size_t)b * p.O + lane, (size_t)p.B * p.O, p.slices);
        p.logits[((size_t)b * p.O + lane) * p.T + t] = l;
      }
      const float m = warp_max(l);
      const float e = live ? expf(l - m) : 0.f;
      const float pr = e / warp_sum(e);
#pragma unroll
      for (int f = 0; f < kMaxFeat; ++f) {
        if (f >= p.F) break;
        const float s = warp_sum(bx[f] * pr);
        if (lane == 0) p.sel[(size_t)b * kMaxFeat + f] = s;
      }
    }
    if ((task & 1) == 1 && t >= 1 && lane < 4) {
      const float yv = sum_shares(p.phead + (size_t)b * 4 + lane, (size_t)p.B * 4, p.slices);
      p.y[((size_t)b * p.T + t - 1) * 4 + lane] = yv;
    }
  }
}

// E: float, or bf16_bits for the bf16 operand mode (every input operand)
template <typename E>
__global__ void __launch_bounds__(kThreads, 1) opnet_fused_kernel(const __grid_constant__ Params p) {
  using G4 = typename Gates<E>::type;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Smem<E> sm{reinterpret_cast<G4*>(smem), reinterpret_cast<G4*>(smem + p.off_ws2),
                   reinterpret_cast<G4*>(smem + p.off_wih),
                   reinterpret_cast<float*>(smem + p.off_watt),
                   reinterpret_cast<float*>(smem + p.off_whead),
                   reinterpret_cast<float*>(smem + p.off_stage),
                   reinterpret_cast<float*>(smem + p.off_sel),
                   reinterpret_cast<float*>(smem + p.off_hloc)};

  const int g = blockIdx.x / p.slices, s = blockIdx.x % p.slices;
  load_slice(static_cast<const E*>(p.w1_hh), sm.ws1, p.H1, p.H1, p.U1, s * p.U1);
  load_slice(static_cast<const E*>(p.w2_hh), sm.ws2, p.H2, p.H2, p.U2, s * p.U2);
  load_slice(static_cast<const E*>(p.w2_ih), sm.wih, p.F, p.H2, p.U2, s * p.U2);
  load_rows(static_cast<const E*>(p.w_att_t), sm.watt, p.O, p.H1, p.U1, s * p.U1);
  load_rows(static_cast<const E*>(p.w_head_t), sm.whead, 4, p.H2, p.U2, s * p.U2);

  const int b0 = g * p.Bg, nv = min(p.Bg, p.B - b0);
  const size_t par1 = (size_t)p.groups * p.H1 * p.BgP, par2 = (size_t)p.groups * p.H2 * p.BgP;
  const size_t slab1 = (size_t)g * p.H1 * p.BgP, slab2 = (size_t)g * p.H2 * p.BgP;
  auto h1_of = [&](int step) { return p.h1 + (step & 1) * par1 + slab1; };
  auto h2_of = [&](int step) { return p.h2 + (step & 1) * par2 + slab2; };

  for (int t = 0; t <= p.T; ++t) {
    // X_t = {C(t - 1), A(t)}
    if (t >= 1) {
      const int step = t - 1;
      const Lstm L{p.H2, p.U2, s * p.U2, step ? h2_of(step - 1) : nullptr, h2_of(step),
                   p.c2, p.phead, 4, b0, nv, p.tc};
      lstm_dispatch<E, false>(p, L, step, sm);
    }
    if (t < p.T) {
      const Lstm L{p.H1, p.U1, s * p.U1, t ? h1_of(t - 1) : nullptr, h1_of(t), p.c1, p.plog,
                   p.O, b0, nv, p.ta};
      lstm_dispatch<E, true>(p, L, t, sm);
    }
    grid.sync();
    // Y_t = {B(t), D(t - 1)}
    select_and_head<E>(p, t);
    if (t < p.T) grid.sync();
  }
}

struct Plan {
  Params p;         // the plan's fields of Params
  int blocks;
  size_t smem;
  size_t scratch;   // floats
};

// The register tile of an LSTM phase: the most videos a thread (V) that still
// gives every thread a task; below that V = 1 and the contraction is split in
// KS <= kMaxSplit parts so that KS x tasks threads work.
Tile choose_tile(int units, int videos) {
  for (int v = 8; v >= 2; v /= 2)
    if (units * ((videos + v - 1) / v) >= kThreads) return Tile{v, 1};
  int ks = 1;
  while (ks < kMaxSplit && units * videos * ks * 2 <= kThreads) ks *= 2;
  return Tile{1, ks};
}

// Floats of the stage area that a split contraction's parts need (V = 1).
size_t split_floats(const Tile& t) { return (size_t)4 * (t.KS - 1) * (kThreads / t.KS); }

// Shared memory of a plan, filling its offsets; the stage area holds one h
// chunk when a chunk covers the widest h, else two, and at least the parts
// of a split contraction.
size_t layout(Params& q, int vec) {
  const int hmax = q.H1 > q.H2 ? q.H1 : q.H2;
  const int umax = q.U1 > q.U2 ? q.U1 : q.U2;
  const size_t nbuf = q.KC >= hmax ? 1 : 2;
  size_t stage = nbuf * q.KC * q.BgP;
  stage = stage > split_floats(q.ta) ? stage : split_floats(q.ta);
  stage = stage > split_floats(q.tc) ? stage : split_floats(q.tc);
  size_t o = align16((size_t)q.H1 * q.U1 * vec);
  q.off_ws2 = (int)o;
  o = align16(o + (size_t)q.H2 * q.U2 * vec);
  q.off_wih = (int)o;
  o = align16(o + (size_t)kMaxFeat * q.U2 * vec);
  q.off_watt = (int)o;
  o = align16(o + sizeof(float) * kMaxObjects * q.U1);
  q.off_whead = (int)o;
  o = align16(o + sizeof(float) * 4 * q.U2);
  q.off_stage = (int)o;
  o = align16(o + sizeof(float) * stage);
  q.off_sel = (int)o;
  o = align16(o + sizeof(float) * (size_t)q.BgP * kMaxFeat);
  q.off_hloc = (int)o;
  return align16(o + sizeof(float) * (size_t)q.BgP * (umax + 1));
}

// SM clocks of one LSTM phase a step, roughly: a thread's FMAs (each thread
// gets 128 / kThreads of the SM's FMA a clock), the h bytes staged from L2
// (about 64 a clock) and 200 a chunk for its barriers, for each round of tasks.
double phase_clocks(const Params& q, const Tile& t, int U, int H) {
  const int tasks = U * ((q.Bg + t.V - 1) / t.V);
  const int rounds = (tasks + kThreads / t.KS - 1) / (kThreads / t.KS);
  return rounds * (t.V * 4.0 * ((H + t.KS - 1) / t.KS) * kThreads / 128 +
                   q.Bg * 4.0 * H / 64 + 200.0 * ((H + q.KC - 1) / q.KC));
}

// Every S that fits (weights, stage area and all) with G = min(B, SMs / S)
// groups, scored by phase_clocks; ties go to fewer blocks. A chunk is the
// most rows of h (a multiple of 8, so that a split contraction divides it)
// whose buffers fit.
cudaError_t make_plan(const void* kernel, int B, int H1, int H2, int itemsize, Plan* plan) {
  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int vec = 4 * itemsize;
  const int hmax = H1 > H2 ? H1 : H2;
  const int hmax8 = (hmax + 7) / 8 * 8;
  bool found = false;
  double best = 0.0;
  for (int S = 1; S <= sms && S <= hmax; ++S) {
    Params q = {};
    q.B = B;
    q.H1 = H1;
    q.H2 = H2;
    q.slices = S;
    q.U1 = (H1 + S - 1) / S;
    q.U2 = (H2 + S - 1) / S;
    const int G0 = B < sms / S ? B : sms / S;
    q.Bg = (B + G0 - 1) / G0;
    q.groups = (B + q.Bg - 1) / q.Bg;  // no empty group
    q.BgP = (q.Bg + 3) / 4 * 4;
    q.ta = choose_tile(q.U1, q.Bg);
    q.tc = choose_tile(q.U2, q.Bg);
    size_t smem = 0;
    for (q.KC = hmax8; q.KC >= 8; q.KC = q.KC > 256 ? 256 : q.KC / 2 / 8 * 8) {
      smem = layout(q, vec);
      if (smem <= (size_t)smem_max) break;
    }
    if (q.KC < 8 || smem > (size_t)smem_max) continue;
    const double cost = phase_clocks(q, q.ta, q.U1, H1) + phase_clocks(q, q.tc, q.U2, H2);
    const int blocks = q.groups * S;
    if (!found || cost < best || (cost == best && blocks < plan->blocks)) {
      *plan = Plan{q, blocks, smem, scratch_floats(q)};
      best = cost;
      found = true;
    }
  }
  if (!found) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan->smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, plan->smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || plan->blocks > sms) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

const void* kernel_for(int itemsize) {
  return itemsize == 2 ? (const void*)opnet_fused_kernel<bf16_bits>
                       : (const void*)opnet_fused_kernel<float>;
}

cudaError_t launch(int itemsize, const void* xproj1, const void* boxes, const void* w1_hh,
                   const void* w_att_t, const void* w2_ih, const void* w2_hh,
                   const void* w_head_t, void* y, void* logits, void* scratch, int B, int T,
                   int O, int F, int H1, int H2, cudaStream_t stream) {
  if (B < 1 || T < 1 || O < 1 || O > kMaxObjects || F < 1 || F > kMaxFeat || H1 < 1 ||
      H2 < 1 || H1 % 4 || H2 % 4 || scratch == nullptr)
    return cudaErrorInvalidValue;
  const void* kernel = kernel_for(itemsize);
  Plan plan;
  cudaError_t err = make_plan(kernel, B, H1, H2, itemsize, &plan);
  if (err != cudaSuccess) return err;
  Params p = plan.p;
  p.xproj1 = xproj1;
  p.boxes = boxes;
  p.w1_hh = w1_hh;
  p.w_att_t = w_att_t;
  p.w2_ih = w2_ih;
  p.w2_hh = w2_hh;
  p.w_head_t = w_head_t;
  p.y = static_cast<float*>(y);
  p.logits = static_cast<float*>(logits);
  p.T = T;
  p.O = O;
  p.F = F;
  p.h1 = static_cast<float*>(scratch);
  p.h2 = p.h1 + 2 * (size_t)p.groups * p.BgP * H1;
  p.c1 = p.h2 + 2 * (size_t)p.groups * p.BgP * H2;
  p.c2 = p.c1 + (size_t)B * H1;
  p.sel = p.c2 + (size_t)B * H2;
  p.plog = p.sel + (size_t)B * kMaxFeat;
  p.phead = p.plog + (size_t)p.slices * B * kMaxObjects;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(plan.blocks), dim3(kThreads), args, plan.smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entries, loaded with ctypes. Pointers are device pointers to
// contiguous tensors in the layouts documented on Params: every input
// operand float32 (_f32) or bfloat16 (_bf16), y and logits float32, and
// `scratch` float32 of the plan's `scratch_floats`. Each returns a
// cudaError_t (0 on success); the launch does not synchronise.

// How K1 would be launched for B videos at widths H1, H2 with operands of
// `itemsize` bytes (4: float32, 2: bf16): video groups, unit slices, blocks
// (groups x slices, all co-resident), shared memory bytes a block, and the
// floats of scratch the launch needs. cudaErrorCooperativeLaunchTooLarge
// (720) when no grid fits the card at once.
extern "C" int opnet_fused_plan(int B, int H1, int H2, int itemsize, int* groups, int* slices,
                                int* blocks, int* smem, int* scratch) {
  if (B < 1 || H1 < 1 || H2 < 1 || (itemsize != 2 && itemsize != 4))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  const cudaError_t err = make_plan(kernel_for(itemsize), B, H1, H2, itemsize, &plan);
  if (err != cudaSuccess) return (int)err;
  *groups = plan.p.groups;
  *slices = plan.p.slices;
  *blocks = plan.blocks;
  *smem = (int)plan.smem;
  *scratch = (int)plan.scratch;
  return 0;
}

#define OPNET_ARGS                                                                        \
  const void *xproj1, const void *boxes, const void *w1_hh, const void *w_att_t,           \
      const void *w2_ih, const void *w2_hh, const void *w_head_t, void *y, void *logits, \
      void *scratch, int B, int T, int O, int F, int H1, int H2, void *stream
#define OPNET_PASS                                                                     \
  xproj1, boxes, w1_hh, w_att_t, w2_ih, w2_hh, w_head_t, y, logits, scratch, B, T, O, F, \
      H1, H2, static_cast<cudaStream_t>(stream)

extern "C" int opnet_fused_forward_f32(OPNET_ARGS) { return (int)launch(4, OPNET_PASS); }

extern "C" int opnet_fused_forward_bf16(OPNET_ARGS) { return (int)launch(2, OPNET_PASS); }
