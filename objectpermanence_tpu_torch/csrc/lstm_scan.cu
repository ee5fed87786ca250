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
// Design. At the training batch (16 videos) a tile of videos per block would
// put a handful of blocks on the card, each re-reading w_hh (4 MB at H = 512)
// from L2 at every step. Instead the grid splits the HIDDEN UNITS: block n owns
// units [n*U, n*U + U) for every video and every step, and keeps the four gate
// columns of w_hh for its units in shared memory for the whole sequence
// (H x 4U floats: 32 KB at H = 512, U = 4, 128 blocks). Steps exchange h through
// device memory: each block writes its units' h, a grid-wide barrier
// (cooperative launch, so all blocks are co-resident; the wrapper raises if
// they do not fit), and each block reads the whole h_prev of a tile of videos
// into shared memory. Within a block, 64 (video, unit) pairs each take one
// quarter of the contraction over k, the four partial sums are added in a fixed
// order, and one thread per pair runs the cell; it owns that (video, unit)'s c
// for all steps.
//
// The backward carry dh_prev[b, k] = sum_j dgates[b, j] w_hh[k, j] runs over all
// 4H columns, so a column split cannot finish it. Each block also keeps the ROWS
// of w_hh for its own units (U x 4H floats, 32 KB) and each step has two phases:
// (1) dgates of its units, written to dxproj; barrier; (2) the whole step's
// dgates read back a quarter of the columns at a time to form dh_prev of its
// units. dc stays with its unit. dW_hh of the block's columns accumulates in
// shared memory over every (t, b), each element owned by one thread, and is
// written once at the end: no atomics, and the same sums in the same order on
// every run.
//
// Bound. At B = 16, T = 300, H = 512 the forward does 2.5 GFLOP (0.15 ms at the
// card's 67 TFLOP/s fp32) and moves 15 MB (4.6 us at 3.35 TB/s): bound by
// operations; the backward three times the operations. This first version is
// far from that: every step costs a grid barrier and an L2 round trip for h, and
// each block's 256 threads do 16 x 16 outputs of a 512-long contraction. fp32
// parity with the JAX reference rules out TF32 tensor cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
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

// The backward adds wr [4H][U] floats (rows of owned units), dws [H][U] float4
// (the dW_hh accumulators) and dgs [BT][U] float4 (this tile's dgates).
__host__ __device__ inline size_t bwd_smem_bytes(int H, int U) {
  const int BT = kPairs / U;
  return fwd_smem_bytes(H, U) + sizeof(float4) * ((size_t)H * U + (size_t)BT * U) +
         sizeof(float) * (size_t)4 * H * U;
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

__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ xproj,   // (T, B, 4H)
                const float* __restrict__ h_prev,  // (T, B, H): h of step t - 1, zeros at 0
                const float* __restrict__ c_prev,  // (T, B, H)
                const float* __restrict__ cs,      // (T, B, H)
                const float* __restrict__ dh_out,  // (T, B, H)
                const float* __restrict__ w_hh,    // (H, 4H)
                float* dxproj,                     // (T, B, 4H), also the dgates exchange
                float* dw_hh,                      // (H, 4H)
                float* dh_carry,                   // (B, H) scratch
                float* dc_carry,                   // (B, H) scratch
                int T, int B, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float4* red = smem4;
  float4* ws = red + kSlices * kPairs;
  float* hsm = reinterpret_cast<float*>(ws + H * U);
  const int BT = kPairs / U;
  float4* dws = reinterpret_cast<float4*>(hsm + hsm_floats(H, U));
  float4* dgs = dws + H * U;
  float* wr = reinterpret_cast<float*>(dgs + BT * U);

  const int tid = threadIdx.x;
  const int p = tid % kPairs, slice = tid / kPairs;
  const int bl = p / U, u = p % U;
  const int u0 = blockIdx.x * U;
  const int unit = u0 + u;
  const int kc = (H + kSlices - 1) / kSlices;
  const int k_lo = min(H, slice * kc), k_hi = min(H, k_lo + kc);
  const size_t G = 4 * (size_t)H;

  load_columns(w_hh, ws, H, U, u0);
  for (int i = tid; i < 4 * H * U; i += kThreads) {  // wr[j * U + u] = w_hh[u0 + u, j]
    const int j = i / U, row = u0 + i % U;
    wr[i] = row < H ? __ldg(w_hh + (size_t)row * G + j) : 0.f;
  }
  for (int i = tid; i < H * U; i += kThreads) dws[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = T - 1; t >= 0; --t) {
    const bool last = t == T - 1;  // no carry from a later step yet
    // phase 1: recompute the gates, emit dgates, accumulate dW_hh
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      __syncthreads();
      stage_rows<false>(h_prev + ((size_t)t * B + b0) * H, H, 0, nb, H, hsm);
      __syncthreads();
      red[slice * kPairs + p] = bl < nb ? partial_gates(hsm, ws, H, U, bl, u, k_lo, k_hi)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
      if (slice == 0) {
        float4 dg4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (bl < nb && unit < H) {
          float4 s = red[p];
          for (int q = 1; q < kSlices; ++q) add4(s, red[q * kPairs + p]);
          const int b = b0 + bl;
          const float* xp = xproj + ((size_t)t * B + b) * G + unit;
          const float gi = sigmoid_f(__ldg(xp) + s.x);
          const float gf = sigmoid_f(__ldg(xp + H) + s.y);
          const float gg = tanhf(__ldg(xp + 2 * H) + s.z);
          const float go = sigmoid_f(__ldg(xp + 3 * H) + s.w);
          const size_t o = ((size_t)t * B + b) * H + unit;
          const size_t carry = (size_t)b * H + unit;
          const float dh_total = __ldg(dh_out + o) + (last ? 0.f : dh_carry[carry]);
          const float tanh_c = tanhf(__ldg(cs + o));
          const float dc = (last ? 0.f : dc_carry[carry]) +
                           dh_total * go * (1.0f - tanh_c * tanh_c);
          dg4.x = dc * gg * gi * (1.0f - gi);
          dg4.y = dc * __ldg(c_prev + o) * gf * (1.0f - gf);
          dg4.z = dc * gi * (1.0f - gg * gg);
          dg4.w = dh_total * tanh_c * go * (1.0f - go);
          float* dx = dxproj + ((size_t)t * B + b) * G + unit;
          dx[0] = dg4.x;
          dx[H] = dg4.y;
          dx[2 * H] = dg4.z;
          dx[3 * H] = dg4.w;
          dc_carry[carry] = dc * gf;
        }
        dgs[bl * U + u] = dg4;  // zero for masked videos: they add nothing to dW_hh
      }
      __syncthreads();
      // dW_hh[k, cols of u] += sum_b h_prev[b, k] dgates[b, u]; thread owns rows k
      for (int k = tid; k < H; k += kThreads) {
        for (int uu = 0; uu < U; ++uu) {
          float4 acc = dws[k * U + uu];
          for (int v = 0; v < nb; ++v) fma4(acc, hsm[v * (H + 1) + k], dgs[v * U + uu]);
          dws[k * U + uu] = acc;
        }
      }
    }
    if (t == 0) break;  // no earlier step to carry dh into
    grid.sync();  // dgates of step t are in device memory for every block
    // phase 2: dh for step t - 1 of the owned units, over all 4H columns
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      float acc = 0.f;
      for (int c = 0; c < 4; ++c) {
        __syncthreads();
        stage_rows<true>(dxproj + ((size_t)t * B + b0) * G, (int)G, c * H, nb, H, hsm);
        __syncthreads();
        if (bl < nb) {
          const float* grow = hsm + bl * (H + 1);
          const float* wcol = wr + (size_t)c * H * U + u;
          for (int k = k_lo; k < k_hi; ++k) acc = fmaf(grow[k], wcol[k * U], acc);
        }
      }
      red[slice * kPairs + p].x = acc;
      __syncthreads();
      if (slice == 0 && bl < nb && unit < H) {
        float s = red[p].x;
        for (int q = 1; q < kSlices; ++q) s += red[q * kPairs + p].x;
        dh_carry[(size_t)(b0 + bl) * H + unit] = s;
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < H * U; i += kThreads) {
    const int k = i / U, col = u0 + i % U;
    if (col < H) {
      const float4 d = dws[i];
      float* out = dw_hh + (size_t)k * G + col;
      out[0] = d.x;
      out[H] = d.y;
      out[2 * H] = d.z;
      out[3 * H] = d.w;
    }
  }
}

struct Plan {
  int units;   // U, hidden units per block
  int blocks;  // ceil(H / U), all co-resident
  size_t smem;
};

// Smallest power-of-two U whose grid fits one block per SM; raises (returns an
// error) when no U fits, since a cooperative grid must be co-resident.
cudaError_t make_plan(const void* kernel, bool backward, int H, Plan* plan) {
  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (int U = 1; U <= kMaxUnits; U *= 2) {
    const size_t smem = backward ? bwd_smem_bytes(H, U) : fwd_smem_bytes(H, U);
    const int blocks = (H + U - 1) / U;
    if (smem > (size_t)smem_max || blocks > sms) continue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm >= 1) {
      *plan = Plan{U, blocks, smem};
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// Plain C entries, loaded with ctypes. Pointers are device pointers to
// contiguous fp32 tensors in the layouts documented on the kernels. Each
// returns a cudaError_t (0 on success); the launch does not synchronise.

// How the kernels would be launched at hidden width H: units per block,
// blocks and shared memory bytes. `backward` picks K3's plan.
extern "C" int lstm_scan_plan(int H, int backward, int* units, int* blocks, int* smem) {
  if (H < 1) return (int)cudaErrorInvalidValue;
  Plan plan;
  const cudaError_t err = make_plan(backward ? (const void*)lstm_bwd_kernel
                                             : (const void*)lstm_fwd_kernel,
                                    backward != 0, H, &plan);
  if (err != cudaSuccess) return (int)err;
  *units = plan.units;
  *blocks = plan.blocks;
  *smem = (int)plan.smem;
  return 0;
}

// K2 (cs given) and K4 (cs == nullptr, c carried in c_state (B, H)).
extern "C" int lstm_scan_forward_f32(const void* xproj, const void* w_hh, void* hs, void* cs,
                                     void* c_state, int T, int B, int H, void* stream) {
  if (T < 1 || B < 1 || H < 1 || (cs == nullptr && c_state == nullptr))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = make_plan((const void*)lstm_fwd_kernel, false, H, &plan);
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

// K3. scratch holds 2 * B * H floats (the dh and dc carries).
extern "C" int lstm_scan_backward_f32(const void* xproj, const void* h_prev, const void* c_prev,
                                      const void* cs, const void* dh_out, const void* w_hh,
                                      void* dxproj, void* dw_hh, void* scratch, int T, int B,
                                      int H, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = make_plan((const void*)lstm_bwd_kernel, true, H, &plan);
  if (err != cudaSuccess) return (int)err;
  const float* xp = static_cast<const float*>(xproj);
  const float* hp = static_cast<const float*>(h_prev);
  const float* cp = static_cast<const float*>(c_prev);
  const float* c = static_cast<const float*>(cs);
  const float* dh = static_cast<const float*>(dh_out);
  const float* w = static_cast<const float*>(w_hh);
  float* dx = static_cast<float*>(dxproj);
  float* dw = static_cast<float*>(dw_hh);
  float* dh_carry = static_cast<float*>(scratch);
  float* dc_carry = dh_carry + (size_t)B * H;
  int U = plan.units;
  void* args[] = {&xp, &hp, &cp, &c, &dh, &w, &dx, &dw, &dh_carry, &dc_carry, &T, &B, &H, &U};
  err = cudaLaunchCooperativeKernel((const void*)lstm_bwd_kernel, dim3(plan.blocks),
                                    dim3(kThreads), args, plan.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
