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
// Design. Steps depend on each other and nothing carries between thread
// blocks, so one block owns a tile of TB videos for all T steps. Each thread
// owns whole hidden units: the wrapper passes the recurrent and input
// weights "unit-major" (column 4u + gate instead of gate * H + u), so one
// 16-byte load per weight row gives a thread the four gates of its unit and
// the cell update needs no exchange between threads. h1 and h2 live in
// shared memory, double-buffered so a step reads the old state while it
// writes the new one; c1 and c2 live in shared memory, each element touched
// by its owning thread only. The small products (logits, box head) run one
// warp per output with a shuffle reduction; the softmax and the selection
// run one warp per video, one lane per object slot.
//
// bf16 operands (`compute_dtype=jnp.bfloat16` in JAX, pallas_scan.py:462-482).
// The kernel is templated on the element type it streams: the five weight
// matrices, the boxes and xproj1 arrive as bf16 (the wrapper rounds them;
// xproj1 is the float32 product of the rounded W1_ih, rounded). Each load
// widens them to float32 exactly (a unit's four gates are one 8-byte load),
// and the carries, every product's sum, the softmax and both outputs stay
// float32, as in JAX, where the float32 carries times the bf16 weights
// promote to float32. So the bf16 mode is the float32 function of the bf16
// values: the plain version rounds the same operands and runs its float32
// loop.
//
// Bound. At B=512, T=300 the forward needs 2.84 MFLOP per frame, 436 GFLOP
// in all: about 6.5 ms at the card's 67 TFLOP/s fp32 rate, while the bytes it
// must move (boxes, weights, outputs) take about 0.02 ms, so it is bound by
// operations. fp32 parity with the JAX reference rules out TF32 tensor cores;
// in the bf16 mode the products take a float32 carry, not a bf16 one, so the
// bf16 tensor cores would change the function too, and the bound is the same
// fp32 one. Known cost of this first version: W1_hh (1 MB) and W2_hh (4 MB)
// do not fit one SM's 227 KB of shared memory, so every block re-reads them
// from L2 at every step (5 MB per block per step; 2.6 MB in bf16). Splitting
// the weights across a cluster's distributed shared memory, or a persistent
// grid that splits the hidden units across SMs and syncs once per step, is
// later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4;  // videos per block: 128 blocks at B=512, one per SM
constexpr int kMaxObjects = 32;  // one lane per object slot
constexpr int kMaxFeat = 8;

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

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16_bits* p) {
  return __uint_as_float(static_cast<unsigned int>(__ldg(p)) << 16);
}

// four consecutive elements: one unit's gates [i, f, g, o]
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16_bits* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& w) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

// One LSTM step for the TB videos of the block. `xin[v]` holds the input
// projection of unit `u` for video v (the four gates); the recurrent product
// is added on top of it, as `xproj + h @ w_hh` in the reference.
// w_hh: (H, 4H) unit-major; h_prev, h_next, c: (TB, H) in shared memory.
template <typename E, int TB>
__device__ __forceinline__ void lstm_unit(int u, int H, const E* __restrict__ w_hh,
                                          const float* h_prev, float* h_next, float* c,
                                          const float4 (&xin)[TB]) {
  float4 acc[TB];
#pragma unroll
  for (int v = 0; v < TB; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  const E* wcol = w_hh + 4 * (size_t)u;  // row k of w_hh is 4H elements
#pragma unroll 2
  for (int k = 0; k < H; k += 4) {
    const float4 w0 = load4(wcol + (size_t)(k + 0) * 4 * H);
    const float4 w1 = load4(wcol + (size_t)(k + 1) * 4 * H);
    const float4 w2 = load4(wcol + (size_t)(k + 2) * 4 * H);
    const float4 w3 = load4(wcol + (size_t)(k + 3) * 4 * H);
#pragma unroll
    for (int v = 0; v < TB; ++v) {
      const float4 h = *reinterpret_cast<const float4*>(h_prev + v * H + k);
      fma4(acc[v], h.x, w0);
      fma4(acc[v], h.y, w1);
      fma4(acc[v], h.z, w2);
      fma4(acc[v], h.w, w3);
    }
  }
#pragma unroll
  for (int v = 0; v < TB; ++v) {
    const float gi = sigmoid_f(xin[v].x + acc[v].x);
    const float gf = sigmoid_f(xin[v].y + acc[v].y);
    const float gg = tanhf(xin[v].z + acc[v].z);
    const float go = sigmoid_f(xin[v].w + acc[v].w);
    const float cn = gf * c[v * H + u] + gi * gg;
    c[v * H + u] = cn;
    h_next[v * H + u] = go * tanhf(cn);
  }
}

// E: float, or bf16_bits for the bf16 operand mode (every input below)
template <typename E, int TB>
__global__ void __launch_bounds__(kThreads)
opnet_fused_kernel(const E* __restrict__ xproj1,   // (B, T, 4*H1) unit-major
                   const E* __restrict__ boxes,    // (B, T, O, F)
                   const E* __restrict__ w1_hh,    // (H1, 4*H1) unit-major
                   const E* __restrict__ w_att_t,  // (O, H1)
                   const E* __restrict__ w2_ih,    // (F, 4*H2) unit-major
                   const E* __restrict__ w2_hh,    // (H2, 4*H2) unit-major
                   const E* __restrict__ w_head_t, // (4, H2)
                   float* __restrict__ y,              // (B, T, 4)
                   float* __restrict__ logits,         // (B, O, T)
                   int B, int T, int O, int F, int H1, int H2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* h1 = smem;              // [2][TB][H1]
  float* c1 = h1 + 2 * TB * H1;  // [TB][H1]
  float* h2 = c1 + TB * H1;      // [2][TB][H2]
  float* c2 = h2 + 2 * TB * H2;  // [TB][H2]
  float* att = c2 + TB * H2;     // [TB][kMaxObjects] logits of this step
  float* sel = att + TB * kMaxObjects;  // [TB][kMaxFeat] selected box

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b0 = blockIdx.x * TB;

  const int carry_floats = 3 * TB * H1 + 3 * TB * H2;
  for (int i = tid; i < carry_floats; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const int nxt = cur ^ 1;
    const float* h1_prev = h1 + cur * TB * H1;
    float* h1_next = h1 + nxt * TB * H1;
    const float* h2_prev = h2 + cur * TB * H2;
    float* h2_next = h2 + nxt * TB * H2;

    // --- who-to-attend LSTM step ---
    for (int u = tid; u < H1; u += blockDim.x) {
      float4 xin[TB];
#pragma unroll
      for (int v = 0; v < TB; ++v) {
        const int b = b0 + v;
        xin[v] = b < B ? load4(xproj1 + (((size_t)b * T + t) * H1 + u) * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      lstm_unit<E, TB>(u, H1, w1_hh, h1_prev, h1_next, c1, xin);
    }
    __syncthreads();

    // --- attention logits: one warp per (video, slot) ---
    for (int p = warp; p < TB * O; p += nwarps) {
      const int v = p / O, o = p % O;
      const float* hv = h1_next + v * H1;
      const E* wr = w_att_t + (size_t)o * H1;
      float s = 0.f;
      for (int k = lane; k < H1; k += 32) s = fmaf(hv[k], load1(wr + k), s);
      s = warp_sum(s);
      if (lane == 0) {
        att[v * kMaxObjects + o] = s;
        const int b = b0 + v;
        if (b < B) logits[((size_t)b * O + o) * T + t] = s;
      }
    }
    __syncthreads();

    // --- softmax over the slots and soft box selection: one warp per video ---
    for (int v = warp; v < TB; v += nwarps) {
      const int b = b0 + v;
      const bool live = lane < O;
      const float l = live ? att[v * kMaxObjects + lane] : -INFINITY;
      const float m = warp_max(l);
      const float e = live ? expf(l - m) : 0.f;
      const float p = e / warp_sum(e);
      const E* bx = boxes + (((size_t)b * T + t) * O + lane) * F;
      for (int f = 0; f < F; ++f) {
        const float x = (live && b < B) ? load1(bx + f) : 0.f;
        const float s = warp_sum(x * p);
        if (lane == 0) sel[v * kMaxFeat + f] = s;
      }
    }
    __syncthreads();

    // --- video LSTM step on the selected box ---
    for (int u = tid; u < H2; u += blockDim.x) {
      float4 xin[TB];
#pragma unroll
      for (int v = 0; v < TB; ++v) xin[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int f = 0; f < F; ++f) {
        const float4 w = load4(w2_ih + ((size_t)f * H2 + u) * 4);
#pragma unroll
        for (int v = 0; v < TB; ++v) fma4(xin[v], sel[v * kMaxFeat + f], w);
      }
      lstm_unit<E, TB>(u, H2, w2_hh, h2_prev, h2_next, c2, xin);
    }
    __syncthreads();

    // --- box head: one warp per (video, coordinate). No barrier after it:
    // the next step's first stage touches neither h2 nor y. ---
    for (int p = warp; p < TB * 4; p += nwarps) {
      const int v = p >> 2, j = p & 3;
      const float* hv = h2_next + v * H2;
      const E* wr = w_head_t + (size_t)j * H2;
      float s = 0.f;
      for (int k = lane; k < H2; k += 32) s = fmaf(hv[k], load1(wr + k), s);
      s = warp_sum(s);
      const int b = b0 + v;
      if (lane == 0 && b < B) y[((size_t)b * T + t) * 4 + j] = s;
    }
    cur = nxt;
  }
}

template <typename E, int TB>
cudaError_t launch(const void* xproj1, const void* boxes, const void* w1_hh,
                   const void* w_att_t, const void* w2_ih, const void* w2_hh,
                   const void* w_head_t, void* y, void* logits, int B, int T, int O, int F,
                   int H1, int H2, cudaStream_t stream) {
  if (B < 1 || T < 1 || O < 1 || O > kMaxObjects || F < 1 || F > kMaxFeat || H1 % 4 ||
      H2 % 4)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (3 * TB * H1 + 3 * TB * H2 + TB * kMaxObjects + TB * kMaxFeat);
  cudaError_t err = cudaFuncSetAttribute(
      opnet_fused_kernel<E, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + TB - 1) / TB;
  opnet_fused_kernel<E, TB><<<blocks, kThreads, smem, stream>>>(
      static_cast<const E*>(xproj1), static_cast<const E*>(boxes),
      static_cast<const E*>(w1_hh), static_cast<const E*>(w_att_t),
      static_cast<const E*>(w2_ih), static_cast<const E*>(w2_hh),
      static_cast<const E*>(w_head_t), static_cast<float*>(y), static_cast<float*>(logits),
      B, T, O, F, H1, H2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries, loaded with ctypes. Pointers are device pointers to
// contiguous tensors in the layouts documented on the kernel: every input
// float32 (_f32) or bfloat16 (_bf16), y and logits float32. Returns a
// cudaError_t (0 on success).
#define OPNET_ARGS                                                                        \
  const void *xproj1, const void *boxes, const void *w1_hh, const void *w_att_t,           \
      const void *w2_ih, const void *w2_hh, const void *w_head_t, void *y, void *logits, \
      int B, int T, int O, int F, int H1, int H2, void *stream
#define OPNET_PASS \
  xproj1, boxes, w1_hh, w_att_t, w2_ih, w2_hh, w_head_t, y, logits, B, T, O, F, H1, H2, \
      static_cast<cudaStream_t>(stream)

extern "C" int opnet_fused_forward_f32(OPNET_ARGS) {
  return (int)launch<float, kTile>(OPNET_PASS);
}

extern "C" int opnet_fused_forward_bf16(OPNET_ARGS) {
  return (int)launch<bf16_bits, kTile>(OPNET_PASS);
}
