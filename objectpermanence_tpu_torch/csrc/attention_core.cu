// The attention core of a transformer encoder layer for Hopper (sm_90a), fp32.
//
// It replaces no TPU kernel: the JAX package's self-attention
// (objectpermanence_tpu/ops/attention.py) is plain XLA over 15-token
// sequences. On the card the same composition in PyTorch
// (ops/attention_core.py::attention_core_reference) copies q, k and v out of
// the QKV product's strided views, runs two batched products of tiny 15x15
// matrices, a scale pass and a softmax pass, and copies ctx back: about
// 38 GB moved a served call of transformer_lstm for 35 GFLOP a layer of
// work. This kernel does everything between the QKV product and the
// out-projection in one pass: it reads the (N, L, 3D) product in place and
// writes ctx once, (N, L, D) with the heads side by side, or with `slot`
// the (N, D) rows of that one query.
//
// Bound: bytes. A sequence reads its 3 x L x D slab (q of one row alone in
// the slot form) and writes L x D (or D) floats; at L 15, D 256 that is
// 61 KB for 230 kFLOP, about 3.8 FLOP a byte, far below the card's
// 67 TFLOP/s / 3.35 TB/s = 20. So the design keeps HBM busy:
//  - a persistent grid, as many blocks as fit on the SMs, walks the
//    sequences; each block stages its next sequence's slab in shared
//    memory by 16-byte cp.async while it computes the current one
//    (two buffers), so loads are always in flight;
//  - the arithmetic is fp32 FFMA from shared memory: 8 lanes share one
//    (query row, head), each holding every 8th float4 of the head's q in
//    registers. A lane forms its partial dot with every key row (the 4
//    rows of a warp read the same key float4, a broadcast), the 8 partials
//    are summed by halving exchanges (7 x LMAX / 8 shuffles, not 3 x LMAX), the
//    softmax runs on the lanes' own scores with xor shuffles, and each
//    lane then sums its 16 output columns over the value rows;
//  - ctx leaves in 16-byte stores, 128 contiguous bytes per row of a warp.
//
// Numerics, as the plain composition: scores summed in fp32 over head_dim,
// divided (IEEE) by the fp32 divisor sqrt(head_dim), softmax as
// expf(s - max) (not __expf; no fast-math) summed and divided, the weighted
// sum of v in fp32. Only the order of the head_dim- and L-term sums
// differs from cuBLAS's. A row's arithmetic does not depend on the mode
// (nor on which lanes carry it), so the slot form's row is the full form's
// row `slot` bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                       // lanes sharing one (query row, head)
constexpr int kItemsPerPass = kThreads / kLanes;
// The limits the entry refuses beyond; ops/attention_core.py's MAX_LENGTH,
// MAX_HEAD_DIM and MAX_SLAB_FLOATS (two slabs in kSmemLimit) state them for
// the dispatch rule.
constexpr int kMaxLength = 32;
constexpr int kMaxHeadDim = 256;
constexpr int kSmemLimit = 232448;              // 227 KB: the most shared memory a block may have
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Sequence `n`'s slab into `buf`, D floats a row: the query rows (every row,
// or row `slot` alone), then the L key rows, then the L value rows.
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ qkv, long long n,
                                      long long stride_n, long long stride_l, int length,
                                      int dim, int q_rows, int slot) {
  const int d4 = dim >> 2;
  const int rows = q_rows + 2 * length;
  const float* seq = qkv + n * stride_n;
  const int seg_step = kThreads / d4, col_step = kThreads % d4;
  int seg = threadIdx.x / d4, col = threadIdx.x % d4;
  while (seg < rows) {
    int row, part;
    if (seg < q_rows) {
      row = slot < 0 ? seg : slot;
      part = 0;
    } else if (seg < q_rows + length) {
      row = seg - q_rows;
      part = 1;
    } else {
      row = seg - q_rows - length;
      part = 2;
    }
    cp_async16(buf + seg * dim + 4 * col, seq + row * stride_l + part * dim + 4 * col);
    seg += seg_step;
    col += col_step;
    if (col >= d4) {
      col -= d4;
      ++seg;
    }
  }
}

// One halving step: of s[0, 2 x WIDTH) a lane keeps the half its bit BIT
// names and adds the partner lane's (lane ^ BIT) copy of that half.
template <int LMAX, int WIDTH, int BIT>
__device__ __forceinline__ void halve(float (&s)[LMAX], int lane) {
  const bool upper = lane & BIT;
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) {
    const float send = upper ? s[k] : s[k + WIDTH];
    const float keep = upper ? s[k + WIDTH] : s[k];
    s[k] = keep + __shfl_xor_sync(kFull, send, BIT);
  }
}

// The 8 lanes of a group each hold partial scores s[0, LMAX); afterwards lane
// c holds the group's sums of s[c * LMAX/8 + k] in s[k], k < LMAX/8.
template <int LMAX>
__device__ __forceinline__ void sum_over_lanes(float (&s)[LMAX], int lane) {
  static_assert(kLanes == 8, "three halving steps");
  halve<LMAX, LMAX / 2, 4>(s, lane);
  halve<LMAX, LMAX / 4, 2>(s, lane);
  halve<LMAX, LMAX / 8, 1>(s, lane);
}

// LMAX: 16 or 32, at least the sequence length. F: float4s of a head each
// lane holds, at least head_dim / 32.
template <int LMAX, int F>
__global__ void __launch_bounds__(kThreads, 2)
attention_core_kernel(const float* __restrict__ qkv, float* __restrict__ out, long long n_seq,
                      long long stride_n, long long stride_l, int length, int heads,
                      int head_dim, int slot, float divisor) {
  extern __shared__ float4 smem4[];
  constexpr int kOwn = LMAX / kLanes;  // scores a lane holds after the sums
  const int dim = heads * head_dim;
  const int q_rows = slot < 0 ? length : 1;
  const int slab = (q_rows + 2 * length) * dim;
  float* const smem = reinterpret_cast<float*>(smem4);  // two slabs, used in turns
  const int lane = threadIdx.x & (kLanes - 1);
  const int nf = head_dim >> 2;
  const int items = heads * q_rows;

  long long n = blockIdx.x;
  if (n < n_seq) stage(smem, qkv, n, stride_n, stride_l, length, dim, q_rows, slot);
  cp_async_commit();
  for (int it = 0; n < n_seq; n += gridDim.x, ++it) {
    const long long next = n + gridDim.x;
    if (next < n_seq)
      stage(smem + ((it + 1) & 1) * slab, qkv, next, stride_n, stride_l, length, dim, q_rows,
            slot);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const float* buf = smem + (it & 1) * slab;
    const float* keys = buf + q_rows * dim;
    const float* values = keys + length * dim;

    for (int base = 0; base < items; base += kItemsPerPass) {
      if (base + (threadIdx.x >> 5) * (32 / kLanes) >= items) continue;  // a warp with no item
      const int item = base + threadIdx.x / kLanes;
      const bool active = item < items;
      const int h = (active ? item : 0) / q_rows, r = (active ? item : 0) % q_rows;

      float4 q[F];
      const float4* q_row = reinterpret_cast<const float4*>(buf + r * dim + h * head_dim);
#pragma unroll
      for (int m = 0; m < F; ++m) {
        const int f = lane + kLanes * m;
        q[m] = f < nf ? q_row[f] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float s[LMAX];
#pragma unroll
      for (int j = 0; j < LMAX; ++j) {
        s[j] = 0.f;
        if (j < length) {
          const float4* k_row = reinterpret_cast<const float4*>(keys + j * dim + h * head_dim);
#pragma unroll
          for (int m = 0; m < F; ++m) {
            if (lane + kLanes * m < nf) {
              const float4 k = k_row[lane + kLanes * m];
              s[j] = fmaf(q[m].x, k.x, s[j]);
              s[j] = fmaf(q[m].y, k.y, s[j]);
              s[j] = fmaf(q[m].z, k.z, s[j]);
              s[j] = fmaf(q[m].w, k.w, s[j]);
            }
          }
        }
      }
      sum_over_lanes<LMAX>(s, lane);

      // softmax over the row's keys, lane `lane` holding keys lane * kOwn + k
      float top = -INFINITY;
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        s[k] = __fdiv_rn(s[k], divisor);
        if (lane * kOwn + k < length) top = fmaxf(top, s[k]);
      }
#pragma unroll
      for (int bit = kLanes / 2; bit > 0; bit /= 2)
        top = fmaxf(top, __shfl_xor_sync(kFull, top, bit));
      float total = 0.f;
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        s[k] = lane * kOwn + k < length ? expf(__fsub_rn(s[k], top)) : 0.f;
        total = __fadd_rn(total, s[k]);
      }
#pragma unroll
      for (int bit = kLanes / 2; bit > 0; bit /= 2)
        total = __fadd_rn(total, __shfl_xor_sync(kFull, total, bit));
#pragma unroll
      for (int k = 0; k < kOwn; ++k) s[k] = __fdiv_rn(s[k], total);

      // ctx: the weights times the value rows, summed in key order
      float4 acc[F];
#pragma unroll
      for (int m = 0; m < F; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < LMAX; ++j) {
        if (j < length) {
          const float p = __shfl_sync(kFull, s[j % kOwn], j / kOwn, kLanes);
          const float4* v_row =
              reinterpret_cast<const float4*>(values + j * dim + h * head_dim);
#pragma unroll
          for (int m = 0; m < F; ++m) {
            if (lane + kLanes * m < nf) {
              const float4 v = v_row[lane + kLanes * m];
              acc[m].x = fmaf(p, v.x, acc[m].x);
              acc[m].y = fmaf(p, v.y, acc[m].y);
              acc[m].z = fmaf(p, v.z, acc[m].z);
              acc[m].w = fmaf(p, v.w, acc[m].w);
            }
          }
        }
      }
      if (active) {
        const long long out_row = slot < 0 ? n * length + r : n;
        float4* o = reinterpret_cast<float4*>(out + out_row * dim + h * head_dim);
#pragma unroll
        for (int m = 0; m < F; ++m)
          if (lane + kLanes * m < nf) o[lane + kLanes * m] = acc[m];
      }
    }
    __syncthreads();  // the buffer is refilled by the next iteration's copies
  }
}

size_t smem_bytes(int length, int dim, int slot) {
  const int q_rows = slot < 0 ? length : 1;
  return 2 * sizeof(float) * (size_t)(q_rows + 2 * length) * (size_t)dim;
}

template <int LMAX, int F>
int launch(const float* qkv, float* out, long long n_seq, long long stride_n, long long stride_l,
           int length, int heads, int head_dim, int slot, float divisor, cudaStream_t stream) {
  auto kernel = attention_core_kernel<LMAX, F>;
  const size_t smem = smem_bytes(length, heads * head_dim, slot);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)per_sm * sms;
  const int grid = (int)(n_seq < blocks ? n_seq : blocks);
  kernel<<<grid, kThreads, smem, stream>>>(qkv, out, n_seq, stride_n, stride_l, length, heads,
                                           head_dim, slot, divisor);
  return (int)cudaGetLastError();
}

template <int LMAX>
int launch_by_width(const float* qkv, float* out, long long n_seq, long long stride_n,
                    long long stride_l, int length, int heads, int head_dim, int slot,
                    float divisor, cudaStream_t stream) {
  const int per_lane = (head_dim / 4 + kLanes - 1) / kLanes;
  if (per_lane <= 1)
    return launch<LMAX, 1>(qkv, out, n_seq, stride_n, stride_l, length, heads, head_dim, slot,
                           divisor, stream);
  if (per_lane <= 2)
    return launch<LMAX, 2>(qkv, out, n_seq, stride_n, stride_l, length, heads, head_dim, slot,
                           divisor, stream);
  if (per_lane <= 4)
    return launch<LMAX, 4>(qkv, out, n_seq, stride_n, stride_l, length, heads, head_dim, slot,
                           divisor, stream);
  return launch<LMAX, 8>(qkv, out, n_seq, stride_n, stride_l, length, heads, head_dim, slot,
                         divisor, stream);
}

}  // namespace

// qkv: (n, length, 3 x dim) float32 on the card, the last axis contiguous,
// q | k | v each heads x head_dim with the heads side by side; strides in
// elements, multiples of 4, the pointer 16-byte aligned. out: contiguous
// float32, (n, length, dim), or with slot >= 0 (n, dim), the query of row
// `slot` alone. divisor: sqrt(head_dim) in fp32. Returns a cudaError_t.
extern "C" int attention_core_f32(const void* qkv, void* out, long long n, long long stride_n,
                                  long long stride_l, int length, int heads, int head_dim,
                                  int slot, float divisor, void* stream) {
  const int dim = heads * head_dim;
  if (n < 0 || length < 1 || length > kMaxLength || heads < 1 || head_dim < 4 ||
      head_dim > kMaxHeadDim || head_dim % 4 != 0 || slot >= length ||
      stride_n % 4 != 0 || stride_l % 4 != 0 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      3LL * length * dim > kSmemLimit / (2 * (long long)sizeof(float)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float* q = static_cast<const float*>(qkv);
  float* o = static_cast<float*>(out);
  const int s = slot < 0 ? -1 : slot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (length <= 16)
    return launch_by_width<16>(q, o, n, stride_n, stride_l, length, heads, head_dim, s, divisor,
                               st);
  return launch_by_width<32>(q, o, n, stride_n, stride_l, length, heads, head_dim, s, divisor,
                             st);
}
