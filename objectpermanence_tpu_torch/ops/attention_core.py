"""The attention core of `ops/attention.py::MultiheadSelfAttention`:
everything between the QKV product and the out-projection (the scores q·kᵀ,
their division by √head_dim, the softmax over the sequence, the weighted sum
of v, and ctx laid out `(N, L, D)` with the heads side by side), or with
`slot` that one query's rows, `(N, D)`.

The JAX package has no Pallas kernel here (its attention is XLA). On a card,
outside autograd, the core is the kernel of `csrc/attention_core.cu`: it
reads the QKV product in place and writes ctx once, where the plain
composition copies q, k, v and ctx and runs batched 15x15 products and
separate scale and softmax passes. Every other case runs the plain
composition (`attention_core_reference`): the CPU, training under autograd
(its check is held to how the encoder's products sum, and the kernel has no
backward), and sequences longer than `MAX_LENGTH` (`reference_compat`'s B·T
tokens). `kernel_takes` states the rule; a tensor it takes launches the
kernel or raises.
"""

import ctypes
import math

import torch

from objectpermanence_tpu_torch.ops import _build

# the kernel's limits, as `csrc/attention_core.cu` states them (kMaxLength,
# kMaxHeadDim, kSmemLimit) and its entry refuses beyond them
MAX_LENGTH = 32
MAX_HEAD_DIM = 256
# two (3 x L x D) float32 slabs in a block's 227 KB of shared memory
MAX_SLAB_FLOATS = 232448 // 8


def attention_core_reference(qkv: torch.Tensor, num_heads: int, slot=None) -> torch.Tensor:
    """The plain composition over `qkv (N, L, 3D)`: ctx `(N, L, D)`, or with
    `slot` its rows `ctx[:, slot]`, `(N, D)`."""
    n, length, three_dim = qkv.shape
    dim = three_dim // 3
    head_dim = dim // num_heads
    q, k, v = (t.reshape(n, length, num_heads, head_dim).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim), dim=-1)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(n, length, dim)
    return ctx if slot is None else ctx[:, slot]


def kernel_takes(qkv: torch.Tensor, num_heads: int) -> bool:
    """The dispatch rule: a float32 tensor on a card, outside autograd, of at
    most `MAX_LENGTH` tokens, head_dim a multiple of 4 up to `MAX_HEAD_DIM`,
    and a slab that fits the kernel's shared memory."""
    length, dim = qkv.shape[1], qkv.shape[2] // 3
    head_dim = dim // num_heads
    return (qkv.device.type == "cuda" and qkv.dtype == torch.float32
            and not torch.is_grad_enabled() and length <= MAX_LENGTH
            and head_dim % 4 == 0 and head_dim <= MAX_HEAD_DIM
            and 3 * length * dim <= MAX_SLAB_FLOATS)


def _core_kernel():
    """`csrc/attention_core.cu`'s entry, built on first use."""
    if not hasattr(_core_kernel, "fn"):
        fn = _build.load("attention_core").attention_core_f32
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _core_kernel.fn = fn
    return _core_kernel.fn


def _launch(qkv: torch.Tensor, num_heads: int, slot) -> torch.Tensor:
    n, length, three_dim = qkv.shape
    dim = three_dim // 3
    head_dim = dim // num_heads
    if slot is not None and not -length <= slot < length:
        raise IndexError(f"slot {slot} out of range for {length} tokens")
    if (qkv.stride(2) != 1 or qkv.stride(0) % 4 or qkv.stride(1) % 4
            or qkv.data_ptr() % 16):
        raise ValueError(f"attention core kernel: qkv strides {qkv.stride()} at "
                         f"{qkv.data_ptr():#x} are not 16-byte rows")
    out = torch.empty((n, length, dim) if slot is None else (n, dim),
                      dtype=qkv.dtype, device=qkv.device)
    if n:
        with torch.cuda.device(qkv.device):
            err = _core_kernel()(qkv.data_ptr(), out.data_ptr(), n, qkv.stride(0),
                                 qkv.stride(1), length, num_heads, head_dim,
                                 -1 if slot is None else slot % length, math.sqrt(head_dim),
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"attention core kernel launch failed: cudaError {err}")
        attention_core.launches += 1
    return out


def attention_core(qkv: torch.Tensor, num_heads: int, slot=None) -> torch.Tensor:
    """ctx from `qkv (N, L, 3D)`, q | k | v each `num_heads` heads side by
    side: `(N, L, D)`, or with `slot` that query's rows, `(N, D)`. The kernel
    where `kernel_takes` holds (counted in `attention_core.launches`), else
    the plain composition."""
    if kernel_takes(qkv, num_heads):
        return _launch(qkv, num_heads, slot)
    return attention_core_reference(qkv, num_heads, slot)


attention_core.launches = 0
