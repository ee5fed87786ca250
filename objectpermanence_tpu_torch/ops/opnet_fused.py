"""Fused OPNet forward: the CUDA kernel `csrc/opnet_fused.cu` and its plain
version.

Counterpart of `opnet_fused_forward` in
`objectpermanence_tpu/ops/pallas_scan.py` (the Pallas kernel
`_opnet_kernel`). Same function, same public layouts:
`boxes (B, T, O, F)` -> `(y (B, T, 4), logits (B, O, T))`, weights in the
JAX layout `w (in, out)`, LSTM gates `[i, f, g, o]`, no biases.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `opnet_forward_reference`, a step-by-step loop of the same
arithmetic. The kernel is a cooperative grid of video groups x unit slices
(`launch_plan`), each block holding its slice of the recurrent weights in
shared memory; it exchanges h through a float32 scratch buffer that the
wrapper allocates, and raises if the grid does not fit the card at once.

`compute_dtype=torch.bfloat16` is the TPU kernel's bf16 operand mode: the
six weights and the boxes are rounded to bf16, and `xproj1 = scene @ W1_ih`
of the rounded values, summed in float32, is rounded to bf16 too; the h/c
carries, every product's sum, the softmax and both outputs stay float32
(`pallas_scan.py:462-482`; XLA rounds the float32 scene to bf16 before its
bf16 product).
The kernel streams those bf16 values; the plain version rounds them and
runs the float32 step loop, so both compute the float32 function of the
same bf16 values.
"""

import ctypes

import torch

from objectpermanence_tpu_torch.ops import _build
from objectpermanence_tpu_torch.ops.lstm import lstm_cell

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_FNS = {}


def _kernel(compute_dtype=torch.float32):
    """The C entry of K1 for `compute_dtype`'s operands."""
    name = "opnet_fused_forward_bf16" if compute_dtype == torch.bfloat16 else \
        "opnet_fused_forward_f32"
    if name not in _FNS:
        fn = getattr(_build.load("opnet_fused"), name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def launch_plan(batch, att_hidden, vid_hidden, compute_dtype=torch.float32):
    """How K1 runs `batch` videos at widths `att_hidden`/`vid_hidden` on the
    current card: {groups, slices, blocks, smem (bytes a block), scratch
    (float32 elements)}. Raises if no grid fits the card at once."""
    lib = _build.load("opnet_fused")
    out = [ctypes.c_int() for _ in range(5)]
    itemsize = 2 if compute_dtype == torch.bfloat16 else 4
    err = lib.opnet_fused_plan(ctypes.c_int(batch), ctypes.c_int(att_hidden),
                               ctypes.c_int(vid_hidden), ctypes.c_int(itemsize),
                               *[ctypes.byref(x) for x in out])
    _raise_on(err, "opnet_fused plan")
    return dict(zip(("groups", "slices", "blocks", "smem", "scratch"), (x.value for x in out)))


def _raise_on(err, what):
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"{what}: no grid fits the card at once (cudaError 720); "
                           f"the kernel needs every block co-resident")
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def _rounded(x, compute_dtype):
    """x's values in `compute_dtype`, read back as float32."""
    return x if compute_dtype == torch.float32 else x.to(compute_dtype).float()


def opnet_forward_reference(boxes, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head,
                            compute_dtype=torch.float32):
    """Plain PyTorch OPNet forward, one step at a time, on any device; with
    `compute_dtype=torch.bfloat16`, on the weights, boxes and input
    projection rounded to bf16, as the kernel's bf16 mode reads them."""
    w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head = (
        _rounded(w, compute_dtype) for w in (w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head))
    boxes = _rounded(boxes, compute_dtype)
    batch, seq_len, num_objects, feat = boxes.shape
    xproj1 = _rounded(torch.matmul(boxes.reshape(batch, seq_len, num_objects * feat), w1_ih),
                      compute_dtype)
    h1 = boxes.new_zeros(batch, w1_hh.shape[0])
    c1 = torch.zeros_like(h1)
    h2 = boxes.new_zeros(batch, w2_hh.shape[0])
    c2 = torch.zeros_like(h2)
    ys, logits = [], []
    for t in range(seq_len):
        h1, c1 = lstm_cell(xproj1[:, t] + h1 @ w1_hh, c1)
        step_logits = h1 @ w_att                                  # (B, O)
        probs = torch.softmax(step_logits, dim=-1)
        selected = (boxes[:, t] * probs[..., None]).sum(dim=1)    # (B, F)
        h2, c2 = lstm_cell(selected @ w2_ih + h2 @ w2_hh, c2)
        ys.append(h2 @ w_head)
        logits.append(step_logits)
    return torch.stack(ys, dim=1), torch.stack(logits, dim=2)


def _unit_major(w):
    """(D, 4H) gate-major columns (gate * H + u) -> unit-major (4u + gate)."""
    rows, cols = w.shape
    return w.view(rows, 4, cols // 4).transpose(1, 2).reshape(rows, cols)


def _check(boxes, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head, compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                        f"got {compute_dtype}")
    tensors = {"boxes": boxes, "w1_ih": w1_ih, "w1_hh": w1_hh, "w_att": w_att,
               "w2_ih": w2_ih, "w2_hh": w2_hh, "w_head": w_head}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != boxes.device:
            raise ValueError(f"{name} is on {x.device}, boxes on {boxes.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if boxes.dim() != 4:
        raise ValueError(f"boxes must be (B, T, O, F), got {tuple(boxes.shape)}")
    batch, seq_len, num_objects, feat = boxes.shape
    att_hidden, vid_hidden = w1_hh.shape[0], w2_hh.shape[0]
    expected = {"w1_ih": (num_objects * feat, 4 * att_hidden),
                "w1_hh": (att_hidden, 4 * att_hidden),
                "w_att": (att_hidden, num_objects),
                "w2_ih": (feat, 4 * vid_hidden),
                "w2_hh": (vid_hidden, 4 * vid_hidden),
                "w_head": (vid_hidden, 4)}
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for boxes {tuple(boxes.shape)}, "
                             f"got {tuple(tensors[name].shape)}")
    if batch < 1 or seq_len < 1:
        raise ValueError(f"empty batch or sequence: boxes {tuple(boxes.shape)}")
    if num_objects > 32 or feat > 8:
        raise ValueError(f"the kernel takes at most 32 object slots and 8 features, "
                         f"got {num_objects} and {feat}")
    if att_hidden % 4 or vid_hidden % 4:
        raise ValueError(f"hidden widths must be multiples of 4, got {att_hidden}, {vid_hidden}")


def kernel_operands(boxes, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head,
                    compute_dtype=torch.float32):
    """The kernel's seven inputs, each contiguous in `compute_dtype`:
    `xproj1 (B, T, 4*H1)` unit-major, the boxes, W1_hh, W2_ih and W2_hh
    unit-major, W_att and W_head transposed. In bf16, xproj1 is the plain
    version's product (the float32 sum of the rounded scene and W1_ih),
    made unit-major and rounded in one copy."""
    batch, seq_len, num_objects, feat = boxes.shape
    att_hidden = w1_hh.shape[0]
    boxes = boxes.to(compute_dtype)
    scene = boxes.view(batch, seq_len, num_objects * feat)
    if compute_dtype == torch.float32:
        xproj1 = torch.matmul(scene, _unit_major(w1_ih))
    else:
        xproj1 = torch.empty((batch, seq_len, att_hidden, 4), dtype=compute_dtype,
                             device=boxes.device)
        xproj1.copy_(torch.matmul(scene.float(), _rounded(w1_ih, compute_dtype))
                     .view(batch, seq_len, 4, att_hidden).transpose(2, 3))
        xproj1 = xproj1.view(batch, seq_len, 4 * att_hidden)
    return (xproj1, boxes, _unit_major(w1_hh).to(compute_dtype),
            w_att.t().contiguous().to(compute_dtype), _unit_major(w2_ih).to(compute_dtype),
            _unit_major(w2_hh).to(compute_dtype), w_head.t().contiguous().to(compute_dtype))


def opnet_fused_forward(boxes, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head,
                        compute_dtype=torch.float32):
    """`boxes (B, T, O, F)` float32 -> `(y (B, T, 4), logits (B, O, T))`
    float32; weights float32, `compute_dtype` float32 or bfloat16 (the
    kernel's operands, above).

    CUDA tensors launch the kernel (and count one launch); CPU tensors run
    `opnet_forward_reference`. The input projection `scene @ w1_ih` is one
    torch.matmul outside the kernel, as XLA computed it outside Pallas; for
    fp32 parity TF32 must be off (`torch.backends.cuda.matmul.allow_tf32`)."""
    _check(boxes, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head, compute_dtype)
    if boxes.device.type == "cpu":
        return opnet_forward_reference(boxes, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head,
                                       compute_dtype)
    if boxes.device.type != "cuda":
        raise ValueError(f"opnet_fused_forward runs on cuda or cpu, got {boxes.device}")

    batch, seq_len, num_objects, feat = boxes.shape
    att_hidden, vid_hidden = w1_hh.shape[0], w2_hh.shape[0]
    fn = _kernel(compute_dtype)
    with torch.cuda.device(boxes.device):
        plan = launch_plan(batch, att_hidden, vid_hidden, compute_dtype)
        operands = kernel_operands(boxes, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head,
                                   compute_dtype)
        y = torch.empty((batch, seq_len, 4), dtype=torch.float32, device=boxes.device)
        logits = torch.empty((batch, num_objects, seq_len), dtype=torch.float32,
                             device=boxes.device)
        scratch = torch.empty(plan["scratch"], dtype=torch.float32, device=boxes.device)
        err = fn(*[x.data_ptr() for x in operands], y.data_ptr(), logits.data_ptr(),
                 scratch.data_ptr(), batch, seq_len, num_objects, feat,
                 att_hidden, vid_hidden, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "opnet_fused kernel launch")
    opnet_fused_forward.launches += 1
    return y, logits


opnet_fused_forward.launches = 0
