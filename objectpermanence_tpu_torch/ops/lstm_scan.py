"""LSTM recurrence kernels: `csrc/lstm_scan.cu` and their plain versions.

Counterparts of `objectpermanence_tpu/ops/pallas_scan.py`:

- `lstm_scan_forward` (K2, `_lstm_fwd_pallas`): `xproj (T, B, 4H)`,
  `w_hh (H, 4H)` -> `hs, cs (T, B, H)`;
- `lstm_scan_backward` (K3, `_lstm_bwd_pallas`): the reverse-time backward,
  -> `dxproj (T, B, 4H)`, `dW_hh (H, 4H)`; on the card hand-written
  launches for the gates of all steps, the carry loop and dW_hh;
- `lstm_scan_hs` (K4's recurrence, `lstm_scan_pallas`): `hs` only;
- `lstm_scan_fused(params, x)`: the differentiable layer `x (B, T, D) ->
  (B, T, H)` over K2 and K3, as `jax.custom_vjp` there;
- `lstm_scan_pallas(params, x)`: the forward-only layer over K4.

Weights keep the JAX layout (`w_ih (D, 4H)`, `w_hh (H, 4H)`, gates
`[i, f, g, o]`), sequences inside are time-major. On a CUDA tensor each
wrapper launches its kernel (and counts one launch) or raises; on a CPU
tensor it runs the plain version beside it, a step loop of the same fp32
arithmetic. The batch is masked in the kernel, not padded, so the JAX
module's batch-tile knobs (`FWD_BLOCK_B`, `BWD_BLOCK_B`, the time chunks)
have no counterpart. For fp32 parity the products around the kernels need
TF32 off (`torch.backends.cuda.matmul.allow_tf32`).
"""

import ctypes
import functools
from typing import Mapping

import torch

from objectpermanence_tpu_torch.ops import _build

_FNS = {}


def _kernel(name: str):
    """The C entry `name` of the lstm_scan library, built on first use."""
    if name not in _FNS:
        fn = getattr(_build.load("lstm_scan"), name)
        pointers = {"lstm_scan_forward_f32": 5, "lstm_scan_backward_f32": 9}[name]
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


_PLAN_FIELDS = ("units", "blocks", "smem", "groups", "slices", "stage", "lanes", "scratch",
                "tile", "splits", "passes", "videos")


def launch_plan(hidden: int, backward: bool = False, batch: int = 16, frames: int = 300):
    """How the kernel is launched at hidden width `hidden` and `batch` videos
    (and, for K3, `frames` steps) on the current card, as the library plans
    it: units per block, blocks (video groups x unit slices), shared memory
    bytes, the staging (K3: videos of dgates at once; K2/K4: rows of h a
    chunk), unit lanes of a warp (K3), scratch bytes, the forward's register
    tile of videos and parts of the contraction over k, its passes over
    slices of the batch, and videos of a group."""
    lib = _build.load("lstm_scan")
    out = (ctypes.c_int * len(_PLAN_FIELDS))()
    err = lib.lstm_scan_plan(ctypes.c_int(hidden), ctypes.c_int(batch), ctypes.c_int(frames),
                             ctypes.c_int(int(backward)), out)
    _raise_on(err, "lstm_scan plan")
    return dict(zip(_PLAN_FIELDS, out))


# The forward's shape constants (`csrc/lstm_scan.cu`)
THREADS = 256
TILES = (1, 2, 4, 8, 16)  # videos of a thread's register tile (`kMaxTile`)
K_SPLITS = (1, 2, 4, 8)   # parts of the contraction over k (`kMaxKSplit`)


def _fwd_per_round(tasks, splits):
    return max(32, min(THREADS // splits, -(-tasks // 32) * 32))


def _fwd_stage_floats(hidden, padded, chunk, tile, splits, tasks):
    chunks = (1 if chunk >= hidden else 2) * chunk * padded
    parts = 4 * tile * splits * _fwd_per_round(tasks, splits)
    return (max(chunks, parts) + 3) // 4 * 4


def _fwd_smem_bytes(hidden, units, padded, stage):
    floats = stage + padded * units + padded * (units + 1) + 4 * padded * units
    return (16 * hidden * units + 4 * floats + 15) // 16 * 16


def _fwd_step_clocks(hidden, units, videos, padded, slices, tile, splits, chunk):
    """`csrc/lstm_scan.cu::fwd_step_clocks`, in the same integers."""
    tasks = units * -(-videos // tile)
    per_round = _fwd_per_round(min(tasks, THREADS), splits)
    rounds = -(-tasks // per_round)
    active = min(tasks, per_round)
    warps = splits * -(-active // 32)
    lanes = min(active, 32)
    quarters = (lanes + 7) // 8
    h_wf = 1 if tile == 1 else (lanes + 15) // 16 if tile == 2 else tile // 4 * quarters
    per_sched = (warps + 3) // 4
    issue = per_sched * (4 * tile + 1 + (1 if tile <= 2 else tile // 4) + 3)
    per_row = max(issue * (4 if per_sched == 1 else 3) // 2, warps * (quarters + h_wf))
    contraction = -(-hidden // splits) * per_row
    staged = padded * 4 * hidden // 64
    chunks = -(-hidden // chunk)
    round_ = max(contraction, staged) + 200 * chunks
    cells = -(-(videos * units) // THREADS) * (300 + 20 * splits)
    return rounds * round_ + cells + 1000 + 20 * slices


def _fwd_candidates(hidden, pass_videos, sms, smem_max):
    """(cost, plan) of every grid, tile and chunk `make_fwd_plan` weighs for a
    pass of `pass_videos` videos, in its order; a chunk is the most rows of h
    (a multiple of 8) whose buffers fit."""
    for slices in range(1, min(hidden, sms) + 1):
        units = -(-hidden // slices)
        if -(-hidden // units) != slices or 16 * hidden * units > smem_max:
            continue  # S = ceil(H / U) for one U only; the columns must fit
        for groups in range(1, min(pass_videos, sms // slices) + 1):
            videos = -(-pass_videos // groups)
            if -(-pass_videos // videos) != groups:
                continue
            padded = (videos + 3) // 4 * 4
            for tile in TILES:
                if tile > 1 and tile > videos:
                    break
                tasks = units * -(-videos // tile)
                for splits in K_SPLITS:
                    if splits > 1 and tasks * splits > THREADS:
                        break
                    chunk = (hidden + 7) // 8 * 8
                    while chunk >= 8:
                        stage = _fwd_stage_floats(hidden, padded, chunk, tile, splits, tasks)
                        smem = _fwd_smem_bytes(hidden, units, padded, stage)
                        if smem <= smem_max:
                            break
                        chunk = 256 if chunk > 256 else chunk // 2 // 8 * 8
                    if chunk < 8:
                        continue
                    cost = _fwd_step_clocks(hidden, units, videos, padded, slices, tile, splits,
                                            chunk)
                    yield cost, {"units": units, "blocks": groups * slices, "smem": smem,
                                 "groups": groups, "slices": slices, "stage": chunk, "lanes": 0,
                                 "scratch": 4 * 2 * groups * hidden * padded + 4 * groups,
                                 "tile": tile, "splits": splits, "videos": videos}


def forward_launch_plan(hidden: int, batch: int, sms: int, smem_max: int) -> dict:
    """K2/K4's plan for `batch` videos at `hidden` units on a card of `sms`
    SMs and `smem_max` bytes of opt-in shared memory a block, with
    `launch_plan`'s keys: the CPU's copy of `csrc/lstm_scan.cu::make_fwd_plan`
    (a card test holds the two equal). The fewest passes over slices of the
    batch whose videos a grid can hold; then the G x S grid, register tile
    (V videos x one unit, over 1 / KS of k) and chunk of least modelled step
    cost; ties to fewer blocks, then more parts. Raises RuntimeError when no
    grid fits, where the library returns cudaErrorCooperativeLaunchTooLarge."""
    if hidden < 1 or batch < 1:
        raise ValueError(f"hidden and batch must be >= 1, got {hidden}, {batch}")
    passes = 1
    while passes < 2 * batch:
        pass_videos = -(-batch // passes)
        candidates = list(_fwd_candidates(hidden, pass_videos, sms, smem_max))
        if candidates:
            _, plan = min(candidates, key=lambda c: (c[0], c[1]["blocks"], -c[1]["splits"]))
            return {**plan, "passes": -(-batch // pass_videos)}
        passes *= 2
    raise RuntimeError(f"no grid of the LSTM forward fits {sms} SMs of {smem_max} bytes at "
                       f"hidden width {hidden}")


@functools.lru_cache(maxsize=64)
def _scratch_bytes(device_index, hidden, batch, seq_len, backward) -> int:
    """The kernel's scratch bytes on this card (the plan depends on the card
    only through its SM count and shared memory)."""
    return launch_plan(hidden, backward, batch, seq_len)["scratch"]


def _raise_on(err: int, what: str) -> None:
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"{what}: the grid does not fit the card at once (cudaError 720); "
                           f"the kernel needs every block co-resident")
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def _gates(xproj_t, h, w_hh):
    i, f, g, o = (xproj_t + h @ w_hh).chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def lstm_scan_forward_reference(xproj: torch.Tensor, w_hh: torch.Tensor):
    """Plain K2: `xproj (T, B, 4H)` -> `(hs, cs)`, each `(T, B, H)`."""
    seq_len, batch, _ = xproj.shape
    h = xproj.new_zeros(batch, w_hh.shape[0])
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in range(seq_len):
        i, f, g, o = _gates(xproj[t], h, w_hh)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_scan_backward_reference(xproj, h_prev, c_prev, cs, dh_out, w_hh):
    """Plain K3, the arithmetic of `_lstm_bwd_kernel` step by step in
    reverse time -> `(dxproj (T, B, 4H), dW_hh (H, 4H))`."""
    seq_len, batch, _ = xproj.shape
    dh = xproj.new_zeros(batch, w_hh.shape[0])
    dc = torch.zeros_like(dh)
    d_w_hh = torch.zeros_like(w_hh)
    dxproj = torch.empty_like(xproj)
    for t in reversed(range(seq_len)):
        i, f, g, o = _gates(xproj[t], h_prev[t], w_hh)
        dh_total = dh_out[t] + dh
        tanh_c = torch.tanh(cs[t])
        dc = dc + dh_total * o * (1.0 - tanh_c * tanh_c)
        di = dc * g * i * (1.0 - i)
        df = dc * c_prev[t] * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        do = dh_total * tanh_c * o * (1.0 - o)
        dgates = torch.cat([di, df, dg, do], dim=1)
        dxproj[t] = dgates
        d_w_hh = d_w_hh + h_prev[t].t() @ dgates
        dh = dgates @ w_hh.t()
        dc = dc * f
    return dxproj, d_w_hh


def _check(named, seq_shape):
    """float32, contiguous, one device; `seq_shape` maps names to shapes."""
    device = next(iter(named.values())).device
    for name, x in named.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(x.shape) != seq_shape[name]:
            raise ValueError(f"{name} must be {seq_shape[name]}, got {tuple(x.shape)}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the LSTM kernels run on cuda or cpu, got {device}")
    return device


def _forward_shapes(xproj, w_hh):
    if xproj.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"xproj must be (T, B, 4H) and w_hh (H, 4H), got "
                         f"{tuple(xproj.shape)} and {tuple(w_hh.shape)}")
    seq_len, batch, _ = xproj.shape
    hidden = w_hh.shape[0]
    if seq_len < 1 or batch < 1 or hidden < 1:
        raise ValueError(f"empty sequence, batch or width: xproj {tuple(xproj.shape)}")
    return seq_len, batch, hidden, {"xproj": (seq_len, batch, 4 * hidden),
                                    "w_hh": (hidden, 4 * hidden)}


def _launch_forward(xproj, w_hh, emit_cells: bool):
    seq_len, batch, hidden = xproj.shape[0], xproj.shape[1], w_hh.shape[0]
    with torch.cuda.device(xproj.device):
        hs = torch.empty((seq_len, batch, hidden), dtype=torch.float32, device=xproj.device)
        cs = torch.empty_like(hs) if emit_cells else None
        # the groups' h slabs and their barriers' counters (zeroed by the entry)
        scratch = torch.empty(_scratch_bytes(xproj.device.index, hidden, batch, seq_len, False),
                              dtype=torch.uint8, device=xproj.device)
        err = _kernel("lstm_scan_forward_f32")(
            xproj.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
            None if cs is None else cs.data_ptr(), scratch.data_ptr(),
            seq_len, batch, hidden, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "lstm_scan forward kernel launch")
    return hs, cs


def lstm_scan_forward(xproj: torch.Tensor, w_hh: torch.Tensor):
    """K2: `xproj (T, B, 4H)`, `w_hh (H, 4H)` -> `(hs, cs)`, each `(T, B, H)`."""
    _, _, _, shapes = _forward_shapes(xproj, w_hh)
    if _check({"xproj": xproj, "w_hh": w_hh}, shapes).type == "cpu":
        return lstm_scan_forward_reference(xproj, w_hh)
    out = _launch_forward(xproj, w_hh, emit_cells=True)
    lstm_scan_forward.launches += 1
    return out


def lstm_scan_hs(xproj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """K4: the forward recurrence emitting `hs (T, B, H)` only."""
    _, _, _, shapes = _forward_shapes(xproj, w_hh)
    if _check({"xproj": xproj, "w_hh": w_hh}, shapes).type == "cpu":
        return lstm_scan_forward_reference(xproj, w_hh)[0]
    hs, _ = _launch_forward(xproj, w_hh, emit_cells=False)
    lstm_scan_hs.launches += 1
    return hs


def lstm_scan_backward(xproj, h_prev, c_prev, cs, dh_out, w_hh):
    """K3: the reverse-time backward. Sequences `(T, B, .)`; `h_prev` and
    `c_prev` are `hs` and `cs` shifted one step later with zeros at t=0.
    Returns `(dxproj (T, B, 4H), dW_hh (H, 4H))`."""
    seq_len, batch, hidden, shapes = _forward_shapes(xproj, w_hh)
    for name in ("h_prev", "c_prev", "cs", "dh_out"):
        shapes[name] = (seq_len, batch, hidden)
    named = {"xproj": xproj, "h_prev": h_prev, "c_prev": c_prev, "cs": cs, "dh_out": dh_out,
             "w_hh": w_hh}
    if _check(named, shapes).type == "cpu":
        return lstm_scan_backward_reference(xproj, h_prev, c_prev, cs, dh_out, w_hh)
    with torch.cuda.device(xproj.device):
        dxproj = torch.empty_like(xproj)
        d_w_hh = torch.empty_like(w_hh)
        # dW_hh's partial sums and the loop's barrier counters (zeroed by the entry)
        scratch = torch.empty(_scratch_bytes(xproj.device.index, hidden, batch, seq_len, True),
                              dtype=torch.uint8, device=xproj.device)
        err = _kernel("lstm_scan_backward_f32")(
            xproj.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(), cs.data_ptr(),
            dh_out.data_ptr(), w_hh.data_ptr(), dxproj.data_ptr(), d_w_hh.data_ptr(),
            scratch.data_ptr(), seq_len, batch, hidden, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "lstm_scan backward kernel launch")
    lstm_scan_backward.launches += 1
    return dxproj, d_w_hh


lstm_scan_forward.launches = 0
lstm_scan_hs.launches = 0
lstm_scan_backward.launches = 0


def _time_major_xproj(x, w_ih):
    """`x (B, T, D) @ w_ih` as `(T, B, 4H)`, the einsum "btd,dh->tbh"."""
    return torch.matmul(x.transpose(0, 1), w_ih).contiguous()


class _LSTMScanFused(torch.autograd.Function):
    """Forward on K2, backward on K3; saves `x`, `hs`, `cs` and recomputes
    `xproj` in the backward, as `_fused_fwd` / `_fused_bwd` do."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh):
        hs, cs = lstm_scan_forward(_time_major_xproj(x, w_ih), w_hh.contiguous())
        ctx.save_for_backward(x, w_ih, w_hh, hs, cs)
        return hs.transpose(0, 1)

    @staticmethod
    def backward(ctx, dout):
        x, w_ih, w_hh, hs, cs = ctx.saved_tensors
        xproj = _time_major_xproj(x, w_ih)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
        dh_out = dout.transpose(0, 1).contiguous()
        dxproj, d_w_hh = lstm_scan_backward(xproj, h_prev, c_prev, cs, dh_out,
                                            w_hh.contiguous())
        d_w_ih = torch.einsum("btd,tbh->dh", x, dxproj)
        dx = torch.einsum("tbh,dh->btd", dxproj, w_ih)
        return dx, d_w_ih, d_w_hh


def lstm_scan_fused(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Differentiable bias-free LSTM layer `x (B, T, D) -> (B, T, H)`, with
    the recurrence forward on K2 and backward on K3."""
    return _LSTMScanFused.apply(x, params["w_ih"], params["w_hh"])


def lstm_scan_pallas(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Forward-only layer `x (B, T, D) -> (B, T, H)` on K4; records no
    gradient."""
    with torch.no_grad():
        hs = lstm_scan_hs(_time_major_xproj(x, params["w_ih"]), params["w_hh"].contiguous())
    return hs.transpose(0, 1)
