"""What the references share: products in a stated precision, the LSTM
step loop, the L1 loss, Adam, and the denormalisation to pixels.

`precision` is "fp32", the configurations' own (the card's TF32 must be
off, as `run.py` sets it), or "tf32", the control: both operands of every
product rounded to TF32's 10 explicit mantissa bits (to nearest, ties away
from zero) and summed in float32, as the tensor cores' TF32 mode reads them.
The rounding is explicit, so the control means the same on the CPU.
"""

import torch

FRAME_SCALE = (320.0, 240.0, 320.0, 240.0)
PRECISIONS = ("fp32", "tf32")


def tf32(x):
    """`x` (float32) rounded to TF32's precision, kept as float32. The
    gradient passes through the rounding unchanged, so a backward product
    takes the rounded operand that the forward saved."""
    plain = x.detach().contiguous()
    rounded = ((plain.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return rounded if not x.requires_grad else x + (rounded - plain)


def matmul(a, b, precision):
    if precision == "tf32":
        return torch.matmul(tf32(a), tf32(b))
    if precision != "fp32":
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.matmul(a, b)


def lstm(x, w_ih, w_hh, precision):
    """A bias-free LSTM over `x (B, T, D)` -> `(B, T, H)`; gates [i, f, g, o]
    along the 4H columns of `w_ih (D, 4H)` and `w_hh (H, 4H)`."""
    batch, frames, _ = x.shape
    xproj = matmul(x, w_ih, precision)
    h = x.new_zeros(batch, w_hh.shape[0])
    c = torch.zeros_like(h)
    hs = []
    for t in range(frames):
        h, c = lstm_cell(xproj[:, t] + matmul(h, w_hh, precision), c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def lstm_cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def l1_loss(y, labels):
    """The mean absolute error over every coordinate of every frame."""
    return (y - labels).abs().mean()


def to_pixels(y, dtype=torch.int16):
    """Normalised boxes -> integer pixels: the float32 product, truncated
    toward zero."""
    return (y * torch.tensor(FRAME_SCALE, dtype=y.dtype, device=y.device)).to(dtype)


class Adam:
    """Adam as Kingma and Ba state it, betas (0.9, 0.999), eps 1e-8, over a
    dict of float32 leaves."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
