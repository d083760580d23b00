"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the program. ``mm`` is every projection's matrix
product: in float32 (``precision="float32"``, TF32 off) for the
reference, or in float8 (``"fp8"``) for a control, the precision below
the bfloat16 that the configurations state for their matrix products:
as float8 training does it, both operands of the forward product are
rounded to e4m3 and the gradient of its output to e5m2, each under a
per-tensor scale that maps its largest magnitude to the format's
largest, and the backward products take the rounded operands.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@contextmanager
def no_tf32():
    """Float32 matrix products in full float32 for the block."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def round_fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to the float8 format ``fmt`` under a per-tensor scale
    that maps its largest magnitude to the format's largest, back in
    ``x``'s dtype."""
    scale = FP8[fmt] / x.abs().amax().float().clamp_min(1e-30)
    return (x * scale).to(fmt).to(x.dtype) / scale


class _FP8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = round_fp8(x), round_fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = round_fp8(gy, torch.float8_e5m2)
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gq @ wq.T, gw


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (..., K) times ``w`` (K, N)."""
    if precision == "fp8":
        return _FP8Product.apply(x, w)
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def rms_norm(x, scale, eps):
    """``x / rms(x) * (1 + scale)``: the scale is stored as an offset
    from one."""
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def softmax_attention(q, k, v, *, causal: bool):
    """q (B,Sq,H,hd), k and v (B,Sk,H,hd) -> (B,Sq,H,hd)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def next_token_loss(logits, tokens, rows=None):
    """Mean cross-entropy of ``logits[:, :-1]`` against ``tokens[:, 1:]``;
    ``rows`` keeps only the first that many rows (a fault of the checks'
    own tests: half of the batch left out)."""
    if rows is not None:
        logits, tokens = logits[:rows], tokens[:rows]
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())
