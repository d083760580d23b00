"""xLSTM LM (arXiv:2405.04517): alternating mLSTM and sLSTM blocks.

Counterpart of ``repro/models/xlstm.py``, op for op.

* mLSTM: matrix-memory cell with exponential gating. Training and
  prefill use the chunkwise-parallel form (the stabilised quadratic form
  within a chunk, the exact recurrent state ``(C, n, m)`` carried across
  chunks in float32); the reference's ``lax.scan`` over chunks is a
  Python loop here. Decode is the O(1)-per-token recurrent form.
* sLSTM: scalar-memory cell with a hidden-state recurrence, inherently
  sequential: a loop over time (``lax.scan`` there) whose backward is
  written out (:class:`_SLSTMScan`), both loops replayed as CUDA graphs
  on the card in training, and one step for decode.

Blocks follow the paper: pre-norm, up-projection (factor 2) with a
causal conv4 + SiLU on the q/k path, gated output, down-projection.
Layer kinds alternate per ``cfg.block_pattern``; the parameters'
``blocks`` is a list of per-layer dicts (kinds differ), not stacks over
layers, so :meth:`XLSTM.state_tree` is the reference's ``init_params``
tree with the same names, shapes and dtypes. The reference's
``shard_act`` pins sit where it has them (no-ops without a mesh; the
mLSTM's queries shard their sequence over "model"). The decode state is a dict
``{"layers": [per-layer dicts], "pos": () int32}`` whose shapes depend
only on the config; ``decode_step`` returns a new one and leaves the
given state unchanged, as the reference's does.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cross_entropy, new_param, rms_norm
from repro_torch.models.sharding import shard_act

NEG = -1e30   # the reference's guard for all -inf rows and its initial m


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,D), w (W,D) -> (B,S,D)."""
    wlen = w.shape[0]
    s = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(wlen):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[wlen - 1 - i].to(x.dtype)
    return out + b.to(x.dtype)


def _conv_step(x_t, conv_state, w, b):
    """x_t (B,D); conv_state (B,W-1,D) holds previous inputs (oldest
    first) -> (out (B,D), the next conv state)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)          # (B,W,D)
    out = torch.einsum("bwd,wd->bd", window, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return out, window[:, 1:].contiguous()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ModelConfig, generator, device) -> nn.ParameterDict:
    d = cfg.d_model
    di = 2 * d
    h = cfg.n_heads

    def new(shape, init="dense", **kw):
        return new_param(generator, shape, cfg.pdt, device, init, **kw)

    return nn.ParameterDict({
        "ln": new((d,), 0.0),
        "w_up": new((d, di)),
        "w_z": new((d, di)),
        "conv_w": new((cfg.conv_width, di), scale=0.3),
        "conv_b": new((di,), 0.0),
        "wq": new((di, di)),
        "wk": new((di, di)),
        "wv": new((di, di)),
        "w_i": new((di, h)),
        "w_f": new((di, h)),
        "b_i": new((h,), 0.0),
        "b_f": new((h,), 3.0),       # open forget gates at init
        "gn": new((h, di // h), 0.0),
        "w_down": new((di, d)),
    })


def _mlstm_parallel(q, k, v, logf, logi):
    """q/k/v: (B,S,H,hd); logf/logi: (B,S,H) -> (B,S,H,hd)."""
    s, hd = q.shape[1], q.shape[3]
    Fc = torch.cumsum(logf.float(), dim=1).transpose(1, 2)        # (B,H,S)
    D = Fc[:, :, :, None] - Fc[:, :, None, :] + logi.float().transpose(1, 2)[:, :, None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    D = torch.where(mask, D, float("-inf"))
    m = D.amax(dim=-1, keepdim=True).clamp_min(NEG)             # guard all -inf rows
    w = torch.exp(D - m)
    scores = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * (hd ** -0.5) * w
    denom = torch.maximum(scores.sum(-1, keepdim=True).abs(), torch.exp(-m))
    out = torch.einsum("bhij,bjhd->bihd", scores / denom, v.float())
    return out.to(q.dtype)


def _mlstm_chunked(q, k, v, logf, logi, chunk: int):
    """Chunkwise-parallel mLSTM (the xLSTM paper's training form).

    Within a chunk: the stabilised quadratic form. Across chunks: the
    exact recurrent state (C, n, m) carries in float32, so memory is
    O(S*c) instead of O(S^2), and the final carry IS the decode state.

    Returns (h (B,S,H,hd), (C, n, m) after the last token)."""
    b, s, h, hd = q.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    dev = q.device
    scale = hd ** -0.5
    C = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((b, h, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, h), NEG, dtype=torch.float32, device=dev)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    outs = []
    for qi, ki, vi, lf, li in zip(*(t.float().split(chunk, dim=1) for t in (q, k, v, logf, logi))):
        Lh = torch.cumsum(lf, dim=1).transpose(1, 2)               # (b,h,c) inclusive
        lih = li.transpose(1, 2)
        D = Lh[:, :, :, None] - Lh[:, :, None, :] + lih[:, :, None, :]
        D = torch.where(mask, D, float("-inf"))
        m_intra = D.amax(dim=-1).clamp_min(NEG)                  # (b,h,c)
        m_tot = torch.maximum(m_intra, Lh + m[:, :, None])        # (b,h,c)
        w = torch.exp(D - m_tot[..., None])
        scores = torch.einsum("bihd,bjhd->bhij", qi, ki) * scale * w
        carry_w = torch.exp(Lh + m[:, :, None] - m_tot)           # (b,h,c)
        qh = qi.transpose(1, 2)                                   # (b,h,c,hd)
        numer = scores @ vi.transpose(1, 2) + carry_w[..., None] * (qh @ C)
        dsum = scores.sum(-1) + carry_w * (qh @ n[..., None])[..., 0]
        denom = torch.maximum(dsum.abs(), torch.exp(-m_tot))
        outs.append((numer / denom[..., None]).transpose(1, 2))  # (b,c,h,hd)

        Lc = Lh[:, :, -1]                                         # (b,h)
        e_j = Lc[:, :, None] - Lh + lih                           # (b,h,c)
        m_new = torch.maximum(Lc + m, e_j.amax(dim=-1))
        wj = torch.exp(e_j - m_new[:, :, None])                   # (b,h,c)
        kw = ki.transpose(1, 2) * scale * wj[..., None]           # (b,h,c,hd)
        decay = torch.exp(Lc + m - m_new)
        C = decay[..., None, None] * C + kw.transpose(-1, -2) @ vi.transpose(1, 2)
        n = decay[..., None] * n + kw.sum(dim=2)
        m = m_new
    return torch.cat(outs, dim=1).to(q.dtype), (C, n, m)


def _mlstm_apply(q, k, v, logf, logi, *, chunk: int = 1024):
    s = q.shape[1]
    c = chunk if (s > chunk and s % chunk == 0) else s
    return _mlstm_chunked(q, k, v, logf, logi, c)


def _mlstm_qkv(p, cfg: ModelConfig, x):
    dt = x.dtype
    h = cfg.n_heads
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xm = shard_act(xn @ p["w_up"].to(dt), "dp", None, "tp")
    z = shard_act(xn @ p["w_z"].to(dt), "dp", None, "tp")
    xc = F.silu(_conv_causal(xm, p["conv_w"], p["conv_b"]).float()).to(dt)
    b, s, di = xm.shape
    hd = di // h
    # sequence-parallel mLSTM: queries shard over "tp"; k/v stay
    # batch-sharded and are broadcast
    q = shard_act((xc @ p["wq"].to(dt)).reshape(b, s, h, hd), "dp", "tp", None, None)
    k = (xc @ p["wk"].to(dt)).reshape(b, s, h, hd)
    v = (xm @ p["wv"].to(dt)).reshape(b, s, h, hd)
    logi = xc @ p["w_i"].to(dt) + p["b_i"].to(dt)
    logf = F.logsigmoid((xc @ p["w_f"].to(dt) + p["b_f"].to(dt)).float())
    return q, k, v, logi.float(), logf, z


def _mlstm_out(p, cfg: ModelConfig, x, hout, z):
    # each head's output RMS-normed over hd: the reference's _headnorm
    hout = rms_norm(hout, p["gn"], cfg.norm_eps)
    b, s = x.shape[0], x.shape[1]
    flat = shard_act(hout.reshape(b, s, -1) * F.silu(z.float()).to(x.dtype), "dp", None, "tp")
    return shard_act(x + flat @ p["w_down"].to(x.dtype), "dp", None, None)


def mlstm_block(p, cfg: ModelConfig, x):
    q, k, v, logi, logf, z = _mlstm_qkv(p, cfg, x)
    hout, _ = _mlstm_apply(q, k, v, logf, logi)
    return _mlstm_out(p, cfg, x, hout, z)


def mlstm_decode(p, cfg: ModelConfig, state, x_t):
    """x_t: (B,1,d); state: {C (B,H,hd,hd), n (B,H,hd), m (B,H), conv (B,W-1,di)}."""
    dt = x_t.dtype
    h = cfg.n_heads
    xn = rms_norm(x_t[:, 0], p["ln"], cfg.norm_eps)
    xm = xn @ p["w_up"].to(dt)
    z = xn @ p["w_z"].to(dt)
    conv_out, conv_state = _conv_step(xm, state["conv"], p["conv_w"], p["conv_b"])
    xc = F.silu(conv_out.float()).to(dt)
    b, di = xm.shape
    hd = di // h
    q = (xc @ p["wq"].to(dt)).reshape(b, h, hd)
    k = (xc @ p["wk"].to(dt)).reshape(b, h, hd)
    v = (xm @ p["wv"].to(dt)).reshape(b, h, hd)
    logi = (xc @ p["w_i"].to(dt) + p["b_i"].to(dt)).float()
    logf = F.logsigmoid((xc @ p["w_f"].to(dt) + p["b_f"].to(dt)).float())
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, logi)                       # (B,H)
    a = torch.exp(logf + m - m_new)[..., None]
    bgate = torch.exp(logi - m_new)[..., None]
    kf = k.float() * (hd ** -0.5)
    vf = v.float()
    C = a[..., None] * C + bgate[..., None] * (kf[..., :, None] * vf[..., None, :])
    n = a * n + bgate * kf
    qf = q.float()
    num = (qf[..., None, :] @ C)[..., 0, :]                      # (B,H,hd)
    den = torch.maximum((n * qf).sum(-1).abs()[..., None], torch.exp(-m_new)[..., None])
    hout = rms_norm((num / den).to(dt), p["gn"], cfg.norm_eps)
    flat = hout.reshape(b, -1) * F.silu(z.float()).to(dt)
    y = x_t[:, 0] + flat @ p["w_down"].to(dt)
    return {"C": C, "n": n, "m": m_new, "conv": conv_state}, y[:, None]


def mlstm_state(cfg: ModelConfig, b: int, device=None) -> Dict[str, torch.Tensor]:
    di = 2 * cfg.d_model
    h = cfg.n_heads
    hd = di // h
    f32 = torch.float32
    return {
        "C": torch.zeros((b, h, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((b, h, hd), dtype=f32, device=device),
        "m": torch.full((b, h), NEG, dtype=f32, device=device),
        "conv": torch.zeros((b, cfg.conv_width - 1, di), dtype=cfg.cdt, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg: ModelConfig, generator, device) -> nn.ParameterDict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h

    def new(shape, init="dense", **kw):
        return new_param(generator, shape, cfg.pdt, device, init, **kw)

    bias = torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0), torch.zeros(d)])
    return nn.ParameterDict({
        "ln": new((d,), 0.0),
        "w": new((d, 4 * d)),                    # z, i, f, o inputs
        "r": new((h, hd, 4 * hd), scale=0.4),    # recurrent (block-diagonal)
        "b": new((4 * d,), bias),
        "gn": new((h, hd), 0.0),
        "w_down": new((d, d)),
    })


def _slstm_cell(r, carry, pre_x):
    """One step, heads first: ``r`` (H,hd,4hd) float32, ``pre_x``
    (H,B,4hd) the step's input projection plus the bias in float32,
    ``carry`` (h, c, n, m) each (H,B,hd) float32. Returns the new carry
    and the step's gates ``(z, o, decay, gate, lfm, logi, logf)`` for
    the backward. Heads lead so that the block-diagonal recurrence is one
    ``baddbmm`` with no transposes: the time loop runs 2,048 of these a
    layer, and each op costs a launch (so c and n update through
    ``addcmul``, and the bias is added to the whole sequence's projection
    once)."""
    hprev, c, n, m = carry
    pre = torch.baddbmm(pre_x, hprev, r)
    z_pre, i_pre, f_pre, o_pre = pre.chunk(4, dim=-1)
    z = torch.tanh(z_pre)
    logi = i_pre
    logf = F.logsigmoid(f_pre)
    o = torch.sigmoid(o_pre)
    lfm = logf + m
    m_new = torch.maximum(lfm, logi)
    decay = torch.exp(lfm - m_new)
    gate = torch.exp(logi - m_new)
    c = torch.addcmul(decay * c, gate, z)
    n = torch.addcmul(gate, decay, n)
    h_new = o * (c / n.clamp_min(1e-6))
    return (h_new, c, n, m_new), (z, o, decay, gate, lfm, logi, logf)


def _scan_forward(pre_x, r, h, c, n, m, *, keep: bool):
    """The time loop: ``(ys, h, c, n, m)`` and, with ``keep``, the stacked
    per-step ``c, n`` and gates that the backward reads."""
    hs, steps = [], []
    for px in pre_x.unbind(0):
        (h, c, n, m), gates = _slstm_cell(r, (h, c, n, m), px)
        hs.append(h)
        if keep:
            steps.append((c, n) + gates)
    return (torch.stack(hs), h, c, n, m) + tuple(torch.stack(x) for x in zip(*steps))


def _scan_backward(r, h0, c0, n0, ys, cs, ns, zs, o_gates, decays, gates, lfms, logis, logfs,
                   g_ys, g_h, g_c, g_n, g_m):
    """The recurrence of the gradients, last step first: ``(d pre_x, d r)``."""
    nc = ns.clamp_min(1e-6)
    # d(h = o * c / nc): into c, into n (where the clamp passes), into o's pre-activation
    to_c = o_gates / nc
    to_n = -(o_gates * cs / (nc * nc)) * (ns >= 1e-6)
    to_o = (cs / nc) * o_gates * (1 - o_gates)
    to_z = gates * (1 - zs * zs)                       # tanh's
    to_lfm = (lfms > logis).float() + 0.5 * (lfms == logis).float()
    to_logi = 1 - to_lfm                               # maximum's
    to_f = 1 - torch.exp(logfs)                        # logsigmoid's: sigmoid(-f)
    c_prev = torch.cat([c0[None], cs[:-1]])
    n_prev = torch.cat([n0[None], ns[:-1]])
    dh_rec, dc, dn, dm = g_h, g_c, g_n, g_m
    dpre = torch.empty(ys.shape[:-1] + (4 * ys.shape[-1],), dtype=ys.dtype, device=ys.device)
    r_t = r.transpose(1, 2)
    per_step = zip(*(x.unbind(0) for x in (
        g_ys, to_c, to_n, to_o, to_z, c_prev, n_prev, zs, decays, gates, to_lfm, to_logi,
        to_f, dpre)))
    for gy, a_c, a_n, a_o, a_z, cp, np_, z, decay, gate, w_l, w_i, a_f, dp in \
            reversed(list(per_step)):
        dh = gy + dh_rec
        dc = torch.addcmul(dc, dh, a_c)
        dn = torch.addcmul(dn, dh, a_n)
        d_decay = torch.addcmul(dc * cp, dn, np_)
        d_gate = torch.addcmul(dn, dc, z)
        dd = d_decay * decay
        dg = d_gate * gate
        dm = dm - dd - dg
        d_lfm = torch.addcmul(dd, dm, w_l)
        torch.cat([dc * a_z, torch.addcmul(dg, dm, w_i), d_lfm * a_f, dh * a_o], dim=-1, out=dp)
        dh_rec = torch.bmm(dp, r_t)
        dc, dn, dm = dc * decay, dn * decay, d_lfm
    s, h, b, hd = ys.shape
    h_prev = torch.cat([h0[None], ys[:-1]]).permute(1, 3, 0, 2).reshape(h, hd, s * b)
    dr = torch.bmm(h_prev, dpre.permute(1, 0, 2, 3).reshape(h, s * b, 4 * hd))
    return dpre, dr


# CUDA graphs of the training loops, one per loop (by its name): a call
# at other shapes or options replaces the loop's graph, so at most two
# are held, each with its static inputs, outputs and memory pool, until
# release_graphs(). Serving never captures one (see _SLSTMScan.forward)
_GRAPHS: Dict[str, Tuple[tuple, Any, List[torch.Tensor], Tuple[torch.Tensor, ...]]] = {}
_GRAPHS_LOCK = threading.Lock()
_SIDE: Dict[torch.device, Any] = {}   # the warm-ups' stream, one a device


def _run(fn, tensors, **options):
    """``fn(*tensors, **options)``: eagerly off the card; on a CUDA device
    through the loop's CUDA graph, captured when the loop's last graph was
    for other shapes (after one eager warm-up on a side stream, as capture
    requires), its inputs copied into the graph's static buffers and its
    outputs cloned out at each call. The same kernels run, without a host
    launch each. Capture, copies and replay hold one lock, and capture
    only forbids unsafe calls of its own thread, so other threads may use
    the card meanwhile."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return fn(*tensors, **options)
    key = (tuple((tuple(t.shape), t.dtype) for t in tensors), dev,
           tuple(sorted(options.items())))
    with _GRAPHS_LOCK:
        held = _GRAPHS.get(fn.__name__)
        if held is None or held[0] != key:
            _GRAPHS.pop(fn.__name__, None)
            del held    # the old graph's pool goes before the new capture
            inputs = [t.clone() for t in tensors]
            if dev not in _SIDE:
                _SIDE[dev] = torch.cuda.Stream(dev)
            side = _SIDE[dev]
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*inputs, **options)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = fn(*inputs, **options)
            _GRAPHS[fn.__name__] = (key, graph, inputs, outputs)
        _, graph, inputs, outputs = _GRAPHS[fn.__name__]
        for buf, t in zip(inputs, tensors):
            buf.copy_(t)
        graph.replay()
        return tuple(o.clone() for o in outputs)


def release_graphs() -> None:
    """Drop the captured time loops and their memory pools."""
    with _GRAPHS_LOCK:
        _GRAPHS.clear()


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM's time loop with its backward written out:
    ``(pre_x (S,H,B,4hd), r (H,hd,4hd), h0, c0, n0, m0 (H,B,hd)) ->
    (ys (S,H,B,hd), h, c, n, m)``, heads first, float32.

    Forward runs :func:`_slstm_cell` step by step, as the reference's
    scan does, and keeps each step's gates. Backward runs the recurrence
    of the gradients (h through ``r``; the c, n and m carries) step by
    step in 19 kernels, with the per-step coefficients that need no carry
    computed for the whole sequence before the loop and ``r``'s gradient
    one product over all steps after it. ``torch.maximum``'s split of the
    gradient at a tie is kept (a half to each side), as in JAX. On the
    card a forward that keeps its gates for a backward, and the backward,
    replay as CUDA graphs (:func:`_run`): training repeats its shapes. A
    forward with nothing to differentiate runs eagerly and holds nothing,
    and so does every forward with grad mode off (prefill and serving,
    whose prompt lengths vary, in inference mode). Recorded op by
    op by autograd the loop took some 60 kernels and as many graph nodes
    a step, and an sLSTM layer 5.70 s of a train step at xlstm-350m's
    widths on an H100 (the device busy 5 % of it); written out, 1.78 s
    (PERF.md)."""

    @staticmethod
    def forward(ctx, pre_x, r, h, c, n, m):
        keep = any(ctx.needs_input_grad)
        if not keep:
            return _scan_forward(pre_x, r, h, c, n, m, keep=False)
        out = _run(_scan_forward, (pre_x, r, h, c, n, m), keep=True)
        ctx.save_for_backward(r, h, c, n, *out[:1], *out[5:])
        return out[:5]

    @staticmethod
    def backward(ctx, g_ys, g_h, g_c, g_n, g_m):
        saved = ctx.saved_tensors
        ys = saved[4]
        zero = torch.zeros_like(saved[1])
        grads = (torch.zeros_like(ys) if g_ys is None else g_ys,
                 *(zero if g is None else g for g in (g_h, g_c, g_n, g_m)))
        dpre, dr = _run(_scan_backward, saved + grads)
        return dpre, dr, None, None, None, None


def _slstm_operands(p, cfg: ModelConfig):
    h = cfg.n_heads
    hd = cfg.d_model // h
    return p["r"].float(), p["b"].float().reshape(h, 1, 4 * hd)


def _slstm_step(p, cfg: ModelConfig, carry, wx_t):
    """carry: (h, c, n, m) each (B,H,hd); wx_t: (B, 4d) precomputed Wx."""
    r, bias = _slstm_operands(p, cfg)
    b, h, hd = carry[0].shape
    heads_first = tuple(t.float().transpose(0, 1) for t in carry)
    pre_x = wx_t.reshape(b, h, 4 * hd).float().transpose(0, 1) + bias
    new, _ = _slstm_cell(r, heads_first, pre_x)
    out = tuple(t.transpose(0, 1).contiguous() for t in new)
    return out, out[0]


def _slstm_scan(p, cfg: ModelConfig, x):
    """The time loop of an sLSTM block from the zero state: (ys
    (B,S,H,hd) float32, the final carry (h, c, n, m) each (B,H,hd))."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    wx = shard_act(xn @ p["w"].to(x.dtype), "dp", None, "tp")
    wx = wx.reshape(b, s, h, 4 * hd).float().permute(1, 2, 0, 3)
    r, bias = _slstm_operands(p, cfg)
    st = slstm_state(cfg, b, device=x.device)
    carry = (st[k].transpose(0, 1).contiguous() for k in ("h", "c", "n", "m"))
    args = ((wx + bias).contiguous(), r, *carry)
    if torch.is_grad_enabled():
        ys, *final = _SLSTMScan.apply(*args)
    else:   # no graph: parameters may require grad under inference mode
        ys, *final = _scan_forward(*args, keep=False)
    final = tuple(t.transpose(0, 1).contiguous() for t in final)
    return ys.permute(2, 0, 1, 3), final


def _slstm_out(p, cfg: ModelConfig, x, ys):
    b, s, d = x.shape
    ys = rms_norm(ys.to(x.dtype), p["gn"], cfg.norm_eps)
    return shard_act(x + ys.reshape(b, s, d) @ p["w_down"].to(x.dtype), "dp", None, None)


def slstm_block(p, cfg: ModelConfig, x):
    ys, _ = _slstm_scan(p, cfg, x)
    return _slstm_out(p, cfg, x, ys)


def slstm_decode(p, cfg: ModelConfig, state, x_t):
    xn = rms_norm(x_t[:, 0], p["ln"], cfg.norm_eps)
    wx = xn @ p["w"].to(x_t.dtype)
    carry = (state["h"], state["c"], state["n"], state["m"])
    (h_new, c, n, m), y = _slstm_step(p, cfg, carry, wx)
    b, d = x_t.shape[0], cfg.d_model
    ys = rms_norm(y.to(x_t.dtype), p["gn"], cfg.norm_eps)
    out = x_t[:, 0] + ys.reshape(b, d) @ p["w_down"].to(x_t.dtype)
    return {"h": h_new, "c": c, "n": n, "m": m}, out[:, None]


def slstm_state(cfg: ModelConfig, b: int, device=None) -> Dict[str, torch.Tensor]:
    h = cfg.n_heads
    hd = cfg.d_model // h
    f32 = torch.float32
    return {
        "h": torch.zeros((b, h, hd), dtype=f32, device=device),
        "c": torch.zeros((b, h, hd), dtype=f32, device=device),
        "n": torch.full((b, h, hd), 1e-6, dtype=f32, device=device),
        "m": torch.full((b, h, hd), NEG, dtype=f32, device=device),
    }


# ---------------------------------------------------------------------------
# LM assembly
# ---------------------------------------------------------------------------


_BLOCK_INIT = {"mlstm": init_mlstm, "slstm": init_slstm}


class XLSTM(nn.Module):
    """The xLSTM's parameters: ``embed``, ``final_norm``, ``out`` and one
    ``ParameterDict`` a layer in ``blocks``.

    With a ``generator`` the parameters are initialised as the reference
    initialises them (normal draws from the generator's device, placed on
    ``device``); without one they are left uninitialised, to be loaded.
    """

    def __init__(self, cfg: ModelConfig, *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        blocks = []
        for kind in cfg.layer_kinds():
            if kind not in _BLOCK_INIT:
                raise ValueError(f"xlstm: unknown block kind {kind!r}")
            blocks.append(_BLOCK_INIT[kind](cfg, generator, device))
        self.blocks = nn.ModuleList(blocks)
        v, d = cfg.vocab_size, cfg.d_model
        self.embed = new_param(generator, (v, d), cfg.pdt, device, "embed")
        self.final_norm = new_param(generator, (d,), cfg.pdt, device, 0.0)
        self.out = new_param(generator, (v, d), cfg.pdt, device)

    def state_tree(self) -> Dict[str, Any]:
        """The reference's parameter tree; its leaves are this module's
        own parameters (not copies)."""
        return {
            "embed": self.embed,
            "final_norm": self.final_norm,
            "out": self.out,
            "blocks": [dict(b.items()) for b in self.blocks],
        }

    def forward(self, tokens: torch.Tensor, *, remat: bool = False):
        return forward(self.state_tree(), self.cfg, tokens, remat=remat)


def _blocks(cfg: ModelConfig, params):
    return zip(cfg.layer_kinds(), params["blocks"])


def forward(params, cfg: ModelConfig, tokens, *, remat: bool = True, **_):
    """-> (logits (B, S, V), a zero aux loss () float32)."""
    x = shard_act(params["embed"].to(cfg.cdt)[tokens.long()], "dp", None, None)
    for kind, p in _blocks(cfg, params):
        fn = mlstm_block if kind == "mlstm" else slstm_block
        if remat:
            x = checkpoint(lambda h, fn=fn, p=p: fn(p, cfg, h), x, use_reentrant=False)
        else:
            x = fn(p, cfg, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = shard_act(x @ params["out"].to(cfg.cdt).T, "dp", None, "tp")
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def lm_loss(params, cfg: ModelConfig, tokens, *, remat: bool = True, **_):
    logits, aux = forward(params, cfg, tokens, remat=remat)
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
    return ce, {"ce": ce, "aux": aux}


def init_state(params, cfg: ModelConfig, b: int, s_max: int = 0, *, device=None):
    """Recurrent decode state (the 'cache'): O(1) in sequence length.

    Shapes depend only on cfg; it lives on the device of ``params``'
    embedding, or on ``device`` when ``params`` is None (``"meta"``
    gives the structure without memory)."""
    del s_max
    dev = params["embed"].device if params is not None else device
    states = [mlstm_state(cfg, b, dev) if kind == "mlstm" else slstm_state(cfg, b, dev)
              for kind in cfg.layer_kinds()]
    return {"layers": states, "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(params, cfg: ModelConfig, state, tokens):
    """tokens: (B, 1) -> (logits (B, V), the next state); ``state`` is
    left unchanged."""
    x = params["embed"].to(cfg.cdt)[tokens.long()]               # (B,1,d)
    new_states = []
    for (kind, p), st in zip(_blocks(cfg, params), state["layers"]):
        fn = mlstm_decode if kind == "mlstm" else slstm_decode
        st2, x = fn(p, cfg, st, x)
        new_states.append(st2)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, 0] @ params["out"].to(cfg.cdt).T
    return logits, {"layers": new_states, "pos": state["pos"] + 1}


def mlstm_block_with_state(p, cfg: ModelConfig, x):
    """Chunkwise mLSTM forward whose carried (C, n, m) after the last
    chunk IS the decode state: no token loop, O(S*c) memory."""
    q, k, v, logi, logf, z = _mlstm_qkv(p, cfg, x)
    hout, (C, n, m) = _mlstm_apply(q, k, v, logf, logi)
    out = _mlstm_out(p, cfg, x, hout, z)
    s = x.shape[1]
    xm = rms_norm(x, p["ln"], cfg.norm_eps) @ p["w_up"].to(x.dtype)
    wlen = cfg.conv_width - 1
    tail = xm[:, max(0, s - wlen):]
    if tail.shape[1] < wlen:
        tail = F.pad(tail, (0, 0, wlen - tail.shape[1], 0))
    return out, {"C": C, "n": n, "m": m, "conv": tail.to(cfg.cdt).contiguous()}


def slstm_block_with_state(p, cfg: ModelConfig, x):
    """Time-looped sLSTM forward returning the final carry."""
    ys, (hf, cf, nf, mf) = _slstm_scan(p, cfg, x)
    return _slstm_out(p, cfg, x, ys), {"h": hf, "c": cf, "n": nf, "m": mf}


def prefill(params, cfg: ModelConfig, tokens, *, s_max: Optional[int] = None, **_):
    """Parallel prefill: the forward pass with the closed-form final
    recurrent state of each mLSTM and the time loop's final carry of
    each sLSTM -> (state, logits of the last token (B, V))."""
    x = shard_act(params["embed"].to(cfg.cdt)[tokens.long()], "dp", None, None)
    states: List[Dict[str, torch.Tensor]] = []
    for kind, p in _blocks(cfg, params):
        fn = mlstm_block_with_state if kind == "mlstm" else slstm_block_with_state
        x, st = fn(p, cfg, x)
        states.append(st)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, -1] @ params["out"].to(cfg.cdt).T
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    return {"layers": states, "pos": pos}, logits
