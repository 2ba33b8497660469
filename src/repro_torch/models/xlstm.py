"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory with a hidden-state recurrence), xlstm-1.3b's mixers.  Port of
``repro/models/xlstm.py``, which is plain XLA: no Pallas kernel here.

mLSTM: the max-stabiliser ``m_t = max(m_{t-1} + log_f_t, log_i_t)`` is a
max-plus scan, run in the log-step (Hillis-Steele) form of the reference's
associative combine; the matrix recurrence runs chunk by chunk (chunks of
``min(chunk, s)`` steps, the last padded with identity steps), the state
(C [b, H, dh, dh], n [b, H, dh]) carried from one chunk to the next in
float32.  The contractions take q/k/v in the compute dtype, rounded as the
reference rounds them, and accumulate in float32 (the reference's
``preferred_element_type``).  sLSTM: its gates read h_{t-1}, so it is a
loop over time of elementwise ops and one per-head product, with no host
synchronisation inside.  ``w_if``, ``b_if``, ``outnorm`` (mLSTM) and ``b``,
``r``, ``gnorm`` (sLSTM) are float32 whatever the parameter dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, Norm, _frozen, truncated_normal

NEG = -1e30


def _dims(cfg):
    """(H, dx, dh) of an mLSTM block."""
    dx = int(cfg.xlstm_proj_factor * cfg.d_model)
    return cfg.n_heads, dx, dx // cfg.n_heads


# ===========================================================================
# mLSTM
# ===========================================================================
class MLSTM(nn.Module):
    """``up`` [D, 2 dx], ``conv_w`` [4, dx], ``conv_b`` [dx], ``wq``/``wk``
    [dx, dx], ``wv``/``w_o`` [D, dx], float32 ``w_if`` [dx, 2H] and
    ``b_if`` [2H], the float32 RMSNorm ``outnorm`` [dx], ``down`` [dx, D]."""

    def __init__(self, up: Dense, conv_w, conv_b, wq: Dense, wk: Dense, wv: Dense,
                 w_if, b_if, w_o: Dense, outnorm: Norm, down: Dense):
        super().__init__()
        self.up, self.wq, self.wk, self.wv, self.w_o, self.down = up, wq, wk, wv, w_o, down
        self.conv_w, self.conv_b, self.w_if, self.b_if = map(
            _frozen, (conv_w, conv_b, w_if, b_if))
        self.outnorm = outnorm

    @classmethod
    def init(cls, cfg, dtype, *, generator, device=None):
        D = cfg.d_model
        H, dx, _ = _dims(cfg)
        kw = dict(generator=generator, device=device)
        dev = generator.device if device is None else device
        f32 = torch.float32
        b_if = torch.cat([torch.zeros((H,), dtype=f32, device=dev),
                          torch.full((H,), 3.0, dtype=f32, device=dev)])
        return cls(Dense.init(D, 2 * dx, dtype, **kw),
                   truncated_normal((4, dx), 0.5, dtype, **kw),
                   torch.zeros((dx,), dtype=dtype, device=dev),
                   Dense.init(dx, dx, dtype, **kw), Dense.init(dx, dx, dtype, **kw),
                   Dense.init(D, dx, dtype, **kw),
                   truncated_normal((dx, 2 * H), dx ** -0.5, f32, **kw), b_if,
                   Dense.init(D, dx, dtype, **kw),
                   Norm.init(dx, "rmsnorm", 1e-5, f32, dev),
                   Dense.init(dx, D, dtype, **kw))


def _mlstm_gates(p: MLSTM, xc, H: int):
    """xc: [b, s, dx] -> (log_f, log_i) each [b, s, H] float32."""
    g = xc.float() @ p.w_if + p.b_if
    log_i, f_pre = g.split(H, dim=-1)
    return F.logsigmoid(f_pre), log_i


def _stabiliser(log_f, log_i, m0):
    """m_t = max(m_{t-1} + log_f_t, log_i_t) from m_{-1} = m0, for every t.
    log_f/log_i: [b, s, H]; m0: [b, H] -> m [b, s, H].  The reference's
    combine ``(a1 + a2, max(b1 + a2, b2))`` in log2(s) passes: pass d
    combines each step with the one d before it."""
    A, B = log_f.clone(), log_i.clone()
    s, d = A.shape[1], 1
    while d < s:
        B[:, d:] = torch.maximum(B[:, :-d] + A[:, d:], B[:, d:])
        A[:, d:] = A[:, :-d] + A[:, d:]
        d *= 2
    return torch.maximum(m0[:, None] + A, B)


def mlstm_cell(q, k, v, log_f, log_i, state, *, chunk: int = 256):
    """Chunkwise-parallel mLSTM cell.

    q, k, v: [b, H, s, dh]; log_f, log_i: [b, s, H]; state: (C [b, H, dh, dh],
    n [b, H, dh], m [b, H]).  Returns (h [b, H, s, dh] float32, new state)."""
    b, H, s, dh = q.shape
    C, n, m0 = state
    wire = q.dtype
    qf = q * torch.tensor(dh ** -0.5, dtype=wire)

    m = _stabiliser(log_f, log_i, m0)                              # [b, s, H]
    m_prev = torch.cat([m0[:, None], m[:, :-1]], dim=1)
    log_fp = log_f + m_prev - m                                     # <= 0
    log_ip = log_i - m

    L = min(chunk, s)
    n_chunks = -(-s // L)
    sp = n_chunks * L
    kf, vf = k, v
    if sp != s:
        # identity steps: log_f' = 0, log_i' = NEG, m held at its last value
        pad = sp - s
        log_fp = F.pad(log_fp, (0, 0, 0, pad))
        log_ip = F.pad(log_ip, (0, 0, 0, pad), value=NEG)
        m = torch.cat([m, m[:, -1:].expand(b, pad, H)], dim=1)
        qf, kf, vf = (F.pad(a, (0, 0, 0, pad)) for a in (qf, kf, vf))

    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(n_chunks):
        t = slice(c * L, (c + 1) * L)
        lf, li, mm = (a[:, t].transpose(1, 2) for a in (log_fp, log_ip, m))  # [b,H,L]
        qq, kk, vv = (a[:, :, t] for a in (qf, kf, vf))                        # [b,H,L,dh]
        q32, k32, v32 = qq.float(), kk.float(), vv.float()
        G = lf.cumsum(-1)                                          # [b,H,L]
        eG = G.exp()
        # inter-chunk: exp(G_t) * (q_t @ C_in)
        inter = (q32 @ C.to(wire).float()) * eG[..., None]
        n_inter = (q32 @ n.to(wire).float()[..., None])[..., 0] * eG
        # intra-chunk: decay(tau -> t) = exp(G_t - G_tau + li_tau), tau <= t
        dec = G[..., :, None] - G[..., None, :] + li[..., None, :]
        w = torch.where(causal, dec, NEG).exp()                    # [b,H,L,L]
        scores = (q32 @ k32.transpose(-1, -2)) * w
        intra = scores @ v32
        n_intra = w @ k32                                          # [b,H,L,dh]
        n_t = (q32 * n_intra.to(wire).float()).sum(-1) + n_inter
        denom = torch.maximum(n_t.abs(), (-mm).exp())[..., None]
        hs.append((inter + intra) / denom)
        # the chunk's final state
        gl = G[..., -1]
        wC = (gl[..., None] - G + li).exp()                        # [b,H,L]
        kw = k32 * wC[..., None]
        C = C * gl.exp()[..., None, None] + kw.transpose(-1, -2) @ v32
        n = n * gl.exp()[..., None] + kw.sum(-2)
    h = torch.cat(hs, dim=2)[:, :, :s]
    return h, (C, n, m[:, s - 1])


def _conv_silu(p: MLSTM, xm, s: int, dtype):
    """Causal depthwise conv(4) + silu along s (the reference's sum of
    shifted slices)."""
    pad = F.pad(xm, (0, 0, 3, 0))
    xc = sum(pad[:, i:i + s] * p.conv_w[i].to(dtype) for i in range(4)) \
        + p.conv_b.to(dtype)
    return F.silu(xc)


def _mlstm_out(p: MLSTM, h, x, z):
    """Output gate, outnorm, the z gate and the down projection.  h: [b, s,
    dx] float32."""
    o = torch.sigmoid(p.w_o(x).float())
    h = p.outnorm(h.float())
    return p.down((h * o).to(x.dtype) * F.silu(z))


def mlstm_apply(p: MLSTM, cfg, x, *, chunk: int = 256):
    """Full mLSTM block.  x: [b, s, D] -> [b, s, D]."""
    b, s, _ = x.shape
    H, dx, dh = _dims(cfg)
    xm, z = p.up(x).chunk(2, dim=-1)                               # [b, s, dx]
    xc = _conv_silu(p, xm, s, x.dtype)
    heads = lambda a: a.reshape(b, s, H, dh).transpose(1, 2)
    q, k, v = heads(p.wq(xc)), heads(p.wk(xc)), heads(p.wv(x))
    log_f, log_i = _mlstm_gates(p, xc, H)
    state = mlstm_init_cache(cfg, b, x.dtype, x.device)
    h, _ = mlstm_cell(q, k, v, log_f, log_i, (state["C"], state["n"], state["m"]),
                      chunk=chunk)
    return _mlstm_out(p, h.transpose(1, 2).reshape(b, s, dx), x, z)


def mlstm_init_cache(cfg, batch: int, dtype, device) -> dict:
    H, dx, dh = _dims(cfg)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, 3, dx), dtype=dtype, device=device),
            "C": zeros(batch, H, dh, dh), "n": zeros(batch, H, dh), "m": zeros(batch, H)}


def mlstm_decode(p: MLSTM, cfg, x1, cache: dict):
    """x1: [b, 1, D] -> (y1, new cache); the one-step recurrence."""
    b = x1.shape[0]
    H, dx, dh = _dims(cfg)
    xm, z = p.up(x1).chunk(2, dim=-1)                              # [b, 1, dx]
    window = torch.cat([cache["conv"], xm], dim=1)                 # [b, 4, dx]
    xc = F.silu((window * p.conv_w.to(x1.dtype)[None]).sum(1, keepdim=True)
                + p.conv_b.to(x1.dtype))
    q = p.wq(xc).reshape(b, H, dh) * dh ** -0.5
    k = p.wk(xc).reshape(b, H, dh)
    v = p.wv(x1[:, 0]).reshape(b, H, dh)
    log_f, log_i = (a[:, 0] for a in _mlstm_gates(p, xc, H))       # [b, H]
    m_new = torch.maximum(cache["m"] + log_f, log_i)
    fp = (log_f + cache["m"] - m_new).exp()[..., None]
    ip = (log_i - m_new).exp()[..., None]
    kf, vf, qf = k.float(), v.float(), q.float()
    C = cache["C"] * fp[..., None] + ip[..., None] * kf[..., :, None] * vf[..., None, :]
    n = cache["n"] * fp + ip * kf
    num = (qf[..., None, :] @ C)[..., 0, :]                        # [b, H, dh]
    den = torch.maximum((qf * n).sum(-1).abs(), (-m_new).exp())[..., None]
    y = _mlstm_out(p, (num / den).reshape(b, 1, dx), x1, z)
    return y, {"conv": window[:, 1:], "C": C, "n": n, "m": m_new}


# ===========================================================================
# sLSTM
# ===========================================================================
def _f_up(D: int) -> int:
    return -(-int(4 * D / 3) // 128) * 128          # 2816 at D = 2048


class SLSTM(nn.Module):
    """``w`` [D, 4D], float32 ``b`` [4D] and per-head recurrence ``r`` [H,
    dh, 4 dh], the float32 RMSNorm ``gnorm`` [D], the gated GELU FFN
    ``up`` [D, 2 f_up] and ``down`` [f_up, D]."""

    def __init__(self, w, b, r, gnorm: Norm, up: Dense, down: Dense):
        super().__init__()
        self.w, self.b, self.r = map(_frozen, (w, b, r))
        self.gnorm, self.up, self.down = gnorm, up, down

    @classmethod
    def init(cls, cfg, dtype, *, generator, device=None):
        D, H = cfg.d_model, cfg.n_heads
        dh, f_up = D // H, _f_up(D)
        kw = dict(generator=generator, device=device)
        dev = generator.device if device is None else device
        f32 = torch.float32
        b = torch.zeros((4 * D,), dtype=f32, device=dev)
        b[2 * D:3 * D] = 3.0                          # the forget gate's bias
        return cls(truncated_normal((D, 4 * D), D ** -0.5, dtype, **kw), b,
                   truncated_normal((H, dh, 4 * dh), dh ** -0.5, f32, **kw),
                   Norm.init(D, "rmsnorm", 1e-5, f32, dev),
                   Dense.init(D, 2 * f_up, dtype, **kw), Dense.init(f_up, D, dtype, **kw))


def _slstm_scan(p: SLSTM, cfg, wx, state):
    """wx: [b, s, 4D] input projections; state: (c, n, h, m) each [b, D]
    float32.  Returns (h_seq [b, s, D], new state), one step at a time.
    ``rh`` is the per-head product reshaped head-major to [b, 4D], then
    split into z, i, f, o as four contiguous D-wide slices."""
    b, s, _ = wx.shape
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    c, n, h, m = state
    wx = wx.float()
    hs = []
    for t in range(s):
        # one [b, dh] x [dh, 4 dh] product per head (a broadcast matmul
        # would copy r b times a step)
        rh = torch.bmm(h.view(b, H, dh).transpose(0, 1), p.r).transpose(0, 1)
        z_pre, i_pre, f_pre, o_pre = (wx[:, t] + rh.reshape(b, 4 * D) + p.b).split(D, dim=-1)
        lfm = F.logsigmoid(f_pre) + m
        m_new = torch.maximum(lfm, i_pre)
        ip = (i_pre - m_new).exp()
        fp = (lfm - m_new).exp()
        c = torch.addcmul(fp * c, ip, torch.tanh(z_pre))
        n = torch.addcmul(ip, fp, n)
        h = torch.sigmoid(o_pre) * (c / n.clamp_min(1e-6))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def _slstm_out(p: SLSTM, h, dtype):
    h = p.gnorm(h).to(dtype)
    a, g = p.up(h).chunk(2, dim=-1)
    return p.down(F.gelu(a, approximate="tanh") * g)


def slstm_apply(p: SLSTM, cfg, x):
    b, _, D = x.shape
    wx = x @ p.w.to(x.dtype)
    state = tuple(torch.zeros((b, D), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    h, _ = _slstm_scan(p, cfg, wx, state)
    return _slstm_out(p, h, x.dtype)


def slstm_init_cache(cfg, batch: int, dtype, device) -> dict:
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
            for k in "cnhm"}


def slstm_decode(p: SLSTM, cfg, x1, cache: dict):
    wx = x1 @ p.w.to(x1.dtype)
    h, (c, n, hh, m) = _slstm_scan(p, cfg, wx, tuple(cache[k] for k in "cnhm"))
    return _slstm_out(p, h, x1.dtype), {"c": c, "n": n, "h": hh, "m": m}
