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

On a {data, model} mesh (``tp``, dist/tp.py) the rule table splits d_x
(mLSTM) and the gates and the FFN's hidden dim (sLSTM) over 'model'.  The
fused up-projections (mLSTM's ``up`` [D, 2 dx], sLSTM's ``up`` [D, 2
f_up]) are column-parallel over the concatenation, so their local products
are regrouped into this rank's slices of both halves by one all-to-all,
as Mamba's ``in_proj`` is (models/ssm.py says why not the weight).
mLSTM: ``wq``/``wk`` read the whole post-conv activation (all-gathered)
and, with ``wv`` and ``w_o``, give this rank's columns; ``w_if`` is row-
parallel, its gate pre-activations summed over 'model' before the
stabiliser; ``outnorm`` takes its mean square over the ranks.  Where the
model axis divides the heads a rank's columns are whole heads; where a
head spans ranks (more ranks than heads) the head's q/k/v columns are
gathered and its ranks each run the head's cell whole, keeping their own
columns of h.  The decode cache's state C [b, H, dh, dh] is split by the
table along its first dh (its largest dim), not by head: ``mlstm_decode``
regroups there.  sLSTM: ``w`` is column-parallel and the recurrence ``r``
replicated, so the gate pre-activations are gathered once, before the
loop, which every rank then runs whole with no collective inside it;
its state cache (split along D) is gathered for the step and cut back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.tp import ONE
from repro_torch.models.layers import Dense, Norm, _frozen, dense, dense_col, norm, truncated_normal

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


def _mlstm_gates(p: MLSTM, xc, H: int, tp=ONE, sharded: bool = False):
    """xc: [b, s, dx] (this rank's columns on a mesh: ``w_if`` is row-
    parallel, its product summed over 'model' before the bias) -> (log_f,
    log_i) each [b, s, H] float32, every head."""
    g = tp.psum(xc.float() @ p.w_if, sharded) + tp.rep(p.b_if, sharded)
    log_i, f_pre = g.split(H, dim=-1)
    return F.logsigmoid(f_pre), log_i


def _stabiliser(log_f, log_i, m0):
    """m_t = max(m_{t-1} + log_f_t, log_i_t) from m_{-1} = m0, for every t.
    log_f/log_i: [b, s, H]; m0: [b, H] -> m [b, s, H].  The reference's
    combine ``(a1 + a2, max(b1 + a2, b2))`` in log2(s) passes: pass d
    combines each step with the one d before it."""
    A, B = log_f, log_i
    s, d = A.shape[1], 1
    while d < s:                # new tensors each pass: autograd keeps what it read
        B = torch.cat([B[:, :d], torch.maximum(B[:, :-d] + A[:, d:], B[:, d:])], dim=1)
        A = torch.cat([A[:, :d], A[:, :-d] + A[:, d:]], dim=1)
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


def _split_norm(n: Norm, x, tp, sharded: bool):
    """The RMSNorm ``n`` over a last dim that may be split over 'model'
    (``outnorm`` over d_x): the mean square from the sum over the ranks."""
    if not sharded:
        return norm(n, x, tp)
    xf = x.float()
    ms = tp.psum((xf * xf).sum(-1, keepdim=True), sharded) / (x.shape[-1] * tp.r.tp)
    y = xf * torch.rsqrt(ms + n.eps) * tp.cols(n.scale, x.shape[-1], sharded).float()
    return y.to(x.dtype)


def _mlstm_out(p: MLSTM, h, x, z, tp=ONE, sharded: bool = False):
    """Output gate, outnorm, the z gate and the down projection.  h: [b, s,
    dx] float32 (this rank's columns on a mesh; ``down`` row-parallel)."""
    o = torch.sigmoid(dense_col(p.w_o, x, tp, sharded).float())
    h = _split_norm(p.outnorm, h.float(), tp, sharded)
    y = tp.leave(dense(p.down.w, None, (h * o).to(x.dtype) * F.silu(z)), sharded)
    b = tp.rep(p.down.b, False)
    return y if b is None else y + b.to(y.dtype)


def _head_cover(c0: int, width: int, dh: int) -> tuple[int, int]:
    """The heads [h0, h1) that columns [c0, c0 + width) of d_x touch."""
    return c0 // dh, -(-(c0 + width) // dh)


def mlstm_apply(p: MLSTM, cfg, x, *, chunk: int = 256, tp=None):
    """Full mLSTM block.  x: [b, s, D] -> [b, s, D].  On a mesh (``tp``)
    each rank holds a contiguous slice of d_x: ``up`` regrouped into its
    slices of x_m and z (``TP.halves``), the convolution on its channels,
    ``wq``/``wk`` on the whole post-conv activation (all-gathered) and
    ``wv``/``w_o`` column-parallel, the gates all-reduced (``w_if`` row-
    parallel); the cell runs on the heads of its columns.  Where a head
    spans ranks (more ranks than heads), its q/k/v columns are all-gathered
    and every rank of the head runs the head's cell whole, keeping its own
    columns of h."""
    tp = tp or ONE
    sh = tp.sharded(p)
    b, s, _ = x.shape
    H, dx, dh = _dims(cfg)
    x = tp.enter(x, sh)
    xm, z = tp.halves(dense_col(p.up, x, tp, sh), sh)              # [b, s, dx]
    xc = _conv_silu(p, xm, s, x.dtype)
    xcw = tp.gather(xc, -1, sh)
    q, k, v = (dense_col(p.wq, xcw, tp, sh), dense_col(p.wk, xcw, tp, sh),
               dense_col(p.wv, x, tp, sh))
    log_f, log_i = _mlstm_gates(p, xc, H, tp, sh)
    dxl = q.shape[-1]
    c0 = tp.lo(dxl, sh)
    h0, h1 = _head_cover(c0, dxl, dh)
    if c0 % dh or dxl % dh:
        q, k, v = (tp.gather(a, -1, sh)[..., h0 * dh:h1 * dh] for a in (q, k, v))
    nh = h1 - h0
    heads = lambda a: a.reshape(b, s, nh, dh).transpose(1, 2)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=x.device)
    state = (zeros(b, nh, dh, dh), zeros(b, nh, dh), zeros(b, nh))
    h, _ = mlstm_cell(heads(q), heads(k), heads(v), log_f[..., h0:h1], log_i[..., h0:h1],
                      state, chunk=chunk)
    h = h.transpose(1, 2).reshape(b, s, nh * dh)[..., c0 - h0 * dh:c0 - h0 * dh + dxl]
    return _mlstm_out(p, h, x, z, tp, sh)


def mlstm_init_cache(cfg, batch: int, dtype, device) -> dict:
    H, dx, dh = _dims(cfg)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, 3, dx), dtype=dtype, device=device),
            "C": zeros(batch, H, dh, dh), "n": zeros(batch, H, dh), "m": zeros(batch, H)}


def mlstm_decode(p: MLSTM, cfg, x1, cache: dict, tp=None):
    """x1: [b, 1, D] -> (y1, new cache); the one-step recurrence.  On a
    mesh the convolution window holds this rank's channels of d_x, as the
    weights do, but the table splits the state C [b, H, dh, dh] along its
    first dh (its largest dim), n along dh and m along H where 'model'
    divides them, which is not the split of the heads that the weights
    imply: the step regroups here, gathering q, k, v and the state whole
    over 'model' (``TP.state_whole``), running every head, and keeping
    this rank's columns of h and its slices of the new state
    (``TP.state_part``)."""
    tp = tp or ONE
    sh = tp.sharded(p)
    b = x1.shape[0]
    H, dx, dh = _dims(cfg)
    x1 = tp.enter(x1, sh)
    xm, z = tp.halves(dense_col(p.up, x1, tp, sh), sh)             # [b, 1, dx]
    window = torch.cat([cache["conv"], xm], dim=1)                 # [b, 4, dx]
    xc = F.silu((window * p.conv_w.to(x1.dtype)[None]).sum(1, keepdim=True)
                + p.conv_b.to(x1.dtype))
    xcw = tp.gather(xc, -1, sh)
    whole = lambda a: tp.gather(a, -1, sh).reshape(b, H, dh)
    q = whole(dense_col(p.wq, xcw, tp, sh)) * dh ** -0.5
    k = whole(dense_col(p.wk, xcw, tp, sh))
    v = whole(dense_col(p.wv, x1[:, 0], tp, sh))
    log_f, log_i = (a[:, 0] for a in _mlstm_gates(p, xc, H, tp, sh))       # [b, H]
    st = tp.state_whole({"C": cache["C"], "n": cache["n"], "m": cache["m"]})
    m_new = torch.maximum(st["m"] + log_f, log_i)
    fp = (log_f + st["m"] - m_new).exp()[..., None]
    ip = (log_i - m_new).exp()[..., None]
    kf, vf, qf = k.float(), v.float(), q.float()
    C = st["C"] * fp[..., None] + ip[..., None] * kf[..., :, None] * vf[..., None, :]
    n = st["n"] * fp + ip * kf
    num = (qf[..., None, :] @ C)[..., 0, :]                        # [b, H, dh]
    den = torch.maximum((qf * n).sum(-1).abs(), (-m_new).exp())[..., None]
    dxl = xm.shape[-1]
    c0 = tp.lo(dxl, sh)
    h = (num / den).reshape(b, 1, dx)[..., c0:c0 + dxl]
    y = _mlstm_out(p, h, x1, z, tp, sh)
    return y, {"conv": window[:, 1:], **tp.state_part({"C": C, "n": n, "m": m_new})}


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
    r, bias = p.r, p.b
    wx = wx.float()
    hs = []
    for t in range(s):
        # one [b, dh] x [dh, 4 dh] product per head (a broadcast matmul
        # would copy r b times a step)
        rh = torch.bmm(h.view(b, H, dh).transpose(0, 1), r).transpose(0, 1)
        z_pre, i_pre, f_pre, o_pre = (wx[:, t] + rh.reshape(b, 4 * D) + bias).split(D, dim=-1)
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


def _slstm_out(p: SLSTM, h, dtype, tp=ONE, sharded: bool = False):
    """gnorm, then the gated GELU FFN: ``up`` column-parallel (regrouped
    into this rank's slices of a and g), ``down`` row-parallel."""
    h = norm(p.gnorm, h).to(dtype)
    a, g = tp.halves(dense_col(p.up, tp.enter(h, sharded), tp, sharded), sharded)
    y = tp.leave(dense(p.down.w, None, F.gelu(a, approximate="tanh") * g), sharded)
    b = tp.rep(p.down.b, False)
    return y if b is None else y + b.to(y.dtype)


def _slstm_wx(p: SLSTM, x, tp, sharded: bool):
    """Every gate's input projection, [b, s, 4D] float32 on every rank: on
    a mesh ``w`` is column-parallel and the pre-activations are gathered
    once, before the loop, which every rank then runs whole (the
    recurrence ``r`` is replicated), so no collective runs inside it."""
    return tp.gather_whole(tp.enter(x, sharded) @ p.w.to(x.dtype), -1, sharded)


def slstm_apply(p: SLSTM, cfg, x, tp=None):
    tp = tp or ONE
    sh = tp.sharded(p)
    b, _, D = x.shape
    wx = _slstm_wx(p, x, tp, sh)
    state = tuple(torch.zeros((b, D), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    h, _ = _slstm_scan(p, cfg, wx, state)
    return _slstm_out(p, h, x.dtype, tp, sh)


def slstm_init_cache(cfg, batch: int, dtype, device) -> dict:
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
            for k in "cnhm"}


def slstm_decode(p: SLSTM, cfg, x1, cache: dict, tp=None):
    """One step; on a mesh the state (split along D by the table) is
    gathered whole for the step and cut back after it."""
    tp = tp or ONE
    sh = tp.sharded(p)
    wx = _slstm_wx(p, x1, tp, sh)
    st = tp.state_whole(cache)
    h, (c, n, hh, m) = _slstm_scan(p, cfg, wx, tuple(st[k] for k in "cnhm"))
    return _slstm_out(p, h, x1.dtype, tp, sh), tp.state_part({"c": c, "n": n, "h": hh, "m": m})
