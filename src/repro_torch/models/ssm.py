"""Mamba2 (state-space duality) block: chunked train / prefill and the
one-token recurrent decode (the JAX package's ``models/ssm.py``).

Chunked SSD: within a chunk of Q positions the output is a masked quadratic
("attention-like") term; across chunks a recurrent state [B, H, P, N] is
carried by a Python loop over the chunks (the JAX package's ``lax.scan``).
Decode is one recurrent state update.  Group count 1.

The JAX package writes the SSD as einsums, one of them over four operands;
here each is written as its elementwise products and one batched
``torch.matmul`` (both operands carrying the batch and chunk axes, so none
lowers to ``aten.mm`` and the ``"dots"`` remat policy recomputes them, as
``dots_with_no_batch_dims_saveable`` does).  The contraction order is fixed
by hand: ``torch.einsum`` picks its path with ``opt_einsum`` where that
package is installed and left to right where it is not, and one order of
the four-operand term materialises [B, C, Q, Q, H, P].

Parameters stay in ``cfg.param_dtype`` and are cast to the compute dtype at
each use; the SSM state is fp32, the conv tail in the compute dtype, and
the rounding points are the JAX package's (``_gated_norm`` multiplies in the
compute dtype, then normalises in fp32; ``dt`` is the projection cast to
fp32 plus ``dt_bias``, through a softplus equal to ``jax.nn.softplus``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ann
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _init

NEG = -1e30


def init_ssm(cfg: ModelConfig, gen: torch.Generator, device):
    """Random parameters with the JAX package's scales and constants
    (``A_log = log(linspace(1, 16, H))``, ``D = 1``, ``dt_bias = -4.6``,
    ``norm_w = 1``, conv biases 0), in the split projection layout
    (``w_x`` / ``w_B`` / ``w_C`` with ``conv_w_x``, ``conv_w_bc``) when
    ``cfg.ssm_split_proj``, else the fused ``w_xbc`` / ``conv_w``."""
    D, di = cfg.d_model, cfg.d_inner
    N, H, W = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    gN = cfg.ssm_groups * N
    xbc = di + 2 * gN
    s = 1.0 / math.sqrt(D)
    pd = cfg.pdtype()
    a_init = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                      device=device))
    p = {
        "w_z": ann(_init(gen, (D, di), s, pd, device), None, "ff"),
        "w_dt": ann(_init(gen, (D, H), s, pd, device), None, "heads"),
        "A_log": ann(a_init.to(pd), "heads"),
        "D": ann(torch.ones((H,), dtype=pd, device=device), "heads"),
        "dt_bias": ann(torch.full((H,), -4.6, dtype=pd, device=device),
                       "heads"),
        "norm_w": ann(torch.ones((di,), dtype=pd, device=device), "ff"),
        "w_out": ann(_init(gen, (di, D), 1.0 / math.sqrt(di), pd, device),
                     "ff", None),
    }
    if cfg.ssm_split_proj:
        p.update({
            "w_x": ann(_init(gen, (D, di), s, pd, device), None, "ff"),
            "w_B": ann(_init(gen, (D, gN), s, pd, device), None, None),
            "w_C": ann(_init(gen, (D, gN), s, pd, device), None, None),
            "conv_w_x": ann(_init(gen, (W, di), 0.5, pd, device), None,
                            "ff"),
            "conv_b_x": ann(torch.zeros((di,), dtype=pd, device=device),
                            "ff"),
            "conv_w_bc": ann(_init(gen, (W, 2 * gN), 0.5, pd, device), None,
                             None),
            "conv_b_bc": ann(torch.zeros((2 * gN,), dtype=pd,
                                         device=device), None),
        })
    else:
        p.update({
            "w_xbc": ann(_init(gen, (D, xbc), s, pd, device), None, "ff"),
            "conv_w": ann(_init(gen, (W, xbc), 0.5, pd, device), None, "ff"),
            "conv_b": ann(torch.zeros((xbc,), dtype=pd, device=device),
                          "ff"),
        })
    return p


def _softplus(x):
    """``log(1 + exp(x))`` for every x, as ``jax.nn.softplus``
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv. xbc [B,S,C]; w [W,C]; conv_state [B,W-1,C]
    (the last W - 1 inputs before xbc; zeros when ``None``) -> (silu(y),
    the new conv state [B,W-1,C] in xbc's dtype)."""
    W, S = w.shape[0], xbc.shape[1]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                 # [B, S+W-1, C]
    ff, wf = full.float(), w.float()
    y = sum(ff[:, i:i + S, :] * wf[i] for i in range(W))
    return F.silu(y + b.float()).to(xbc.dtype), full[:, -(W - 1):, :]


def _split_xbc(xbc, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    B, S = xbc.shape[:2]
    x = xbc[..., :di].reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
    return x, xbc[..., di:di + N], xbc[..., di + N:di + 2 * N]


def _gated_norm(y, z, w, eps):
    g = (y * F.silu(z)).float()
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * w.float()).to(y.dtype)


def _project_xbc(p, h, cfg: ModelConfig, c, conv_state=None):
    """-> (x [B,S,H,P], Bm, Cm [B,S,gN], new conv state [B,W-1,xbc]).

    Split layout: three projections and a depthwise conv on each part (its
    channels are those of the fused conv, so the math is the same).  Fused
    layout: one projection, the conv, then channel slices."""
    if "w_x" in p:
        gN, di = cfg.ssm_groups * cfg.ssm_state, cfg.d_inner
        x = h @ p["w_x"].to(c)
        bc = torch.cat([h @ p["w_B"].to(c), h @ p["w_C"].to(c)], dim=-1)
        st_x = st_bc = None
        if conv_state is not None:
            st_x, st_bc = conv_state[..., :di], conv_state[..., di:]
        x, st_x = _causal_conv(x, p["conv_w_x"].to(c), p["conv_b_x"].to(c),
                               st_x)
        bc, st_bc = _causal_conv(bc, p["conv_w_bc"].to(c),
                                 p["conv_b_bc"].to(c), st_bc)
        B, S = x.shape[:2]
        x = x.reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
        return (x, bc[..., :gN], bc[..., gN:],
                torch.cat([st_x, st_bc], dim=-1))
    xbc = h @ p["w_xbc"].to(c)
    xbc, new_state = _causal_conv(xbc, p["conv_w"].to(c), p["conv_b"].to(c),
                                  conv_state)
    x, Bm, Cm = _split_xbc(xbc, cfg)
    return x, Bm, Cm, new_state


def _dt(p, h, c):
    """softplus(h @ w_dt in the compute dtype, then fp32, + dt_bias)."""
    return _softplus((h @ p["w_dt"].to(c)).float() + p["dt_bias"].float())


def ssm_forward(p, h, cfg: ModelConfig, *, initial_state=None,
                return_state=False):
    """h [B,S,D] -> y [B,S,D] (and, with ``return_state``, the fp32 SSM
    state [B,H,P,N] after the last position and the conv tail [B,W-1,xbc]
    in the compute dtype).  ``initial_state``: the SSM state before the
    first position (zeros when ``None``).  S must be a multiple of
    ``min(cfg.ssm_chunk, S)``, as in the JAX package (no padding)."""
    c = cfg.cdtype()
    B, S, _ = h.shape
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"S {S} is not a multiple of the SSD chunk {Q}")
    nC = S // Q
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    z = h @ p["w_z"].to(c)
    x, Bm, Cm, conv_state = _project_xbc(p, h, cfg, c)
    dt = _dt(p, h, c)                                           # [B,S,H]
    A = -torch.exp(p["A_log"].float())                          # [H] < 0
    a = dt * A                                                  # <= 0

    xc = x.reshape(B, nC, Q, H, P).float()
    Bc = Bm.reshape(B, nC, Q, N).float()
    Cc = Cm.reshape(B, nC, Q, N).float()
    ac = a.reshape(B, nC, Q, H)
    dtc = dt.reshape(B, nC, Q, H)
    if initial_state is None:
        state = torch.zeros((B, H, P, N), dtype=torch.float32,
                            device=h.device)
    else:
        state = initial_state.float()

    idx = torch.arange(Q, device=h.device)
    causal = idx[:, None] >= idx[None, :]
    cum = torch.cumsum(ac, dim=2)                               # [B,C,Q,H]
    ci = cum.transpose(2, 3)                                    # [B,C,H,Q]
    # intra-chunk quadratic term, batched over the chunks: mask before exp
    # (the upper triangle's differences are large and positive)
    dec = torch.exp(torch.where(causal, ci[..., :, None] - ci[..., None, :],
                                NEG))                           # [B,C,H,Q,K]
    cb = Cc @ Bc.transpose(2, 3)                                # [B,C,Q,K]
    w = dec * cb[:, :, None] * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = (w @ xc.transpose(2, 3)).transpose(2, 3)          # [B,C,Q,H,P]
    # per-chunk input states and decays, batched over the chunks
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # [B,C,Q,H]
    u = (dtc * decay_to_end)[..., None] * xc                    # [B,C,K,H,P]
    s_chunk = (u.reshape(B, nC, Q, H * P).transpose(2, 3) @ Bc) \
        .reshape(B, nC, H, P, N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [B,C,H]

    # sequential part: state_in[c+1] = chunk_decay[c] * state_in[c]
    # + s_chunk[c], each chunk reading the state it comes in with
    states_in = []
    for k in range(nC):
        states_in.append(state)
        state = chunk_decay[:, k, :, None, None] * state + s_chunk[:, k]
    states_in = torch.stack(states_in, dim=1)                   # [B,C,H,P,N]

    # inter-chunk readout, batched over the chunks
    y_inter = (states_in.reshape(B, nC, H * P, N) @ Cc.transpose(2, 3)) \
        .reshape(B, nC, H, P, Q).permute(0, 1, 4, 2, 3)         # [B,C,Q,H,P]
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + p["D"].float()[None, None, :, None] * x.float()
    y = y.to(c).reshape(B, S, H * P)
    y = _gated_norm(y, z, p["norm_w"], cfg.rms_eps)
    out = y @ p["w_out"].to(c)
    if return_state:
        return out, (state, conv_state.to(c))
    return out


def ssm_decode(p, h, cfg: ModelConfig, ssm_state, conv_state):
    """One-token recurrent step. h [B,1,D]; ssm_state [B,H,P,N] fp32;
    conv_state [B,W-1,xbc] -> (y [B,1,D], (new fp32 state, new conv state
    in the compute dtype)).  The caller writes them into its cache."""
    c = cfg.cdtype()
    B = h.shape[0]
    z = h @ p["w_z"].to(c)
    x, Bm, Cm, conv_state = _project_xbc(p, h, cfg, c, conv_state)
    dt = _dt(p, h, c)[:, 0]                                     # [B,H]
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)                                   # [B,H]
    xs = x[:, 0].float()                                        # [B,H,P]
    Bs = Bm[:, 0].float()                                       # [B,N]
    Cs = Cm[:, 0].float()
    new_state = (decay[:, :, None, None] * ssm_state
                 + (dt[:, :, None] * xs)[..., None] * Bs[:, None, None, :])
    y = (new_state @ Cs[:, None, :, None])[..., 0]              # [B,H,P]
    y = y + p["D"].float()[None, :, None] * xs
    y = y.to(c).reshape(B, 1, -1)
    y = _gated_norm(y, z, p["norm_w"], cfg.rms_eps)
    out = y @ p["w_out"].to(c)
    return out, (new_state, conv_state.to(c))
