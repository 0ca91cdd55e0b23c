"""Mamba2 (SSD) block: the chunked selective-state-space scan (PyTorch port).

The counterpart of the JAX package's ``models/mamba2.py``. Prefill runs the
chunked SSD algorithm (intra-chunk masked matmul + inter-chunk state
recurrence); decode is the O(1)-per-token state recurrence. On a CUDA tensor
with one B/C group, ``ssd_chunked`` runs the SSD chunk-scan kernel
(``kernels/ssm_scan.py``); on the CPU it is the reference's arithmetic op for
op. States are float32.

Shapes: x [B,S,H,P]; dt [B,S,H] (>0); A [H] (<0); B/C [B,S,G,N]; state
[B,H,P,N].
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import rmsnorm


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan (``src/repro/models/mamba2.py:21``). Returns
    (y [B,S,H,P] in x's dtype, final state [B,H,P,N] float32).

    S is padded to a multiple of ``Q = min(chunk, S)``; the padded steps have
    dt = 0, so they leave the state unchanged. A CUDA tensor runs the SSD
    chunk-scan kernel, which takes one B/C group (G = 1): every registered
    config has G = 1, and G > 1 raises on the card.
    """
    B, S0, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, S0)
    pad = (-S0) % Q
    if pad:
        def zpad(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        x, dt, Bm, Cm = zpad(x), zpad(dt), zpad(Bm), zpad(Cm)
    S = S0 + pad
    if x.device.type == "cuda":
        if G != 1:
            raise NotImplementedError(
                f"ssd_chunked on the card runs the SSD kernel, which takes "
                f"one B/C group; got G = {G}")
        from ..kernels.ssm_scan import ssm_chunk_scan
        y, h = ssm_chunk_scan(x.contiguous(), dt.contiguous(), A,
                              Bm[:, :, 0].contiguous(),
                              Cm[:, :, 0].contiguous(), chunk=Q, h0=h0)
        return y[:, :S0], h
    nc = S // Q
    f32 = torch.float32
    xq = x.reshape(B, nc, Q, G, hpg, P).to(f32)
    dtq = dt.reshape(B, nc, Q, G, hpg).to(f32)
    Bq = Bm.reshape(B, nc, Q, G, N).to(f32)
    Cq = Cm.reshape(B, nc, Q, G, N).to(f32)
    a = dtq * A.reshape(G, hpg)                     # [B,nc,Q,G,hpg], negative
    cum = torch.cumsum(a, dim=2)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = torch.zeros((B, G, hpg, P, N), dtype=f32, device=x.device) \
        if h0 is None else h0.reshape(B, G, hpg, P, N).to(f32)
    ys = []
    for c in range(nc):
        x_c, dt_c, B_c, C_c, cum_c = xq[:, c], dtq[:, c], Bq[:, c], Cq[:, c], \
            cum[:, c]
        # intra-chunk: M[t,s] = (C_t.B_s) * exp(cum_t - cum_s) * dt_s, s <= t
        seg = cum_c[:, :, None] - cum_c[:, None]    # [B,t,s,G,hpg]
        L = torch.where(causal[None, :, :, None, None], torch.exp(seg),
                        torch.zeros((), dtype=f32, device=x.device))
        CB = torch.einsum("btgn,bsgn->btsg", C_c, B_c)
        M = CB[..., None] * L * dt_c[:, None]       # [B,t,s,G,hpg]
        y_intra = torch.einsum("btsgh,bsghp->btghp", M, x_c)
        # inter-chunk: y_inter[t] = exp(cum_t) * C_t . h_prev
        y_inter = torch.einsum("btgn,bghpn->btghp", C_c, h) * \
            torch.exp(cum_c)[..., None]
        # state: h = exp(cum_Q) h_prev + sum_s exp(cum_Q - cum_s) dt_s B_s x_s
        w = torch.exp(cum_c[:, -1:] - cum_c) * dt_c  # [B,Q,G,hpg]
        dstate = torch.einsum("bsgn,bsghp->bghpn", B_c, x_c * w[..., None])
        h = torch.exp(cum_c[:, -1])[..., None, None] * h + dstate
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)[:, :S0]
    return y.to(x.dtype), h.reshape(B, H, P, N)


def ssd_decode(x, dt, A, Bm, Cm, h):
    """One-token SSD step (``src/repro/models/mamba2.py:75``). x [B,H,P];
    dt [B,H]; B/C [B,G,N]; h [B,H,P,N]. Returns (y [B,H,P], new state)."""
    B, H, P = x.shape
    G, N = Bm.shape[1], Bm.shape[2]
    hpg = H // G
    f32 = torch.float32
    xg = x.reshape(B, G, hpg, P).to(f32)
    dtg = dt.reshape(B, G, hpg).to(f32)
    hg = h.reshape(B, G, hpg, P, N).to(f32)
    decay = torch.exp(dtg * A.reshape(G, hpg))      # [B,G,hpg]
    dstate = torch.einsum("bgn,bghp->bghpn", Bm.to(f32), xg * dtg[..., None])
    h_new = decay[..., None, None] * hg + dstate
    y = torch.einsum("bgn,bghpn->bghp", Cm.to(f32), h_new)
    return y.reshape(B, H, P).to(x.dtype), h_new.reshape(B, H, P, N)


def causal_conv(x, w, state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence. x [B,S,C]; w [K,C]; state
    [B,K-1,C]. Returns (y [B,S,C], new_state [B,K-1,C])."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)   # [B, S+K-1, C]
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y, new_state


def mamba_params_shapes(d_model: int, s) -> dict:
    """Per-block param shapes (unstacked); s: SSMCfg."""
    di, H, N, G, K = s.d_inner, s.n_heads, s.state_dim, s.n_groups, \
        s.conv_kernel
    return {
        "ln": (d_model,),
        "w_x": (d_model, di),
        "w_z": (d_model, di),
        "w_bc": (d_model, 2 * G * N),
        "w_dt": (d_model, H),
        "dt_bias": (H,),
        "conv_w": (K, di),
        "A_log": (H,),
        "D_skip": (H,),
        "out_norm": (di,),
        "w_out": (di, d_model),
    }


def mamba_block(p, x, s, dtype, conv_state=None, ssm_state=None,
                decode=False):
    """Apply one Mamba2 block (``src/repro/models/mamba2.py:124``). x:
    [B,S,D] (S == 1 for decode). Returns (out [B,S,D], (conv_state,
    ssm_state))."""
    B, S, D = x.shape
    di, H, P = s.d_inner, s.n_heads, s.head_dim
    G, N = s.n_groups, s.state_dim
    xr = rmsnorm(x, p["ln"]).to(dtype)
    xin = xr @ p["w_x"].to(dtype)
    z = xr @ p["w_z"].to(dtype)
    bc = xr @ p["w_bc"].to(dtype)
    dt = F.softplus((xr @ p["w_dt"].to(dtype)).float()
                    + p["dt_bias"].float())
    xin, conv_state = causal_conv(xin, p["conv_w"].to(dtype), conv_state)
    xin = F.silu(xin)
    Bm = bc[..., :G * N].reshape(B, S, G, N)
    Cm = bc[..., G * N:].reshape(B, S, G, N)
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, S, H, P)
    if decode:
        y, ssm_state = ssd_decode(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                  ssm_state)
        y = y[:, None]
    else:
        y, ssm_state = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk, ssm_state)
    y = y + p["D_skip"].to(y.dtype)[:, None] * xh
    y = y.reshape(B, S, di)
    y = y * F.silu(z)
    y = rmsnorm(y, p["out_norm"]).to(dtype)
    out = y @ p["w_out"].to(dtype)
    return out.to(x.dtype), (conv_state, ssm_state)
