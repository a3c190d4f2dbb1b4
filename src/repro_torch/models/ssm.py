"""State-space and recurrent blocks: Mamba (Jamba's 7 of 8 layers) and
xLSTM's mLSTM (matrix memory) and sLSTM (scalar memory) blocks (port of
repro/models/ssm.py).

Each block takes x (B, S, d) and an optional carried state and returns
(out, state), as the reference does:

  state None             prefill from scratch / `forward`: no state back
  state given, S == 1    decode: one O(1) update (Mamba's own path; the
                         xLSTM blocks step their recurrence once)
  state given, S > 1     a chunk of S tokens advancing the state
  collect_states         (needs a state) the state after every token, an
                         extra position axis on every leaf (B, S, ...), for
                         speculative verification's restore

The reference's `jax.lax.scan` over chunks and tokens becomes a Python loop
(nothing here needs a gradient).  Mamba's in-chunk `associative_scan` is an
inclusive doubling (Hillis-Steele) scan of the same combine, so its sums
run in another order and agree within the float bar, not bit for bit.
mLSTM takes the chunkwise-parallel form when there is no state and S > 1,
and the sequential step otherwise, as the reference does.  `softplus` is
`logaddexp(x, 0)` and the GELU is the tanh form, as in JAX.

The states are NamedTuples of tensors, as `PagedKVCache` is: the model
writes them in place (`copy_` / `index_copy_` / `masked_fill_`), so a
captured CUDA graph reads them at fixed addresses.  The init of every leaf
is zero except the log-space stabilizers `m`, which start at -1e30.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.quant import modes

M_INIT = -1e30      # the stabilizer m's init; every other leaf starts at 0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Mamba (selective SSM, v1 parameterization)
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    h: torch.Tensor       # (B, d_inner, d_state) float32 SSM state
    conv: torch.Tensor    # (B, d_conv - 1, d_inner) model dtype, causal-conv tail


def init_mamba(gen: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    mc = cfg.mamba
    di = mc.expand * d
    dtr = mc.resolved_dt_rank(d)
    dt = cfg.torch_dtype
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((mc.d_conv, di), generator=gen, **f32) * 0.1
    return {
        "w_in": layers._init_dense(gen, d, 2 * di, dt, device),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "w_x": layers._init_dense(gen, di, dtr + 2 * mc.d_state, dt, device),
        "w_dt": layers._init_dense(gen, dtr, di, dt, device),
        "b_dt": torch.zeros((di,), **f32),
        # S4D-real init: A_log = log(1..d_state), broadcast over channels.
        "A_log": torch.log(torch.arange(1, mc.d_state + 1, **f32).repeat(di, 1)),
        "D": torch.ones((di,), **f32),
        "w_out": layers._init_dense(gen, di, d, dt, device),
    }


def _mamba_inner(x_in: torch.Tensor, p: dict, cfg):
    """The dt / B / C projections and the discretization: (dA, dBx, C) per
    token.  quant="none": they feed exp() in the recurrence and stay float
    under w8a8, as in the reference."""
    mc = cfg.mamba
    dtr = mc.resolved_dt_rank(cfg.d_model)
    xdb = layers.dense(x_in, p["w_x"], quant="none").to(torch.float32)
    dt, B_ssm, C_ssm = torch.split(xdb, [dtr, mc.d_state, mc.d_state], dim=-1)
    dt = _softplus(layers.dense(dt.to(x_in.dtype), p["w_dt"], quant="none")
                   .to(torch.float32) + p["b_dt"])                  # (..., di)
    A = -torch.exp(p["A_log"])                                      # (di, ds)
    dA = torch.exp(dt[..., None] * A)                               # (..., di, ds)
    dBx = dt[..., None] * B_ssm[..., None, :] * x_in.to(torch.float32)[..., None]
    return dA, dBx, C_ssm


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the affine maps h -> a * h + b (the
    reference's combine (a0 * a1, a1 * b0 + b1)), by doubling."""
    n, off = a.shape[1], 1
    while off < n:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def mamba_block(x: torch.Tensor, p: dict, cfg, *, state: Optional[MambaState] = None,
                chunk: int = 16, collect_states: bool = False
                ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """x (B, S, d) -> (B, S, d) and the state (module docstring)."""
    B, S, d = x.shape
    mc = cfg.mamba
    di = mc.expand * d
    xz = layers.dense(x, p["w_in"])
    x_in, z = torch.chunk(xz, 2, dim=-1)                 # (B, S, di) each

    if state is not None and S == 1 and not collect_states:
        # decode: one O(1) update
        conv_ctx = torch.cat([state.conv, x_in.to(state.conv.dtype)], dim=1)
        w = p["conv_w"].to(torch.float32)                 # (dc, di)
        xc = torch.einsum("btd,td->bd", conv_ctx.to(torch.float32), w) \
            + p["conv_b"].to(torch.float32)
        xc = F.silu(xc)[:, None, :].to(x.dtype)           # (B, 1, di)
        dA, dBx, C_ssm = _mamba_inner(xc, p, cfg)
        h = state.h * dA[:, 0] + dBx[:, 0]                # (B, di, ds)
        y = torch.einsum("bds,bs->bd", h, C_ssm[:, 0])[:, None, :]
        y = y + p["D"] * xc.to(torch.float32)
        out = layers.dense((y * F.silu(z.to(torch.float32))).to(x.dtype), p["w_out"])
        return out, MambaState(h=h, conv=conv_ctx[:, 1:])

    # prefill: chunked selective scan; the conv context and h resume from
    # the state when one is given, and start at zero otherwise
    dc = mc.d_conv
    tail = state.conv if state is not None else x_in.new_zeros((B, dc - 1, di))
    xp = torch.cat([tail.to(x_in.dtype), x_in], dim=1)
    w = p["conv_w"].to(torch.float32)
    xc = sum(xp[:, i:i + S].to(torch.float32) * w[i] for i in range(dc)) \
        + p["conv_b"].to(torch.float32)
    xc = F.silu(xc).to(x.dtype)                           # (B, S, di)

    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    h = state.h if state is not None else torch.zeros(
        (B, di, mc.d_state), dtype=torch.float32, device=x.device)
    ys, h_pos = [], []
    for c0 in range(0, S, chunk):
        # the discretization one chunk at a time, as the reference's scanned
        # body, whose projections its calibration tap does not see
        with modes.capture_paused():
            dA_c, dBx_c, C_c = _mamba_inner(xc[:, c0:c0 + chunk], p, cfg)
        pA, pBx = _prefix_scan(dA_c, dBx_c)
        h_c = pA * h[:, None] + pBx                       # (B, chunk, di, ds)
        ys.append(torch.einsum("bcds,bcs->bcd", h_c, C_c))
        if collect_states:
            h_pos.append(h_c)
        h = h_c[:, -1]
    y = torch.cat(ys, dim=1) + p["D"] * xc.to(torch.float32)
    out = layers.dense((y * F.silu(z.to(torch.float32))).to(x.dtype), p["w_out"])
    if collect_states:
        if state is None:
            raise ValueError("collect_states needs a carried state")
        # the conv tail after token j is the last d_conv - 1 inputs up to j
        conv_pos = torch.stack([xp[:, j + 1:j + dc] for j in range(S)], dim=1)
        return out, MambaState(h=torch.cat(h_pos, dim=1), conv=conv_pos.to(tail.dtype))
    if state is None:
        return out, None
    return out, MambaState(h=h, conv=xp[:, S:].to(tail.dtype))


def init_mamba_state(cfg, batch: int, device) -> MambaState:
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    return MambaState(
        h=torch.zeros((batch, di, mc.d_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, mc.d_conv - 1, di), dtype=cfg.torch_dtype, device=device))


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, hd, hd) matrix memory
    n: torch.Tensor   # (B, H, hd) normalizer
    m: torch.Tensor   # (B, H) log-space stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd)
    n: torch.Tensor   # (B, H, hd)
    h: torch.Tensor   # (B, H, hd)
    m: torch.Tensor   # (B, H)


def _scan(step, st, seq, collect_states: bool):
    """The sequential recurrence over the S tokens of `seq` (a tuple of
    (B, S, ...) tensors): (final state, outputs (B, S, ...), and with
    `collect_states` the state after every token (leaves (B, S, ...)))."""
    S = seq[0].shape[1]
    ys, per_pos = [], None
    for t in range(S):
        st, y = step(st, tuple(a[:, t] for a in seq))
        ys.append(y)
        if collect_states:
            if per_pos is None:
                per_pos = type(st)(*(leaf.new_empty((leaf.shape[0], S) + leaf.shape[1:])
                                     for leaf in st))
            for dst, leaf in zip(per_pos, st):
                dst[:, t] = leaf
    return st, torch.stack(ys, dim=1), per_pos


def init_mlstm(gen: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    di = 2 * d                       # up-projection factor 2 (xLSTM block)
    H = cfg.n_heads
    dt = cfg.torch_dtype
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up": layers._init_dense(gen, d, 2 * di, dt, device),
        "w_q": layers._init_dense(gen, di, di, dt, device),
        "w_k": layers._init_dense(gen, di, di, dt, device),
        "w_v": layers._init_dense(gen, di, di, dt, device),
        "w_i": layers._init_dense(gen, di, H, dt, device),
        "w_f": layers._init_dense(gen, di, H, dt, device),
        "b_i": torch.zeros((H,), **f32),
        "b_f": torch.full((H,), 3.0, **f32),        # forget-gate bias init
        "w_down": layers._init_dense(gen, di, d, dt, device),
    }


def _mlstm_step(s: MLSTMState, t):
    qt, kt, vt, it, ft = t                       # (B, H, hd) x3, (B, H) x2
    log_f = -_softplus(-ft)                      # log sigmoid(f)
    m_new = torch.maximum(log_f + s.m, it)
    f_sc = torch.exp(log_f + s.m - m_new)[..., None]
    i_sc = torch.exp(it - m_new)[..., None]
    C = f_sc[..., None] * s.C + (i_sc * vt)[..., None] * kt[..., None, :]
    n = f_sc * s.n + i_sc * kt
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n, qt))[..., None], min=1.0)
    h = torch.einsum("bhij,bhj->bhi", C, qt) / denom
    return MLSTMState(C, n, m_new), h


def mlstm_block(x: torch.Tensor, p: dict, cfg, *, state: Optional[MLSTMState] = None,
                collect_states: bool = False):
    """mLSTM block: up-projection, matrix-memory recurrence, gated
    down-projection."""
    B, S, d = x.shape
    di = 2 * d
    H = cfg.n_heads
    hd = di // H
    up = layers.dense(x, p["w_up"])
    xm, z = torch.chunk(up, 2, dim=-1)           # (B, S, di)

    def heads(w):
        return layers.dense(xm, w).reshape(B, S, H, hd).to(torch.float32)

    q, k, v = heads(p["w_q"]), heads(p["w_k"]) * hd ** -0.5, heads(p["w_v"])
    # quant="none": gate pre-activations feed log-space exponentials
    i_pre = layers.dense(xm, p["w_i"], quant="none").to(torch.float32) + p["b_i"]
    f_pre = layers.dense(xm, p["w_f"], quant="none").to(torch.float32) + p["b_f"]
    st = state if state is not None else init_mlstm_state(cfg, B, x.device)

    if state is None and S > 1:
        hs, _ = _mlstm_chunkwise(q, k, v, i_pre, f_pre, st)
        new_state = None
    else:
        if collect_states and state is None:
            raise ValueError("collect_states needs a carried state")
        new_state, hs, per_pos = _scan(_mlstm_step, st, (q, k, v, i_pre, f_pre),
                                       collect_states)
        if collect_states:
            new_state = per_pos
    h = hs.reshape(B, S, di).to(x.dtype)
    out = layers.dense(h * F.silu(z.to(torch.float32)).to(x.dtype), p["w_down"])
    return out, (new_state if state is not None else None)


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, st: MLSTMState, chunk: int = 64):
    """Chunkwise-parallel stabilized mLSTM (the reference's formulation):
    within a chunk F_t = cumsum(log f), a_s = i_s - F_s, M_t = max(m_prev,
    cummax a_s), D[t, s] = exp(a_s - M_t) for s <= t, and

      h_t = [exp(m_prev - M_t) (C_prev q_t) + sum_s D[t,s] (q_t k_s) v_s]
            / max(|exp(m_prev - M_t) (n_prev q_t) + sum_s D[t,s] (q_t k_s)|, 1);

    the state closes each chunk at t = chunk.  q/k/v (B, S, H, hd) f32,
    i_pre / f_pre (B, S, H).  Returns (h (B, S, H * hd), final state)."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    state, hs = st, []
    for c0 in range(0, S, chunk):
        qc, kc, vc, ic, fc = (t[:, c0:c0 + chunk] for t in (q, k, v, i_pre, f_pre))
        log_f = -_softplus(-fc)                                     # (B, c, H)
        Fc = torch.cumsum(log_f, dim=1)                             # inclusive
        a = ic - Fc
        M = torch.maximum(state.m[:, None], torch.cummax(a, dim=1).values)
        D = torch.exp(a[:, None, :, :] - M[:, :, None, :])          # (B, t, s, H)
        D = torch.where(tri[None, :, :, None], D, torch.zeros_like(D))
        qk = torch.einsum("bthd,bshd->btsh", qc, kc)
        w = D * qk
        num_intra = torch.einsum("btsh,bshd->bthd", w, vc)
        den_intra = torch.sum(w, dim=2)                             # (B, t, H)
        scale = torch.exp(state.m[:, None] - M)                     # (B, t, H)
        num_inter = scale[..., None] * torch.einsum("bhij,bthj->bthi", state.C, qc)
        den_inter = scale * torch.einsum("bhd,bthd->bth", state.n, qc)
        num = num_intra + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.clamp(torch.abs(den), min=1.0)[..., None])
        M_c = M[:, -1]                                              # (B, H)
        w_end = torch.exp(a - M_c[:, None])                         # (B, s, H)
        C_new = scale[:, -1][..., None, None] * state.C + torch.einsum(
            "bsh,bshd,bshe->bhde", w_end, vc, kc)
        n_new = scale[:, -1][..., None] * state.n + torch.einsum(
            "bsh,bshd->bhd", w_end, kc)
        state = MLSTMState(C_new, n_new, Fc[:, -1] + M_c)
    return torch.cat(hs, dim=1).reshape(B, S, H * hd), state


def init_slstm(gen: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    dt = cfg.torch_dtype
    p = {f"w_{g}": layers._init_dense(gen, d, d, dt, device) for g in "izfo"}
    for g in "izfo":
        r = torch.randn((H, hd, hd), generator=gen, dtype=torch.float32, device=device)
        p[f"r_{g}"] = (r * hd ** -0.5).to(dt)
    p["b_f"] = torch.full((H, hd), 3.0, dtype=torch.float32, device=device)
    ff = int(8 / 3 * d) // 8 * 8
    p["w_ff_up"] = layers._init_dense(gen, d, 2 * ff, dt, device)
    p["w_ff_down"] = layers._init_dense(gen, ff, d, dt, device)
    return p


def slstm_block(x: torch.Tensor, p: dict, cfg, *, state: Optional[SLSTMState] = None,
                collect_states: bool = False):
    """sLSTM block: scalar-memory LSTM with a head-wise recurrence, then the
    GLU feed-forward (proj factor 4/3)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    # quant="none": the gate projections stay float under w8a8
    pre = [layers.dense(x, p[f"w_{g}"], quant="none").reshape(B, S, H, hd)
           .to(torch.float32) for g in "izfo"]
    st = state if state is not None else init_slstm_state(cfg, B, x.device)
    rec = {g: p[f"r_{g}"].to(torch.float32) for g in "izfo"}

    def step(s: SLSTMState, t):
        ti, tz, tf, to = t

        def r(g):
            return torch.einsum("bhj,hij->bhi", s.h, rec[g])

        i_pre = ti + r("i")
        f_pre = tf + r("f") + p["b_f"]
        z_t = torch.tanh(tz + r("z"))
        o_t = torch.sigmoid(to + r("o"))
        log_f = -_softplus(-f_pre)                                   # (B, H, hd)
        m_new = torch.maximum(torch.amax(log_f, dim=-1) + s.m,
                              torch.amax(i_pre, dim=-1))            # (B, H)
        f_sc = torch.exp(log_f + (s.m - m_new)[..., None])
        i_sc = torch.exp(i_pre - m_new[..., None])
        c = f_sc * s.c + i_sc * z_t
        n = f_sc * s.n + i_sc
        h = o_t * c / torch.clamp(n, min=1.0)
        return SLSTMState(c, n, h, m_new), h

    if collect_states and state is None:
        raise ValueError("collect_states needs a carried state")
    new_state, hs, per_pos = _scan(step, st, tuple(pre), collect_states)
    if collect_states:
        new_state = per_pos
    h = hs.reshape(B, S, d).to(x.dtype)
    up = layers.dense(h, p["w_ff_up"])
    a, b = torch.chunk(up, 2, dim=-1)
    g = F.gelu(a.to(torch.float32), approximate="tanh").to(x.dtype)
    out = layers.dense(g * b, p["w_ff_down"])
    return out, (new_state if state is not None else None)


def init_mlstm_state(cfg, batch: int, device) -> MLSTMState:
    di = 2 * cfg.d_model
    H = cfg.n_heads
    hd = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((batch, H, hd, hd), **f32),
                      n=torch.zeros((batch, H, hd), **f32),
                      m=torch.full((batch, H), M_INIT, **f32))


def init_slstm_state(cfg, batch: int, device) -> SLSTMState:
    H = cfg.n_heads
    hd = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(c=torch.zeros((batch, H, hd), **f32),
                      n=torch.zeros((batch, H, hd), **f32),
                      h=torch.zeros((batch, H, hd), **f32),
                      m=torch.full((batch, H), M_INIT, **f32))


# ---------------------------------------------------------------------------
# the states as the paged decode state holds them
# ---------------------------------------------------------------------------

RECURRENT_STATES = (MambaState, MLSTMState, SLSTMState)

_INIT_STATE = {"mamba": init_mamba_state, "mlstm": init_mlstm_state,
               "slstm": init_slstm_state}


def init_state_for_kind(cfg, kind: str, batch: int, device):
    """The per-slot state of a recurrent block kind, at its init."""
    if kind not in _INIT_STATE:
        raise ValueError(f"{kind!r} is not a recurrent block kind")
    return _INIT_STATE[kind](cfg, batch, device)


def _slot_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def reset_state_(state, mask: Optional[torch.Tensor] = None):
    """Return `state`'s slots (all, or those `mask` (B,) bool marks) to
    their init, in place: m to -1e30, everything else to zero."""
    for name, leaf in zip(state._fields, state):
        val = M_INIT if name == "m" else 0.0
        if mask is None:
            leaf.fill_(val)
        else:
            leaf.masked_fill_(_slot_mask(mask, leaf), val)
    return state


def select_into_(state, new, mask: Optional[torch.Tensor] = None):
    """state <- new where `mask` (B,) marks a slot (every slot when None),
    in place, in one pass: the slots a step left inactive keep their
    state."""
    for old, leaf in zip(state, new):
        if mask is None:
            old.copy_(leaf)
        else:
            torch.where(_slot_mask(mask, old), leaf.to(old.dtype), old, out=old)
    return state


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state)
