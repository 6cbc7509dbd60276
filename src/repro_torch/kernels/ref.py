"""Plain PyTorch versions of the port's kernels.

The counterparts of the JAX package's ``kernels/ref.py`` oracles: the two
attention functions of the serving path, and the two recurrent scans
(Mamba2 SSD, RWKV6 wkv) with their sequential oracles and chunked forms.
``ops`` runs them for tensors on the CPU (the tests; the chunked forms for
the scans, as JAX's ``impl="auto"`` does off the TPU), and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  The
scans' backward kernels (K3-bwd, K4-bwd) are held against
``mamba2_scan_bwd`` and ``rwkv6_scan_bwd``: autograd through the chunked
forms, as JAX differentiates its chunked references.  The main path never
runs any of them when a card is present.

One deliberate difference from the JAX references: a query row that sees
no key (``seq_len == 0``, or causal ``Sq > Skv`` above the first key)
returns 0, as the Pallas kernels and the CUDA kernels do, where the JAX
references return NaN from a softmax over nothing.
"""
from __future__ import annotations

import torch


def _softmax_rows(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of the unmasked entries; a row with no
    unmasked entry gives all zeros (not NaN)."""
    logits = logits.masked_fill(~mask, float("-inf"))
    if logits.shape[-1] == 0:      # no key at all: nothing to weigh
        return logits
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    return p / torch.where(denom == 0, torch.ones_like(denom), denom)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None,
                  compute_dtype: torch.dtype = torch.float32,
                  return_lse: bool = False):
    """Multi-head attention with grouped KV heads.

    q: (B, H, Sq, D);  k, v: (B, Hkv, Skv, D) with H % Hkv == 0.  Causal
    keys are right-aligned: query i sees keys <= i + (Skv - Sq).
    Returns (B, H, Sq, D) in q.dtype; softmax in fp32.  With
    ``return_lse`` also each row's log-sum-exp of its scaled logits, fp32
    (B, H, Sq), +inf where the row sees no key (K2's convention).

    ``compute_dtype`` is the dtype the products' operands are rounded to
    (``q*scale``, ``k``, ``v`` and the probabilities); accumulation is fp32
    either way.
    """
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    group = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = (q.float() * scale).to(compute_dtype).float()
    kf = k.to(compute_dtype).float()
    vf = v.to(compute_dtype).float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        ki = torch.arange(Skv, device=q.device)[None, :]
        mask = ki <= qi
    else:
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    probs = _softmax_rows(logits, mask)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(compute_dtype).float(), vf)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), -1)
    return out.to(q.dtype), lse.masked_fill(lse == float("-inf"),
                                            float("inf"))


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Decode attention for one new token per sequence over a paged KV cache.

    q:          (B, H, D)      — current-step queries
    k_pages:    (P, page, Hkv, D) — physical page pool
    v_pages:    (P, page, Hkv, D)
    page_table: (B, max_pages) int32 — virtual->physical translation
    seq_lens:   (B,) int32     — valid tokens per sequence (cache length)
    Returns (B, H, D) in q.dtype.

    The "software walk": gather every sequence's pages with tensor indexing
    first, then dense attention.
    """
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    max_pages = page_table.shape[1]
    group = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    pt = page_table.long()
    k_seq = k_pages[pt].reshape(B, max_pages * page, Hkv, D)
    v_seq = v_pages[pt].reshape(B, max_pages * page, Hkv, D)
    qf = q.float() * scale
    kf = k_seq.float()
    vf = v_seq.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    pos = torch.arange(max_pages * page, device=q.device)
    mask = (pos[None, :] < seq_lens[:, None].long())[:, None, :]
    probs = _softmax_rows(logits, mask)
    out = torch.einsum("bhs,bshd->bhd", probs, vf)
    return out.to(q.dtype)


# ----------------------------------------------------------------------------
# Mamba2 / SSD selective scan (n_groups = 1)
# ----------------------------------------------------------------------------

def _state(init: torch.Tensor | None, shape, device) -> torch.Tensor:
    """The fp32 initial state: ``init``, or zeros."""
    if init is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return init.float()


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor,
                h0: torch.Tensor | None = None, return_state: bool = False):
    """Sequential oracle of the Mamba2 SSD recurrence (n_groups = 1).

    x: (B, S, H, dh); dt: (B, S, H) softplus-ed step sizes (> 0);
    A: (H,) negative decay rates; Bmat, Cmat: (B, S, ds); D: (H,) skip
    gain; h0: (B, H, ds, dh) initial state (zeros if None).

    h_t = exp(A dt_t) h_{t-1} + dt_t * B_t (x) x_t ;  y_t = C_t . h_t + D x_t
    Returns y (B, S, H, dh) in x.dtype [and the final fp32 state].
    """
    Bsz, S, H, dh = x.shape
    ds = Bmat.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bmat.float(), Cmat.float()
    Af = A.float()
    h = _state(h0, (Bsz, H, ds, dh), x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(Af[None, :] * dtf[:, t])                  # (B,H)
        inject = torch.einsum("bs,bhd->bhsd", Bf[:, t],
                              xf[:, t] * dtf[:, t, :, None])
        h = h * decay[..., None, None] + inject
        ys.append(torch.einsum("bs,bhsd->bhd", Cf[:, t], h))
    y = (torch.stack(ys, 1) + D.float()[None, None, :, None] * xf).to(x.dtype)
    return (y, h) if return_state else y


def _pad_to_chunks(t: torch.Tensor, chunk: int, axis: int = 1):
    pad = (-t.shape[axis]) % chunk
    if pad == 0:
        return t, 0
    shape = list(t.shape)
    shape[axis] = pad
    return torch.cat([t, t.new_zeros(shape)], axis), pad


DEFAULT_SCAN_CHUNK = 64


def mamba2_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bmat: torch.Tensor, Cmat: torch.Tensor,
                        D: torch.Tensor, h0: torch.Tensor | None = None,
                        return_state: bool = False,
                        chunk: int = DEFAULT_SCAN_CHUNK):
    """Chunked SSD: the contract of ``mamba2_scan`` in O(S/chunk) steps.

    Per chunk (the decay is a scalar per head and step, so all is matmuls):
      G[t,j] = exp(cum_t - cum_j)                       (<= 1 for j <= t)
      y_t    = sum_{j<=t} G[t,j] (C_t.B_j) dt_j x_j + exp(cum_t) C_t . h_in
               + D x_t
      h_out  = exp(cum_C) h_in + sum_j exp(cum_C - cum_j) dt_j B_j (x) x_j
    Padded steps have dt = 0: decay 1, no injection.
    """
    Bsz, S, H, dh = x.shape
    ds = Bmat.shape[-1]
    xf, _ = _pad_to_chunks(x.float(), chunk)
    dtf, _ = _pad_to_chunks(dt.float(), chunk)
    Bf, _ = _pad_to_chunks(Bmat.float(), chunk)
    Cf, _ = _pad_to_chunks(Cmat.float(), chunk)
    Af, Df = A.float(), D.float()
    nC = xf.shape[1] // chunk
    h = _state(h0, (Bsz, H, ds, dh), x.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for c in range(nC):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, bc, cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(Af[None, None, :] * dtc, 1)         # (B,C,H) <= 0
        cum_h = cum.transpose(1, 2)                             # (B,H,C)
        # mask the exponent BEFORE exp: the upper triangle is positive, and
        # exp(+big) * 0 would be inf * 0 = NaN
        diff = cum_h[..., :, None] - cum_h[..., None, :]
        G = torch.exp(torch.where(mask, diff, diff.new_tensor(-1e30)))
        CB = torch.einsum("bts,bjs->btj", cc, bc)
        xdt = xc * dtc[..., None]                               # (B,C,H,dh)
        y = torch.einsum("bhtj,btj,bjhd->bthd", G, CB, xdt)
        y = y + torch.einsum("bts,bhsd->bthd", cc, h) \
            * torch.exp(cum)[..., None]
        ys.append(y + Df[None, None, :, None] * xc)
        decay_end = torch.exp(cum_h[..., -1:] - cum_h)          # (B,H,C) <= 1
        h = h * torch.exp(cum_h[..., -1])[..., None, None] \
            + torch.einsum("bhj,bjs,bjhd->bhsd", decay_end, bc, xdt)
    y = torch.cat(ys, 1)[:, :S].to(x.dtype)
    return (y, h) if return_state else y


# ----------------------------------------------------------------------------
# RWKV6 (Finch) wkv recurrence with data-dependent per-channel decay
# ----------------------------------------------------------------------------

def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None, return_state: bool = False):
    """Sequential oracle of the RWKV6 wkv recurrence.

    r, k, v, w: (B, S, H, dh), w the decay in (0, 1); u: (H, dh) bonus;
    s0: (B, H, dh, dh) initial state (zeros if None).
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
    Returns y (B, S, H, dh) in r.dtype [and the final fp32 state].
    """
    B, S, H, dh = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    s = _state(s0, (B, H, dh, dh), r.device)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               s + uf[None, :, :, None] * kv))
        s = s * wf[:, t, ..., None] + kv
    y = torch.stack(ys, 1).to(r.dtype)
    return (y, s) if return_state else y


def rwkv6_scan_split(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: torch.Tensor | None = None):
    """One decode step (S = 1) of the RWKV6 wkv recurrence on a slice of
    the key channels, the plain version of K4's split-key route.

    r, k, w: (B, 1, H, dk) the slice's keys; v: (B, 1, H, dv); u: (H, dk)
    the slice's bonus; s0: (B, H, dk, dv) the state's rows of those keys
    (zeros if None).  Returns (y_part (B, 1, H, dv) fp32, the slice's part
    of ``rwkv6_scan``'s readout, which is the sum of every slice's part;
    the new state rows (B, H, dk, dv) fp32).
    """
    B, _, H, dk = r.shape
    rf, kf, wf = (t[:, 0].float() for t in (r, k, w))
    vf = v[:, 0].float()
    s = _state(s0, (B, H, dk, vf.shape[-1]), r.device)
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf, s + u.float()[None, :, :, None] * kv)
    return y[:, None], s * wf[..., None] + kv


RWKV_SCAN_CHUNK = 32


def rwkv6_scan_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       s0: torch.Tensor | None = None,
                       return_state: bool = False,
                       chunk: int = RWKV_SCAN_CHUNK):
    """Chunked RWKV6 wkv: the contract of ``rwkv6_scan`` in O(S/chunk) steps.

    The decay is per k-channel, so the intra-chunk term keeps the channel
    sum, with the exact pairwise exponent cum_{t-1} - cum_j (<= 0 for
    j < t):
      y_t = sum_{j<t} sum_c r_t[c] exp(cum_{t-1}[c] - cum_j[c]) k_j[c] v_j
          + (r_t . u k_t) v_t + (r_t * exp(cum_{t-1})) . S_in
    Padded steps have w = 1 and k = v = 0.
    """
    Bsz, S, H, dh = r.shape
    rf, _ = _pad_to_chunks(r.float(), chunk)
    kf, _ = _pad_to_chunks(k.float(), chunk)
    vf, _ = _pad_to_chunks(v.float(), chunk)
    wf, pad = _pad_to_chunks(w.float(), chunk)
    if pad:
        wf[:, S:] = 1.0
    uf = u.float()
    nC = rf.shape[1] // chunk
    s = _state(s0, (Bsz, H, dh, dh), r.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)   # j < t
    ys = []
    for c in range(nC):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        # the floor keeps w in fp32's normal range: a denormal flushed to 0
        # would give log(0) = -inf and poison cum_prev = cum - lw
        lw = torch.log(torch.clamp_min(wc, 1e-30))
        cum = torch.cumsum(lw, 1)                       # inclusive, <= 0
        cum_prev = cum - lw                             # exclusive
        r2 = rc * torch.exp(cum_prev)
        expo = cum_prev[:, :, None] - cum[:, None, :]   # (B,C,C,H,dh)
        expo = torch.where(mask[None, :, :, None, None], expo,
                           expo.new_tensor(-1e30))
        att = torch.einsum("bihd,bijhd,bjhd->bhij", rc, torch.exp(expo), kc)
        y = torch.einsum("bhij,bjhd->bihd", att, vc)
        bonus = torch.einsum("bihd,hd,bihd->bih", rc, uf, kc)
        y = y + bonus[..., None] * vc
        ys.append(y + torch.einsum("bihk,bhkv->bihv", r2, s))
        decay_end = torch.exp(cum[:, -1:] - cum)        # (B,C,H,dh) <= 1
        s = s * torch.exp(cum[:, -1])[..., None] \
            + torch.einsum("bjhk,bjhv->bhkv", kc * decay_end, vc)
    y = torch.cat(ys, 1)[:, :S].to(r.dtype)
    return (y, s) if return_state else y


# ----------------------------------------------------------------------------
# the scans' gradients (the plain versions of K3-bwd and K4-bwd)
# ----------------------------------------------------------------------------

def _grads(fn, inputs, state, out_grads):
    """autograd.grad of ``fn(*inputs, state)`` -> (y, final state) for
    ``out_grads`` = (dy, d final state or None); the gradients of
    ``inputs`` and of ``state``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in inputs]
        st = state.detach().requires_grad_(True)
        outs = fn(*ins, st)
        pairs = [(o, g) for o, g in zip(outs, out_grads) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   ins + [st], [g for _, g in pairs],
                                   allow_unused=True)


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                   s0: torch.Tensor | None = None,
                   ds_out: torch.Tensor | None = None):
    """The gradient of ``rwkv6_scan_chunked`` at (r, k, v, w, u, s0) for
    the output gradient ``dy`` and ``ds_out`` (the final state's; None:
    zero) -> (dr, dk, dv, dw, du, ds0), each in its input's dtype (ds0
    fp32 when s0 is None).  Where w < 1e-30 the chunked form's floor gives
    dw = 0."""
    B, _, H, dh = r.shape
    state = _state(s0, (B, H, dh, dh), r.device)
    g = _grads(lambda r_, k_, v_, w_, u_, s_: rwkv6_scan_chunked(
        r_, k_, v_, w_, u_, s0=s_, return_state=True),
        (r, k, v, w, u), state, (dy, ds_out))
    ds0 = g[5] if s0 is None else g[5].to(s0.dtype)
    return (*g[:5], ds0)


def mamba2_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor,
                    dy: torch.Tensor, h0: torch.Tensor | None = None,
                    dh_out: torch.Tensor | None = None):
    """The gradient of ``mamba2_scan_chunked`` at (x, dt, A, Bmat, Cmat, D,
    h0) for the output gradient ``dy`` and ``dh_out`` (the final state's;
    None: zero) -> (dx, ddt, dA, dB, dC, dD, dh0), each in its input's
    dtype (dh0 fp32 when h0 is None)."""
    B, _, H, dh = x.shape
    state = _state(h0, (B, H, Bmat.shape[-1], dh), x.device)
    g = _grads(lambda x_, dt_, A_, B_, C_, D_, h_: mamba2_scan_chunked(
        x_, dt_, A_, B_, C_, D_, h0=h_, return_state=True),
        (x, dt, A, Bmat, Cmat, D), state, (dy, dh_out))
    dh0 = g[6] if h0 is None else g[6].to(h0.dtype)
    return (*g[:6], dh0)
