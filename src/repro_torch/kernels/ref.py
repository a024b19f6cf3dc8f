"""Plain PyTorch twins of the kernels: the same function, no kernel.

Counterpart of ``repro.kernels.ref``.  Every product takes its operands in
their own dtype and accumulates in fp32 (``preferred_element_type=f32`` in
the reference): the operands are widened to fp32 first, which is exact for
bf16.  Masks use the finite ``NEG_INF`` the reference uses, so a row whose
keys are all masked averages uniformly instead of producing NaN.

The CPU path runs the attention and norm twins; on the card only
``chip_smoke.py`` and the tests call them, to hold each kernel against its
twin.  ``flash_attention_bwd_ref`` and ``rmsnorm_bwd_ref`` are the backward
kernels' twins: autograd of the forward twins (attention's in fp32).  ``ssm_scan_ref`` and
``mlstm_scan_ref`` are the sequential oracles of the two scans, whose plain
twins are the chunked forms in ``ops``;
``decode_attention_split_ref``, ``ssd_chunk_parallel_ref``,
``mlstm_chunk_parallel_ref`` and ``flash_attention_bwd_order_ref`` compute
decode attention, the two scans and attention's backward in the order
their CUDA kernels do, for the tests (no path calls them).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def _gqa_expand(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,Hq,D) by repeating kv heads."""
    group = n_q_heads // k.shape[2]
    return k.repeat_interleave(group, dim=2) if group > 1 else k


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Masked GQA attention. q (B,Sq,Hq,D); k, v (B,Skv,Hkv,D) -> (B,Sq,Hq,D)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k, hq)
    v = _gqa_expand(v, hq)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True, window: int = 0,
                            scale: float | None = None):
    """(dq, dk, dv) in q's dtype: autograd of ``flash_attention_ref`` at the
    fp32 values of (q, k, v) for the output gradient ``do`` -- the gradient
    the backward kernel computes.  In fp32, because autograd of the bf16
    twin rounds dP = dO V^T to bf16 inside the softmax backward: on a row
    whose attention is nearly one-hot, dS is small and that rounding is
    not, and the bf16 twin's dq there is off the fp32 gradient by more
    than the kernels' tolerance."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(qq, kk, vv, causal=causal, window=window, scale=scale)
        grads = torch.autograd.grad(out, (qq, kk, vv), do.float())
    return tuple(g.to(q.dtype) for g in grads)


def flash_attention_bwd_order_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  do: torch.Tensor, *, causal: bool = True, window: int = 0,
                                  scale: float | None = None, delta: str = "o32",
                                  split_dq: bool = True, split_dk: bool = True,
                                  centre: str = "band", exact_delta_tiles: int | None = None):
    """(dq, dk, dv) computed as the bf16 backward kernel computes them, for
    the tests (no path calls it): P recomputed in fp32, dP = dO V^T in fp32,
    dS = P o (dP - Delta); P rounded to the input dtype as the operand of
    dV = P^T dO; dS entering dQ and dK as two halves in the input dtype (hi
    + lo); every product summed in fp32.  Square masks (Sq = Skv).  The
    kernel's 64-row query blocks: a block's band is the key tiles from the
    one holding its first visible key to its last (the kernel's tiles: 64
    keys up to head dim 128, 32 past it).

    ``delta``: "o32" (the kernel's) Delta_i = rowsum(dO o O32), O32 the
    forward's output before rounding, bf16(p) V / sum bf16(p) with p the
    exponentiated scores (here against the row's maximum); "o32_by_l" the
    same normalised by sum p (the forward's l); "sum_p_dp" sum_j P dP in
    fp32 (PR 20's kernel, from a first pass); "output" rowsum(dO o O) from
    the output rounded to the input dtype (the usual flash backward).
    ``exact_delta_tiles`` T: the rows of a block whose band spans at most T
    tiles take Delta = sum_j P dP (the kernel's first sweep there; by
    default the kernel's: 256 keys' worth up to head dim 128, every band
    past it).
    ``split_dq`` / ``split_dk``: dS as hi + lo (else one rounding) in dQ,
    dK.  ``centre``: dq = scale (dS K - c rowsum(dS)) for the rounded dS,
    c the mean of the block's "band" of keys (the kernel's), of its "first"
    tile, of its "diagonal" tile, the row's P-weighted mean ("weighted"),
    or no centring ("none")."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    key_tile = 64 if d <= 128 else 32
    if exact_delta_tiles is None:       # sq tiles: every band
        exact_delta_tiles = 256 // key_tile if d <= 128 else sq
    kf, vf = _gqa_expand(k, hq).float(), _gqa_expand(v, hq).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    pos = torch.arange(sq, device=q.device)
    mask = torch.ones((sq, sq), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window and window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    logits = torch.where(mask, logits, -torch.inf)
    p = torch.where(mask, torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    exact = (p * dp).sum(-1, keepdim=True)
    if delta == "sum_p_dp":
        dl = exact
    else:
        if delta == "output":
            out = flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale).float()
        else:
            pu = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)), 0.0)
            pr = pu.to(q.dtype).float()
            l = pu.sum(-1, keepdim=True) if delta == "o32_by_l" else pr.sum(-1, keepdim=True)
            out = torch.einsum("bhqk,bkhd->bqhd", pr / l, vf)
        dl = (do.float() * out).sum(-1).transpose(1, 2)[..., None]
        for q0 in range(0, sq, 64):
            k0, k1 = _band(q0, sq, causal, window, key_tile)
            if -(-(k1 - k0) // key_tile) <= exact_delta_tiles:
                dl[:, :, q0:q0 + 64] = exact[:, :, q0:q0 + 64]
    ds = p * (dp - dl)
    hi = ds.to(q.dtype).float()
    split = hi + (ds - hi).to(q.dtype).float()
    ds_q, ds_k = (split if s_ else hi for s_ in (split_dq, split_dk))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_q, kf)
    if centre != "none":
        c = torch.empty_like(q, dtype=torch.float32)
        for q0 in range(0, sq, 64):
            k0, k1 = _band(q0, sq, causal, window, key_tile)
            k0, k1 = {"first": (k0, k0 + key_tile),
                      "diagonal": (q0, q0 + 64)}.get(centre, (k0, k1))
            c[:, q0:q0 + 64] = kf[:, k0:k1].mean(1, keepdim=True)
        if centre == "weighted":
            c = torch.einsum("bhqk,bkhd->bqhd", p, kf)
        dq = dq - c * ds_q.sum(-1).transpose(1, 2)[..., None]
    dq = scale * dq
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds_k, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do.float())
    dk, dv = (t.reshape(b, sq, hkv, hq // hkv, d).sum(3) for t in (dk, dv))
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _band(q0: int, s: int, causal: bool, window: int, tile: int) -> tuple[int, int]:
    """The keys [begin, end) the backward kernel's dQ block of query rows
    [q0, q0 + 64) walks (square masks): from the ``tile``-key tile holding
    its first visible key to its last visible key."""
    begin = max(0, q0 - window + 1) // tile * tile if window and window > 0 else 0
    return begin, min(s, q0 + 64) if causal else s


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6):
    """(dx, dscale): autograd of ``rmsnorm_ref`` at (x, scale) for the output
    gradient ``g`` -- what the backward kernel computes."""
    with torch.enable_grad():
        xx, ss = x.detach().requires_grad_(), scale.detach().requires_grad_()
        out = rmsnorm_ref(xx, ss, eps)
        return torch.autograd.grad(out, (xx, ss), g.to(out.dtype))


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                         scale: float | None = None) -> torch.Tensor:
    """One query token per row against a padded cache.
    q (B,Hq,D); caches (B,S,Hkv,D); cache_len (B,) valid lengths -> (B,Hq,D)."""
    b, hq, d = q.shape
    s = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k_cache, hq)
    v = _gqa_expand(v_cache, hq)
    logits = torch.einsum("bhd,bkhd->bhk", q.to(k.dtype).float(), k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < cache_len.to(q.device)[:, None]
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                               split: int, scale: float | None = None) -> torch.Tensor:
    """``decode_attention_ref`` computed as the CUDA kernel computes it: the
    cache is cut into ``split``-key blocks; each block that holds keys of a
    row gives a softmax state over its valid keys (max m, sum l,
    unnormalised fp32 acc), and a row's states are merged by log-sum-exp.
    Blocks at or past a row's length give none; a row of length 0 gets
    zeros.  With a single block the probabilities are normalised and
    rounded to the input dtype before P.V, as in ``decode_attention_ref``.
    Used by no path: it holds the kernel's algorithm to the reference."""
    b, hq, d = q.shape
    s = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    n = max(1, -(-s // split))
    pad = n * split - s
    k = torch.nn.functional.pad(_gqa_expand(k_cache, hq).float(), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(_gqa_expand(v_cache, hq).float(), (0, 0, 0, 0, 0, pad))
    lens = cache_len.to(q.device).clamp(0, s)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    valid = torch.arange(n * split, device=q.device)[None, :] < lens[:, None]     # (B,K)
    logits = torch.where(valid[:, None, :], logits, NEG_INF).reshape(b, hq, n, split)
    m = logits.amax(dim=-1)                                                      # (B,H,n)
    p = torch.exp(logits - m[..., None]) * valid.reshape(b, 1, n, split)
    l = p.sum(dim=-1)
    if n == 1:
        p = (p / l[..., None].clamp_min(1e-30)).to(v_cache.dtype).float()
        return torch.einsum("bhs,bshd->bhd", p[:, :, 0], v).to(q.dtype)
    acc = torch.einsum("bhns,bnshd->bhnd", p, v.reshape(b, n, split, hq, d))
    used = (torch.arange(n, device=q.device)[None, :] * split < lens[:, None])[:, None, :]
    m_all = torch.where(used, m, NEG_INF).amax(dim=-1, keepdim=True)             # (B,H,1)
    w = torch.exp(m - m_all) * used
    num = torch.einsum("bhn,bhnd->bhd", w, acc)
    den = (w * l).sum(dim=-1, keepdim=True)
    return (num / den.clamp_min(1e-30)).to(q.dtype)


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor):
    """Sequential Mamba2 / SSD oracle, one token at a time.

    h_t = exp(A dt_t) h_{t-1} + dt_t (x_t outer B_t);  y_t = h_t . C_t
    x (B,S,H,P); dt (B,S,H); A (H,); Bm, Cm (B,S,N); the state starts at zero.
    Returns (y (B,S,H,P) in x.dtype, h_final (B,H,P,N) fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, bf, cf, af = x.float(), dt.float(), Bm.float(), Cm.float(), A.float()
    hs = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(af[None, :] * dtf[:, t])                          # (B,H)
        inject = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        hs = hs * decay[..., None, None] + inject
        ys.append(torch.einsum("bhpn,bn->bhp", hs, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf[:, :0]
    return y.to(x.dtype), hs


def ssm_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, dy: torch.Tensor, dh_final: torch.Tensor | None = None,
                     *, chunk: int = 256):
    """(dx, ddt, dA, dB, dC): autograd of the chunked twin ``ops.ssd_chunked``
    at the fp32 values of the inputs, for the output gradient ``dy`` and
    the final state's ``dh_final`` (None: zero) -- the gradient the
    backward kernel computes.  Each in its input's dtype."""
    from .ops import ssd_chunked
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        y, h_final = ssd_chunked(*leaves, chunk=chunk)
        outs, grads = [y], [dy.float()]
        if dh_final is not None:
            outs.append(h_final)
            grads.append(dh_final.float())
        got = torch.autograd.grad(outs, leaves, grads)
    return tuple(g.to(t.dtype) for g, t in zip(got, (x, dt, A, Bm, Cm)))


def ssm_scan_bwd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                             Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                             dh_final: torch.Tensor | None = None, *, chunk: int = 64):
    """``ssm_scan_bwd_ref`` computed pass by pass as the backward kernel
    computes it, no autograd, fp32 (for the tests: no path calls it).

    Per (row, chunk, head), cum = cumsum(A dt) in the chunk, L[t,s] =
    exp(cum_t - cum_s) (s <= t, the exponent masked before exp), h_in the
    chunk's incoming state and dh_out its outgoing state's gradient:
      1. every chunk's own state S_c = sum_s w_s x_s outer B_s, w_s = dt_s
         exp(cum_T - cum_s) (the forward's rerun), and its local state
         gradient D_c = sum_t exp(cum_t) dy_t outer C_t;
      2. the carries: h_in forward, h_c = exp(cum_T) h_{c-1} + S_c, and
         dh_out in reverse from dh_final, dh_{c-1} = exp(cum_T) dh_c + D_c;
      3. per chunk, with G = C B^T, dG = dy x^T (over P, per head) and
         M = dG o L o dt (s <= t):
         U = (G o L)^T dy + exp(cum_T - cum) B dh_out^T, dx = dt U,
         ddt (direct) = rowsum(x o U);
         dC = M B + exp(cum) dy h_in, dB = M^T C + w x dh_out (per head);
         dcum_t = rowsum(G o M)_t - colsum(G o M)_t + R_t, R_t = exp(cum_t)
         dy_t . (C_t h_in^T); da = the reverse cumsum of dcum in the chunk,
         plus sum_{s<r} V_s, V_s = w_s x_s . (dh_out B_s) (w's exponent
         cum_T - cum_s, without the cancelling pair at s = T), plus
         exp(cum_T) <dh_out, h_in> (the decay, through cum_T) on every row;
         ddt = ddt (direct) + A da, dA = sum dt da;
      4. dB, dC summed over the heads, dA over rows and positions.
    Rows past S are identity steps (dt = 0, x = B = C = dy = 0)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    f = [_pad_chunks(a.float(), chunk) for a in (x, dt, Bm, Cm, dy)]
    nc = f[0].shape[1] // chunk
    xf, dyf = (a.reshape(b, nc, chunk, h, p) for a in (f[0], f[4]))
    dtf = f[1].reshape(b, nc, chunk, h)
    bf, cf = (a.reshape(b, nc, chunk, n) for a in (f[2], f[3]))
    af = A.float()
    cum = torch.cumsum(af * dtf, dim=2)                                   # (B,nc,T,H)
    last = cum[:, :, -1]                                                  # (B,nc,H)
    ef = torch.exp(last[:, :, None] - cum)                                # exp(cum_T - cum_s)
    ecum = torch.exp(cum)
    w = dtf * ef
    # pass 1: every chunk's own state and local state gradient
    own = torch.einsum("bcthp,bcth,bctn->bchpn", xf, w, bf)
    local = torch.einsum("bcthp,bcth,bctn->bchpn", dyf, ecum, cf)
    # pass 2: the carries, forward (h_in) and in reverse (dh_out)
    h_in, dh_out = torch.empty_like(own), torch.empty_like(local)
    hc = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    for c in range(nc):
        h_in[:, c] = hc
        hc = hc * torch.exp(last[:, c])[..., None, None] + own[:, c]
    dh = (torch.zeros_like(hc) if dh_final is None else dh_final.float())
    for c in reversed(range(nc)):
        dh_out[:, c] = dh
        dh = dh * torch.exp(last[:, c])[..., None, None] + local[:, c]
    # pass 3: per chunk and head
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None],
                              cum[:, :, :, None] - cum[:, :, None], NEG_INF))  # (B,nc,t,s,H)
    G = torch.einsum("bctn,bcsn->bcts", cf, bf)[..., None]                # (B,nc,t,s,1)
    dG = torch.einsum("bcthp,bcshp->bctsh", dyf, xf)
    M = dG * L * dtf[:, :, None]
    U = torch.einsum("bctsh,bcthp->bcshp", G * L, dyf) \
        + ef[..., None] * torch.einsum("bcsn,bchpn->bcshp", bf, dh_out)
    dx = dtf[..., None] * U
    ddt = (xf * U).sum(-1)
    Z = torch.einsum("bcshp,bchpn->bcshn", xf, dh_out)
    W = torch.einsum("bcthp,bchpn->bcthn", dyf, h_in)
    dC = torch.einsum("bctsh,bcsn->bcthn", M, bf) + ecum[..., None] * W
    dB = torch.einsum("bctsh,bctn->bcshn", M, cf) + w[..., None] * Z
    Q = G * M
    R = ecum * torch.einsum("bcthn,bctn->bcth", W, cf)
    V = w * torch.einsum("bcshn,bcsn->bcsh", Z, bf)
    dcum = Q.sum(3) - Q.sum(2) + R
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    # the weights w_s enter cum_T and -cum_s: da_r takes V_s for s < r (an
    # exclusive prefix sum, so V_T never cancels against itself), and the
    # decay of h_in enters cum_T, which every row of the chunk moves
    before = torch.nn.functional.pad(torch.cumsum(V, dim=2)[:, :, :-1], (0, 0, 1, 0))
    da = da + before + (torch.exp(last) * (dh_out * h_in).sum((-2, -1)))[:, :, None]
    ddt = ddt + af * da
    dA = (dtf * da).sum((0, 1, 2))
    # pass 4: the sums over heads, cut to S
    dB, dC = dB.sum(3), dC.sum(3)
    cut = [t.reshape(b, nc * chunk, *t.shape[3:])[:, :s] for t in (dx, ddt, dB, dC)]
    return (cut[0].to(x.dtype), cut[1].to(dt.dtype), dA.to(A.dtype), cut[2].to(Bm.dtype),
            cut[3].to(Cm.dtype))


def _split(t: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the bf16 kernels feed it to a product: bf16 hi
    plus bf16 lo (16 mantissa bits)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssm_scan_bwd_walk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                          dh_final: torch.Tensor | None = None, *, chunk: int = 64,
                          heads: int = 4):
    """``ssm_scan_bwd_ref`` in the order of the bf16 kernel's wgmma passes
    (``csrc/ssm_scan_bwd.cu``), fp32, no autograd (for the tests: no path
    calls it).  ``ssm_scan_bwd_chunked_ref`` states the terms; here:

      1. the walks: h_in forward, h_c = exp(cum_T) h_{c-1} + (x o w)^T B,
         and dh_out in reverse from dh_final, dh_{c-1} = exp(cum_T) dh_c +
         (dy o exp(cum))^T C, each stored as bf16 hi + lo;
      2. per (row, chunk), the heads in groups of ``heads`` (the last group
         short where they do not divide), in order: dC and dB summed over
         a group's heads in order, the groups' sums then added in order;
         dA per head over rows and chunks.

    Every fp32 operand of a product (x o w, dy o exp(cum), the stored
    states, M, (G o L)^T) is rounded as the kernel feeds it: bf16 hi + lo.
    Rows past S are identity steps (dt = 0, x = B = C = dy = 0)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    f = [_pad_chunks(a.float(), chunk) for a in (x, dt, Bm, Cm, dy)]
    nc = f[0].shape[1] // chunk
    xf, dyf = (a.reshape(b, nc, chunk, h, p) for a in (f[0], f[4]))
    dtf = f[1].reshape(b, nc, chunk, h)
    bf, cf = (a.reshape(b, nc, chunk, n) for a in (f[2], f[3]))
    af = A.float()
    cum = torch.cumsum(af * dtf, dim=2)                                   # (B,nc,T,H)
    last = cum[:, :, -1]                                                  # (B,nc,H)
    ef = torch.exp(last[:, :, None] - cum)
    ecum = torch.exp(cum)
    w = dtf * ef
    # 1. the walks
    h_in = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=x.device)
    dh_out = torch.empty_like(h_in)
    hc = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    for c in range(nc):
        h_in[:, c] = _split(hc)
        hc = hc * torch.exp(last[:, c])[..., None, None] + torch.einsum(
            "bthp,btn->bhpn", _split(xf[:, c] * w[:, c, :, :, None]), bf[:, c])
    dh = torch.zeros_like(hc) if dh_final is None else dh_final.float()
    for c in reversed(range(nc)):
        dh_out[:, c] = _split(dh)
        dh = dh * torch.exp(last[:, c])[..., None, None] + torch.einsum(
            "bthp,btn->bhpn", _split(dyf[:, c] * ecum[:, c, :, :, None]), cf[:, c])
    # 2. per (row, chunk), head by head
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    G = torch.einsum("bctn,bcsn->bcts", cf, bf)
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dA = torch.empty(h, dtype=torch.float32, device=x.device)
    groups = []
    for g0 in range(0, h, heads):
        sum_b = torch.zeros_like(bf)
        sum_c = torch.zeros_like(cf)
        for hh in range(g0, min(g0 + heads, h)):
            xh, dyh, cu = xf[..., hh, :], dyf[..., hh, :], cum[..., hh]
            hi, dho = h_in[:, :, hh], dh_out[:, :, hh]
            L = torch.exp(torch.where(tri, cu[..., :, None] - cu[..., None, :], NEG_INF))
            M = torch.einsum("bctp,bcsp->bcts", dyh, xh) * L * dtf[:, :, None, :, hh]
            W = torch.einsum("bctp,bcpn->bctn", dyh, hi)
            Z = torch.einsum("bcsp,bcpn->bcsn", xh, dho)
            sum_c = sum_c + (ecum[..., hh, None] * W + torch.einsum("bcts,bcsn->bctn", _split(M), bf))
            sum_b = sum_b + (w[..., hh, None] * Z + torch.einsum("bcts,bctn->bcsn", _split(M), cf))
            U = ef[..., hh, None] * torch.einsum("bcsn,bcpn->bcsp", bf, dho) \
                + torch.einsum("bcts,bctp->bcsp", _split(G * L), dyh)
            dx[..., hh, :] = dtf[..., hh, None] * U
            Q = G * M
            R = ecum[..., hh] * (W * cf).sum(-1)
            V = w[..., hh] * (Z * bf).sum(-1)
            dcum = Q.sum(3) - Q.sum(2) + R
            da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
            da = da + torch.nn.functional.pad(torch.cumsum(V, dim=2)[:, :, :-1], (1, 0)) \
                + (torch.exp(last[..., hh]) * (dho * hi).sum((-2, -1)))[..., None]
            ddt[..., hh] = (xh * U).sum(-1) + af[hh] * da
            dA[hh] = (dtf[..., hh] * da).sum()
        groups.append((sum_b, sum_c))
    dB, dC = groups[0]
    for gb, gc in groups[1:]:
        dB, dC = dB + gb, dC + gc
    cut = [t.reshape(b, nc * chunk, *t.shape[3:])[:, :s] for t in (dx, ddt, dB, dC)]
    return (cut[0].to(x.dtype), cut[1].to(dt.dtype), dA.to(A.dtype), cut[2].to(Bm.dtype),
            cut[3].to(Cm.dtype))


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_gate: torch.Tensor, f_gate: torch.Tensor) -> torch.Tensor:
    """Sequential stabilised mLSTM oracle (xLSTM matrix memory).

    C_t = f_t C_{t-1} + i_t v_t k_t^T;  n_t = f_t n_{t-1} + i_t k_t;
    y_t = C~_t q_t / max(|n~_t . q_t|, exp(-m_t)),  m_t = max(log f_t + m_{t-1}, log i_t).
    q, k, v (B,S,H,D); i_gate (B,S,H) log-space input gate; f_gate (B,S,H)
    forget-gate preactivation (log-sigmoid applied here).  Returns y in q.dtype."""
    b, s, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    logf = torch.nn.functional.logsigmoid(f_gate.float())
    logi = i_gate.float()
    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    nv = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        m_new = torch.maximum(logf[:, t] + m, logi[:, t])
        fe = torch.exp(logf[:, t] + m - m_new)
        ie = torch.exp(logi[:, t] - m_new)
        C = C * fe[..., None, None] + ie[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", vf[:, t], kf[:, t])
        nv = nv * fe[..., None] + ie[..., None] * kf[:, t]
        qt = qf[:, t] * d ** -0.5
        denom = torch.maximum(torch.einsum("bhd,bhd->bh", nv, qt).abs(), torch.exp(-m_new))
        ys.append(torch.einsum("bhde,bhe->bhd", C, qt) / denom[..., None])
        m = m_new
    y = torch.stack(ys, dim=1) if ys else qf[:, :0]
    return y.to(q.dtype)


def _pad_chunks(t: torch.Tensor, chunk: int, value: float = 0.0) -> torch.Tensor:
    """Pad dim 1 (the sequence) to a whole number of chunks, at least one."""
    pad = max(1, -(-t.shape[1] // chunk)) * chunk - t.shape[1]
    return torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad), value=value)


def ssd_chunk_parallel_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                           Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64):
    """The SSD scan in the order the bf16 CUDA kernel computes it.

    G = C B^T once per (batch row, chunk), shared by every head; every
    chunk's own state S_c = sum_s dt_s exp(cum_T - cum_s) x_s outer B_s and
    its y_intra = (G o L o dt) x at once; then the one sequential pass,
    h_c = exp(cum_T) h_{c-1} + S_c, elementwise; then y += exp(cum) C h_{c-1}^T.
    Same arguments and results as ``ssm_scan_ref``; rows past S are
    identity steps (dt = 0)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, bf, cf = (_pad_chunks(a.float(), chunk) for a in (x, dt, Bm, Cm))
    nc = xf.shape[1] // chunk
    xf = xf.reshape(b, nc, chunk, h, p)
    dtf = dtf.reshape(b, nc, chunk, h)
    bf = bf.reshape(b, nc, chunk, n)
    cf = cf.reshape(b, nc, chunk, n)
    G = torch.einsum("bctn,bcsn->bcts", cf, bf)                           # once per chunk
    cum = torch.cumsum(A.float() * dtf, dim=2)                            # (B,nc,T,H)
    last = cum[:, :, -1]                                                  # (B,nc,H)
    w = dtf * torch.exp(last[:, :, None] - cum)
    states = torch.einsum("bcthp,bcth,bctn->bchpn", xf, w, bf)            # every chunk's own
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None],
                              cum[:, :, :, None] - cum[:, :, None], NEG_INF))
    y = torch.einsum("bcts,bctsh,bcsh,bcshp->bcthp", G, L, dtf, xf)
    h_in = torch.empty_like(states)
    hc = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    for c in range(nc):                                                   # the carry alone
        h_in[:, c] = hc
        hc = hc * torch.exp(last[:, c])[..., None, None] + states[:, c]
    y = y + torch.exp(cum)[..., None] * torch.einsum("bctn,bchpn->bcthp", cf, h_in)
    return y.reshape(b, nc * chunk, h, p)[:, :s].to(x.dtype), hc


def mlstm_chunk_parallel_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             logi: torch.Tensor, logf: torch.Tensor, *,
                             chunk: int = 64) -> torch.Tensor:
    """The mLSTM scan in the order the bf16 CUDA kernel computes it.

    logi, logf (B,S,H) are log-space gates (fp32).  A gates-only pre-pass
    gives the stabiliser entering every chunk, m_{c+1} = max(F_c + m_c,
    max_s(li_s + F_c - bcum_s)), F_c the chunk's sum of logf; every chunk's
    scores (q k^T) D^-1/2 o exp(w - m_row) (scaled after the product), their
    row sums and scores v at once; then the one sequential pass, the (C, n)
    carry, restabilised at the pre-pass's m.  Returns y in q.dtype, as
    ``mlstm_scan_ref``; rows past S enter with logi = -1e30, logf = 0."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    qf, kf, vf = (_pad_chunks(a.float(), chunk).reshape(b, -1, chunk, h, d) for a in (q, k, v))
    li = _pad_chunks(logi.float(), chunk, NEG_INF).reshape(b, -1, chunk, h)
    lf = _pad_chunks(logf.float(), chunk).reshape(b, -1, chunk, h)
    nc = qf.shape[1]
    bcum = torch.cumsum(lf, dim=2)                                        # (B,nc,T,H)
    F = bcum[:, :, -1]                                                    # (B,nc,H)
    tail = (li + (F[:, :, None] - bcum)).amax(dim=2)
    m_in = torch.empty_like(F)
    m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    for c in range(nc):                                                   # gates only
        m_in[:, c] = m
        m = torch.maximum(F[:, c] + m, tail[:, c])
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    wlog = torch.where(tri[None, None, :, :, None],
                       bcum[:, :, :, None] - bcum[:, :, None] + li[:, :, None], -torch.inf)
    m_row = torch.maximum(wlog.amax(dim=3), bcum + m_in[:, :, None]).clamp_min(NEG_INF)
    scores = torch.einsum("bcthd,bcshd->bctsh", qf, kf) * scale \
        * torch.exp(wlog - m_row[:, :, :, None])
    rowsum = scores.sum(dim=3)                                            # (B,nc,T,H)
    y_intra = torch.einsum("bctsh,bcshd->bcthd", scores, vf)
    gexp = torch.exp(bcum + m_in[:, :, None] - m_row)
    m_out = torch.cat([m_in[:, 1:], m[:, None]], dim=1)                   # m leaving chunk c
    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    nvec = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    state = torch.empty_like(y_intra)
    qn = torch.empty_like(rowsum)
    for c in range(nc):                                                   # the carry alone
        state[:, c] = torch.einsum("bhde,bthe->bthd", C, qf[:, c]) * scale
        qn[:, c] = torch.einsum("bthd,bhd->bth", qf[:, c], nvec) * scale
        inj = torch.exp(li[:, c] + (F[:, c, None] - bcum[:, c]) - m_out[:, c, None])
        decay = torch.exp(F[:, c] + m_in[:, c] - m_out[:, c])
        C = C * decay[..., None, None] + torch.einsum("bthd,bthe,bth->bhde", vf[:, c], kf[:, c],
                                                      inj)
        nvec = nvec * decay[..., None] + torch.einsum("bthd,bth->bhd", kf[:, c], inj)
    denom = torch.maximum((rowsum + gexp * qn).abs(), torch.exp(-m_row))
    y = (y_intra + gexp[..., None] * state) / denom[..., None]
    return y.reshape(b, nc * chunk, h, d)[:, :s].to(q.dtype)


def mlstm_scan_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logi: torch.Tensor,
                       logf: torch.Tensor, dy: torch.Tensor, *, chunk: int = 256):
    """(dq, dk, dv, dlogi, dlogf): autograd of the chunked twin
    ``ops.mlstm_chunked`` at the fp32 values of the inputs, for the output
    gradient ``dy`` -- the gradient the backward kernel computes.  Each in
    its input's dtype."""
    from .ops import mlstm_chunked
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v, logi, logf)]
        y, _ = mlstm_chunked(*leaves, chunk)
        got = torch.autograd.grad(y, leaves, dy.float())
    return tuple(g.to(t.dtype) for g, t in zip(got, (q, k, v, logi, logf)))


def mlstm_scan_bwd_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               logi: torch.Tensor, logf: torch.Tensor, dy: torch.Tensor, *,
                               chunk: int = 64):
    """``mlstm_scan_bwd_ref`` computed pass by pass as the backward kernel
    (``csrc/mlstm_scan_bwd.cu``) computes it, no autograd, fp32 (for the
    tests: no path calls it).

    y is invariant to the stabiliser, so every m is a constant here: the
    forward's gates pass gives m_in per chunk, and per chunk, with qs = q
    D^-1/2, bcum = cumsum(logf), W[t,s] = exp(bcum_t - bcum_s + li_s -
    m_row_t) (s <= t), gexp = exp(bcum + m_in - m_row), inj_s = exp(li_s +
    F - bcum_s - m_out) and the decay exp(F + m_in - m_out) (F = bcum_T):
      1. the forward walk: every chunk's incoming (C, n);
      2. per chunk P = (qs k^T) o W and DV = dy v^T (T x T), nq = rowsum P
         + gexp qs.n_in, and yd = dy . (P v + gexp qs C_in^T);
      3. per row den = max(|nq|, exp(-m_row)), r = 1/den and the
         denominator's gradient dnq = -yd r^2 sign(nq) where |nq| >
         exp(-m_row), else 0 (the floor binds: no gradient);
      4. the reverse walk: every chunk's outgoing (dC, dn), from zero,
         dC_in = decay dC_out + (dy o gexp r)^T qs, dn_in = decay dn_out +
         (gexp dnq)^T qs;
      5. per chunk dP = (r DV + dnq) o W, and
         dq = D^-1/2 (dP k + gexp (r dy C_in + dnq n_in)),
         dk = dP^T qs + inj (v dC_out + dn_out),
         dv = (P o r)^T dy + inj k dC_out^T;
      6. the gates by their identities, dlogi_s = <k_s, dk_s> and dlogf_j =
         sum_{t >= j} dF_t, dF_t = <q_t, dq_t> - <k_t, dk_t>, a reverse
         cumulative sum over the whole sequence (for the first S // 2 rows
         minus the sum before j: the dF sum to zero), each dot taken apart
         as the sums of G = (r DV + dnq) o P (a pair's log weight's
         gradient) and the state parts' dots, G's diagonal left out of dF.
    Rows past S enter with logi = -1e30 and logf = 0, as the forward pads,
    and q = k = v = dy = 0: they add to no gradient."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    qf, kf, vf, dyf = (_pad_chunks(a.float(), chunk).reshape(b, -1, chunk, h, d)
                       .permute(0, 3, 1, 2, 4) for a in (q, k, v, dy))        # (B,H,nc,T,D)
    li = _pad_chunks(logi.float(), chunk, NEG_INF).reshape(b, -1, chunk, h).permute(0, 3, 1, 2)
    lf = _pad_chunks(logf.float(), chunk).reshape(b, -1, chunk, h).permute(0, 3, 1, 2)
    nc = qf.shape[2]
    bcum = torch.cumsum(lf, dim=3)                                        # (B,H,nc,T)
    F = bcum[..., -1]                                                     # (B,H,nc)
    tail = (li + (F[..., None] - bcum)).amax(dim=3)
    m_in = torch.empty_like(F)
    m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    for c in range(nc):                                                   # the gates pass
        m_in[..., c] = m
        m = torch.maximum(F[..., c] + m, tail[..., c])
    m_out = torch.cat([m_in[..., 1:], m[..., None]], dim=-1)
    # the kernels' row stabiliser: bcum_t + the prefix max of li_s - bcum_s
    m_row = torch.maximum(bcum + m_in[..., None],
                          bcum + torch.cummax(li - bcum, dim=3).values).clamp_min(NEG_INF)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    W = torch.exp(torch.where(tri, bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
                              - m_row[..., None], NEG_INF))               # (B,H,nc,t,s)
    gexp = torch.exp(bcum + m_in[..., None] - m_row)
    inj = torch.exp(li + (F[..., None] - bcum) - m_out[..., None])
    decay = torch.exp(F + m_in - m_out)
    # 1. the forward walk
    C_in = torch.empty((b, h, nc, d, d), dtype=torch.float32, device=q.device)
    n_in = torch.empty((b, h, nc, d), dtype=torch.float32, device=q.device)
    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    nv = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    for c in range(nc):
        C_in[:, :, c], n_in[:, :, c] = C, nv
        C = decay[..., c, None, None] * C + torch.einsum(
            "bhtd,bhte->bhde", vf[:, :, c] * inj[:, :, c, :, None], kf[:, :, c])
        nv = decay[..., c, None] * nv + torch.einsum("bht,bhte->bhe", inj[:, :, c], kf[:, :, c])
    # 2. the chunks' matrices and the read-out's dot with dy
    P = torch.einsum("bhctd,bhcsd->bhcts", qf, kf) * scale * W
    DV = torch.einsum("bhctd,bhcsd->bhcts", dyf, vf)
    nq = P.sum(-1) + gexp * scale * torch.einsum("bhctd,bhcd->bhct", qf, n_in)
    num = torch.einsum("bhcts,bhcsd->bhctd", P, vf) \
        + (gexp * scale)[..., None] * torch.einsum("bhcde,bhcte->bhctd", C_in, qf)
    yd = (dyf * num).sum(-1)
    # 3. the rows
    floor = torch.exp(-m_row)
    r = 1.0 / torch.maximum(nq.abs(), floor)
    dnq = torch.where(nq.abs() > floor, -yd * r * r * torch.sign(nq), 0.0)
    # 4. the reverse walk
    dC_out = torch.empty_like(C_in)
    dn_out = torch.empty_like(n_in)
    dC = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    dn = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    for c in reversed(range(nc)):
        dC_out[:, :, c], dn_out[:, :, c] = dC, dn
        g = gexp[:, :, c] * r[:, :, c] * scale
        dC = decay[..., c, None, None] * dC + torch.einsum(
            "bhtd,bhte->bhde", dyf[:, :, c] * g[..., None], qf[:, :, c])
        dn = decay[..., c, None] * dn + torch.einsum(
            "bht,bhte->bhe", gexp[:, :, c] * dnq[:, :, c] * scale, qf[:, :, c])
    # 5. the chunks' gradients; the state parts apart, for the gates
    dP = (r[..., None] * DV + dnq[..., None]) * W
    dq_state = scale * ((gexp * r)[..., None] * torch.einsum("bhctd,bhcde->bhcte", dyf, C_in)
                        + (gexp * dnq)[..., None] * n_in[:, :, :, None])
    dk_state = inj[..., None] * (torch.einsum("bhcsd,bhcde->bhcse", vf, dC_out)
                                 + dn_out[:, :, :, None])
    dq = scale * torch.einsum("bhcts,bhcse->bhcte", dP, kf) + dq_state
    dk = scale * torch.einsum("bhcts,bhcte->bhcse", dP, qf) + dk_state
    dv = torch.einsum("bhcts,bhctd->bhcsd", P * r[..., None], dyf) \
        + inj[..., None] * torch.einsum("bhcse,bhcde->bhcsd", kf, dC_out)
    # 6. the gates: with G = (r DV + dnq) o P, the gradient of each pair's
    # log weight, <k_s, dk_s> = colsum(G)_s + V_s and <q_t, dq_t> = rowsum(G)_t
    # + R_t, V and R the state parts' dots; the diagonal of G enters both
    # sums of dF and is left out of them (under strong forgetting it is
    # nearly all of each, and its two roundings would not cancel)
    G = (r[..., None] * DV + dnq[..., None]) * P
    R = (qf * dq_state).sum(-1)
    V = (kf * dk_state).sum(-1)
    diag = torch.diagonal(G, dim1=-2, dim2=-1)
    below = G.sum(-1) - diag                                              # sum_{s<t} G[t,s]
    above = G.sum(-2) - diag                                              # sum_{t>s} G[t,s]
    dlogi = (diag + above + V).reshape(b, h, -1)
    dF = (below + R - above - V).reshape(b, h, -1)
    # the dF of a row sum to zero (a shift of every cumulative forget gate
    # moves no weight), so dlogf_j is also minus the sum before j: the rows
    # of the first half take that form, the others the sum from j (each sum
    # then runs over at most half the rows; dlogf_0 is exactly zero)
    after = torch.flip(torch.cumsum(torch.flip(dF, [2]), dim=2), [2])
    before = torch.cumsum(dF, dim=2) - dF
    dlogf = torch.where(torch.arange(dF.shape[2], device=q.device) < s // 2, -before, after)

    def cut(t):
        return t.reshape(b, h, nc * chunk, *t.shape[4:]).transpose(1, 2)[:, :s]
    return (cut(dq).to(q.dtype), cut(dk).to(k.dtype), cut(dv).to(v.dtype),
            dlogi.transpose(1, 2)[:, :s].to(logi.dtype),
            dlogf.transpose(1, 2)[:, :s].to(logf.dtype))
