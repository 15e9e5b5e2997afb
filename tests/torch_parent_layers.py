"""The port's model functions that tensor parallelism changed, as they
stood before it, for holding the whole-weights paths to them bit for bit
(``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_tp_ssm.py``
and ``tests/test_torch_tp_encdec.py`` put them in place of the current
ones with ``monkeypatch``): the dense and MoE layers as they stood before
the attention families were cut, and the SSM, hybrid and
encoder-decoder passes (``ssm_block``, the hybrid's group, ``_mha`` and
``_mlp``) as they stood before those families were.

Copies of the earlier bodies, with the current modules' helpers that did
not change; ``embed_tokens`` takes (and ignores) the ``vocab`` that its
callers now pass.  Imports ``torch`` and the port only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import encdec, hybrid, moe
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_rope, chunked_attention,
                                       gelu_mlp, remat, rms_norm, swiglu,
                                       unstack)
from repro_torch.parallel.hints import (current_split, hint, residual_block,
                                        split_sequence)


def _project_q(cfg, lp, x, q_offset):
    B, S, _ = x.shape
    q = torch.matmul(x, lp["wq"])
    if "bq" in lp:
        q = q + lp["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    return apply_rope(q, tfm._positions(S, q_offset, x.device),
                      cfg.rope_theta)


def _attn(cfg, lp, x, *, k_full, v_full, window, q_offset, kv_len,
          block_k=1024):
    B, S, _ = x.shape
    out = chunked_attention(
        _project_q(cfg, lp, x, q_offset), k_full, v_full, causal=True,
        window=window, q_offset=q_offset, kv_len=kv_len, block_k=block_k)
    return torch.matmul(out.reshape(B, S, -1), lp["wo"])


def _attn_prompt(cfg, lp, x, k, v, window):
    B, S, _ = x.shape
    out = ops.mha(_project_q(cfg, lp, x, 0), k, v, causal=True,
                  window=int(window))
    return torch.matmul(out.reshape(B, S, -1), lp["wo"])


def _project_kv(cfg, lp, x, q_offset):
    B, S, _ = x.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.hd
    k = torch.matmul(x, lp["wk"])
    v = torch.matmul(x, lp["wv"])
    if "bk" in lp:
        k, v = k + lp["bk"], v + lp["bv"]
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    k = apply_rope(k, tfm._positions(S, q_offset, x.device), cfg.rope_theta)
    return k, v


def dense_layer(cfg, lp, x, window, *, cache_kv=None, pos=0, block_k=1024,
                ffn=None):
    h = hint(rms_norm(x, lp["ln1"], cfg.norm_eps), "block_in")
    if cache_kv is None:
        if int(pos) != 0:
            raise ValueError(f"pos={pos}")
        k, v = _project_kv(cfg, lp, h, 0)
        attn = _attn_prompt(cfg, lp, h, k, v, window)
        new_kv = (k, v)
    else:
        k_new, v_new = _project_kv(cfg, lp, h, pos)
        k_buf, v_buf = cache_kv
        S = x.shape[1]
        at = min(max(int(pos), 0), k_buf.shape[1] - S)
        k_buf[:, at:at + S] = k_new.to(k_buf.dtype)
        v_buf[:, at:at + S] = v_new.to(v_buf.dtype)
        attn = _attn(cfg, lp, h, k_full=k_buf, v_full=v_buf, window=window,
                     q_offset=pos, kv_len=pos + S, block_k=block_k)
        new_kv = (k_buf, v_buf)
    x = x + residual_block(attn)
    h = hint(rms_norm(x, lp["ln2"], cfg.norm_eps), "block_in")
    if ffn is None:
        delta = swiglu(residual_block(h), lp["w_gate"], lp["w_up"],
                       lp["w_down"])
    else:
        delta = residual_block(ffn(lp, h))
    x = x + delta
    return x, new_kv


def logits_fn(cfg, params, h):
    w = params.get("lm_head", params["embed"])
    return torch.matmul(h, w.to(h.dtype).T)


class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table = (table.shape, table.dtype)
        return table.to(torch.bfloat16)[tokens]

    @staticmethod
    def backward(ctx, ct):
        (tokens,) = ctx.saved_tensors
        shape, dtype = ctx.table
        grad = torch.zeros(shape, dtype=torch.float32, device=ct.device)
        grad.index_put_((tokens.reshape(-1).long(),),
                        ct.reshape(-1, shape[-1]).float(), accumulate=True)
        return grad.to(dtype), None


def embed_tokens(params, tokens, vocab=None):
    return _Embed.apply(params["embed"], tokens)


def _xent(hc, lc, w):
    logits = hint(torch.matmul(hc.float(), w.T), "logits")
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return lse - gold


def chunked_xent(cfg, params, h, labels, chunk=512):
    split = current_split()
    if split is not None:
        labels = split.block(labels)
    B, S, D = h.shape
    w = params.get("lm_head", params["embed"]).float()
    nchunks = max(1, S // chunk)
    hs = h.reshape(B, nchunks, S // nchunks, D)
    ls = labels.reshape(B, nchunks, S // nchunks)
    losses = [remat(_xent, hs[:, c], ls[:, c], w) for c in range(nchunks)]
    loss = torch.stack(losses).mean()
    return loss if split is None else split.mean(loss)


@torch.no_grad()
def prefill(cfg, params, tokens, max_len, ffn=None, residual_hint=True):
    B, S = tokens.shape
    with split_sequence(S) as split:
        x = residual_block(embed_tokens(params, tokens))
        windows = tfm.layer_windows(cfg)
        cache = tfm.init_cache(cfg, B, max_len, device=x.device)
        for i in range(cfg.n_layers):
            x, (k, v) = dense_layer(cfg, tfm._layer_params(params, i), x,
                                    int(windows[i]), ffn=ffn)
            if residual_hint:
                x = hint(x, "residual")
            cache.k[i, :, :S] = k
            cache.v[i, :, :S] = v
        h = rms_norm(x, params["ln_f"], cfg.norm_eps)
        logits = logits_fn(cfg, params, h[:, -1:])[:, 0]
    if split is not None:
        logits = split.last_block(logits)
    return logits, tfm.KVCache(cache.k, cache.v, S)


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, block_k=1024, ffn=None):
    x = embed_tokens(params, tokens)
    windows = tfm.layer_windows(cfg)
    pos = int(cache.pos)
    for i in range(cfg.n_layers):
        x, _ = dense_layer(cfg, tfm._layer_params(params, i), x,
                           int(windows[i]), cache_kv=(cache.k[i], cache.v[i]),
                           pos=pos, block_k=block_k, ffn=ffn)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(cfg, params, h)[:, 0]
    return logits, tfm.KVCache(cache.k, cache.v, pos + 1)


def _route(cfg, router_w, xt, batch_fe=False):
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    E = probs.shape[-1]
    me = probs.mean(0)
    fe = torch.nn.functional.one_hot(top_i[:, 0], E).float().mean(0)
    split = current_split() if batch_fe else None
    if split is not None:
        fe = split.batch_mean(fe)
    aux = E * torch.sum(fe * me)
    return top_p, top_i, aux


def moe_ffn_sorted(cfg, lp, h):
    B, S, D = h.shape
    T = B * S
    K, E = cfg.top_k, cfg.n_experts
    C = moe.capacity(cfg, T)
    xt = h.reshape(T, D)
    top_p, top_i, aux = _route(cfg, lp["router"], xt, batch_fe=True)
    slot_token, order, sorted_e, rank, keep = moe.dispatch_slots(top_i, C, E)
    buf = hint(ops.dispatch(xt, slot_token).view(E, C, D), "expert_buffer")
    y = swiglu(buf, lp["we_gate"], lp["we_up"], lp["we_down"])
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=h.device))
    row = (sorted_e * C + torch.clamp(rank, max=C - 1))[inv]
    y_tok = y.reshape(E * C, D)[row].masked_fill(~keep[inv][:, None], 0)
    out = (y_tok.float() * top_p.reshape(-1, 1)).view(T, K, D).sum(1)
    return out.reshape(B, S, D).to(h.dtype), aux


def _ffn(cfg, impl, aux=None):
    moe_fn = moe.MOE_IMPLS[impl]

    def ffn(lp, h):
        delta, aux_l = moe_fn(cfg, lp, h)
        if aux is not None:
            aux.append(aux_l)
        if cfg.shared_expert:
            delta = residual_block(delta) + swiglu(
                residual_block(h), lp["w_gate"], lp["w_up"], lp["w_down"])
        return delta

    return ffn


# ---------------------------------------------------------------------------
# The SSM family before its channel cut
# ---------------------------------------------------------------------------


def ssm_block(cfg, lp, x, *, conv_state=None, ssm_state=None,
              streaming=False):
    Bsz, S, D = x.shape
    d_inner, H, P, N = ssm_mod.dims(cfg)
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    proj = torch.matmul(h, lp["in_proj"])
    z, xin, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * N, H],
                                     dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, new_conv = ssm_mod._causal_conv(conv_in, lp["conv_w"],
                                              lp["conv_b"], conv_state)
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    xh = xin.reshape(Bsz, S, H, P)
    if streaming and S == 1:
        dA = torch.exp(dt[:, 0] * A)
        xdt = xh[:, 0] * dt[:, 0, :, None]
        s_add = torch.einsum("bn,bhp->bhpn", Bm[:, 0].float(), xdt.float())
        state = ssm_state * dA[..., None, None] + s_add
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), state)
        y = y[:, None]
        new_state = state
    else:
        y, new_state = ssm_mod.ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                           ssm_state)
    y = y + lp["D_skip"][:, None] * xh.float()
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = rms_norm(y.float() * ssm_mod._silu(z).float(), lp["gate_ln"],
                 cfg.norm_eps).to(x.dtype)
    out = torch.matmul(y, lp["out_proj"])
    return x + out, (new_conv, new_state)


def ssm_init_cache(cfg, batch, dtype=torch.bfloat16, device="cuda"):
    d_inner, H, P, N = ssm_mod.dims(cfg)
    L = cfg.n_layers
    return ssm_mod.SSMCache(
        torch.zeros((L, batch, cfg.ssm_conv - 1, d_inner + 2 * N),
                    dtype=dtype, device=device),
        torch.zeros((L, batch, H, P, N), dtype=torch.float32, device=device),
        0)


def ssm_forward(cfg, params, tokens):
    x = tfm.embed_tokens(params, tokens)

    def block(lp, x):
        return ssm_mod.ssm_block(cfg, lp, x)[0]

    for lp in unstack(params["layers"], cfg.n_layers):
        x = hint(remat(block, lp, x), "residual")
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def ssm_lm_loss(cfg, params, batch):
    with split_sequence(batch["tokens"].shape[1], cut=False) as split:
        params = tfm.spread_grads(params, split)
        h = ssm_mod.forward(cfg, params, batch["tokens"])
        return tfm.chunked_xent(cfg, params, h, batch["labels"])


@torch.no_grad()
def ssm_decode_step(cfg, params, cache, tokens):
    x = tfm.embed_tokens(params, tokens)
    for i in range(cfg.n_layers):
        x, (conv, state) = ssm_mod.ssm_block(
            cfg, ssm_mod.layer(params["layers"], i), x,
            conv_state=cache.conv[i], ssm_state=cache.state[i],
            streaming=True)
        cache.conv[i] = conv
        cache.state[i] = state
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h)[:, 0]
    return logits, ssm_mod.SSMCache(cache.conv, cache.state,
                                    int(cache.pos) + 1)


@torch.no_grad()
def ssm_prefill(cfg, params, tokens):
    B, S = tokens.shape
    x = tfm.embed_tokens(params, tokens)
    cache = ssm_mod.init_cache(cfg, B, device=x.device)
    for i in range(cfg.n_layers):
        x, (conv, state) = ssm_mod.ssm_block(
            cfg, ssm_mod.layer(params["layers"], i), x)
        cache.conv[i] = conv
        cache.state[i] = state
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, ssm_mod.SSMCache(cache.conv, cache.state, S)


# ---------------------------------------------------------------------------
# The hybrid before its channel cut
# ---------------------------------------------------------------------------


def hybrid_init_cache(cfg, batch, max_len, dtype=torch.bfloat16,
                      device="cuda"):
    d_inner, H, P, N = ssm_mod.dims(cfg)
    G, per = hybrid._groups(cfg)
    kv = (G, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return hybrid.HybridCache(
        torch.zeros((G, per, batch, cfg.ssm_conv - 1, d_inner + 2 * N),
                    dtype=dtype, device=device),
        torch.zeros((G, per, batch, H, P, N), dtype=torch.float32,
                    device=device),
        torch.zeros(kv, dtype=dtype, device=device),
        torch.zeros(kv, dtype=dtype, device=device),
        0)


def hybrid_forward(cfg, params, tokens):
    x = tfm.embed_tokens(params, tokens)
    G, per = hybrid._groups(cfg)
    shared = params["shared_attn"]

    def group(lps, x):
        for lp in lps:
            x, _ = ssm_mod.ssm_block(cfg, lp, x)
        return tfm.dense_layer(cfg, shared, x, 0)[0]

    for stacked in unstack(params["ssm"], G):
        x = hint(remat(group, unstack(stacked, per), x), "residual")
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def hybrid_lm_loss(cfg, params, batch):
    with split_sequence(batch["tokens"].shape[1], cut=False) as split:
        params = tfm.spread_grads(params, split)
        h = hybrid.forward(cfg, params, batch["tokens"])
        return tfm.chunked_xent(cfg, params, h, batch["labels"])


@torch.no_grad()
def hybrid_decode_step(cfg, params, cache, tokens):
    x = tfm.embed_tokens(params, tokens)
    G, per = hybrid._groups(cfg)
    pos = int(cache.pos)
    for g in range(G):
        for i in range(per):
            x, (conv, state) = ssm_mod.ssm_block(
                cfg, ssm_mod.layer(params["ssm"], (g, i)), x,
                conv_state=cache.conv[g, i], ssm_state=cache.state[g, i],
                streaming=True)
            cache.conv[g, i] = conv
            cache.state[g, i] = state
        x, _ = tfm.dense_layer(cfg, params["shared_attn"], x, 0,
                               cache_kv=(cache.k[g], cache.v[g]), pos=pos)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h)[:, 0]
    return logits, hybrid.HybridCache(cache.conv, cache.state, cache.k,
                                      cache.v, pos + 1)


@torch.no_grad()
def hybrid_prefill(cfg, params, tokens, max_len):
    B, S = tokens.shape
    x = tfm.embed_tokens(params, tokens)
    G, per = hybrid._groups(cfg)
    cache = hybrid.init_cache(cfg, B, max_len, device=x.device)
    for g in range(G):
        for i in range(per):
            x, (conv, state) = ssm_mod.ssm_block(
                cfg, ssm_mod.layer(params["ssm"], (g, i)), x)
            cache.conv[g, i] = conv
            cache.state[g, i] = state
        x, (k, v) = tfm.dense_layer(cfg, params["shared_attn"], x, 0)
        cache.k[g, :, :S] = k
        cache.v[g, :, :S] = v
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, hybrid.HybridCache(cache.conv, cache.state, cache.k,
                                      cache.v, S)


# ---------------------------------------------------------------------------
# The encoder-decoder before its cuts
# ---------------------------------------------------------------------------


def _mha(cfg, ap, xq, xkv, *, causal):
    B, Sq, _ = xq.shape
    Sk = xkv.shape[1]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.matmul(xq, ap["wq"]).reshape(B, Sq, H, Dh)
    k = torch.matmul(xkv, ap["wk"]).reshape(B, Sk, Hkv, Dh)
    v = torch.matmul(xkv, ap["wv"]).reshape(B, Sk, Hkv, Dh)
    q = apply_rope(q, tfm._positions(Sq, 0, xq.device), cfg.rope_theta)
    k = apply_rope(k, tfm._positions(Sk, 0, xq.device), cfg.rope_theta)
    out = ops.mha(q, k, v, causal=causal)
    return torch.matmul(out.reshape(B, Sq, H * Dh), ap["wo"]), (k, v)


def _mlp(cfg, lp, x):
    m = lp["mlp"]
    return gelu_mlp(x, m["w_up"], m["b_up"], m["w_down"], m["b_down"])


def encdec_encode_grad(cfg, params, frames):
    def block(lp, x):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = encdec._mha(cfg, lp["attn"], h, h, causal=False)
        x = x + a
        return x + encdec._mlp(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))

    x = frames
    for lp in unstack(params["enc"], cfg.n_encoder_layers or cfg.n_layers):
        x = hint(remat(block, lp, x), "residual")
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


@torch.no_grad()
def encdec_encode(cfg, params, frames):
    return encdec._encode(cfg, params, frames)


def encdec_decode_train(cfg, params, enc_out, tokens):
    def block(lp, x):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = encdec._mha(cfg, lp["self"], h, h, causal=True)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        a, _ = encdec._mha(cfg, lp["cross"], h, enc_out, causal=False)
        x = x + a
        return x + encdec._mlp(cfg, lp, rms_norm(x, lp["ln3"], cfg.norm_eps))

    x = tfm.embed_tokens(params, tokens)
    for lp in unstack(params["dec"], cfg.n_layers):
        x = hint(remat(block, lp, x), "residual")
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def encdec_lm_loss(cfg, params, batch):
    with split_sequence(batch["tokens"].shape[1], cut=False) as split:
        params = tfm.spread_grads(params, split)
        enc_out = encdec._encode(cfg, params,
                                 batch["frames"].to(torch.bfloat16))
        h = encdec.decode_train(cfg, params, enc_out, batch["tokens"])
        return tfm.chunked_xent(cfg, params, h, batch["labels"])


@torch.no_grad()
def encdec_prefill(cfg, params, frames, tokens, max_len):
    B, S = tokens.shape
    enc_out = encdec.encode(cfg, params, frames.to(torch.bfloat16))
    x = tfm.embed_tokens(params, tokens)
    L, S_enc = cfg.n_layers, enc_out.shape[1]
    kv = (L, B, max_len, cfg.n_kv_heads, cfg.hd)
    cross = (L, B, S_enc, cfg.n_kv_heads, cfg.hd)
    k_self = torch.zeros(kv, dtype=x.dtype, device=x.device)
    v_self = torch.zeros(kv, dtype=x.dtype, device=x.device)
    k_cross = torch.empty(cross, dtype=x.dtype, device=x.device)
    v_cross = torch.empty(cross, dtype=x.dtype, device=x.device)
    for i in range(L):
        lp = encdec._layer(params["dec"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = encdec._mha(cfg, lp["self"], h, h, causal=True)
        k_self[i, :, :S], v_self[i, :, :S] = k, v
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        a, (k, v) = encdec._mha(cfg, lp["cross"], h, enc_out, causal=False)
        k_cross[i], v_cross[i] = k, v
        x = x + a
        x = x + encdec._mlp(cfg, lp, rms_norm(x, lp["ln3"], cfg.norm_eps))
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h[:, -1:])[:, 0]
    return logits, encdec.EncDecCache(k_self, v_self, k_cross, v_cross, S)


@torch.no_grad()
def encdec_decode_step(cfg, params, cache, tokens):
    x = tfm.embed_tokens(params, tokens)
    pos = int(cache.pos)
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for i in range(cfg.n_layers):
        lp = encdec._layer(params["dec"], i)
        k_s, v_s = cache.k_self[i], cache.v_self[i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        k_new = torch.matmul(h, lp["self"]["wk"]).reshape(B, S, Hkv, Dh)
        v_new = torch.matmul(h, lp["self"]["wv"]).reshape(B, S, Hkv, Dh)
        k_new = apply_rope(k_new, tfm._positions(S, pos, x.device),
                           cfg.rope_theta)
        at = min(max(pos, 0), k_s.shape[1] - S)
        k_s[:, at:at + S] = k_new.to(k_s.dtype)
        v_s[:, at:at + S] = v_new.to(v_s.dtype)
        q = torch.matmul(h, lp["self"]["wq"]).reshape(B, S, H, Dh)
        q = apply_rope(q, tfm._positions(S, pos, x.device), cfg.rope_theta)
        a = chunked_attention(q, k_s, v_s, causal=True, q_offset=pos,
                              kv_len=pos + 1)
        x = x + torch.matmul(a.reshape(B, S, H * Dh), lp["self"]["wo"])
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        q = torch.matmul(h, lp["cross"]["wq"]).reshape(B, S, H, Dh)
        q = apply_rope(q, tfm._positions(S, pos, x.device), cfg.rope_theta)
        a = chunked_attention(q, cache.k_cross[i], cache.v_cross[i],
                              causal=False)
        x = x + torch.matmul(a.reshape(B, S, H * Dh), lp["cross"]["wo"])
        x = x + encdec._mlp(cfg, lp, rms_norm(x, lp["ln3"], cfg.norm_eps))
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = tfm.logits_fn(cfg, params, h)[:, 0]
    return logits, encdec.EncDecCache(cache.k_self, cache.v_self,
                                      cache.k_cross, cache.v_cross, pos + 1)


def put_in_place(monkeypatch):
    """The functions above in place of the current ones, in the modules
    that call them."""
    for name in ("_project_q", "_attn", "_attn_prompt", "_project_kv",
                 "dense_layer", "logits_fn", "embed_tokens", "chunked_xent",
                 "prefill", "decode_step"):
        monkeypatch.setattr(tfm, name, globals()[name])
    monkeypatch.setattr(moe, "_route", _route)
    monkeypatch.setattr(moe, "_ffn", _ffn)
    monkeypatch.setattr(moe, "moe_ffn_sorted", moe_ffn_sorted)
    monkeypatch.setitem(moe.MOE_IMPLS, "sorted", moe_ffn_sorted)
    monkeypatch.setattr(ssm_mod, "ssm_block", ssm_block)
    for mod, prefix, names in (
            (ssm_mod, "ssm_", ("init_cache", "forward", "lm_loss",
                               "decode_step", "prefill")),
            (hybrid, "hybrid_", ("init_cache", "forward", "lm_loss",
                                 "decode_step", "prefill")),
            (encdec, "encdec_", ("encode", "decode_train", "lm_loss",
                                 "prefill", "decode_step"))):
        for name in names:
            monkeypatch.setattr(mod, name, globals()[prefix + name])
    monkeypatch.setattr(encdec, "_encode", encdec_encode_grad)
    monkeypatch.setattr(encdec, "_mha", _mha)
    monkeypatch.setattr(encdec, "_mlp", _mlp)
