"""The port's model functions that tensor parallelism changed, as they
stood before it, for holding the whole-weights paths to them bit for bit
(``tests/test_torch_tensor_parallel.py`` puts them in place of the
current ones with ``monkeypatch``).

Copies of the earlier bodies, with the current modules' helpers that did
not change; ``embed_tokens`` takes (and ignores) the ``vocab`` that its
callers now pass.  Imports ``torch`` and the port only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_rope, chunked_attention, remat,
                                       rms_norm, swiglu)
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
