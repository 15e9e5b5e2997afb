"""Model FLOPs of the MoE transformer, from the configuration's widths:
every matrix product a token needs (attention projections, the router,
its ``top_k`` experts' SwiGLU), attention over the keys each query sees,
and the output head at the positions whose logits are asked for (the
last of each prompt; every token in a decode step).  Two FLOPs a
multiply-add; norms, softmax and the routing's sort are not counted."""


def _per_token(arch: dict) -> int:
    D, H, Hkv, Dh = (arch["d_model"], arch["n_heads"], arch["n_kv_heads"],
                     arch["head_dim"])
    proj = 2 * D * (H * Dh + 2 * Hkv * Dh) + 2 * H * Dh * D
    router = 2 * D * arch["n_experts"]
    experts = arch["top_k"] * 3 * 2 * D * arch["moe_d_ff"]
    return proj + router + experts


def prefill(arch: dict, B: int, S: int) -> int:
    attn = 2 * B * arch["n_heads"] * arch["head_dim"] * S * (S + 1)
    head = 2 * B * arch["d_model"] * arch["vocab"]
    return arch["n_layers"] * (B * S * _per_token(arch) + attn) + head


def decode(arch: dict, B: int, keys: int) -> int:
    """One step of ``B`` tokens, each attending over ``keys`` positions."""
    attn = 4 * B * arch["n_heads"] * arch["head_dim"] * keys
    head = 2 * B * arch["d_model"] * arch["vocab"]
    return arch["n_layers"] * (B * _per_token(arch) + attn) + head
