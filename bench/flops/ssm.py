"""Model FLOPs of the Mamba2 language model, from the configuration's
widths.  A block a token: the input projection, the depthwise
convolution, the recurrence (``5 H P N``: decay, input and output of the
state; the chunked form's extra work is the implementation's, not the
model's) and the output projection.  The output head at the last position
of each prompt (every token in a decode step).  Two FLOPs a multiply-add;
norms, the gate and the softplus are not counted."""


def _per_token(arch: dict) -> int:
    D, N = arch["d_model"], arch["ssm_state"]
    d_inner = arch["ssm_expand"] * D
    H = d_inner // arch["ssm_head_dim"]
    conv_dim = d_inner + 2 * N
    return (2 * D * (2 * d_inner + 2 * N + H) + 2 * arch["ssm_conv"] * conv_dim
            + 5 * d_inner * N + 2 * d_inner * D)


def prefill(arch: dict, B: int, S: int) -> int:
    head = 2 * B * arch["d_model"] * arch["vocab"]
    return B * S * arch["n_layers"] * _per_token(arch) + head


def decode(arch: dict, B: int, keys: int) -> int:
    """One step of ``B`` tokens (the state is the same size whatever
    ``keys``)."""
    head = 2 * B * arch["d_model"] * arch["vocab"]
    return B * arch["n_layers"] * _per_token(arch) + head
