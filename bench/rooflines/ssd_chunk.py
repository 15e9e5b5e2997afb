"""B6, ``kernels/ssd_chunk.py``: one chunk of the SSD scan for every
(row, head), one launch a chunk of a Mamba2 block of a prefill
(``ceil(S / Q)`` a block: a last chunk is padded to ``Q``).

Operations, as the SSD algorithm needs them for a chunk: ``C B^T`` once a
row (``2 Q^2 N``), its decay-masked product with ``x`` a head (``2 Q^2
P``), the carried state's contribution to ``y`` and the new state (``2 Q P
N`` each); against the TF32 peak, the highest of the float32 class, so
that no scheme reads above it.  Bytes: ``x``, ``dt``, ``B``, ``C``, the
cumulative decay and the state read once, ``y`` and the new state written
once, float32."""

KERNELS = ("sc_ssd_chunk",)
PEAK = "tf32"


def cost(arch: dict, B: int):
    d_inner = arch["ssm_expand"] * arch["d_model"]
    P, N, Q = arch["ssm_head_dim"], arch["ssm_state"], arch["ssm_chunk"]
    H = d_inner // P
    flops = 2 * B * Q * Q * N + 2 * B * H * Q * Q * P + 4 * B * H * Q * P * N
    bytes_ = 4 * (2 * B * H * Q * P + 2 * B * H * Q + 2 * B * Q * N
                  + 2 * B * H * P * N)
    return flops, bytes_


def calls(arch: dict, family: str, record: dict):
    Q = arch["ssm_chunk"]
    return [cost(arch, B) for B, S in record.get("batches", ())
            for _ in range(arch["n_layers"] * -(-S // Q))]
