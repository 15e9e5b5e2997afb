"""Roofline analysis of the dry-run cells on the NVIDIA H100.

For every dry-run cell, the three roofline terms per device:

    compute    = FLOPs_per_device / PEAK_FLOPS      (bf16 matmul, measured)
    memory     = HBM_bytes_per_device / HBM_BW      (device copy, measured)
    collective = collective_bytes_per_device / LINK_BW   (NVLink, data sheet)

``PEAK_FLOPS`` and ``HBM_BW`` are what ``chip_smoke.py``'s
``roofline_probe`` measured on the card (a bf16 ``torch.matmul`` of 8192^3
and a 4 GiB device copy); the data sheet's figures stand beside them.
One card cannot measure a link, so ``LINK_BW`` is the data sheet's.

The three terms come from ANALYTIC models that are exact by construction
given this framework's own sharding policy, as in the JAX package.
MODEL_FLOPS = 6*N*D (train) / 2*N_active*D (serve) is the useful-work
yardstick; MODEL/executed exposes remat + attention overhead.  The JAX
package also keeps a census of each compiled XLA loop body
(``extrapolated_census``, the ``hlo_*`` fields) as a cross-check; this
package compiles nothing ahead of time, so it has no census, and its
entries carry no ``hlo_*`` field.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dryrun-json results/torch/dryrun_singlepod.json \\
        --out results/torch/roofline.json
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Any, Dict, Optional

# Measured by chip_smoke.py's roofline_probe on an NVIDIA H100 80GB HBM3 at
# a 700 W power limit: a bf16 matmul of 8192^3 at 750.51 TFLOP/s, a 4 GiB
# device copy at 3048.37 GB/s (the data sheet: 989e12 dense bf16, 3.35e12
# HBM3).
PEAK_FLOPS = 750.51e12  # bf16 FLOP/s a device
HBM_BW = 3.04837e12     # bytes/s a device
# NVLink 4 of the H100 SXM, the data sheet's 900 GB/s a GPU both ways
# together: 450 GB/s each way.  Not measured: one card has no link.
LINK_BW = 450e9
HBM_BYTES = 80e9       # an H100's 80 GB

from ..configs import SHAPES, get_arch
from ..configs.base import ArchConfig, ShapeConfig
from ..models import get_model, param_shapes
from .mesh import make_production_mesh


# ---------------------------------------------------------------------------
# Parameter counts / analytic FLOPs
# ---------------------------------------------------------------------------


def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    flat: Dict[str, float] = {}

    def walk(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{p}/{k}")
        else:
            flat[p] = float(t.numel())

    walk(param_shapes(get_model(cfg)))
    total = sum(flat.values())
    expert = sum(v for k, v in flat.items() if "/we_" in k)
    if cfg.n_experts:
        active = total - expert + expert * cfg.top_k / cfg.n_experts
    else:
        active = total
    return {"total": total, "active": active, "expert": expert}


def analytic_flops(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Executed + useful FLOPs for one step (GLOBAL, all devices)."""
    pc = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        ctx = shape.seq_len / 2
        fwd_mult, train_mult = 1.0, 3.0      # fwd + 2x bwd
        remat_mult = 4.0 / 3.0               # full remat re-forward
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        ctx = shape.seq_len / 2
        fwd_mult, train_mult, remat_mult = 1.0, 1.0, 1.0
    else:  # decode: one token against a seq_len context
        tokens = shape.global_batch * 1
        ctx = shape.seq_len
        fwd_mult, train_mult, remat_mult = 1.0, 1.0, 1.0

    matmul = 2.0 * pc["active"] * tokens
    # attention score+AV flops per token ~ 4 * ctx * H * Dh per attn layer
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        n_attn = cfg.n_layers * (2 if cfg.family == "encdec" else 1)
        eff_ctx = ctx
        if cfg.sliding_window and cfg.local_global_ratio:
            r = cfg.local_global_ratio
            eff_ctx = (r * min(ctx, cfg.sliding_window) + ctx) / (r + 1)
        attn = 4.0 * eff_ctx * cfg.n_heads * cfg.hd * tokens * n_attn
    elif cfg.family == "hybrid":
        sites = max(1, cfg.n_layers // max(1, cfg.hybrid_period))
        attn = 4.0 * ctx * cfg.n_heads * cfg.hd * tokens * sites
        # SSD chunk flops ~ 2*Q*(N+P) + state update per token per layer
        d_inner = cfg.ssm_expand * cfg.d_model
        attn += tokens * cfg.n_layers * (
            2 * cfg.ssm_chunk * d_inner + 4 * d_inner * cfg.ssm_state)
    else:  # ssm
        d_inner = cfg.ssm_expand * cfg.d_model
        attn = tokens * cfg.n_layers * (
            2 * cfg.ssm_chunk * d_inner + 4 * d_inner * cfg.ssm_state)

    executed = (matmul + attn) * train_mult * remat_mult * fwd_mult
    useful = 6.0 * pc["active"] * tokens if shape.kind == "train" \
        else 2.0 * pc["active"] * tokens
    return {"executed": executed, "model_flops": useful,
            "params_total": pc["total"], "params_active": pc["active"]}


# ---------------------------------------------------------------------------
# Roofline assembly
# ---------------------------------------------------------------------------


def analytic_traffic(cfg: ArchConfig, shape: ShapeConfig, chips: int,
                     n_model: int, n_data: int, fsdp: bool
                     ) -> Dict[str, float]:
    """Per-device HBM bytes + collective bytes for one step, derived from
    the sharding policy this framework installs (``parallel/sharding.py``
    + ``launch/dryrun.make_policy``).  All sizes bf16 unless stated."""
    pc = param_counts(cfg)
    D = cfg.d_model
    F = cfg.d_ff or 1
    L = cfg.n_layers
    train = shape.kind == "train"
    decode = shape.kind in ("decode", "long_decode")

    tokens_loc = shape.global_batch * (1 if decode else shape.seq_len) \
        / max(chips // n_model, 1)
    params_loc_model = pc["total"] * 2.0 / n_model          # bf16
    params_loc_full = pc["total"] * 2.0 / chips if fsdp else params_loc_model

    hbm = 0.0
    coll = 0.0
    # --- parameters ---------------------------------------------------------
    reads = 3.0 if train else 1.0            # fwd + remat-refwd + bwd
    hbm += params_loc_full * reads
    if fsdp:
        # FSDP: AG the layer's params from the data axis, fwd+bwd
        coll += params_loc_model * (2.0 if train else 1.0)
    if train:
        # optimizer: m, v, master fp32 read+write (ZeRO-1: /chips)
        hbm += pc["total"] * 12.0 * 2.0 / chips
        # gradient reduction over data (+pod): RS+AG ~ 2x local param bytes
        coll += params_loc_model * 2.0

    # --- activations ---------------------------------------------------------
    act_mult = 3.0 if train else 1.0         # fwd + remat + bwd traffic
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        n_blk = L * (2 if cfg.family == "encdec" else 1)
        # gathered block inputs (r+w) + projections + mlp tiles (sharded)
        per_layer = tokens_loc * 2.0 * (6 * D + 3 * F / n_model
                                        + 2 * cfg.n_heads * cfg.hd / n_model)
        hbm += per_layer * n_blk * act_mult
        if not decode:
            # SP: AG block inputs (x2 per layer) + RS residual (x2)
            coll += tokens_loc * D * 2.0 * 4 * n_blk * act_mult / 2
        # attention KV streaming (flash-style): K+V read once per q-block
        if not decode:
            n_qblk = max(1, shape.seq_len // 512)
            kv_bytes = (shape.seq_len * 2 * cfg.n_kv_heads * cfg.hd * 2.0
                        * shape.global_batch / chips)
            eff = 1.0
            if cfg.sliding_window and cfg.local_global_ratio:
                r = cfg.local_global_ratio
                eff = (r * min(1.0, cfg.sliding_window / shape.seq_len)
                       + 1) / (r + 1)
            hbm += kv_bytes * n_qblk * n_blk / L * L * eff * act_mult / 3
    else:  # ssm / hybrid: channel-sharded
        d_inner = cfg.ssm_expand * D
        per_layer = tokens_loc * 2.0 * (4 * D + 4 * d_inner / n_model)
        hbm += per_layer * L * act_mult
        if not decode:
            # channel-sharded residual: AR of partial sums per layer
            coll += tokens_loc * D * 2.0 * 2 * L * act_mult / 2
        if cfg.family == "hybrid":
            sites = max(1, L // max(1, cfg.hybrid_period))
            coll += tokens_loc * D * 2.0 * 4 * sites * act_mult / 2

    # --- MoE ------------------------------------------------------------------
    if cfg.n_experts and not decode:
        # a2a-style combine: reduce-scatter of (tokens_loc, D) fp32 a layer
        coll += tokens_loc * D * 4.0 * L * act_mult

    # --- logits / embedding ---------------------------------------------------
    if not decode:
        hbm += tokens_loc * cfg.vocab * 4.0 / n_model        # logits chunks
        coll += tokens_loc * 4.0 * 2                         # lse all-reduce
    else:
        hbm += shape.global_batch / max(chips // n_model, 1) \
            * cfg.vocab * 4.0 / n_model

    # --- decode cache streaming ----------------------------------------------
    if decode:
        # the baseline reads the full cache every step (window masking does
        # not reduce HBM reads); the windowed ideal lives in _cache_bytes
        # and is the min-bytes yardstick
        hbm += _cache_bytes(cfg, shape, windowed=False) / chips
        coll += tokens_loc * D * 2.0 * L * 2                 # tiny partial ARs

    return {"hbm_bytes": hbm, "coll_bytes": coll}


def _cache_bytes(cfg: ArchConfig, shape: ShapeConfig,
                 windowed: bool = True) -> float:
    """Global bytes a decode step must stream from the cache.

    windowed=True gives the information-theoretic minimum (local layers
    read only their window -- what the ring cache achieves); windowed=False
    is what the baseline full-buffer layout reads."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        return cfg.n_layers * B * H * cfg.ssm_head_dim * cfg.ssm_state * 4.0
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        sites = max(1, cfg.n_layers // max(1, cfg.hybrid_period))
        return (cfg.n_layers * B * H * cfg.ssm_head_dim * cfg.ssm_state * 4.0
                + sites * B * S * 2 * cfg.n_kv_heads * cfg.hd * 2.0)
    n_attn = cfg.n_layers * (2 if cfg.family == "encdec" else 1)
    eff_S = S
    if windowed and cfg.sliding_window and cfg.local_global_ratio:
        r = cfg.local_global_ratio
        eff_S = (r * min(S, cfg.sliding_window) + S) / (r + 1)
    return n_attn * B * eff_S * 2 * cfg.n_kv_heads * cfg.hd * 2.0


BOTTLENECK_NOTES = {
    "compute": "raise arithmetic intensity per chip (bigger per-chip tiles, "
               "less remat re-forward) or spread model FLOPs wider",
    "memory": "cut HBM traffic: fuse/reuse (flash-style blocks), shrink KV "
              "(windowed cache, quantization), avoid re-reading weights",
    "collective": "reshape the layout: fewer gathered dims, bigger per-hop "
                  "payloads, overlap collectives with compute, or compress",
}


def analyze_cell(entry: Dict[str, Any], mesh, chips: int
                 ) -> Optional[Dict[str, Any]]:
    """The roofline of one ``dryrun.lower_cell`` entry on ``mesh``'s
    ``chips`` devices (None for a skipped or failed cell)."""
    if "error" in entry or "skipped" in entry:
        return None
    arch, shape_name = entry["arch"], entry["shape"]
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    af = analytic_flops(cfg, shape)
    n_model = mesh.shape["model"]
    n_data = mesh.shape.get("data", 1)
    pbytes = af["params_total"] * 2 / n_model
    fsdp = pbytes > 2 * 2**30

    traffic = analytic_traffic(cfg, shape, chips, n_model, n_data, fsdp)

    t_compute = af["executed"] / chips / PEAK_FLOPS
    t_memory = traffic["hbm_bytes"] / HBM_BW
    t_collective = traffic["coll_bytes"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    mfu = (af["model_flops"] / chips / PEAK_FLOPS) / max(step_time, 1e-30)
    # decode cells are bandwidth-limited by construction: the honest
    # roofline fraction is min-bytes / achieved-bytes, where min-bytes =
    # params + *windowed* cache streamed exactly once per step
    if shape.kind in ("decode", "long_decode"):
        min_bytes_pc = (af["params_active"] * 2
                        + _cache_bytes(cfg, shape, windowed=True)) / chips
        mfu = min(min_bytes_pc / max(traffic["hbm_bytes"], 1.0), 1.0)
    return {
        "arch": arch, "shape": shape_name,
        "compute_s": t_compute, "memory_s": t_memory,
        "collective_s": t_collective,
        "dominant": dominant,
        "model_flops": af["model_flops"],
        "executed_flops": af["executed"],
        "analytic_hbm_bytes_per_chip": traffic["hbm_bytes"],
        "analytic_coll_bytes_per_chip": traffic["coll_bytes"],
        "useful_ratio_model_over_executed": (
            af["model_flops"] / max(af["executed"], 1.0)),
        "roofline_fraction": min(mfu, 1.0),
        "note": BOTTLENECK_NOTES[dominant],
        "argument_gib": entry["memory"]["bytes_per_device_argument"] / 2**30,
        "fsdp": fsdp,
        "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-json",
                    default="results/torch/dryrun_singlepod.json")
    ap.add_argument("--out", default="results/torch/roofline.json")
    ap.add_argument("--only", default=None, help="arch:shape filter")
    args = ap.parse_args(argv)

    with open(args.dryrun_json) as f:
        entries = json.load(f)
    mesh = make_production_mesh(multi_pod=False)
    chips = mesh.size
    rows = []
    for e in entries:
        if "skipped" in e or "error" in e:
            continue
        if args.only:
            a, s = args.only.split(":")
            if not (e["arch"] == a and e["shape"] == s):
                continue
        t0 = time.time()
        try:
            r = analyze_cell(e, mesh, chips)
        except Exception:
            traceback.print_exc()
            r = None
        if r:
            rows.append(r)
            print(f"{r['arch']:16s} {r['shape']:12s} "
                  f"comp={r['compute_s']*1e3:9.3f}ms "
                  f"mem={r['memory_s']*1e3:9.3f}ms "
                  f"coll={r['collective_s']*1e3:9.3f}ms "
                  f"dom={r['dominant']:10s} "
                  f"frac={r['roofline_fraction']*100:5.1f}% "
                  f"({time.time()-t0:.0f}s)")
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {args.out} ({len(rows)} cells)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
