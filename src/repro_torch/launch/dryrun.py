"""Dry-run of every (arch x shape x mesh) cell, on the host.

For each cell this builds the step's inputs as shapes on the ``meta``
device (nothing is allocated), gives each its partition spec from the
banking-solver bridge (``parallel/sharding.py``) on a production mesh
description (``launch/mesh.py``), and records

* the exact **per-device bytes** of parameters, optimizer state, cache
  and batch, from the shard shapes the specs give (a dim cut over axes of
  sizes n1, n2 keeps ceil(dim / (n1 * n2)) rows, what a padded shard
  holds);
* the analytic FLOPs and HBM / collective traffic of
  ``launch/roofline.py``;
* whether the arguments fit one H100's 80 GB.

The JAX package lowers and compiles each cell for 512 host devices and
reads XLA's memory and cost analyses and a census of the collectives in
the compiled HLO.  This package compiles nothing ahead of time, so those
fields are absent: ``flops`` here is the analytic executed FLOPs a device,
and ``memory`` holds the argument bytes alone (no temporaries).  Keys keep
the JAX package's names where the meaning matches.

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --out results/torch
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import ARCH_IDS, SHAPES, _ALIASES, get_arch
from ..configs.base import ArchConfig, ShapeConfig
from ..models import get_model, param_shapes
from ..optim import adamw
from ..parallel import sharding as shd
from ..parallel.sharding import P, PartitionSpec
from . import roofline
from .mesh import make_production_mesh


def make_policy(cfg: ArchConfig, shape: ShapeConfig, mesh
                ) -> Dict[str, Any]:
    """Activation-sharding policy per cell (see parallel/hints.py).

    Attention families run Megatron-SP: residual stream sequence-sharded
    over 'model', block inputs gathered.  SSM/hybrid shard the residual on
    channels instead (the SSD chunk scan cannot have a sharded leading
    axis).  Decode shapes leave activations as they are (seq == 1).
    """
    dp = shd.dp_axes(mesh)
    pol: Dict[str, Any] = {"expert_buffer": P("model", None, None)}
    if shape.kind in ("train", "prefill"):
        if cfg.family in ("ssm", "hybrid"):
            pol["residual"] = P(dp, None, "model")
        else:
            pol.update(shd.sequence_parallel_layout(mesh))
        pol["logits"] = P(dp, None, "model")
    return pol


SKIPS: Dict[tuple, str] = {}
for _a in ["deepseek_67b", "qwen2_7b", "internlm2_20b", "chameleon_34b",
           "llama4_maverick", "olmoe_1b_7b", "whisper_base"]:
    SKIPS[(_a, "long_500k")] = (
        "pure full attention (or unmodelled chunked variant): long_500k "
        "needs sub-quadratic attention -- skip per assignment, DESIGN.md "
        "Arch-applicability")


@dataclass(frozen=True)
class Struct:
    """A tensor's global shape, dtype and partition spec (the JAX
    package's ``ShapeDtypeStruct`` with a ``NamedSharding``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: PartitionSpec

    def local_shape(self, axes: Dict[str, int]) -> Tuple[int, ...]:
        out = []
        for d, n in enumerate(self.shape):
            entry = self.spec[d] if d < len(self.spec) else None
            k = 1
            if entry is not None:
                for a in ((entry,) if isinstance(entry, str) else entry):
                    k *= axes[a]
            out.append(-(-n // k))
        return tuple(out)

    def local_bytes(self, axes: Dict[str, int]) -> int:
        n = 1
        for d in self.local_shape(axes):
            n *= d
        return n * self.dtype.itemsize


def _tree_structs(shape_tree, spec_tree):
    """Structs over a tree of meta tensors (an ``int`` leaf is a 0-d
    int32, the JAX package's scalar ``pos``) and a spec tree like it."""
    if isinstance(shape_tree, dict):
        return {k: _tree_structs(v, spec_tree[k])
                for k, v in shape_tree.items()}
    if hasattr(shape_tree, "_fields"):
        return type(shape_tree)(*(
            _tree_structs(getattr(shape_tree, k), getattr(spec_tree, k))
            for k in shape_tree._fields))
    if isinstance(shape_tree, torch.Tensor):
        return Struct(tuple(shape_tree.shape), shape_tree.dtype, spec_tree)
    return Struct((), torch.int32, spec_tree)


def tree_bytes(structs, axes: Dict[str, int]) -> int:
    """Bytes a device holds of a tree of :class:`Struct`."""
    if isinstance(structs, Struct):
        return structs.local_bytes(axes)
    if isinstance(structs, dict):
        return sum(tree_bytes(v, axes) for v in structs.values())
    return sum(tree_bytes(v, axes) for v in structs)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh
                ) -> Dict[str, Struct]:
    """Structs of the data batch of one step."""
    b, s = shape.global_batch, shape.seq_len
    bs = shd.batch_specs(cfg, shape, mesh)
    out = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = Struct((b, s), torch.int32, bs["tokens"])
        if shape.kind == "train":
            out["labels"] = Struct((b, s), torch.int32, bs["labels"])
        if cfg.family == "encdec":
            out["frames"] = Struct((b, s, cfg.d_model), torch.bfloat16,
                                   bs["frames"])
    else:  # decode / long_decode: one new token against a seq_len cache
        out["tokens"] = Struct((b, 1), torch.int32,
                               P(bs["tokens"][0], None))
    return out


def cache_structs(cfg: ArchConfig, shape: ShapeConfig, mesh):
    if cfg.family == "encdec":
        from ..models.encdec import EncDecCache
        L, B, Hkv, Dh = (cfg.n_layers, shape.global_batch, cfg.n_kv_heads,
                         cfg.hd)
        kv = torch.empty((L, B, shape.seq_len, Hkv, Dh),
                         dtype=torch.bfloat16, device="meta")
        shapes = EncDecCache(k_self=kv, v_self=kv, k_cross=kv, v_cross=kv,
                             pos=0)
    else:
        shapes = get_model(cfg).init_cache(shape.global_batch,
                                           shape.seq_len, device="meta")
    return _tree_structs(shapes, shd.cache_specs(cfg, shape, mesh))


def params_structs(cfg: ArchConfig, mesh, fsdp: bool):
    shapes = param_shapes(get_model(cfg))
    specs = shd.param_specs(shapes, mesh, fsdp=fsdp)
    return _tree_structs(shapes, specs), specs


def default_fsdp(cfg: ArchConfig, mesh) -> bool:
    """The cell's rule: parameters cut over ``model`` only, unless the
    bf16 copy would not fit comfortably a device (more than 2 GiB after
    the ``model`` cut) -- then over the data axis too (FSDP / ZeRO-3)."""
    pbytes = sum(t.numel() * t.dtype.itemsize for t in
                 adamw.tree_leaves(param_shapes(get_model(cfg))))
    return pbytes / shd.mesh_axes(mesh)["model"] > 2 * 2**30


def param_bytes_per_device(cfg: ArchConfig, mesh,
                           fsdp: Optional[bool] = None) -> int:
    """``bytes_per_device_params`` of a (config, mesh) pair without a
    whole cell: the bytes of one device's blocks of the parameters under
    ``param_specs`` (``fsdp`` by :func:`default_fsdp` unless given) --
    what a rank of a tensor-parallel model holds."""
    if fsdp is None:
        fsdp = default_fsdp(cfg, mesh)
    return tree_bytes(params_structs(cfg, mesh, fsdp=fsdp)[0],
                      shd.mesh_axes(mesh))


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def lower_cell(arch: str, shape_name: str, mesh, *,
               fsdp: Optional[bool] = None, variant: str = "baseline",
               bf16_opt: bool = False) -> Dict[str, Any]:
    """One cell's per-device bytes and analytic roofline inputs.

    variant: baseline | moe_a2a (the expert-parallel MoE layer, a live
    mesh in the policy) | ring_cache (windowed local-layer KV rings --
    local:global archs) | int8_kv (the int8 KV cache)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    axes = shd.mesh_axes(mesh)
    t0 = time.time()
    if fsdp is None:
        # optimizer state is always data+model cut (ZeRO-1)
        fsdp = default_fsdp(cfg, mesh)

    policy = make_policy(cfg, shape, mesh)
    if variant == "moe_a2a":
        policy["__mesh__"] = mesh
        policy["__fsdp__"] = fsdp
    from ..models import transformer as tfm

    p_structs, _ = params_structs(cfg, mesh, fsdp=fsdp)
    opt_structs = cache = None
    batch = input_specs(cfg, shape, mesh)
    if variant == "ring_cache":
        if shape.kind not in ("decode", "long_decode"):
            raise ValueError("ring_cache is a decode variant")
        cache = _tree_structs(
            tfm.init_grouped_cache(cfg, shape.global_batch, shape.seq_len,
                                   device="meta"),
            shd.ring_cache_specs(cfg, shape, mesh))
    elif variant == "int8_kv":
        if shape.kind not in ("decode", "long_decode"):
            raise ValueError("int8_kv is a decode variant")
        cache = _tree_structs(
            tfm.init_quant_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta"),
            shd.quant_cache_specs(cfg, shape, mesh))
    elif shape.kind == "train":
        moment_dt = torch.bfloat16 if bf16_opt else torch.float32
        opt_shapes = adamw.init(param_shapes(get_model(cfg)), moment_dt)
        zaxes = ("data", "pod")  # ZeRO across every pure-DP axis
        opt_specs = adamw.AdamWState(
            step=P(),
            m=shd.param_specs(opt_shapes.m, mesh, fsdp=True,
                              fsdp_axes=zaxes),
            v=shd.param_specs(opt_shapes.v, mesh, fsdp=True,
                              fsdp_axes=zaxes),
            master=shd.param_specs(opt_shapes.master, mesh, fsdp=True,
                                   fsdp_axes=zaxes))
        opt_structs = _tree_structs(opt_shapes, opt_specs)
    elif shape.kind in ("decode", "long_decode"):
        cache = cache_structs(cfg, shape, mesh)

    chips = 1
    for n in axes.values():
        chips *= n
    af = roofline.analytic_flops(cfg, shape)
    traffic = roofline.analytic_traffic(cfg, shape, chips, axes["model"],
                                        axes.get("data", 1), fsdp)
    memory = {
        "bytes_per_device_params": tree_bytes(p_structs, axes),
        "bytes_per_device_optimizer": (tree_bytes(opt_structs, axes)
                                       if opt_structs is not None else 0),
        "bytes_per_device_cache": (tree_bytes(cache, axes)
                                   if cache is not None else 0),
        "bytes_per_device_batch": tree_bytes(batch, axes),
    }
    memory["bytes_per_device_argument"] = sum(memory.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": dict(axes),
        "variant": variant, "fsdp": fsdp,
        "lower_s": time.time() - t0,
        "flops": af["executed"] / chips,
        "model_flops": af["model_flops"] / chips,
        "hbm_bytes": traffic["hbm_bytes"],
        "coll_bytes": traffic["coll_bytes"],
        "memory": memory,
        "fits_hbm": memory["bytes_per_device_argument"] <= roofline.HBM_BYTES,
        "policy": {k: _spec_json(v) for k, v in policy.items()
                   if isinstance(v, PartitionSpec)},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "moe_a2a", "ring_cache", "int8_kv"])
    ap.add_argument("--bf16-opt", action="store_true",
                    help="bf16 Adam moments (halves optimizer HBM)")
    ap.add_argument("--out", default=None,
                    help="directory for dryrun_singlepod.json / "
                         "dryrun_multipod.json")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        arch = _ALIASES.get(args.arch,
                            args.arch.replace("-", "_").replace(".", "_"))
        cells = [(arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        results = []
        for arch, shape_name in cells:
            tag = (f"{arch} x {shape_name} x "
                   f"{'2x16x16' if multi_pod else '16x16'}")
            if (arch, shape_name) in SKIPS:
                print(f"SKIP  {tag}: {SKIPS[(arch, shape_name)]}")
                results.append({"arch": arch, "shape": shape_name,
                                "skipped": SKIPS[(arch, shape_name)]})
                continue
            try:
                r = lower_cell(arch, shape_name, mesh, variant=args.variant,
                               bf16_opt=args.bf16_opt)
                r["multi_pod"] = multi_pod
                results.append(r)
                mem = r["memory"]["bytes_per_device_argument"]
                print(f"OK    {tag}: flops={r['flops']:.3e} "
                      f"args={mem / 2**30:.2f}GiB "
                      f"fits={r['fits_hbm']} fsdp={r['fsdp']}")
            except Exception as e:
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape_name,
                                "multi_pod": multi_pod,
                                "error": str(e)[:500]})
                print(f"FAIL  {tag}: {e}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(args.out, "dryrun_multipod.json" if multi_pod
                                else "dryrun_singlepod.json")
            with open(path, "w") as f:
                json.dump(results, f, indent=1)
            print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
