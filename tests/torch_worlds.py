"""Worlds of processes for the port's multi-device side.

:func:`run_world` starts one process a rank, each given its rank on the
command line, waits for all of them within a time limit, and kills the
rest when one fails or the limit passes: a rank that fails or hangs fails
the world.  :func:`init_rank` joins such a process to its ``gloo`` process
group through a file under the caller's directory (no port is taken, so
worlds of parallel test workers never clash), with a timeout on every
collective.

Run as a script, this module is one rank of the CPU tests' worlds:

    python tests/torch_worlds.py ENTRY RANK WORLD INIT_FILE OUT_DIR

where ENTRY names a function of :data:`ENTRIES`.  It imports ``torch`` and
the port only (neither JAX nor the JAX package), so a rank starts fast;
``chip_smoke.py`` launches its own ranks on the card through
:func:`run_world` too.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANK_TIMEOUT_S = 120       # a collective that waits longer fails the rank


def run_world(argv_of_rank, world, *, timeout=300, env=None):
    """Run ``argv_of_rank(r)`` for every rank ``r`` of ``world`` at once.
    Returns ``[(returncode, stdout, stderr)]`` by rank; raises
    ``RuntimeError`` (with every rank's end of stderr) when a rank fails
    or the world outlasts ``timeout`` seconds.  No process is left."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(argv_of_rank(r), cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = [None] * world
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} of {world} outlasted "
                                   f"{timeout} s")
            outs[r] = (p.returncode, out, err)
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {world} exited "
                                   f"{p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return outs


def init_rank(rank, world, init_file):
    """Join the world's gloo process group (file rendezvous, a timeout on
    every collective)."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method="file://" + os.path.abspath(init_file),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))


def python_rank(entry, world, tmp_path):
    """``argv_of_rank`` for an entry of this module, writing under
    ``tmp_path``."""
    init = os.path.join(str(tmp_path), f"pg_{entry}")
    return lambda r: [sys.executable, os.path.join(HERE, "torch_worlds.py"),
                      entry, str(r), str(world), init, str(tmp_path)]


# ---------------------------------------------------------------------------
# The CPU tests' ranks: inputs from OUT_DIR/inputs.npz, results to
# OUT_DIR/<entry>_<rank>.npz (arrays) or .json
# ---------------------------------------------------------------------------


def _inputs(out):
    with np.load(os.path.join(out, "inputs.npz")) as z:
        return {k: z[k] for k in z.files}


def rank_pipeline(rank, world, out):
    """The tanh stack through ``pipeline_apply`` over every rank, the
    placements of a 2x2 mesh and a hint's redistribution."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.hints import hint, sharding_policy
    from repro_torch.parallel.pipeline import pipeline_apply

    inp = _inputs(out)
    Ws = torch.from_numpy(inp["pipe_w"])
    x = torch.from_numpy(inp["pipe_x"])

    def stage_fn(params, h):          # params (L_per, D, D)
        for w in params:
            h = torch.tanh(h @ w)
        return h

    got = pipeline_apply(stage_fn, Ws, x)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))
    full = torch.arange(16.0).reshape(4, 4)
    joint = distribute_tensor(full, mesh, list(shd.placements(
        shd.P(("data", "model"), None), mesh)))
    cols = distribute_tensor(full, mesh, list(shd.placements(
        shd.P(None, "model"), mesh)))
    with sharding_policy({"residual": shd.P("data", None)}):
        moved = hint(cols, "residual")
        plain = hint(full, "residual")
    np.savez(os.path.join(out, f"pipeline_{rank}.npz"), got=got.numpy(),
             joint=joint.to_local().numpy(),
             coord=np.asarray(mesh.get_coordinate()),
             moved=moved.to_local().numpy(),
             moved_full=moved.full_tensor().numpy(),
             plain_is_same=np.asarray(plain is full))


def rank_pair(rank, world, out):
    """On two ranks: the compressed gradient mean (the same gradients on
    both ranks, then each rank's own, over two steps of error feedback),
    the expert-parallel MoE layer over a model axis of 2 and with its
    weights cut over a data axis of 2 (FSDP), and the elastic restore onto
    meshes of 1 and 2."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.convert import for_ranks, params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.collectives import compressed_grad_mean
    from repro_torch.parallel.hints import layer_blocks, sharding_policy

    inp = _inputs(out)
    res = {}

    def grads(prefix):
        return {"a": torch.from_numpy(inp[prefix + "a"]),
                "b": {"c": torch.from_numpy(inp[prefix + "c"])}}

    same = grads("g0_")
    zeros = {"a": torch.zeros_like(same["a"]),
             "b": {"c": torch.zeros_like(same["b"]["c"])}}
    m, r = compressed_grad_mean(same, zeros, None)
    res.update(same_mean_a=m["a"], same_mean_c=m["b"]["c"],
               same_res_a=r["a"], same_res_c=r["b"]["c"])
    own = grads(f"g{rank}_")
    m1, r1 = compressed_grad_mean(own, zeros, None)
    m2, r2 = compressed_grad_mean(own, r1, None)
    res.update(own_mean1_a=m1["a"], own_mean1_c=m1["b"]["c"],
               own_res1_a=r1["a"], own_res1_c=r1["b"]["c"],
               own_mean2_a=m2["a"], own_mean2_c=m2["b"]["c"],
               own_res2_a=r2["a"], own_res2_c=r2["b"]["c"])

    cfg = get_arch("olmoe_1b_7b").reduced()
    lp = params_from_numpy({k[3:]: v for k, v in inp.items()
                            if k.startswith("lp_")}, device="cpu")
    lp = {k: v.to(torch.bfloat16) if k.startswith("we_") else v
          for k, v in lp.items()}
    mesh = make_host_mesh("cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, world)
    h = torch.from_numpy(inp["moe_h"]).to(torch.bfloat16)
    with sharding_policy({"__mesh__": mesh}):
        y, aux = moe.moe_ffn_a2a(cfg, for_ranks(lp, experts=(rank, world)),
                                 h)
    res.update(moe_out=y.float(), moe_aux=aux)
    # FSDP: every expert on a model axis of 1, each weight cut on its F
    # dim over a data axis of 2, declared so, and gathered for the layer
    # (the stacks' specs: a leading layer dim); a row a rank
    data_mesh = DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                           mesh_dim_names=("data", "model"))
    blk = lp["we_gate"].shape[-1] // world
    f = slice(rank * blk, (rank + 1) * blk)
    cut = {"router": lp["router"], "we_gate": lp["we_gate"][..., f],
           "we_up": lp["we_up"][..., f], "we_down": lp["we_down"][:, f]}
    specs = {"layers": {"router": shd.P(None, None, None),
                        "we_gate": shd.P(None, None, None, "data"),
                        "we_up": shd.P(None, None, None, "data"),
                        "we_down": shd.P(None, None, "data", None)}}
    with sharding_policy({"__mesh__": data_mesh, "__params__": specs}):
        y, aux = moe.moe_ffn_a2a(cfg, layer_blocks(cut), h[rank:rank + 1])
    res.update(fsdp_out=y.float(), fsdp_aux=aux)

    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    template = {"w": torch.zeros(8, 8), "b": torch.zeros(4, 6,
                                                         dtype=torch.bfloat16)}
    groups = [dist.new_group([i]) for i in range(world)]
    one = DeviceMesh.from_group(groups[rank], "cpu",
                                mesh_dim_names=("model",))
    two = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("model",))
    for name, mesh_r in (("one", one), ("two", two)):
        spec_w, spec_b = shd.P("model", None), shd.P(None, "model")
        state, _ = mgr.restore(template, shardings={
            "w": (mesh_r, shd.placements(spec_w, mesh_r)),
            "b": (mesh_r, shd.placements(spec_b, mesh_r))})
        res[f"{name}_w_full"] = state["w"].full_tensor()
        res[f"{name}_b_full"] = state["b"].full_tensor().view(torch.int16)
        res[f"{name}_w_local"] = state["w"].to_local()
        res[f"{name}_b_local"] = state["b"].to_local().view(torch.int16)
    np.savez(os.path.join(out, f"pair_{rank}.npz"),
             **{k: v.detach().numpy() for k, v in res.items()})


def flatten(tree, prefix=""):
    """Nested dicts -> ``{"a/b": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


MESH_MAX_LEN = 24          # the prefill's cache length in the mesh worlds


def rank_mesh_model(rank, world, out):
    """One rank of a ``(world // 2) x 2`` ``("data", "model")`` mesh
    running whole models under the dry-run's policy plus the mesh: for
    each case of OUT_DIR/mesh_cases.json, the loss and its gradients, the
    prefill's logits and cache, and the parameters after one
    ``make_train_step``; for the MoE case also the loss under a policy
    that holds the mesh alone.  The batch rows are this rank's data
    row's; the experts (``a2a``) this rank's share on ``model``, declared
    (``"__params__"``: ``expert_specs``)."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES
    from repro_torch.convert import for_ranks, params_from_numpy
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import get_model, param_shapes
    from repro_torch.optim import adamw
    from repro_torch.parallel.hints import sharding_policy
    from repro_torch.parallel.sharding import expert_specs

    with open(os.path.join(out, "mesh_cases.json")) as f:
        cases = json.load(f)
    inp = _inputs(out)
    n_data = world // 2
    d, m = divmod(rank, 2)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(n_data, 2),
                      mesh_dim_names=("data", "model"))
    res = {}
    for name, case in cases.items():
        cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                                  **case["replace"])
        model = get_model(cfg, moe_impl=case["impl"])

        def fresh():
            flat = {k[len(name) + 3:]: v for k, v in inp.items()
                    if k.startswith(name + "/p/")}
            p = params_from_numpy(unflatten(flat), device="cpu")
            p = adamw.tree_map(
                lambda t, dt: t.to(getattr(torch, dt)), p,
                unflatten(case["dtypes"]))
            if case["impl"] == "a2a":
                p["layers"] = {k: v.clone() for k, v in for_ranks(
                    p["layers"], experts=(m, 2)).items()}
            return p

        B = inp[name + "/tokens"].shape[0] // n_data
        rows = slice(d * B, (d + 1) * B)
        batch = {k: inp[f"{name}/{k}"][rows] for k in ("tokens", "labels")}
        # the experts' cut, declared; every leaf whole elsewhere
        weights = ({"__params__": expert_specs(param_shapes(model))}
                   if case["impl"] == "a2a" else {})
        train = {**make_policy(cfg, SHAPES["train_4k"], mesh),
                 "__mesh__": mesh, **weights}
        prefill = {**make_policy(cfg, SHAPES["prefill_32k"], mesh),
                   "__mesh__": mesh, **weights}
        params = fresh()
        with sharding_policy(train):
            loss, grads = value_and_grad(model, params, batch)
        res[f"{name}/loss"] = loss
        res.update({f"{name}/g/{k}": v for k, v in flatten(grads).items()})
        with sharding_policy(prefill):
            logits, cache = model.prefill(
                params, {"tokens": torch.as_tensor(batch["tokens"])},
                MESH_MAX_LEN)
        res[f"{name}/logits"] = logits
        for field, v in cache._asdict().items():
            if torch.is_tensor(v):
                res[f"{name}/cache/{field}"] = v
        if case["impl"] == "a2a":
            with sharding_policy({"__mesh__": mesh}):
                res[f"{name}/mesh_only_loss"] = model.loss(
                    params, {k: torch.as_tensor(v) for k, v in batch.items()})
        step = make_train_step(model, adamw.AdamWConfig(**case["opt"]))
        with sharding_policy(train):
            loss1, params1, _ = step(params, adamw.init(params), batch)
        res[f"{name}/step_loss"] = loss1
        res.update({f"{name}/s/{k}": v for k, v in flatten(params1).items()})
    np.savez(os.path.join(out, f"mesh_model_{world}_{rank}.npz"),
             **{k: v.detach().float().numpy() for k, v in res.items()})


TP_DECODE_STEPS = 3        # decode steps after the tensor-parallel prefill


def rank_tensor_parallel(rank, world, out):
    """One rank of a ``(world // 2) x 2`` ``("data", "model")`` mesh
    running tensor-parallel models: for each case of
    OUT_DIR/tp_cases.json the reference's weights cut into this rank's
    blocks by ``param_specs`` (``convert.for_ranks``), then under the
    dry-run's policies plus the mesh and the weights' declared cut
    (``"__params__"``) the loss and its gradients, the prefill's logits
    and this rank's share of every tensor of the cache (kv heads; the SSM
    families' conv channels and heads), ``TP_DECODE_STEPS`` serve steps
    fed the tokens of ``<case>/decode_tokens``, and the parameters after
    one ``make_train_step``; beside them the bytes and storage bytes of
    the rank's parameters and the dry-run's bytes a device.  The
    encoder-decoder's batch and prefill take ``<case>/frames`` too.  The
    prefill and serve policies declare the cache's layout
    (``"__cache__"``: ``cache_specs`` of their shapes, the case's
    ``"serve"``); a case that does not ``"train"`` (a batch of one row,
    held whole by every data row) runs the prefill and serve steps
    alone; so does a case with ``"experts"``, whose weights are the
    expert-parallel cut (``expert_specs``), and a case that names its
    ``"worlds"`` runs in those alone.  A case with ``"fsdp"`` cuts the
    weights over ``data`` too
    (``param_specs(..., fsdp=True)``, ZeRO-3) and its optimizer state by
    the dry-run's opt specs (``"__opt__"``, ZeRO-1, with the state's
    bytes and the dry-run's beside them); it then runs again in the same
    processes with the weights whole over ``data`` and the state still
    cut, its outputs under ``<case>/zero1/``."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES
    from repro_torch.convert import for_ranks, params_from_numpy
    from repro_torch.launch.dryrun import (_tree_structs, make_policy,
                                           param_bytes_per_device,
                                           tree_bytes)
    from repro_torch.launch.steps import (make_serve_step, make_train_step,
                                          value_and_grad)
    from repro_torch.models import get_model, param_shapes
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.hints import sharding_policy, state_layout

    with open(os.path.join(out, "tp_cases.json")) as f:
        cases = json.load(f)
    inp = _inputs(out)
    n_data = world // 2
    d = rank // 2
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(n_data, 2),
                      mesh_dim_names=("data", "model"))
    res = {}
    for name, case in cases.items():
        if world not in case.get("worlds", (world,)):
            continue
        cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                                  **case["replace"])
        model = get_model(cfg, moe_impl=case["impl"])
        shapes = param_shapes(model)
        fsdp = case.get("fsdp", False)
        opt = (shd.param_specs(shapes, mesh, fsdp=True,
                               fsdp_axes=("data", "pod")) if fsdp else None)

        def policy(shape, weights, cache=False):
            pol = {**make_policy(cfg, SHAPES[shape], mesh), "__mesh__": mesh,
                   "__params__": weights}
            if cache and not case.get("experts"):   # attention whole
                pol["__cache__"] = shd.cache_specs(cfg, SHAPES[shape], mesh)
            if opt is not None and SHAPES[shape].kind == "train":
                pol["__opt__"] = opt
            return pol

        def fresh(weights):
            flat = {k[len(name) + 3:]: v for k, v in inp.items()
                    if k.startswith(name + "/p/")}
            blocks = for_ranks(unflatten(flat), specs=weights, mesh=mesh,
                               coords=shd.mesh_coords(mesh),
                               head_dim=shd.head_widths(cfg))
            p = params_from_numpy(blocks, device="cpu")
            return adamw.tree_map(lambda t, dt: t.to(getattr(torch, dt)), p,
                                  unflatten(case["dtypes"]))

        B = inp[name + "/tokens"].shape[0]
        # the batch over the data rows, or whole in each where it has
        # fewer rows (the dry-run's batch_specs)
        rows = (slice(d * B // n_data, (d + 1) * B // n_data)
                if B >= n_data else slice(0, B))
        batch = {k: inp[f"{name}/{k}"][rows]
                 for k in ("tokens", "labels", "frames")
                 if f"{name}/{k}" in inp}
        prefill_shape, decode_shape = case.get(
            "serve", ("prefill_32k", "decode_32k"))
        train = case.get("train", True)
        prompt = {k: torch.as_tensor(v) for k, v in batch.items()
                  if k != "labels"}

        def run(key, data_cut):
            weights = (shd.expert_specs(shapes) if case.get("experts") else
                       shd.param_specs(shapes, mesh, fsdp=data_cut))
            params = fresh(weights)
            leaves = adamw.tree_leaves(params)
            res[f"{key}/param_bytes"] = torch.tensor(
                sum(t.numel() * t.element_size() for t in leaves))
            res[f"{key}/storage_bytes"] = torch.tensor(
                sum(t.untyped_storage().nbytes() for t in leaves))
            res[f"{key}/dryrun_bytes"] = torch.tensor(
                param_bytes_per_device(cfg, mesh, fsdp=data_cut))
            res.update({f"{key}/shape/{k}": torch.tensor(v.shape)
                        for k, v in flatten(params).items()})
            if train:
                with sharding_policy(policy("train_4k", weights)):
                    loss, grads = value_and_grad(model, params, batch)
                res[f"{key}/loss"] = loss
                res.update({f"{key}/g/{k}": v
                            for k, v in flatten(grads).items()})
            with sharding_policy(policy(prefill_shape, weights, cache=True)):
                logits, cache = model.prefill(params, prompt, MESH_MAX_LEN)
            res[f"{key}/logits"] = logits
            for field, v in cache._asdict().items():
                if torch.is_tensor(v):      # decoding writes in place
                    res[f"{key}/cache/{field}"] = v.clone()
            serve = make_serve_step(model)
            feed = torch.as_tensor(inp[f"{name}/decode_tokens"][rows])
            with sharding_policy(policy(decode_shape, weights, cache=True)):
                for i in range(TP_DECODE_STEPS):
                    tok, logits, cache = serve(params, cache,
                                               feed[:, i:i + 1])
                    res[f"{key}/decode{i}/logits"] = logits
                    res[f"{key}/decode{i}/tokens"] = tok
            if not train:
                return
            step = make_train_step(model, adamw.AdamWConfig(**case["opt"]))
            with sharding_policy(policy("train_4k", weights)):
                state = adamw.init(params, cuts=state_layout(params))
                loss1, params1, state = step(params, state, batch)
            res[f"{key}/step_loss"] = loss1
            res.update({f"{key}/s/{k}": v
                        for k, v in flatten(params1).items()})
            if opt is not None:
                res[f"{key}/state_bytes"] = torch.tensor(sum(
                    t.numel() * t.element_size()
                    for part in state for t in adamw.tree_leaves(part)))
                meta = adamw.init(shapes)
                res[f"{key}/dryrun_state_bytes"] = torch.tensor(tree_bytes(
                    _tree_structs(meta, adamw.AdamWState(
                        shd.P(), opt, opt, opt)), shd.mesh_axes(mesh)))

        run(name, fsdp)
        if fsdp:
            run(f"{name}/zero1", False)
    np.savez(os.path.join(out, f"tensor_parallel_{world}_{rank}.npz"),
             **{k: v.detach().float().numpy() if v.is_floating_point()
                else v.numpy() for k, v in res.items()})


def rank_decode_variants(rank, world, out):
    """One rank of the decode variants' worlds: for each case of
    OUT_DIR/variant_cases.json whose mesh (``"1x2"``, ``"2x2"``, ``"1x4"``,
    data x model) has ``world`` ranks, the reference's weights cut into
    this rank's blocks by ``param_specs`` (over ``data`` too where the
    case says ``"fsdp"``), the case's whole history cache
    (``<case>/cache/<field>``) cut into this rank's block by the variant's
    specs (``ring_cache_specs`` or ``quant_cache_specs`` of the case's
    shape), and ``TP_DECODE_STEPS`` steps of ``grouped_decode_step`` or
    ``decode_step_quant`` fed ``<case>/decode_tokens`` (this rank's data
    row's rows), under the dry-run's decode policy plus the mesh and the
    declared ``"__params__"`` and ``"__cache__"``.  Saves each step's
    logits and tokens and the cache's blocks after the last one."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.convert import for_ranks, params_from_numpy
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import get_model, param_shapes
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.hints import sharding_policy

    with open(os.path.join(out, "variant_cases.json")) as f:
        cases = json.load(f)
    inp = _inputs(out)
    meshes = {}
    for mesh_id in ("1x2", "2x2", "1x4"):
        dims = tuple(int(n) for n in mesh_id.split("x"))
        if dims[0] * dims[1] == world:
            meshes[mesh_id] = DeviceMesh(
                "cpu", torch.arange(world).reshape(dims),
                mesh_dim_names=("data", "model"))
    res = {}
    for name, case in cases.items():
        mesh = meshes.get(case["mesh"])
        if mesh is None:
            continue
        cfg = dataclasses.replace(get_arch(case["arch"]).reduced(),
                                  **case["replace"])
        shape = dataclasses.replace(SHAPES[case["shape"]],
                                    global_batch=case["batch"])
        weights = shd.param_specs(param_shapes(get_model(cfg)), mesh,
                                  fsdp=case["fsdp"])
        coords = shd.mesh_coords(mesh)
        flat = {k[len(name) + 3:]: v for k, v in inp.items()
                if k.startswith(name + "/p/")}
        params = params_from_numpy(
            for_ranks(unflatten(flat), specs=weights, mesh=mesh,
                      coords=coords, head_dim=shd.head_widths(cfg)),
            device="cpu")
        params = adamw.tree_map(lambda t, dt: t.to(getattr(torch, dt)),
                                params, unflatten(case["dtypes"]))
        ring = case["variant"] == "ring"
        kind, specs_of, step = (
            (tfm.GroupedKVCache, shd.ring_cache_specs,
             tfm.grouped_decode_step) if ring else
            (tfm.QuantKVCache, shd.quant_cache_specs, tfm.decode_step_quant))
        specs = specs_of(cfg, shape, mesh)
        whole = kind(*(torch.as_tensor(inp[f"{name}/cache/{f}"]).to(
            getattr(torch, case["cache_dtypes"][f])) if f != "pos"
            else case["pos"] for f in kind._fields))
        cache = shd.cache_blocks(whole, specs, mesh, coords)
        cache = kind(*(t.clone() if torch.is_tensor(t) else t
                       for t in cache))
        feed = torch.as_tensor(inp[f"{name}/decode_tokens"])
        n_data = mesh.size(0)
        if case["batch"] >= n_data:
            rows = case["batch"] // n_data
            feed = feed[coords["data"] * rows:(coords["data"] + 1) * rows]
        policy = {**make_policy(cfg, SHAPES[case["shape"]], mesh),
                  "__mesh__": mesh, "__params__": weights,
                  "__cache__": specs}
        with sharding_policy(policy):
            for i in range(TP_DECODE_STEPS):
                logits, cache = step(cfg, params, cache, feed[:, i:i + 1])
                res[f"{name}/decode{i}/logits"] = logits
                res[f"{name}/decode{i}/tokens"] = torch.argmax(logits, -1)
        for f, t in cache._asdict().items():
            if torch.is_tensor(t):
                res[f"{name}/cache/{f}"] = t
    np.savez(os.path.join(out, f"decode_variants_{world}_{rank}.npz"),
             **{k: v.detach().float().numpy() if v.is_floating_point()
                else v.numpy() for k, v in res.items()})


ENTRIES = {"pipeline": rank_pipeline, "pair": rank_pair,
           "mesh_model": rank_mesh_model,
           "tensor_parallel": rank_tensor_parallel,
           "decode_variants": rank_decode_variants}


def main(argv):
    entry, rank, world, init_file, out = argv
    rank, world = int(rank), int(world)
    init_rank(rank, world, init_file)
    import torch.distributed as dist

    try:
        ENTRIES[entry](rank, world, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
