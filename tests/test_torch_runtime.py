"""The port's data pipeline, checkpoints and trainer: the JAX package's
``tests/test_runtime.py`` re-pointed at ``repro_torch`` (data determinism
and rank slicing, the prefetch loader's state, atomic save and restore
with keep-2 GC, the bitwise restart of the trainer killed at step 17,
straggler detection), and the port held to the JAX package: batches bit
for bit, and checkpoints that restore across the two packages in both
directions.  The JAX package's elastic-reshard and int8 psum cases wait
for the multi-device side of the port."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as RefCheckpointManager
from repro.data import pipeline as RP
from repro.optim import adamw as RA
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as PP
from repro_torch.data.pipeline import DataConfig, PrefetchingLoader, get_batch
from repro_torch.launch import train as train_launcher
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import StragglerMonitor, TrainConfig, train


def _tiny():
    cfg = get_arch("qwen2_7b").reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=64, d_ff=128,
                               vocab=128, n_heads=2, n_kv_heads=2,
                               head_dim=32)


# ---------------------------------------------------------------------------
# the JAX package's runtime tests, re-pointed
# ---------------------------------------------------------------------------


def test_data_determinism_and_rank_slicing():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=8, seed=3)
    a = get_batch(cfg, 5)
    b = get_batch(cfg, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    shards = [get_batch(cfg, 5, rank=r, world=4)["tokens"] for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(shards), a["tokens"])
    c = get_batch(cfg, 6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_prefetch_loader_state():
    cfg = DataConfig(vocab=50, seq_len=8, global_batch=4)
    ld = PrefetchingLoader(cfg, start_step=0)
    next(ld)
    b1 = next(ld)
    assert ld.state == 2
    ld.close()
    # resume from state reproduces the stream
    ld2 = PrefetchingLoader(cfg, start_step=1)
    b1b = next(ld2)
    ld2.close()
    np.testing.assert_array_equal(b1["tokens"], b1b["tokens"])


def test_ckpt_atomic_save_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(5, dtype=torch.float32),
             "nested": {"b": torch.ones((2, 3))}}
    for step in (10, 20, 30):
        mgr.save(step, state, {"data_state": step})
    assert mgr.all_steps() == [20, 30]  # keep=2 GC
    restored, meta = mgr.restore(state)
    assert torch.equal(restored["a"], state["a"])
    assert torch.equal(restored["nested"]["b"], state["nested"]["b"])
    assert meta["step"] == 30 and meta["data_state"] == 30


def test_train_restart_bitwise_identical(tmp_path):
    """Kill at step 17, restart, final state == uninterrupted run."""
    cfg = _tiny()
    model = get_model(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)

    def tc(d):
        return TrainConfig(total_steps=24, ckpt_every=8, log_every=100,
                           ckpt_dir=str(d))

    oc = adamw.AdamWConfig(total_steps=24, warmup_steps=4)

    # uninterrupted reference
    ref = train(model, dc, tc(tmp_path / "ref"), oc, device="cpu")

    # interrupted: die at step 17 (after the step-16 checkpoint)
    class Boom(Exception):
        pass

    def killer(step):
        if step == 17:
            raise Boom()

    with pytest.raises(Boom):
        train(model, dc, tc(tmp_path / "ft"), oc, failure_hook=killer,
              device="cpu")
    assert CheckpointManager(str(tmp_path / "ft")).latest_step() == 16
    out = train(model, dc, tc(tmp_path / "ft"), oc, device="cpu")

    # bitwise-identical final params and optimizer state
    for a, b in zip(adamw.tree_leaves(ref["params"]),
                    adamw.tree_leaves(out["params"])):
        assert torch.equal(a, b)
    for a, b in zip(adamw.tree_leaves(ref["opt"].master),
                    adamw.tree_leaves(out["opt"].master)):
        assert torch.equal(a, b)
    assert int(out["opt"].step) == int(ref["opt"].step) == 24
    # and the loss tail matches the reference trajectory
    assert len(out["losses"]) == 24 - 16
    np.testing.assert_allclose(ref["losses"][-4:], out["losses"][-4:],
                               rtol=0, atol=0)
    assert ref["losses"][-1] < ref["losses"][0]


def test_straggler_detection():
    mon = StragglerMonitor(window=10, factor=3.0)
    flagged = [mon.record(i, 0.1) for i in range(8)]
    assert not any(flagged)
    assert mon.record(8, 1.0)  # 10x median -> straggler
    assert mon.flagged == [8]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_batches_equal_the_reference_bit_for_bit(seed):
    """Synthetic batches (with frames, as the encoder-decoder gets them)
    for several steps, whole and sliced by rank, equal the JAX package's
    bit for bit."""
    kw = dict(vocab=51865, seq_len=24, global_batch=8, seed=seed,
              frames_dim=16)
    ref_cfg, cfg = RP.DataConfig(**kw), PP.DataConfig(**kw)
    for step in (0, 1, 17):
        for rank, world in ((0, 1), (1, 4), (3, 4)):
            want = RP.get_batch(ref_cfg, step, rank, world)
            got = PP.get_batch(cfg, step, rank, world)
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype
                np.testing.assert_array_equal(want[k], got[k])


def test_file_batches_equal_the_reference_bit_for_bit(tmp_path):
    path = tmp_path / "tokens.u32"
    np.random.default_rng(4).integers(0, 2 ** 32 - 1, size=5000,
                                      dtype=np.uint32).tofile(path)
    kw = dict(vocab=1000, seq_len=32, global_batch=4, seed=2,
              token_file=str(path))
    for step in (0, 5):
        want = RP.get_batch(RP.DataConfig(**kw), step, 1, 2)
        got = PP.get_batch(PP.DataConfig(**kw), step, 1, 2)
        for k in want:
            np.testing.assert_array_equal(want[k], got[k])


def _model_state():
    """A reduced model's bf16 parameters and an AdamW state (int32 step,
    float32 moments and master) after one update, in the JAX package."""
    from repro.configs import get_arch as ref_get_arch
    from repro.models import get_model as ref_get_model

    model = ref_get_model(ref_get_arch("mamba2_370m").reduced())
    params = model.init(jax.random.PRNGKey(0))
    opt = RA.init(params)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt = RA.update(RA.AdamWConfig(), grads, opt, params)
    return params, opt


def _to_port(params, opt):
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                          device="cpu")
    o = adamw.AdamWState(
        step=torch.tensor(int(opt.step), dtype=torch.int32),
        m=params_from_numpy(jax.tree_util.tree_map(np.asarray, opt.m),
                            device="cpu"),
        v=params_from_numpy(jax.tree_util.tree_map(np.asarray, opt.v),
                            device="cpu"),
        master=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, opt.master), device="cpu"))
    return p, o


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    params, opt = _model_state()
    RefCheckpointManager(str(tmp_path)).save(
        3, (params, opt), {"data_state": 3})
    template = _to_port(*jax.tree_util.tree_map(jnp.zeros_like,
                                                (params, opt)))
    (got_p, got_o), meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 3 and meta["data_state"] == 3
    assert type(got_o).__name__ == "AdamWState"
    assert got_p["embed"].dtype == torch.bfloat16
    assert got_o.step.dtype == torch.int32 and int(got_o.step) == 1
    want_p, want_o = _to_port(params, opt)
    for want, got in ((want_p, got_p), (want_o.m, got_o.m),
                      (want_o.v, got_o.v), (want_o.master, got_o.master)):
        for a, b in zip(adamw.tree_leaves(want), adamw.tree_leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    params, opt = _model_state()
    port_state = _to_port(params, opt)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, port_state, {"data_state": 9}, block=False)
    mgr.wait()
    step_dir = tmp_path / "step_0000000005"
    assert sorted(os.listdir(step_dir)) == ["META", "meta.json",
                                            "shard_00000.npz"]
    keys = json.loads((step_dir / "meta.json").read_text())["keys"]
    # the JAX package's names: a top-level tuple's items are "/0", "/1"
    assert "/0/embed::bf16" in keys and "/1/step" in keys
    assert "/1/master/layers/in_proj" in keys and "/1/m/embed" in keys
    (got_p, got_o), meta = RefCheckpointManager(str(tmp_path)).restore(
        jax.tree_util.tree_map(jnp.zeros_like, (params, opt)))
    assert meta["data_state"] == 9
    for a, b in zip(jax.tree_util.tree_leaves((params, opt)),
                    jax.tree_util.tree_leaves((got_p, got_o))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_save_snapshots_before_it_returns(tmp_path):
    """``block=False`` copies the state to the host before returning, so
    the trainer may update its tensors in place at once; a stale tmp dir
    of a crashed save is removed by the next save."""
    (tmp_path / "tmp.7.123").mkdir()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"w": torch.zeros(1000, dtype=torch.bfloat16)}
    mgr.save(1, state, block=False)
    state["w"].fill_(3.0)
    mgr.wait()
    restored, _ = mgr.restore({"w": torch.empty(1000,
                                                dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert float(restored["w"].abs().max()) == 0.0
    assert not (tmp_path / "tmp.7.123").exists()


def test_the_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu", "--seq",
            "16", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert train_launcher.main(argv + ["--steps", "3"]) == 0
    assert "done: 3 steps" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    assert train_launcher.main(argv + ["--steps", "5"]) == 0
    assert "done: 2 steps" in capsys.readouterr().out      # resumed at 3


def test_the_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default works here")
    cfg = _tiny()
    dc = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(get_model(cfg), dc, TrainConfig(total_steps=1,
                                              ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--arch", "qwen2-7b", "--smoke", "--steps", "1",
                             "--ckpt-dir", str(tmp_path)])
