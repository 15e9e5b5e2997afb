"""The twins of ``examples/`` (``repro_torch.examples``) on the CPU.

Each twin runs as ``python -m repro_torch.examples.<name> --device cpu``
(``train_lm`` with ``--quick``) and must exit 0; the reference examples run
beside them, all at once, each in its own interpreter.  The lines that do
not depend on timing or on the framework are held to the reference's:
every line of ``banking_explorer`` apart from its timings; the ticket's
signature, the layouts and the bank counts of ``quickstart``; the
first-tick layout and the page pool of ``serve_lm`` (and the solved
layout, from both packages' ``page_solution``).  A layout's description
names its backend (``jax`` or ``torch``), which is left out.  Without
``--device`` the twins that touch a device raise without a card.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {
    "banking_explorer": ["sobel"],
    "quickstart": ["--device", "cpu"],
    "serve_lm": ["--device", "cpu"],
    "train_lm": ["--quick", "--device", "cpu"],
}
REF = {"banking_explorer": ["sobel"], "quickstart": [], "serve_lm": []}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    procs = {}
    for name, args in PORT.items():
        extra = (["--ckpt-dir", str(tmp / "ckpt")] if name == "train_lm"
                 else [])
        procs[("port", name)] = subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.examples.{name}", *args,
             *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for name, args in REF.items():
        procs[("ref", name)] = subprocess.Popen(
            [sys.executable, os.path.join("examples", f"{name}.py"), *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[key] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _lines(text):
    return [re.sub(r"backend=\w+", "backend=", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("name", list(PORT))
def test_twin_runs_on_the_cpu(outputs, name):
    rc, stdout, stderr = outputs[("port", name)]
    assert rc == 0, stderr[-3000:]
    assert stdout.strip()


def test_banking_explorer_prints_the_reference_lines(outputs):
    def untimed(text):
        return [re.sub(r"\(\d+ ms, ", "(ms, ", ln) for ln in _lines(text)]

    got, want = outputs[("port", "banking_explorer")], \
        outputs[("ref", "banking_explorer")]
    assert want[0] == 0, want[2][-3000:]
    assert untimed(got[1]) == untimed(want[1])
    assert len(untimed(got[1])) > 6


def _starting(text, prefixes):
    return [ln for ln in _lines(text) if ln.startswith(prefixes)]


def test_quickstart_signature_layouts_and_banks_equal_the_reference(outputs):
    got, want = outputs[("port", "quickstart")], outputs[("ref", "quickstart")]
    assert want[0] == 0, want[2][-3000:]

    def signature(text):
        return re.search(r"signature=(\S+)", text).group(1)

    assert signature(got[1]) == signature(want[1])
    prefixes = ("artifact :", "hot-swapped to", "space    :",
                "raw mul/div/mod", "joint    :", "lint     :", "refuted  :")
    assert _starting(got[1], prefixes) == _starting(want[1], prefixes)
    assert len(_starting(got[1], prefixes)) == len(prefixes) + 1  # 2 joint
    # the fallback is the trivial scheme, or the solved one where the
    # solve landed first (in either package, by timing)
    (fallback,) = _starting(got[1], ("fallback :",))
    (solved,) = _starting(got[1], ("artifact :",))
    trivial = " compiled flat N=1 B=1 alpha=(1,) P=(1,) banks=1 vol=256 " \
        "FOmax=1 backend="
    assert fallback.split(":", 1)[1] in (solved.split(":", 1)[1], trivial)
    for prefix in ("tenancy  :", "fabric   :", "observe  :", "telemetry:",
                   "demotion :", "certify  :", "sharded  :"):
        assert _starting(got[1], (prefix,)), prefix


def test_serve_lm_layouts_and_page_pool_equal_the_reference(outputs):
    from repro.configs import get_arch as ref_get_arch
    from repro.runtime.server import page_solution as ref_page_solution

    from repro_torch.configs import get_arch
    from repro_torch.runtime.server import page_solution

    got, want = outputs[("port", "serve_lm")], outputs[("ref", "serve_lm")]
    assert want[0] == 0, want[2][-3000:]
    prefixes = ("first-tick KV layout", "page pool:")
    assert _starting(got[1], prefixes) == _starting(want[1], prefixes)
    assert len(_starting(got[1], prefixes)) == 2
    assert "served 6 requests in" in got[1]
    solved = [_lines(page_solution(cfg, max_len=64, page=16, readers=4)
                     .describe())
              for cfg in (get_arch("qwen2_7b").reduced(),)] + [
        _lines(ref_page_solution(ref_get_arch("qwen2_7b").reduced(),
                                 max_len=64, page=16, readers=4).describe())]
    assert solved[0] == solved[1]
    swapped = "hot-swapped to the solved layout mid-serve: "
    for text in (got[1], want[1]):
        for ln in _lines(text):
            if ln.startswith(swapped):
                assert [ln[len(swapped):]] == solved[0]


def test_train_lm_loss_falls_and_counts_its_parameters(outputs):
    stdout = outputs[("port", "train_lm")][1]
    assert "arch lm-quick: " in stdout and "training loss decreased" in stdout
    assert re.search(r"step time: median [\d.]+ ms over 30 steps, \d+ "
                     r"tokens/s", stdout)


def test_lm_100m_has_the_reference_parameter_count():
    import jax

    from repro.models import get_model as ref_get_model

    from repro_torch.examples.train_lm import lm_100m
    from repro_torch.models import get_model, param_shapes
    from repro_torch.optim import adamw

    cfg = lm_100m()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab) == (12, 768, 12, 64, 3072, 32_000)
    ref = ref_get_model(cfg)       # the configs are alike field for field
    want = sum(int(x.size) for x in jax.tree.leaves(
        jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0)))))
    got = sum(x.numel() for x in adamw.tree_leaves(
        param_shapes(get_model(cfg))))
    assert got == want


@pytest.mark.parametrize("name", ["quickstart", "serve_lm", "train_lm"])
def test_twin_raises_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default works here")
    import importlib

    main = importlib.import_module(f"repro_torch.examples.{name}").main
    args = (["--quick", "--ckpt-dir", str(tmp_path)] if name == "train_lm"
            else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
