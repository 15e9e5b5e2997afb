"""The model steps' layer spans and counters (``core.tracing.MODEL_SPANS``)
on the CPU at toy size: the span tree under a profile, the spans a
profile alone records, nothing recorded and nothing changed when off, the
MoE layer's kept-pairs counter against a recount, the device time's
arithmetic and the registry, and the serve launcher's tracing."""

from __future__ import annotations

import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tracing
from repro_torch.core.tracing import MODEL_SPANS
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import get_model, moe

MOE = dict(name="tiny-moe", family="moe", n_layers=2, d_model=128,
           n_heads=4, n_kv_heads=2, head_dim=32, d_ff=64, vocab=256,
           n_experts=8, top_k=2, moe_d_ff=64, shared_expert=False,
           capacity_factor=1.25, rope_theta=10000.0, norm_eps=1e-6,
           tie_embeddings=False)
SSM = dict(name="tiny-ssm", family="ssm", n_layers=3, d_model=64,
           n_heads=0, n_kv_heads=0, d_ff=0, vocab=256, ssm_state=16,
           ssm_head_dim=16, ssm_expand=2, ssm_conv=4, ssm_chunk=16,
           norm_eps=1e-5, tie_embeddings=True)

# each span's parent; a decode step of the dense family writes its cache
# inside the attention, so it has no cache.store
MOE_TREE = {"embed": "step", "attention": "step",
            "attention.core": "attention", "ffn": "step",
            "moe.route": "ffn", "moe.dispatch": "ffn", "moe.experts": "ffn",
            "moe.combine": "ffn", "cache.store": "step", "head": "step"}
SSM_TREE = {"embed": "step", "ssm.in_proj": "step", "ssm.conv": "step",
            "ssm.scan": "step", "ssm.gate_norm": "step",
            "ssm.out_proj": "step", "cache.store": "step", "head": "step"}
PER_LAYER = {"attention", "attention.core", "ffn", "moe.route",
             "moe.dispatch", "moe.experts", "moe.combine", "cache.store",
             "ssm.in_proj", "ssm.conv", "ssm.scan", "ssm.gate_norm",
             "ssm.out_proj"}


@pytest.fixture(autouse=True)
def fresh():
    MODEL_SPANS.reset()
    yield
    tracing.disable_model_spans()
    MODEL_SPANS.reset()


def _model(arch, **over):
    cfg = ArchConfig(**{**arch, **over})
    model = get_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(3),
                                  device="cpu")


def _tokens(cfg, B=2, S=24, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(2, cfg.vocab - 1, (B, S), generator=g)


def _run(model, params, cfg, decode_steps):
    """A prefill and ``decode_steps`` decode steps: (logits, cache)."""
    logits, cache = make_prefill_step(model, 32)(
        params, {"tokens": _tokens(cfg)})
    serve = make_serve_step(model)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    out = [logits]
    for _ in range(decode_steps):
        tok, logits, cache = serve(params, cache, tok)
        out.append(logits)
    return out, cache


def _ranges(prof):
    """``name -> [(start, end)]`` of the profile's host ranges."""
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append((e.time_range.start,
                                           e.time_range.end))
    return out


def _inside(inner, outers):
    return any(a <= inner[0] and inner[1] <= b for a, b in outers)


@pytest.mark.parametrize("family,tree,steps", [
    ("moe", MOE_TREE, ("prefill", "decode")),
    ("ssm", SSM_TREE, ("prefill",)),
])
def test_span_tree_under_a_profile(family, tree, steps):
    """With the switch on, every span, each a range of the profile."""
    arch = MOE if family == "moe" else SSM
    cfg, model, params = _model(arch)
    tracing.enable_model_spans()
    with torch.profiler.profile() as prof:
        _run(model, params, cfg, decode_steps=1 if "decode" in steps else 0)
    summary = MODEL_SPANS.summary()
    ranges = _ranges(prof)
    for step in steps:
        assert summary["spans"][f"{step}/step"]["calls"] == 1
        for name, parent in tree.items():
            if step == "decode" and name == "cache.store" \
                    and family == "moe":
                continue
            key = f"{step}/{name}"
            row = summary["spans"][key]
            want = cfg.n_layers if name in PER_LAYER else 1
            assert row["calls"] == want, key
            assert row["host_ms"] > 0
            # no card: no device time, never the host's under its name
            assert row["device_ms"] is None and row["self_device_ms"] is None
            assert len(ranges[key]) == want
            for r in ranges[key]:
                assert _inside(r, ranges[f"{step}/{parent}"]), key
    assert not any(n.startswith("bench.") for n in ranges)
    names = {k.split("/", 1)[1] for k in summary["spans"]}
    assert names == set(tree) | {"step"}


@pytest.mark.parametrize("family,read", [
    ("moe", {"step", "attention", "ffn"}),
    ("ssm", {"step"}),
])
def test_a_profile_alone_records_the_read_spans(family, read):
    """Under a profile without the switch, only the spans a benchmark
    metric reads (and the counters): the traced run's ranges and events
    are no more than its metrics need."""
    cfg, model, params = _model(MOE if family == "moe" else SSM)
    with torch.profiler.profile() as prof:
        _run(model, params, cfg, decode_steps=1)
    s = MODEL_SPANS.summary()
    assert {k.split("/", 1)[1] for k in s["spans"]} == read
    steps = ("prefill", "decode")
    assert {n for n in _ranges(prof) if n.split("/", 1)[0] in steps} == {
        f"{step}/{name}" for step in steps for name in read}
    counted = {f"{step}/moe.pairs_{c}" for step in steps
               for c in ("kept", "routed")}
    assert set(s["counters"]) == (counted if family == "moe" else set())


def test_off_records_nothing_and_changes_nothing(monkeypatch):
    cfg, model, params = _model(MOE)
    tracing.enable_model_spans()
    on_out, on_cache = _run(model, params, cfg, decode_steps=2)
    tracing.disable_model_spans()
    assert MODEL_SPANS.summary()["spans"]["decode/step"]["calls"] == 2
    MODEL_SPANS.reset()

    def refused(*a, **k):
        raise AssertionError("record_function called with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    off_out, off_cache = _run(model, params, cfg, decode_steps=2)
    assert MODEL_SPANS.summary() == {"spans": {}, "counters": {}}
    for a, b in zip(on_out, off_out):
        assert torch.equal(a, b)
    assert torch.equal(on_cache.k, off_cache.k)
    assert torch.equal(on_cache.v, off_cache.v)
    assert on_cache.pos == off_cache.pos


def test_off_span_is_the_null_span():
    assert MODEL_SPANS.span("attention") is tracing.NULL_SPAN
    assert MODEL_SPANS.step("prefill", "cpu") is tracing.NULL_SPAN
    MODEL_SPANS.count("moe.pairs_routed", 5)
    assert MODEL_SPANS.summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, None),
                                                   (0.25, True)])
def test_kept_pairs_equal_a_recount(capacity_factor, drops):
    """The layer's counter against ``dispatch_slots``' ``keep`` on the same
    input; at a quarter of the mean load the capacity (8 slots) drops."""
    cfg, model, params = _model(MOE, capacity_factor=capacity_factor)
    lp = {k: w[0] for k, w in params["layers"].items()}
    h = torch.randn((2, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(7)).to(torch.bfloat16)
    tracing.enable_model_spans()
    with MODEL_SPANS.step("prefill", h.device):
        moe.moe_ffn_sorted(cfg, lp, h)
    counters = MODEL_SPANS.summary()["counters"]
    T = h.shape[0] * h.shape[1]
    _, top_i, _ = moe._route(cfg, lp["router"], h.reshape(T, -1))
    keep = moe.dispatch_slots(top_i, moe.capacity(cfg, T),
                              cfg.n_experts)[4]
    assert counters["prefill/moe.pairs_kept"] == int(keep.sum())
    assert counters["prefill/moe.pairs_routed"] == T * cfg.top_k
    if drops:
        assert int(keep.sum()) < T * cfg.top_k


def test_counters_sum_over_the_layers_and_steps():
    cfg, model, params = _model(MOE)
    with torch.profiler.profile():
        _run(model, params, cfg, decode_steps=3)
    c = MODEL_SPANS.summary()["counters"]
    assert c["prefill/moe.pairs_routed"] == cfg.n_layers * 2 * 24 * 2
    assert c["decode/moe.pairs_routed"] == 3 * cfg.n_layers * 2 * 2
    assert 0 < c["prefill/moe.pairs_kept"] <= c["prefill/moe.pairs_routed"]
    assert c["decode/moe.pairs_kept"] == c["decode/moe.pairs_routed"]


def test_counted_tensors_are_summed_past_the_keep_limit(monkeypatch):
    monkeypatch.setattr(MODEL_SPANS, "KEEP", 4)
    tracing.enable_model_spans()
    keep = torch.ones(3, dtype=torch.bool)
    with MODEL_SPANS.step("decode", "cpu"):
        for _ in range(10):
            MODEL_SPANS.count("moe.pairs_kept", keep)
    assert len(MODEL_SPANS._tensors["decode/moe.pairs_kept",
                                    torch.device("cpu")]) < 4
    assert MODEL_SPANS.summary()["counters"]["decode/moe.pairs_kept"] == 30


class _Event:
    """A stand-in for a timing CUDA event: its time is a clock advanced
    by each record, so every span's device ms is known."""

    clock = 0.0

    def record(self, stream):
        _Event.clock += 1.0
        self.t = _Event.clock

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_registry_observes_each_span(monkeypatch):
    """The folded event pairs: each span's device ms, its own ms less its
    children's, and one ``model_span_device_ms`` observation a span; no
    host histogram."""
    monkeypatch.setattr(MODEL_SPANS, "_event", _Event)
    monkeypatch.setattr(MODEL_SPANS, "_pool", [])
    reg = tracing.MetricsRegistry()
    tracing.enable_model_spans(reg)
    for _ in range(2):
        with tracing._StepScope(MODEL_SPANS, "decode", "stream", True):
            with MODEL_SPANS.span("ffn"):       # events 2, 7
                with MODEL_SPANS.span("moe.route"):     # 3, 4
                    pass
                with MODEL_SPANS.span("moe.combine"):   # 5, 6
                    pass
    s = MODEL_SPANS.summary()["spans"]
    assert s["decode/step"] == {"calls": 2, "host_ms": pytest.approx(
        s["decode/step"]["host_ms"]), "device_ms": 2 * 7.0,
        "self_device_ms": 2 * 2.0}
    assert s["decode/ffn"]["device_ms"] == 2 * 5.0
    assert s["decode/ffn"]["self_device_ms"] == 2 * 3.0
    assert s["decode/moe.route"]["self_device_ms"] == 2 * 1.0
    hists = reg.snapshot()["histograms"]
    for span, ms in (("step", 7.0), ("ffn", 5.0), ("moe.combine", 1.0)):
        h = reg.histogram("model_span_device_ms", step="decode", span=span)
        assert h["count"] == 2 and h["sum"] == 2 * ms, span
    assert not any(k.startswith("model_span_host_ms") for k in hists)


def _serve(device, trace_dir):
    from repro_torch.launch import serve

    return serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                       device, "--requests", "1", "--max-batch", "1",
                       "--max-new", "3", "--max-len", "16", "--seed", "1",
                       "--trace-dir", str(trace_dir)])


def test_serve_tracing_feeds_the_registry(tmp_path, capsys):
    """``launch/serve.py`` with tracing on records every span of the
    served model's decode steps, beside ``serve_tick_ms`` in the service's
    registry (no card: no device histogram), and the switch is off again
    when it returns."""
    srv = _serve("cpu", tmp_path)
    capsys.readouterr()
    spans = MODEL_SPANS.summary()["spans"]
    steps = spans["decode/step"]["calls"]
    assert steps >= 3
    for span in ("attention", "ffn", "moe.dispatch"):
        assert spans[f"decode/{span}"]["calls"] == \
            steps * srv.model.cfg.n_layers, span
    hists = srv._kv_service.metrics.snapshot()["histograms"]
    assert any(k.startswith("serve_tick_ms") for k in hists)
    assert not any(k.startswith("model_span") for k in hists)
    assert not MODEL_SPANS.enabled


def test_threads_keep_their_own_steps():
    """Servers on threads share the recorder: each thread's spans nest in
    its own step, and no call or count is lost."""
    import sys
    import threading

    n_threads, rounds = 12, 100
    errors = []

    def work(i):
        try:
            for _ in range(rounds):
                with MODEL_SPANS.step(f"t{i % 3}", "cpu"):
                    with MODEL_SPANS.span("attention"):
                        MODEL_SPANS.count("moe.pairs_routed", 2)
                        MODEL_SPANS.count("moe.pairs_kept",
                                          torch.ones(3, dtype=torch.bool))
        except Exception as e:            # reported by the main thread
            errors.append(e)

    tracing.enable_model_spans()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    s = MODEL_SPANS.summary()
    per_step = n_threads // 3 * rounds
    for step in ("t0", "t1", "t2"):
        assert s["spans"][f"{step}/step"]["calls"] == per_step
        assert s["spans"][f"{step}/attention"]["calls"] == per_step
        assert s["counters"][f"{step}/moe.pairs_routed"] == 2 * per_step
        assert s["counters"][f"{step}/moe.pairs_kept"] == 3 * per_step
    assert set(s["spans"]) == {f"t{i}/{n}" for i in range(3)
                               for n in ("step", "attention")}


@pytest.mark.gpu
def test_device_time_on_a_card():
    """On a card every span of a step has device time from its events, a
    span's own time is its time less its children's (never below 0), the
    MoE layer's parts fit in it, and the counters are read back from the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the spans' CUDA events need a GPU")
    cfg = ArchConfig(**MOE)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(3),
                        device="cuda")
    _run(model, params, cfg, decode_steps=1)            # builds, warms
    torch.cuda.synchronize()
    tracing.enable_model_spans()
    _run(model, params, cfg, decode_steps=3)
    s = MODEL_SPANS.summary()
    for key, row in s["spans"].items():
        assert row["device_ms"] > 0, key
        assert row["self_device_ms"] >= -1e-3 * row["device_ms"], key
    for step, calls in (("prefill", 1), ("decode", 3)):
        assert s["spans"][f"{step}/step"]["calls"] == calls
        ffn = s["spans"][f"{step}/ffn"]
        parts = sum(s["spans"][f"{step}/moe.{p}"]["device_ms"]
                    for p in ("route", "dispatch", "experts", "combine"))
        assert parts <= ffn["device_ms"] * (1 + 1e-3)
    c = s["counters"]
    assert 0 < c["prefill/moe.pairs_kept"] <= c["prefill/moe.pairs_routed"]
    assert c["decode/moe.pairs_routed"] == 3 * cfg.n_layers * 2 * 2


@pytest.mark.gpu
def test_serve_tracing_feeds_device_histograms(tmp_path, capsys):
    """On a card the served model's spans reach the service's registry as
    ``model_span_device_ms{step,span}``, a count a span call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the spans' CUDA events need a GPU")
    srv = _serve("cuda", tmp_path)
    capsys.readouterr()
    spans = MODEL_SPANS.summary()["spans"]
    reg = srv._kv_service.metrics
    for span in ("step", "attention", "ffn", "moe.dispatch"):
        h = reg.histogram("model_span_device_ms", step="decode", span=span)
        assert h["count"] == spans[f"decode/{span}"]["calls"] > 0, span
        assert h["sum"] > 0, span
