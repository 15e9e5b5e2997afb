"""Parity harness: the JAX package (``repro``, the reference) against the
PyTorch port (``repro_torch``) on the same numpy inputs.

A test makes its inputs with numpy from a seed, hands them to a reference
callable and to a port callable, and compares what comes back after both
are converted to numpy: exactly (integers, layouts, tokens, JSON) or within
a stated tolerance.  Float tolerances are the bounds ``tests/test_kernels.py``
uses: 2e-5 for float32; for bfloat16, 2e-2 of the largest magnitude of the
reference result (one bf16 ulp is 2^-8 of a value, and the two frameworks
round at different places).

Only tests import both packages; everything here runs on the CPU, and the
reference's Pallas kernels run in interpret mode, as its own tests run them.
"""

from __future__ import annotations

import numpy as np

FP32_TOL = 2e-5
BF16_TOL = 2e-2

# the layouts tests/test_artifact.py sweeps: (dims, N, B, unit dim | None)
FLAT_CASES = [
    ((24,), 3, 1, 0),
    ((60,), 8, 1, 0),          # pad = 4
    ((32,), 4, 2, 0),
    ((21,), 5, 3, 0),
    ((8, 12), 4, 1, 1),
    ((8, 12), 3, 2, 0),
    ((6, 10), 4, 1, None),     # diagonal alpha = (1, 1)
]
MULTI_CASES = [
    ((8, 12), (2, 3), (1, 1)),
    ((8, 12), (4, 1), (2, 1)),
    ((6, 6), (3, 2), (1, 1)),
]
LAYOUT_CASES = ([("flat",) + c for c in FLAT_CASES]
                + [("multi",) + c for c in MULTI_CASES])


def layout_id(case) -> str:
    return "-".join(str(x).replace(" ", "") for x in case)


def build_artifact(core, case, *, backend, level="full"):
    """One of LAYOUT_CASES compiled by ``core`` (``repro.core`` or
    ``repro_torch.core``: same names in both)."""
    from importlib import import_module
    propose_P = import_module(core.__name__ + ".geometry").propose_P

    kind, dims = case[0], case[1]
    mem = core.MemorySpec("m", dims=dims, word_bits=16, ports=1)
    if kind == "flat":
        _, _, N, B, unit = case
        n = len(dims)
        alpha = ((1,) * n if unit is None else
                 tuple(1 if i == unit else 0 for i in range(n)))
        geo = core.FlatGeometry(N=N, B=B, alpha=alpha,
                                P=propose_P(mem, N, B, alpha)[0])
    else:
        _, _, Ns, Bs = case
        geo = core.MultiDimGeometry(Ns=Ns, Bs=Bs, alphas=(1,) * len(dims))
    return core.compile_geometry(mem, geo, backend=backend,
                                 transform_level=level)


def to_numpy(x):
    """jax.Array / torch.Tensor / nested containers -> numpy (bfloat16 as
    float32, which holds it exactly)."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if hasattr(x, "detach"):                       # torch.Tensor
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def assert_same(ref, port, *, tol=None, what=""):
    """Exact equality when ``tol`` is None, else ``|ref - port| <= tol *
    max(1, max|ref|)`` elementwise."""
    ref, port = to_numpy(ref), to_numpy(port)
    if isinstance(ref, dict):
        assert ref.keys() == port.keys(), what
        for k in ref:
            assert_same(ref[k], port[k], tol=tol, what=f"{what}[{k}]")
        return
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(port), what
        for i, (r, p) in enumerate(zip(ref, port)):
            assert_same(r, p, tol=tol, what=f"{what}[{i}]")
        return
    assert ref.shape == port.shape, (what, ref.shape, port.shape)
    if tol is None:
        np.testing.assert_array_equal(port, ref, err_msg=what)
        return
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(port.astype(np.float64),
                               ref.astype(np.float64), rtol=0,
                               atol=tol * scale, err_msg=what)


def run_both(ref_fn, port_fn, inputs, *, to_ref, to_port, tol=None, what=""):
    """Feed the same numpy ``inputs`` (a dict) to both callables, each
    through its own converter, and compare the results."""
    ref = ref_fn(**{k: to_ref(v) for k, v in inputs.items()})
    port = port_fn(**{k: to_port(v) for k, v in inputs.items()})
    assert_same(ref, port, tol=tol, what=what)
    return ref, port


def strip_backend(d: dict) -> dict:
    """An artifact's JSON without the one field the packages differ in."""
    return {k: v for k, v in d.items() if k != "backend"}
