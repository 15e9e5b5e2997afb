"""The numbers that decide ``correct``: the program's outputs against the
plain reference, run on the same weights and tokens.

What the side under judgement produced is read through two callables of
its cache, ``kv(i)`` the keys and values it holds for attention layer
``i`` (``(B, >= S, Hkv, Dh)``) and ``ssm(i)`` Mamba2 block ``i``'s conv
tail and state, and its logits.  The program gives its own outputs; the
control (:func:`observe`) gives the reference's own run in float8 in
their place.  Every number is a worst case:

* ``logit_gap``: over the judged tokens, how far a token's reference logit
  lies below the reference's best at that position (0 where the token is
  the reference's greedy one);
* ``logit_gap_mean`` (and ``logit_gap_p99`` of a decoding): the mean
  (99th percentile) of those gaps;
* ``logits_rel``: ``|obs - ref| / |ref|`` (Frobenius norms) over all the
  logits judged, so that one row far off moves it; ``logits_row``: that
  of each row, its worst, median (``_p50``) and 90th percentile
  (``_p90``);
* ``kv_rel``, ``ssm_state_rel``, ``conv_rel``: the same over each layer's
  cache rows of the judged positions, worst over the layers; ``kv_tok``
  that of each position's keys and of its values, with their median and
  90th percentile, worst over the layers.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import torch

from .common import Precision, exact_float32


def rel(obs: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float((obs.float() - ref).norm() / ref.norm().clamp(min=1e-30))


def rows_rel(obs: torch.Tensor, ref: torch.Tensor, dims: int
             ) -> torch.Tensor:
    """``|obs - ref| / |ref|`` of each row: norms over the last ``dims``
    dims, one value for each index of the others."""
    ref = ref.float()
    d = (obs.float() - ref).flatten(-dims).norm(dim=-1)
    return (d / ref.flatten(-dims).norm(dim=-1).clamp(min=1e-30)).flatten()


def family(name: str):
    return importlib.import_module(f"{__package__}.{name}")


class Worst(dict):
    """The worst value seen of each number."""

    def add(self, name: str, value) -> None:
        self[name] = max(self.get(name, 0.0), float(value))

    def spread(self, name: str, values: torch.Tensor) -> None:
        """A tensor of per-row errors: its largest value under ``name``,
        its median and 90th percentile under ``name_p50`` and
        ``name_p90``."""
        values = values.float().flatten()
        self.add(name, values.max())
        q = torch.quantile(values.cpu(), torch.tensor([0.5, 0.9]))
        self.add(name + "_p50", q[0])
        self.add(name + "_p90", q[1])


def _gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return (ref_logits.max(-1).values
            - ref_logits.gather(-1, tokens[..., None].long())[..., 0])


def _hooks(worst: Worst, S: int, cache: Dict):
    """The reference's callbacks that hold each layer's cache rows against
    the judged side's (``cache["kv"](i)``, ``cache["ssm"](i)``)."""
    def on_kv(i, k, v):
        ok, ov = cache["kv"](i)
        ok, ov = ok[:, :S], ov[:, :S]
        worst.add("kv_rel", max(rel(ok, k), rel(ov, v)))
        worst.spread("kv_tok", torch.cat([rows_rel(ok, k, 2),
                                          rows_rel(ov, v, 2)]))

    def on_ssm(i, tail, state):
        otail, ostate = cache["ssm"](i)
        worst.add("conv_rel", rel(otail, tail))
        worst.add("ssm_state_rel", rel(ostate, state))

    return on_kv, on_ssm


def hidden(arch: dict, fam: str, params: dict, tokens, prec, layout=None,
           on_kv=None, on_ssm=None):
    return family(fam).hidden(arch, params, tokens, prec, layout=layout,
                              on_kv=on_kv, on_ssm=on_ssm)


def prefill(arch: dict, fam: str, params: dict, batches: List[Tuple],
            kept: int, cache: Dict) -> Worst:
    """Prefills of ``batches``, each ``(tokens (B, S), logits (B, V))``:
    the last-position logits observed for those tokens, whose greedy
    tokens are the ones served; ``cache`` is what the prefill of batch
    ``kept`` left."""
    exact_float32()
    prec = Precision()
    worst = Worst()
    w = family(fam).head(params).T
    obs, refs = [], []
    for j, (tokens, logits) in enumerate(batches):
        on_kv, on_ssm = (_hooks(worst, tokens.shape[1], cache) if j == kept
                         else (None, None))
        h = hidden(arch, fam, params, tokens, prec, on_kv=on_kv,
                   on_ssm=on_ssm)
        refs.append(prec.mm(h[:, -1], w))
        obs.append(logits.float())
        del h
    obs, ref = torch.cat(obs), torch.cat(refs)
    gaps = _gaps(ref, obs.argmax(-1))
    worst.add("logit_gap", gaps.max())
    worst.add("logit_gap_mean", gaps.mean())
    worst.spread("logits_row", rows_rel(obs, ref, 1))
    worst.add("logits_rel", rel(obs, ref))
    return worst


def generate(arch: dict, fam: str, params: dict, fed: torch.Tensor,
             judged: torch.Tensor, layout, observed: Dict,
             rows: int = 8) -> Worst:
    """Greedy decoding after a prompt: ``fed (R, P + n)`` is the prompt
    and the tokens fed back, ``judged (R, n + 1)`` the tokens served at
    positions ``P - 1 .. P + n - 1``, ``observed["logits"]`` maps a
    served index ``j`` to the logits ``(R, V)`` that served it, and
    ``observed["kv"]`` the cache after the last fed token."""
    exact_float32()
    prec = Precision()
    worst = Worst()
    on_kv, _ = _hooks(worst, fed.shape[1], observed)
    h = hidden(arch, fam, params, fed, prec, layout=layout, on_kv=on_kv)
    n1 = judged.shape[1]
    h = h[:, -n1:]
    w = family(fam).head(params).T
    gaps, errs, obs, refs = [], [], [], []
    for lo in range(0, h.shape[0], rows):
        ref = prec.mm(h[lo:lo + rows], w)                   # (r, n+1, V)
        gaps.append(_gaps(ref, judged[lo:lo + rows]).flatten())
        for j, logits in observed["logits"].items():
            o, r = logits[lo:lo + rows].float(), ref[:, j]
            errs.append(rows_rel(o, r, 1))
            obs.append(o)
            refs.append(r)
    gaps = torch.cat(gaps)
    worst.add("logit_gap", gaps.max())
    worst.add("logit_gap_mean", gaps.mean())
    worst.add("logit_gap_p99", torch.quantile(gaps.cpu(), 0.99))
    worst.spread("logits_row", torch.cat(errs))
    worst.add("logits_rel", rel(torch.cat(obs), torch.cat(refs)))
    return worst


def observe(arch: dict, fam: str, params: dict, tokens: torch.Tensor,
            prec: Precision, layout=None, positions: int = 1,
            keep: tuple = (), cache: bool = True) -> Dict:
    """The control's outputs in the program's place: the reference run
    in ``prec`` over ``tokens (B, S)``, its cache rows (where ``cache``)
    kept in bfloat16 as a cache holds them.  ``logits`` are those of the
    last position (a prefill's); ``greedy`` the first tokens of the last
    ``positions`` positions; where ``keep`` names served indices,
    ``logits`` maps each to its logits, as a decoding's are kept."""
    kv, ssm = {}, {}
    h = hidden(arch, fam, params, tokens, prec, layout=layout,
               on_kv=(lambda i, k, v: kv.__setitem__(
                   i, (k.bfloat16(), v.bfloat16()))) if cache else None,
               on_ssm=(lambda i, t, s: ssm.__setitem__(i, (t, s)))
               if cache else None)
    w = family(fam).head(params).T
    h = h[:, -positions:]
    greedy, kept = [], {j: [] for j in keep}
    for lo in range(0, h.shape[0], 8):
        logits = prec.mm(h[lo:lo + 8], w)
        greedy.append(logits.argmax(-1))
        for j in keep:
            kept[j].append(logits[:, j])
    out = {"kv": kv.__getitem__, "ssm": ssm.__getitem__,
           "greedy": torch.cat(greedy)}
    if keep:
        out["logits"] = {j: torch.cat(v) for j, v in kept.items()}
    else:
        out["logits"] = prec.mm(h[:, -1], w)
    return out
