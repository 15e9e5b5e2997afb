"""Static verification layer: lint before solving, certify after.

Two passes over the banking spine, both independent of the solver's own
decision procedure:

* :mod:`repro_torch.analysis.lint` -- :func:`lint_program` flags problems no
  banking can fix (out-of-bounds accesses, colliding ``Sym`` keys,
  degenerate counters, port over-subscription) before a solve queues.
* :mod:`repro_torch.analysis.certify` -- :func:`certify_solution` re-decides
  every access pair of a finished scheme via bounded lattice
  enumeration + residue-witness sets, emitting a machine-checkable
  :class:`ConflictCertificate` or a concrete :class:`Counterexample`.

``PlanService.submit(..., verify="store"|"all")`` arms both in the
serving path; ``python -m repro_torch.analysis`` audits an existing plan
store offline.
"""

from .certify import (CERTIFICATE_FORMAT, CertificationError,
                      CertifyResult, ConflictCertificate, Counterexample,
                      PairDecision, certificate_matches_plan, certify_plan,
                      certify_solution, check_certificate, decide_delta,
                      make_batch_verifier)
from .lint import Diagnostic, LintError, LintReport, lint_program

__all__ = [
    "CERTIFICATE_FORMAT",
    "CertificationError",
    "CertifyResult",
    "ConflictCertificate",
    "Counterexample",
    "Diagnostic",
    "LintError",
    "LintReport",
    "PairDecision",
    "certificate_matches_plan",
    "certify_plan",
    "certify_solution",
    "check_certificate",
    "decide_delta",
    "lint_program",
    "make_batch_verifier",
]
