"""Core banking system: the paper's contribution as a composable library.

The front door is the **service subsystem**: ``PlanService.submit`` poses
a banking problem and returns a ``PlanTicket`` -- warm caches/stores
answer before the ticket is returned, cold solves run on a worker pool,
and ``ticket.fallback()`` gives an immediately executable trivial-scheme
artifact to serve from until the solved one lands (hot-swap).  The
blocking ``BankingPlanner.plan`` is a thin ``submit(...).result()`` over
the same code path.  Plans *execute* through compiled artifacts:
``plan.compile()`` lowers the chosen scheme once into a
``CompiledBankingPlan`` owning the physical layout, the BA/BO resolution
callables, the kernel program the CUDA kernels interpret, pack/unpack and
the (batched) gather/scatter bindings -- every consumer outside ``core/``
goes through it.  Durability is a pluggable ``PlanStore``: ``MemoryStore``
in process, lock-file-guarded ``DirectoryStore`` across processes, in the
same on-disk layout as the JAX package's, so one store directory serves
both.  A remote solve fabric is not part of this package yet: a service
asked for the ``"fabric"`` executor without one runs on its pool.
"""

from .artifact import (
    BankingLayout,
    CompiledBankingPlan,
    as_compiled,
    compile_geometry,
    compile_plan,
    compile_solution,
    compile_trivial,
    lane_compile,
)
from .candidates import (
    Candidate,
    CandidateSpace,
    CutGate,
    SolutionReducer,
    SolveShard,
    evaluate,
    evaluate_parallel,
    shard_from_indices,
    solve_space,
    space_from_wire,
    space_to_wire,
)
from ..runtime.tenancy import (
    AdmissionError,
    QOS_CLASSES,
    QoSClass,
    TenantRegistry,
)
from .controller import AccessDecl, Counter, Ctrl, Program, Sched, Unroll, unroll
from .geometry import FlatGeometry, MultiDimGeometry
from .planner import (
    BankingPlan,
    BankingPlanner,
    PlanRequest,
    PreparedRequest,
    canonical_signature,
    default_planner,
    family_signature,
    program_signature,
    rank_solutions,
    register_scorer,
    registered_scorers,
    resolve_scorer,
    set_ml_scorer_path,
)
from .jointplan import (
    FrontierPoint,
    JointMember,
    JointPlan,
    JointRequest,
    JointSelection,
    ResourceBudget,
    ResourceUse,
    co_select,
    joint_signature,
    pareto_frontier,
    trivial_solution,
)
from .polytope import Access, AccessGroup, Affine, Iterator, MemorySpec
from .service import (
    JointTicket,
    PlanService,
    PlanTicket,
    StaleWhileRevalidate,
    default_service,
)
from .solver import BankingSolution, SolverOptions, solve, solve_monolithic
from .store import DirectoryStore, MemoryStore, PlanStore
from .tracing import (
    FlightRecorder,
    MetricsRegistry,
    Span,
    TicketTrace,
    Tracer,
    chrome_trace_events,
    new_trace_id,
    start_observability_server,
)
from .telemetry import (
    MeasuredCost,
    MeasuredScorer,
    ServiceTelemetry,
    TelemetryConfig,
    TelemetryLog,
    default_telemetry_log,
    roofline_prior_seconds,
    scheme_hash,
)
from .grouping import build_groups
from .transforms import (
    KernelProgram,
    lower_kernel_program,
    lower_np,
    lower_torch,
    run_kernel_program,
)

__all__ = [
    "Access", "AccessDecl", "AccessGroup", "AdmissionError", "Affine",
    "BankingLayout",
    "BankingPlan", "BankingPlanner", "BankingSolution", "Candidate",
    "CandidateSpace", "CompiledBankingPlan", "Counter", "Ctrl", "CutGate",
    "DirectoryStore", "FlatGeometry", "FlightRecorder", "FrontierPoint",
    "Iterator",
    "JointMember", "JointPlan", "JointRequest", "JointSelection",
    "JointTicket", "KernelProgram", "MeasuredCost",
    "MeasuredScorer", "MemorySpec", "MemoryStore", "MetricsRegistry",
    "MultiDimGeometry",
    "PlanRequest", "PlanService", "PlanStore", "PlanTicket",
    "PreparedRequest", "Program", "QOS_CLASSES", "QoSClass",
    "ResourceBudget", "ResourceUse", "Sched",
    "ServiceTelemetry",
    "SolutionReducer", "SolveShard", "SolverOptions",
    "Span", "StaleWhileRevalidate", "TelemetryConfig", "TelemetryLog",
    "TenantRegistry", "TicketTrace", "Tracer", "Unroll",
    "as_compiled", "build_groups", "canonical_signature",
    "chrome_trace_events", "co_select",
    "compile_geometry", "compile_plan", "compile_solution",
    "compile_trivial", "default_planner", "default_service",
    "default_telemetry_log", "evaluate", "evaluate_parallel",
    "family_signature", "joint_signature", "lane_compile",
    "lower_kernel_program", "lower_np", "lower_torch",
    "new_trace_id", "pareto_frontier", "program_signature",
    "rank_solutions", "register_scorer", "registered_scorers",
    "resolve_scorer", "roofline_prior_seconds", "run_kernel_program",
    "scheme_hash", "set_ml_scorer_path", "shard_from_indices", "solve",
    "solve_monolithic", "solve_space", "space_from_wire", "space_to_wire",
    "start_observability_server", "trivial_solution", "unroll",
]
