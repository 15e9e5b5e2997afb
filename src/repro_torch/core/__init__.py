"""Core banking system: the paper's contribution as a composable library.

This package holds the banking math (polytopes, controllers, grouping,
hyperplane geometries, the Sec-3.4 datapath transforms, resource
estimates), the candidate-space solver, and the executable artifact:
``compile_solution`` lowers a solved scheme once into a
``CompiledBankingPlan`` owning the physical layout, the BA/BO resolution
callables, the kernel program the CUDA kernels interpret, pack/unpack and
the (batched) gather/scatter bindings.  The planning plane (planner,
store, service) is not part of this package yet.
"""

from .artifact import (
    BankingLayout,
    CompiledBankingPlan,
    as_compiled,
    compile_geometry,
    compile_solution,
    compile_trivial,
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
from .controller import AccessDecl, Counter, Ctrl, Program, Sched, Unroll, unroll
from .geometry import FlatGeometry, MultiDimGeometry
from .grouping import build_groups
from .polytope import Access, AccessGroup, Affine, Iterator, MemorySpec
from .solver import BankingSolution, SolverOptions, solve, solve_monolithic
from .transforms import (
    KernelProgram,
    lower_kernel_program,
    lower_np,
    lower_torch,
    run_kernel_program,
)

__all__ = [
    "Access", "AccessDecl", "AccessGroup", "Affine", "BankingLayout",
    "BankingSolution", "Candidate", "CandidateSpace", "CompiledBankingPlan",
    "Counter", "Ctrl", "CutGate", "FlatGeometry", "Iterator",
    "KernelProgram", "MemorySpec", "MultiDimGeometry", "Program", "Sched",
    "SolutionReducer", "SolveShard", "SolverOptions", "Unroll",
    "as_compiled", "build_groups", "compile_geometry", "compile_solution",
    "compile_trivial", "evaluate", "evaluate_parallel",
    "lower_kernel_program", "lower_np", "lower_torch", "run_kernel_program",
    "shard_from_indices", "solve", "solve_monolithic", "solve_space",
    "space_from_wire", "space_to_wire", "unroll",
]
