"""Resource-saving datapath transforms for bank-resolution arithmetic (Sec 3.4).

The bank-resolution equations (Eq. 1-2) are built from ``*C``, ``/C``, ``%C``
with solver-chosen constants.  Because the solver is free to steer toward
friendly constants, these rewrites remove multipliers / dividers entirely:

* power-of-two:       shift / mask                                   (free)
* Crandall:           ``x % (2^n - 1)`` as shift-add folds           (adders)
* Eq. 6 extension:    ``x % M2`` with ``M2 * k = 2^n - 1`` via Crandall on
                      the Mersenne then a k-wide one-hot mux          (mux)
* binary decomposition: ``x * C`` as a signed-digit (NAF) sum of shifts when
                      the decomposition has at most R nonzero digits

Each rewrite produces a node graph in a tiny expression IR that can be
(1) cost-annotated with an FPGA resource proxy (LUT/FF/DSP) *and* a
scalar-op count, (2) interpreted for exactness testing, and (3) lowered
three ways: to numpy (``lower_np``, int64), to torch tensor ops
(``lower_torch``, the plain version beside the CUDA kernels) and to a
**kernel program** (``lower_kernel_program``): a flat, register-allocated
instruction list that the banked gather/scatter CUDA kernels interpret per
thread in int32, so the very same transformed arithmetic runs in front of
the memory on the GPU.  GPU relevance: integer divide by a runtime value is
a long instruction sequence on the SM too, so the shift/mask/Crandall/NAF
rewrites shorten the hot index path there, not only on FPGAs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Expression IR
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    op: str                      # var|const|add|sub|shl|shr|and|mul|div|mod|ge|select
    args: Tuple["Node", ...] = ()
    value: int = 0               # const value / shift amount / mask / divisor
    name: str = ""
    width: int = 0               # datapath bits (0 = inherit the call width)

    def w(self, bits: int) -> "Node":
        object.__setattr__(self, "width", int(bits))  # frozen-safe annotate
        return self

    def __add__(self, o):  return Node("add", (self, _n(o)))
    def __sub__(self, o):  return Node("sub", (self, _n(o)))
    def __lshift__(self, k): return Node("shl", (self,), value=int(k))
    def __rshift__(self, k): return Node("shr", (self,), value=int(k))
    def __and__(self, m):  return Node("and", (self,), value=int(m))


def _n(x) -> Node:
    return x if isinstance(x, Node) else Node("const", value=int(x))


def var(name: str) -> Node:
    return Node("var", name=name)


def const(v: int) -> Node:
    return Node("const", value=int(v))


def ge(a: Node, b: Node) -> Node:
    return Node("ge", (a, _n(b)))


def select(c: Node, t: Node, f: Node) -> Node:
    return Node("select", (c, _n(t), _n(f)))


def raw_mul(a: Node, c: int) -> Node:
    return Node("mul", (a,), value=int(c))


def raw_div(a: Node, c: int) -> Node:
    return Node("div", (a,), value=int(c))


def raw_mod(a: Node, c: int) -> Node:
    return Node("mod", (a,), value=int(c))


# ---------------------------------------------------------------------------
# Constant classification (the solver steers toward these -- Sec 3.3/3.4)
# ---------------------------------------------------------------------------


def is_pow2(c: int) -> bool:
    return c > 0 and (c & (c - 1)) == 0


def mersenne_exp(c: int) -> Optional[int]:
    """n if c == 2^n - 1 (n >= 1), else None."""
    if c < 1:
        return None
    n = c.bit_length()
    return n if (1 << n) - 1 == c else None


def mersenne_multiple(c: int, R: int = 16) -> Optional[Tuple[int, int]]:
    """(n, k) with c * k == 2^n - 1 for 1 < k < R (paper Eq. 6), else None."""
    for n in range(2, 40):
        M = (1 << n) - 1
        if M % c == 0:
            k = M // c
            if 1 < k < R:
                return n, k
    return None


def naf_digits(c: int) -> List[Tuple[int, int]]:
    """Non-adjacent-form signed-digit decomposition: c = sum s_i * 2^{e_i}."""
    digits = []
    e = 0
    while c != 0:
        if c & 1:
            s = 2 - (c % 4)  # +1 if c%4==1 else -1
            digits.append((s, e))
            c -= s
        c >>= 1
        e += 1
    return digits


def transform_friendliness(c: int, R_mul: int = 2, R_mod: int = 16) -> int:
    """Priority score for solver constants (lower = cheaper in hardware)."""
    if c <= 1 or is_pow2(c):
        return 0
    if mersenne_exp(c) is not None:
        return 1
    if len(naf_digits(c)) <= R_mul:
        return 1
    if mersenne_multiple(c, R_mod) is not None:
        return 2
    return 5


# ---------------------------------------------------------------------------
# Rewrites
# ---------------------------------------------------------------------------


def mul_const(x: Node, c: int, R: int = 4, level: str = "full") -> Node:
    """x * c via signed-digit shift-adds when the NAF has <= R digits.

    ``level='basic'`` models ordinary codegen: power-of-two strength
    reduction only (every HLS tool does this); the NAF/Mersenne rewrites are
    the paper's Sec-3.4 contribution and need ``level='full'``.
    """
    if c == 0:
        return const(0)
    neg = c < 0
    c = abs(c)
    if c == 1:
        out = x
    elif is_pow2(c):
        out = x << int(math.log2(c))
    elif level != "full":
        out = raw_mul(x, c)
    else:
        digits = naf_digits(c)
        if len(digits) <= R:
            out = None
            for s, e in digits:
                term = x << e if e else x
                if out is None:
                    out = term if s > 0 else const(0) - term
                else:
                    out = out + term if s > 0 else out - term
        else:
            out = raw_mul(x, c)
    return const(0) - out if neg else out


def _crandall_mod_mersenne(x: Node, n: int, in_bits: int = 32) -> Node:
    """x mod (2^n - 1) by folding high bits into low bits (Crandall)."""
    M = (1 << n) - 1
    r = x
    bits = in_bits
    while bits > n + 1:
        # r < 2^bits  ->  (r & M) + (r >> n) < 2^n + 2^(bits-n)
        new_bits = max(n, bits - n) + 1
        r = ((r & M) + (r >> n)).w(new_bits)
        bits = new_bits
    if bits > n:
        r = ((r & M) + (r >> n)).w(n + 1)  # now r <= 2^n
    # one conditional subtract handles r in {M, 2^n}
    return select(ge(r, const(M)).w(n + 1), (r - M).w(n), r).w(n)


def mod_const(x: Node, c: int, in_bits: int = 32, R: int = 16,
              level: str = "full") -> Node:
    if c == 1:
        return const(0)
    if is_pow2(c):
        return x & (c - 1)
    if level != "full":
        return raw_mod(x, c)
    n = mersenne_exp(c)
    if n is not None:
        return _crandall_mod_mersenne(x, n, in_bits)
    nk = mersenne_multiple(c, R)
    if nk is not None:
        n, k = nk
        # Eq. 6:  x mod c == (x mod (2^n - 1)) mod c, then the inner value is
        # < 2^n so the outer mod is a k-wide one-hot subtract-mux.  Ascending
        # j so the largest satisfied threshold wins.
        r = _crandall_mod_mersenne(x, n, in_bits)
        out = r
        for j in range(1, k):
            out = select(ge(r, const(j * c)), r - (j * c), out)
        return out
    return raw_mod(x, c)


def div_const(x: Node, c: int, in_bits: int = 32, R: int = 16,
              level: str = "full") -> Node:
    if c == 1:
        return x
    if is_pow2(c):
        return x >> int(math.log2(c))
    if level != "full":
        return raw_div(x, c)
    n = mersenne_exp(c)
    if n is not None:
        # x div (2^n - 1): geometric-series estimate q0 = sum_i (x >> i*n)
        # undershoots floor(x/M) by at most (#terms + 1); fix with that many
        # conditional subtract/increment stages.  q*M == (q<<n) - q: no DSPs.
        q = x >> n
        shift = 2 * n
        terms = 1
        while shift < in_bits:
            q = q + (x >> shift)
            shift += n
            terms += 1
        r = x - ((q << n) - q)
        for _ in range(terms + 1):
            cond = ge(r, const(c))
            q = select(cond, q + 1, q)
            r = select(cond, r - c, r)
        return q
    nk = mersenne_multiple(c, R)
    if nk is not None:
        # x div c = (x div M) * k + (x mod M) div c   with M = c*k Mersenne
        n, k = nk
        M = (1 << n) - 1
        qM = div_const(x, M, in_bits, R)
        rM = mod_const(x, M, in_bits, R)
        qk = const(0)
        for j in range(1, k):
            qk = select(ge(rM, const(j * c)), const(j), qk)
        return mul_const(qM, k, R=4) + qk
    return raw_div(x, c)


# ---------------------------------------------------------------------------
# Interpreters: evaluate / cost / lower to numpy and torch
# ---------------------------------------------------------------------------


def evaluate(node: Node, env: Dict[str, int],
             _memo: Optional[Dict[int, int]] = None) -> int:
    """DAG interpreter (memoized: rewrites share subexpressions heavily)."""
    memo = _memo if _memo is not None else {}
    key = id(node)
    if key in memo:
        return memo[key]
    op = node.op
    if op == "var":
        out = int(env[node.name])
    elif op == "const":
        out = node.value
    else:
        a = evaluate(node.args[0], env, memo)
        if op == "shl":
            out = a << node.value
        elif op == "shr":
            out = a >> node.value
        elif op == "and":
            out = a & node.value
        elif op == "mul":
            out = a * node.value
        elif op == "div":
            out = a // node.value
        elif op == "mod":
            out = a % node.value
        else:
            b = evaluate(node.args[1], env, memo)
            if op == "add":
                out = a + b
            elif op == "sub":
                out = a - b
            elif op == "ge":
                out = int(a >= b)
            elif op == "select":
                out = b if a else evaluate(node.args[2], env, memo)
            else:
                raise ValueError(op)
    memo[key] = out
    return out


@dataclass
class Cost:
    """FPGA proxy + TPU scalar-op cost of an op graph."""

    lut: float = 0.0
    ff: float = 0.0
    dsp: int = 0
    tpu_ops: int = 0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.lut + o.lut, self.ff + o.ff, self.dsp + o.dsp,
                    self.tpu_ops + o.tpu_ops)


_W = 16  # default address-path width for costing


def _op_cost(op: str, w: int = _W) -> Cost:
    if op in ("var", "const", "shl", "shr"):
        return Cost(0, 0, 0, 0 if op in ("var", "const") else 1)
    if op == "and":
        return Cost(0, 0, 0, 1)  # const mask == wiring on FPGA
    if op in ("add", "sub"):
        return Cost(w, w, 0, 1)
    if op == "ge":
        return Cost(w / 2, 0, 0, 1)
    if op == "select":
        return Cost(w / 2, 0, 0, 1)
    if op == "mul":  # un-transformed constant multiply -> DSP
        return Cost(w, w, max(1, (w + 17) // 18), 2)
    if op in ("div", "mod"):  # vendor divider IP / XLA magic-number sequence
        return Cost(4 * w, 2 * w, max(1, (w + 17) // 18), 8)
    raise ValueError(op)


def cost(node: Node, w: int = _W,
         _seen: Optional[Dict[int, Cost]] = None) -> Cost:
    seen = _seen if _seen is not None else {}
    key = id(node)
    if key in seen:
        return Cost()  # shared subexpression counted once (CSE)
    seen[key] = _op_cost(node.op, node.width or w)
    total = seen[key]
    for a in node.args:
        total = total + cost(a, w, seen)
    return total


def _lower_graph(node: Node, const_fn: Callable,
                 where_fn: Callable) -> Callable:
    """Shared DAG interpreter behind ``lower_torch`` / ``lower_np``: one op
    dispatch, parameterized by the backend's const constructor and select.

    Memoized over the DAG so shared subexpressions trace once (the rewrites
    produce heavy sharing; naive recursion is exponential)."""

    def run(n: Node, env, memo):
        key = id(n)
        if key in memo:
            return memo[key]
        op = n.op
        if op == "var":
            out = env[n.name]
        elif op == "const":
            out = const_fn(n.value)
        else:
            a = run(n.args[0], env, memo)
            if op == "shl":
                out = a << n.value
            elif op == "shr":
                out = a >> n.value
            elif op == "and":
                out = a & n.value
            elif op == "mul":
                out = a * n.value
            elif op == "div":
                out = a // n.value
            elif op == "mod":
                out = a % n.value
            else:
                b = run(n.args[1], env, memo)
                if op == "add":
                    out = a + b
                elif op == "sub":
                    out = a - b
                elif op == "ge":
                    out = a >= b
                elif op == "select":
                    out = where_fn(a, b, run(n.args[2], env, memo))
                else:
                    raise ValueError(op)
        memo[key] = out
        return out

    def fn(**env):
        return run(node, env, {})

    return fn


def _torch_where(cond, a, b):
    """``torch.where`` that also takes a plain Python condition (a graph
    whose inputs are all constants folds to Python ints)."""
    import torch

    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def lower_torch(node: Node) -> Callable:
    """Compile the op graph to a function f(**vars) over torch integer
    tensors (any integer dtype; the callers pass int64, which is what torch
    indexing wants).  Constants stay Python ints, so the result follows the
    dtype and device of the inputs; a graph with no ``var`` returns an int.
    ``//`` and ``%`` on torch integer tensors floor like Python's, and
    ``>>`` is arithmetic, so this agrees with ``lower_np`` wherever the
    values fit the dtype."""
    return _lower_graph(node, int, _torch_where)


def lower_np(node: Node) -> Callable:
    """Compile the op graph to a vectorized numpy function f(**vars)."""
    import numpy as np

    return _lower_graph(node, np.int64, np.where)


def count_raw_ops(node: Node) -> Dict[str, int]:
    """Histogram of untransformed mul/div/mod left in a graph."""
    out: Dict[str, int] = {"mul": 0, "div": 0, "mod": 0}
    seen = set()

    def walk(n: Node):
        if id(n) in seen:
            return
        seen.add(id(n))
        if n.op in out:
            out[n.op] += 1
        for a in n.args:
            walk(a)

    walk(node)
    return out


# ---------------------------------------------------------------------------
# Kernel program: the op graphs as data for the CUDA kernels
# ---------------------------------------------------------------------------

# Opcode numbering shared with ``kernels/csrc/banked.cu`` (enum BkOp).
KERNEL_OPS = ("const", "shl", "shr", "and", "mul", "div", "mod",
              "add", "sub", "ge", "select")
KERNEL_OPCODE = {name: i for i, name in enumerate(KERNEL_OPS)}

# Capacities of the kernels' program (``kernels/csrc/banked.cu``).  The
# largest program of the layouts the tests and the server use has 87
# steps (flat N=5 B=3 over 21 rows, full level: Crandall folds plus
# subtract-mux stages) and the widest needs 11 registers (multidim
# Ns=(3, 2)); the two server layouts take 6 steps and 4 registers.
# Beyond these limits lowering raises -- a program is never truncated.
KERNEL_MAX_INSTRS = 192
KERNEL_MAX_REGS = 32
KERNEL_MAX_DIMS = 8
# The kernels take the program by value as a launch parameter, in one of
# these (instruction, register) capacities -- the smallest that holds it:
# a small program is unrolled at compile time, and a register is read
# through a tree of selects as deep as log2 of the register capacity.
KERNEL_BUCKETS = ((8, 4), (32, 16), (192, 32))
# Packed program (see :func:`pack_kernel_program`): a header, four words an
# instruction slot, three a dimension, two a BA graph, and the program's
# sum of terms (:func:`kernel_terms`): a count, a constant and five words a
# term.
KERNEL_HEADER_WORDS = 8
KERNEL_MAX_TERMS = 4
KERNEL_TERMS_WORDS = 2 + 5 * KERNEL_MAX_TERMS

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


@dataclass(frozen=True)
class KernelProgram:
    """BA graphs + BO graph flattened into one register program.

    Registers ``0 .. n_vars-1`` hold the logical coordinates ``x0..``;
    every instruction is ``(op, dst, a, b, imm)`` over int32 registers:

    * ``const``: ``r[dst] = imm``
    * ``shl shr and mul div mod``: ``r[dst] = r[a] <op> imm``
    * ``add sub ge``: ``r[dst] = r[a] <op> r[b]``
    * ``select``: ``r[dst] = r[b] if r[a] else r[imm]``

    Subexpressions shared between the graphs are evaluated once
    (steps are emitted in the topological order
    ``artifact.graph_to_json`` serializes), and registers are reused once
    a value has no reader left, so ``n_regs`` stays small.  An instruction
    reads its operands before it writes ``dst``.
    """

    n_vars: int
    instrs: Tuple[Tuple[int, int, int, int, int], ...]
    ba_regs: Tuple[int, ...]     # one result register per BA graph
    bo_reg: int
    n_regs: int


def lower_kernel_program(ba_graphs: Sequence[Node], bo_graph: Node,
                         n_vars: int) -> KernelProgram:
    """Flatten the resolution graphs into a :class:`KernelProgram`.

    Integer semantics of the interpreters (the CUDA kernels and
    :func:`run_kernel_program`): all registers are int32.  ``add sub mul
    shl`` wrap modulo 2^32 and are exact whenever the true result fits
    int32 (NAF products go transiently negative through ``sub``; that is
    fine, the sum comes back); ``shr`` is arithmetic (floors negatives,
    like Python's ``>>``); ``div``/``mod`` floor like Python's ``//`` and
    ``%`` for either sign of the dividend; ``and`` is two's complement.
    ``build_*_resolution`` size every graph for ``in_bits <= 32`` inputs, and the
    logical addresses are non-negative int32, so every intermediate of a
    layout whose logical size and bank-major size fit int32 is exact.
    Shift amounts outside ``0..31`` and immediates outside int32 raise.
    """
    roots = list(ba_graphs) + [bo_graph]
    if not 1 <= n_vars <= KERNEL_MAX_DIMS:
        raise ValueError(f"kernel program takes 1..{KERNEL_MAX_DIMS} "
                         f"dimensions, got {n_vars}")
    if len(ba_graphs) > KERNEL_MAX_DIMS:
        raise ValueError(f"{len(ba_graphs)} BA graphs exceed the kernel's "
                         f"{KERNEL_MAX_DIMS}")
    order: List[Node] = []
    pos: Dict[int, int] = {}

    def visit(n: Node) -> None:
        if id(n) in pos:
            return
        for a in n.args:
            visit(a)
        pos[id(n)] = len(order)
        order.append(n)

    for r in roots:
        visit(r)
    last_use = {id(n): -1 for n in order}
    for i, n in enumerate(order):
        for a in n.args:
            last_use[id(a)] = i
    for r in roots:
        last_use[id(r)] = len(order)          # results live to the end

    reg: Dict[int, int] = {}
    free: List[int] = []
    n_regs = n_vars
    instrs: List[Tuple[int, int, int, int, int]] = []
    for i, n in enumerate(order):
        if n.op == "var":
            k = int(n.name[1:])
            if not (n.name.startswith("x") and 0 <= k < n_vars):
                raise ValueError(f"unknown variable {n.name!r}")
            reg[id(n)] = k
            continue
        args = [reg[id(a)] for a in n.args]
        for a in n.args:                      # operands are read first ...
            if a.op != "var" and last_use[id(a)] == i \
                    and reg[id(a)] not in free:
                free.append(reg[id(a)])
        if free:                              # ... so dst may reuse one
            free.sort()
            dst = free.pop(0)
        else:
            dst = n_regs
            n_regs += 1
        reg[id(n)] = dst
        imm = int(n.value)
        if n.op == "const":
            ins = (KERNEL_OPCODE["const"], dst, 0, 0, imm)
        elif n.op in ("shl", "shr", "and", "mul", "div", "mod"):
            if n.op in ("shl", "shr") and not 0 <= imm <= 31:
                raise ValueError(f"shift by {imm} is outside 0..31")
            if n.op in ("div", "mod") and imm == 0:
                raise ValueError(f"{n.op} by zero")
            ins = (KERNEL_OPCODE[n.op], dst, args[0], 0, imm)
        elif n.op in ("add", "sub", "ge"):
            ins = (KERNEL_OPCODE[n.op], dst, args[0], args[1], 0)
        elif n.op == "select":
            ins = (KERNEL_OPCODE["select"], dst, args[0], args[1], args[2])
        else:
            raise ValueError(n.op)
        if not _INT32_MIN <= ins[4] <= _INT32_MAX:
            raise ValueError(f"immediate {ins[4]} of {n.op} does not fit "
                             f"int32")
        instrs.append(ins)
    if len(instrs) > KERNEL_MAX_INSTRS:
        raise ValueError(f"resolution program has {len(instrs)} "
                         f"steps; the kernel holds "
                         f"{KERNEL_MAX_INSTRS}")
    if n_regs > KERNEL_MAX_REGS:
        raise ValueError(f"resolution program needs {n_regs} registers; "
                         f"the kernel holds {KERNEL_MAX_REGS}")
    return KernelProgram(
        n_vars=n_vars, instrs=tuple(instrs),
        ba_regs=tuple(reg[id(g)] for g in ba_graphs),
        bo_reg=reg[id(bo_graph)], n_regs=n_regs)


def _interpret(instrs, n_regs: int, xs):
    """Run register instructions ``(op, dst, a, b, imm)`` on numpy int32
    vectors ``xs`` (registers 0..); returns the register file."""
    import numpy as np

    xs = [np.asarray(x).astype(np.int32) for x in xs]
    shape = np.broadcast_shapes(*[x.shape for x in xs])
    r = [np.zeros(shape, np.int32) for _ in range(n_regs)]
    for i, x in enumerate(xs):
        r[i] = np.broadcast_to(x, shape)
    with np.errstate(over="ignore"):
        for op, dst, a, b, imm in instrs:
            name = KERNEL_OPS[op]
            c = np.int32(imm)
            if name == "const":
                v = np.full(shape, c, np.int32)
            elif name == "shl":
                v = r[a] << c
            elif name == "shr":
                v = r[a] >> c
            elif name == "and":
                v = r[a] & c
            elif name == "mul":
                v = r[a] * c
            elif name == "div":
                v = r[a] // c
            elif name == "mod":
                v = r[a] % c
            elif name == "add":
                v = r[a] + r[b]
            elif name == "sub":
                v = r[a] - r[b]
            elif name == "ge":
                v = (r[a] >= r[b]).astype(np.int32)
            else:
                v = np.where(r[a] != 0, r[b], r[imm])
            r[dst] = v.astype(np.int32)
    return r


def run_kernel_program(prog: KernelProgram, xs):
    """Interpret a :class:`KernelProgram` on numpy int32 vectors exactly as
    the CUDA kernels do per thread; returns ``(ba values, bo)`` with one
    array per BA graph.  The CPU stand-in for reading the kernel."""
    r = _interpret(prog.instrs, prog.n_regs, xs)
    return [r[k] for k in prog.ba_regs], r[prog.bo_reg]


def kernel_bucket(prog: KernelProgram) -> Tuple[int, int]:
    """``(instruction capacity, register capacity)``: the smallest of
    ``KERNEL_BUCKETS`` that holds ``prog``."""
    for cap in KERNEL_BUCKETS:
        if len(prog.instrs) <= cap[0] and prog.n_regs <= cap[1]:
            return cap
    raise ValueError(f"{len(prog.instrs)} steps and {prog.n_regs} registers "
                     f"exceed the kernels' {KERNEL_BUCKETS[-1]}")


def kernel_program_words(capacity: int) -> int:
    """Words of a program packed for ``capacity`` instructions."""
    return (KERNEL_HEADER_WORDS + 4 * capacity + 3 * KERNEL_MAX_DIMS
            + 2 * KERNEL_MAX_DIMS + KERNEL_TERMS_WORDS)


# Kinds of packed instructions: all of const shl shr and mul add sub are
# one branch-free LINEAR form; the others keep their own.
KIND_LINEAR, KIND_GE, KIND_SELECT, KIND_DIV, KIND_MOD = range(5)


def _packed_instr(op: int, dst: int, a: int, b: int, imm: int):
    """One instruction as the kernels read it: ``(code, ma, mb, km)``.

    ``code = kind | dst << 3 | a << 8 | b << 13 | s << 18 | mask << 23``.
    LINEAR computes ``t = r[a] * ma + r[b] * mb`` (wrapping int32), adds
    ``km`` when the mask bit is clear, shifts ``t`` right by ``s``
    (arithmetic) and ands it with ``km`` when the bit is set: const is
    ``(0, 0, imm)``, shl multiplies by ``2**imm``, shr shifts, and masks,
    mul multiplies, add and sub take ``mb = +-1``.  GE compares ``r[a] >=
    r[b]``; SELECT takes ``r[b] if r[a] else r[km]``; DIV and MOD floor by
    ``km``."""
    name = KERNEL_OPS[op]
    ma, mb, km, sh, mask = 1, 0, 0, 0, 0
    kind = KIND_LINEAR
    if name == "const":
        ma, km = 0, imm
    elif name == "shl":
        ma = (1 << imm) - (1 << 32 if imm == 31 else 0)
    elif name == "shr":
        sh = imm
    elif name == "and":
        km, mask = imm, 1
    elif name == "mul":
        ma = imm
    elif name in ("add", "sub"):
        mb = 1 if name == "add" else -1
    else:
        kind = {"ge": KIND_GE, "select": KIND_SELECT, "div": KIND_DIV,
                "mod": KIND_MOD}[name]
        km = imm
    code = kind | dst << 3 | a << 8 | b << 13 | sh << 18 | mask << 23
    return code, ma, mb, km


def split_constants(d: int) -> Tuple[int, int]:
    """``(m, s)`` with ``n // d == (n * m) >> s`` for every ``0 <= n <
    2**31``: ``s = 31 + ceil(log2 d)``, ``m = ceil(2**s / d) < 2**32``
    (Granlund and Montgomery's round-up multiplier for 31-bit dividends).
    The kernels split a logical address into coordinates with one 32 x 32
    -> 64-bit product per dimension instead of a division."""
    if not 1 <= d < (1 << 31):
        raise ValueError(f"dimension {d} is outside [1, 2**31)")
    s = 31 + (d - 1).bit_length()
    return -(-(1 << s) // d), s


def pack_kernel_program(prog: KernelProgram, dims: Sequence[int],
                        ba_fold: Sequence[int], logical_size: int,
                        bank_volume: int):
    """The program as the CUDA kernels take it: int32 words, laid out as
    ``BkLayout<capacity>`` of ``csrc/banked.cu`` reads them, for the
    smallest :func:`kernel_bucket` that holds it.

    * header (``KERNEL_HEADER_WORDS``): ``n_instrs, n_regs, n_dims, n_ba,
      bo_reg, logical_size, bank_volume, capacity``
    * ``capacity`` instruction slots of four words (:func:`_packed_instr`),
      after :func:`fuse_linear_steps`; the unused ones zero
    * ``KERNEL_MAX_DIMS`` dimensions of three words, outermost first: ``d``
      and the multiplier ``m`` (the bits of a uint32) and shift of
      :func:`split_constants`
    * ``KERNEL_MAX_DIMS`` BA graphs of two words: the result register and
      the bank count it folds in (``ba = ba * fold + r[reg]``; 1 for a flat
      layout)
    * the sum of terms (``KERNEL_TERMS_WORDS``): the number of terms (0
      where :func:`kernel_terms` finds none), the constant, and
      ``KERNEL_MAX_TERMS`` terms of five words ``m, k, s, mask, c``

    :func:`run_packed_program` reads the instructions on the CPU and
    :func:`run_packed_terms` the terms."""
    import numpy as np

    if not len(prog.ba_regs) == len(ba_fold) >= 1:
        raise ValueError(f"{len(prog.ba_regs)} BA graphs, {len(ba_fold)} "
                         f"folds")
    if len(dims) != prog.n_vars:
        raise ValueError(f"{len(dims)} dimensions for a program of "
                         f"{prog.n_vars} variables")
    if logical_size > _INT32_MAX:
        raise ValueError(f"logical size {logical_size} does not fit int32")
    capacity = kernel_bucket(prog)[0]
    results = set(prog.ba_regs) | {prog.bo_reg}
    ins = fuse_linear_steps([_packed_instr(*i) for i in prog.instrs],
                            results)
    words = np.zeros(kernel_program_words(capacity), np.int64)
    words[:KERNEL_HEADER_WORDS] = [
        len(ins), prog.n_regs, len(dims), len(prog.ba_regs),
        prog.bo_reg, logical_size, bank_volume, capacity]
    at = KERNEL_HEADER_WORDS
    for i, row in enumerate(ins):
        words[at + 4 * i:at + 4 * i + 4] = row
    at += 4 * capacity
    for i, d in enumerate(dims):
        words[at + 3 * i:at + 3 * i + 3] = (int(d),) + split_constants(int(d))
    at += 3 * KERNEL_MAX_DIMS
    for k, (reg, n) in enumerate(zip(prog.ba_regs, ba_fold)):
        words[at + 2 * k:at + 2 * k + 2] = (reg, int(n))
    at += 2 * KERNEL_MAX_DIMS
    if len(dims) == 1 and len(prog.ba_regs) == 1:
        terms = kernel_terms(ins, prog.n_regs, prog.ba_regs[0], prog.bo_reg,
                             bank_volume)
        if terms is not None:
            base, rows = terms
            words[at:at + 2] = (len(rows), base)
            for j, row in enumerate(rows):
                words[at + 2 + 5 * j:at + 7 + 5 * j] = row
    return (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# Shortening the chain: fused LINEAR steps and the sum of terms
# ---------------------------------------------------------------------------


def _i32(x: int) -> int:
    """``x`` wrapped to a signed int32, as the kernels' registers hold it."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def _linear_fields(row):
    """A packed LINEAR instruction as ``(dst, a, b, ma, mb, k, s, mask)``:
    ``r[dst] = ((r[a] * ma + r[b] * mb + k) >> s) & mask``."""
    code, ma, mb, km = (int(x) for x in row)
    masked = (code >> 23) & 1
    return ((code >> 3) & 31, (code >> 8) & 31, (code >> 13) & 31,
            _i32(ma), _i32(mb), 0 if masked else _i32(km),
            (code >> 18) & 31, _i32(km) if masked else -1)


def _linear_row(dst, a, b, ma, mb, k, s, mask):
    """The inverse of :func:`_linear_fields`, or None where the packed form
    would need both a constant and a mask."""
    if k and mask != -1:
        return None
    masked = mask != -1
    code = (KIND_LINEAR | dst << 3 | a << 8 | b << 13 | s << 18
            | int(masked) << 23)
    return code, _i32(ma), _i32(mb), _i32(mask if masked else k)


def _reads(row):
    """The registers an instruction reads (LINEAR: those with a factor)."""
    code, ma, mb, km = (int(x) for x in row)
    kind, a, b = code & 7, (code >> 8) & 31, (code >> 13) & 31
    if kind == KIND_LINEAR:
        return {r for r, m in ((a, ma), (b, mb)) if _i32(m)}
    if kind == KIND_SELECT:
        return {a, b, int(km)}
    return {a, b} if kind == KIND_GE else {a}


def _only_reader(ins, i, results) -> bool:
    """Whether step ``i + 1`` is the one reader of step ``i``'s value."""
    d = (ins[i][0] >> 3) & 31
    if d not in _reads(ins[i + 1]):
        return False
    for j in range(i + 1, len(ins)):
        if j > i + 1 and d in _reads(ins[j]):
            return False
        if (ins[j][0] >> 3) & 31 == d:         # the value ends here
            return True
    return d not in results


def _fuse_pair(first, second):
    """One LINEAR step that gives what ``second`` computes from the value
    of ``first`` (``second`` reads nothing else), or None: anything after a
    step without shift or mask, a shift or a mask after a shift or a mask
    (``((t >> s1) & m1) >> s2 & m2 == (t >> s1 + s2) & (m1 >> s2 & m2)``,
    arithmetic shifts capped at 31), and a left shift after either
    (``((t >> s) & m) << e == (t >> s - e) & (m << e)`` for ``s >= e``,
    else ``(t << e - s) & (m << e)``)."""
    d1, a, b, ma, mb, k, s1, m1 = _linear_fields(first)
    d2, a2, _, ma2, mb2, k2, s2, m2 = _linear_fields(second)
    if a2 != d1 or mb2 != 0:
        return None
    if s1 == 0 and m1 == -1:                   # linear, then anything
        return _linear_row(d2, a, b, ma * ma2, mb * ma2, k * ma2 + k2, s2, m2)
    if k2:
        return None
    if ma2 == 1:                               # shift/mask, then shift/mask
        return _linear_row(d2, a, b, ma, mb, k, min(s1 + s2, 31),
                           _i32((m1 >> s2) & m2))
    e = ma2.bit_length() - 1
    if ma2 <= 0 or ma2 != 1 << e or s2 or m2 != -1:
        return None                            # not a left shift
    if s1 >= e:
        return _linear_row(d2, a, b, ma, mb, k, s1 - e, _i32(m1 << e))
    f = 1 << (e - s1)
    return _linear_row(d2, a, b, ma * f, mb * f, k * f, 0, _i32(m1 << e))


def fuse_linear_steps(ins, results):
    """Packed instructions (rows ``(code, ma, mb, km)``) with each LINEAR
    step whose value only the next LINEAR step reads merged into it, where
    one LINEAR step holds both (:func:`_fuse_pair`): the server's ``shr 4;
    and 7`` becomes ``(a >> 4) & 7`` and ``shr 7; shl 4`` becomes ``(a >>
    3) & -16``.  ``results``: the registers read after the last step (BA
    and BO).  Every step is a link of the kernels' dependent chain."""
    ins = [tuple(int(x) for x in row) for row in ins]
    i = 0
    while i + 1 < len(ins):
        fused = None
        if ins[i][0] & 7 == KIND_LINEAR == ins[i + 1][0] & 7 \
                and _only_reader(ins, i, results):
            fused = _fuse_pair(ins[i], ins[i + 1])
        if fused is None:
            i += 1
        else:
            ins[i:i + 2] = [fused]
    return ins


# A term ((a * m + k) >> s) & mask of the address a, as (m, k, s, mask);
# (1, 0, 0, -1) is the address itself.
_ADDRESS = (1, 0, 0, -1)


def _combine(x, y, cx, cy):
    """``cx * x + cy * y`` of two sums of terms ``(constant, {term:
    factor})``, wrapping like int32 registers."""
    factors = {}
    for (_, f), c in ((x, cx), (y, cy)):
        for term, v in f.items():
            factors[term] = _i32(factors.get(term, 0) + c * v)
    return (_i32(cx * x[0] + cy * y[0]),
            {t: v for t, v in factors.items() if v})


def _apply_shift_mask(t, s, mask):
    """``(t >> s) & mask`` of a sum of terms, when that is one term again:
    an affine function of the address becomes a term; one term with factor
    1 shifts and masks further.  None otherwise."""
    const, f = t
    if not f:
        return (_i32(const) >> s) & mask, {}
    if len(f) != 1:
        return None
    (m, k, s0, m0), c = next(iter(f.items()))
    if (m, k, s0, m0) == _ADDRESS:             # (a * c + const) >> s & mask
        term = (c, const, s, mask)
    elif c == 1 and const == 0:
        term = (m, k, min(s0 + s, 31), _i32((m0 >> s) & mask))
    else:
        return None
    return (0, {}) if term[3] == 0 else (0, {term: 1})


def kernel_terms(ins, n_regs: int, ba_reg: int, bo_reg: int, volume: int):
    """The row ``BA * volume + BO`` of a program over one address ``a``,
    run symbolically, as ``(base, [(m, k, s, mask, c), ...])`` with

        row = base + sum_k c_k * (((a * m_k + k_k) >> s_k) & mask_k)

    in int32 arithmetic that wraps, or None when a step is not LINEAR, a
    shift or mask applies to a sum of several terms, or more than
    ``KERNEL_MAX_TERMS`` terms remain.  The kernels (``BkTerms``) compute
    the terms side by side, so the chain is one term deep, whatever the
    program's length: the server's layout is ``128 * ((a >> 4) & 7) + ((a
    >> 3) & -16) + (a & 15)``.  Exact for every address whose BA and BO
    fit the table (the layout's row fits int32): add, sub, mul and shl
    wrap modulo 2^32 in both forms."""
    r = [(0, {})] * max(n_regs, 1)
    r[0] = (0, {_ADDRESS: 1})
    for row in ins:
        if int(row[0]) & 7 != KIND_LINEAR:
            return None
        dst, a, b, ma, mb, k, s, mask = _linear_fields(row)
        t = _combine(r[a], r[b], ma, mb)
        t = (_i32(t[0] + k), t[1])
        if (s, mask) != (0, -1):
            t = _apply_shift_mask(t, s, mask)
            if t is None:
                return None
        r[dst] = t
    base, f = _combine(r[ba_reg], r[bo_reg], volume, 1)
    if len(f) > KERNEL_MAX_TERMS:
        return None
    rows = [(*term, c) for term, c in sorted(f.items())] or [(*_ADDRESS, 0)]
    return base, rows


def run_packed_terms(words, addr):
    """The CPU twin of the kernels' ``BkTerms::resolve``: the row of each
    flat logical address from the packed sum of terms
    (:func:`pack_kernel_program`), in int32 arithmetic that wraps, or -1
    where the address lies outside ``[0, logical_size)``.  Raises when the
    program has no sum of terms."""
    import numpy as np

    w = np.asarray(words, dtype=np.int32)
    size, capacity = int(w[5]), int(w[7])
    at = kernel_program_words(capacity) - KERNEL_TERMS_WORDS
    n, base = int(w[at]), w[at + 1]
    if n == 0:
        raise ValueError("the program has no sum of terms")
    addr = np.asarray(addr, dtype=np.int64)
    inside = (addr >= 0) & (addr < size)
    a = np.where(inside, addr, 0).astype(np.int32)
    row = np.full(addr.shape, base, np.int32)
    with np.errstate(over="ignore"):
        for m, k, s, mask, c in w[at + 2:at + 2 + 5 * n].reshape(n, 5):
            row += c * (((a * m + k) >> s) & mask)
    return np.where(inside, row.astype(np.int64), -1)


def run_packed_instrs(ins, r):
    """Run packed instructions (rows ``(code, ma, mb, km)``, see
    :func:`_packed_instr`) on the int32 register file ``r`` (a list of
    numpy arrays, updated and returned), as the kernels' ``bk_step``."""
    import numpy as np

    with np.errstate(over="ignore"):
        for code, ma, mb, km in np.asarray(ins, np.int64).tolist():
            kind, dst = code & 7, (code >> 3) & 31
            a, b = r[(code >> 8) & 31], r[(code >> 13) & 31]
            if kind == KIND_LINEAR:
                t = a * np.int32(ma) + b * np.int32(mb)
                masked = (code >> 23) & 1
                t = (t if masked else t + np.int32(km)) >> ((code >> 18) & 31)
                v = t & np.int32(km) if masked else t
            elif kind == KIND_GE:
                v = (a >= b).astype(np.int32)
            elif kind == KIND_SELECT:
                v = np.where(a != 0, b, r[km])
            elif kind == KIND_DIV:
                v = a // np.int32(km)
            else:
                v = a % np.int32(km)
            r[dst] = np.asarray(v).astype(np.int32)
    return r


def run_packed_program(words, addr):
    """The CPU twin of the kernels' ``bk_resolve``: read packed ``words``
    (:func:`pack_kernel_program`), split each flat logical address with the
    packed multipliers, run the packed instructions, fold the banks;
    returns the int64 row ``bank * bank_volume + offset`` of the bank-major
    table, or -1 where the address lies outside ``[0, logical_size)``."""
    import numpy as np

    w = np.asarray(words, dtype=np.int32)
    n_instrs, n_regs, n_dims, n_ba, bo_reg, size, volume, capacity = (
        int(x) for x in w[:KERNEL_HEADER_WORDS])
    if w.size != kernel_program_words(capacity):
        raise ValueError(f"{w.size} words for a capacity of {capacity}")
    at = KERNEL_HEADER_WORDS
    ins = w[at:at + 4 * n_instrs].reshape(n_instrs, 4)
    at += 4 * capacity
    split = w[at:at + 3 * n_dims].reshape(n_dims, 3).view(np.uint32)
    at += 3 * KERNEL_MAX_DIMS
    fold = w[at:at + 2 * n_ba].reshape(n_ba, 2)

    addr = np.asarray(addr, dtype=np.int64)
    inside = (addr >= 0) & (addr < size)
    rem = np.where(inside, addr, 0).astype(np.uint64)
    r = [np.zeros(addr.shape, np.int32) for _ in range(max(n_regs, n_dims))]
    for i in range(n_dims - 1, 0, -1):       # innermost first; x0 is left
        d, m, sh = (np.uint64(v) for v in split[i])
        q = (rem * m) >> sh
        r[i] = (rem - q * d).astype(np.int32)
        rem = q
    r[0] = rem.astype(np.int32)
    r = run_packed_instrs(ins, r)
    ba = np.zeros(addr.shape, np.int64)
    for reg, n in fold:
        ba = ba * int(n) + r[reg]
    return np.where(inside, ba * volume + r[bo_reg], -1)


# ---------------------------------------------------------------------------
# Bank-resolution circuit construction (Eq. 1-2 under the transforms)
# ---------------------------------------------------------------------------


def build_flat_resolution(
    N: int, B: int, alpha: Tuple[int, ...], P: Tuple[int, ...],
    dims: Tuple[int, ...], in_bits: int = 32, level: str = "full",
) -> Tuple[Node, Node]:
    """(BA, BO) op graphs for a flat geometry, inputs x0..x{n-1}."""
    xs = [var(f"x{i}") for i in range(len(dims))]
    y = None
    for xi, a in zip(xs, alpha):
        if a == 0:
            continue
        t = mul_const(xi, a, level=level)
        y = t if y is None else y + t
    if y is None:
        y = const(0)
    ba = mod_const(div_const(y, B, in_bits, level=level), N, in_bits, level=level)
    off = None
    for i in range(len(dims)):
        stride = 1
        for j in range(i + 1, len(dims)):
            stride *= -(-dims[j] // P[j])
        term = mul_const(div_const(xs[i], P[i], in_bits, level=level), stride,
                         level=level)
        off = term if off is None else off + term
    bo = mul_const(off, B, level=level) + mod_const(y, B, in_bits, level=level)
    return ba, bo


def build_multidim_resolution(
    Ns: Tuple[int, ...], Bs: Tuple[int, ...], alphas: Tuple[int, ...],
    dims: Tuple[int, ...], in_bits: int = 32, level: str = "full",
) -> Tuple[Tuple[Node, ...], Node]:
    """(per-dim BA nodes, BO node) for a multidimensional geometry."""
    bas = []
    coords = []
    sizes = []
    for d, (n_, b_, a_) in enumerate(zip(Ns, Bs, alphas)):
        x = var(f"x{d}")
        y = mul_const(x, a_, level=level)
        bas.append(mod_const(div_const(y, b_, in_bits, level=level), n_,
                             in_bits, level=level))
        blocks = -(-dims[d] * a_ // b_)
        per_bank = -(-blocks // n_)
        block = div_const(y, b_ * n_, in_bits, level=level)
        within = mod_const(y, b_, in_bits, level=level)
        coords.append(mul_const(block, b_, level=level) + within)
        sizes.append(per_bank * b_)
    bo = None
    for c, s in zip(coords, sizes):
        bo = c if bo is None else mul_const(bo, s, level=level) + c
    return tuple(bas), bo
