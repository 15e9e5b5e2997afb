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

# Capacities of the kernel's by-value program struct (BkProgram).  The
# largest program of the layouts the tests and the server use has 87
# steps (flat N=5 B=3 over 21 rows, full level: Crandall folds plus
# subtract-mux stages) and the widest needs 11 registers (multidim
# Ns=(3, 2)); the two server layouts take 6 steps.  Beyond these
# limits lowering raises -- a program is never truncated.
KERNEL_MAX_INSTRS = 192
KERNEL_MAX_REGS = 32
KERNEL_MAX_DIMS = 8

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


def run_kernel_program(prog: KernelProgram, xs):
    """Interpret a :class:`KernelProgram` on numpy int32 vectors exactly as
    the CUDA kernels do per thread; returns ``(ba values, bo)`` with one
    array per BA graph.  The CPU stand-in for reading the kernel."""
    import numpy as np

    xs = [np.asarray(x).astype(np.int32) for x in xs]
    shape = np.broadcast_shapes(*[x.shape for x in xs])
    r = [np.zeros(shape, np.int32) for _ in range(prog.n_regs)]
    for i, x in enumerate(xs):
        r[i] = np.broadcast_to(x, shape)
    with np.errstate(over="ignore"):
        for op, dst, a, b, imm in prog.instrs:
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
    return [r[k] for k in prog.ba_regs], r[prog.bo_reg]


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
