"""Batched serving loop: continuous-batching decode with a paged KV cache.

Serving structure (vLLM-style):

* requests queue in; the scheduler packs up to ``max_batch`` active
  sequences into the fixed decode batch (slots);
* prefill runs per request through the decode step, its KV written into the
  slot's region of the cache;
* one ``serve_step`` decodes a token for every active slot per tick;
* finished sequences (``max_new`` reached) free their slot for the next
  queued request -- continuous batching.

The cache pages are banks from the banking solver (pages = banks, page
size = bank volume).  The server takes a solved ``CompiledBankingPlan``;
it can start on the trivial single-bank artifact (``compile_trivial``) and
hot-swap the page pool -- and the bank-major token-record table -- to a
solved artifact between decode ticks (:meth:`Server._swap_to`).

Each decode tick reads its per-slot token records through **one batched
banked gather** (a single kernel launch over a stacked ``(slots, W)``
index matrix) instead of one launch per row-set -- the compiled
resolution arithmetic runs inside the kernel either way, so the scheduler
and the gather agree on the layout by construction.  Writes go the same
way: token records queue per tick and flush through **one batched banked
scatter** (``artifact.scatter`` with per-slot column indices), so the
resolution circuit -- not host-side index math -- places the rows on both
paths.  The record table, the parameters and the KV cache live on the
server's device; the per-tick index matrices are built on the host and
copied over, and the next tokens come back to the host every tick.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.artifact import CompiledBankingPlan, compile_solution
from ..core.controller import (AccessDecl, Counter, Ctrl, Program, Sched,
                               unroll)
from ..core.grouping import build_groups
from ..core.polytope import Affine, MemorySpec
from ..core.solver import SolverOptions, solve
from ..device import resolve_device
from ..kernels.banked_gather import SCATTER_MAX_T
from ..launch import steps as steps_mod
from ..models import Model


@dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


def _page_program(max_len: int, page: int, readers: int) -> Program:
    mem = MemorySpec("kv_pool", dims=(max_len,), word_bits=16, ports=1)
    return Program(
        root=Ctrl("decode", Sched.INNER,
                  counters=[Counter("r", 0, 1, readers, par=readers),
                            Counter("j", 0, 1, page)],
                  accesses=[AccessDecl("kv_pool", (Affine.of(r=page, j=1),))]),
        memories={"kv_pool": mem},
    )


def page_solution(cfg: Optional[ArchConfig], max_len: int, page: int = 128,
                  readers: int = 8) -> CompiledBankingPlan:
    """The *solved* compiled KV-pool artifact (pages = banks), synchronously.

    ``readers`` concurrent decode lanes must never contend on a page.  The
    KV-pool program is unrolled, grouped and solved in this call, the
    solutions ranked by the proxy resource cost, and the winner compiled:
    what the planning service does behind a ticket.  Once the planning plane
    is part of this package this becomes ``page_ticket(...).artifact()``
    again, and the serving path starts from the ticket's fallback instead
    of waiting here.
    """
    prog = _page_program(max_len, page, readers)
    mem = prog.memories["kv_pool"]
    up = unroll(prog)
    sols = solve(mem, build_groups(up, "kv_pool"), up.iterators,
                 SolverOptions(b_candidates=(page, 1), allow_multidim=False))
    if not sols:
        raise RuntimeError(f"no banking scheme found for the KV pool "
                           f"(max_len={max_len}, page={page}, "
                           f"readers={readers})")
    for s in sols:                       # the "proxy" scorer's ranking
        s.score = s.resources.total.weighted()
    best = sorted(sols, key=lambda s: s.score)[0]
    return compile_solution(best, scorer_name="proxy")


class KVPagePool:
    """Page accounting over a compiled KV banking artifact's layout.

    Pages *are* the artifact's banks and the page size is its bank volume,
    read straight off ``artifact.layout`` -- no local page math.  The
    banking problem is posed per sequence (``dims = (max_len,)``), and the
    decode cache is a dense per-slot region, so every slot owns its own
    ``n_banks`` pages: admission succeeds iff the request's token budget
    fits one slot's pages.  Pages release when the sequence finishes.

    ``swap(artifact)`` re-derives the page geometry -- and every live
    slot's page count -- from a new artifact's layout, which is how the
    server promotes the fallback layout to the solved one mid-flight.
    """

    def __init__(self, artifact: CompiledBankingPlan, slots: int = 1):
        self.slots = slots
        self.owned: Dict[int, int] = {}    # slot -> allocated pages
        self.tokens: Dict[int, int] = {}   # slot -> admitted token budget
        self.swap(artifact)

    def swap(self, artifact: CompiledBankingPlan) -> None:
        """Adopt a new artifact's layout; re-page live allocations."""
        self.artifact = artifact
        self.layout = artifact.layout
        self.page_size = int(self.layout.bank_volume)
        self.pages_per_slot = int(self.layout.n_banks)
        self.owned = {slot: min(self.pages_for(tok), self.pages_per_slot)
                      for slot, tok in self.tokens.items()}

    @property
    def total_pages(self) -> int:
        return self.pages_per_slot * self.slots

    @property
    def used_pages(self) -> int:
        return sum(self.owned.values())

    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.page_size))

    def fits(self, n_tokens: int) -> bool:
        """Can this token budget ever be admitted (into one slot)?"""
        return self.pages_for(n_tokens) <= self.pages_per_slot

    def try_alloc(self, slot: int, n_tokens: int) -> bool:
        need = self.pages_for(n_tokens)
        if need > self.pages_per_slot or slot in self.owned:
            return False
        self.owned[slot] = need
        self.tokens[slot] = int(n_tokens)
        return True

    def release(self, slot: int) -> None:
        self.owned.pop(slot, None)
        self.tokens.pop(slot, None)


class Server:
    """Continuous-batching decode server.

    ``kv_plan`` is a ``CompiledBankingPlan`` (or ``None`` for a server
    without banked token records); anything else raises ``TypeError``.
    The server builds its page pool and token-record table from the
    artifact and can adopt another between ticks (:meth:`_swap_to`).

    Everything the server holds on a device -- parameters, KV cache,
    token-record table -- lies on ``device`` (default ``cuda``, which
    raises when there is no card; pass ``device="cpu"`` to run on the
    host).  ``params`` hands it ready weights (e.g. carried over from the
    JAX package); otherwise they are drawn from ``generator``, or from a
    fresh generator on ``device`` seeded with ``seed``.
    """

    def __init__(self, model: Model, max_batch: int = 4, max_len: int = 128,
                 kv_plan: Optional[CompiledBankingPlan] = None, *,
                 device="cuda", params=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        if kv_plan is not None and not isinstance(kv_plan,
                                                  CompiledBankingPlan):
            raise TypeError(
                f"kv_plan must be a CompiledBankingPlan or None, got "
                f"{type(kv_plan).__name__} (plan tickets are not part of "
                f"this package yet)")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}   # slot -> request
        self._decode = steps_mod.make_serve_step(model)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(seed)
            params = model.init(generator, device=self.device)
        self._params = params
        self.cache = model.init_cache(max_batch, max_len, device=self.device)
        self._kv_art: Optional[CompiledBankingPlan] = None
        # the planning service that answered the KV plan: tracing, metrics
        # and telemetry spans read off it; without a plan plane it is None
        self._kv_service = None
        art = kv_plan
        self.pager = (KVPagePool(art, slots=max_batch)
                      if art is not None else None)
        self.kv_records = None    # bank-major (banks, vol, max_batch) int32
        self._pending_records: List[tuple] = []   # (pos, slot, tok) queue
        self._gather_window = min(4, max_len)
        if art is not None:
            self._adopt_kv_artifact(art, records=None)
        self.swaps = 0            # layouts adopted through _swap_to
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.positions = np.zeros(max_batch, np.int64)  # next record slot
        self.ticks = 0
        self._serve_trace: Optional[str] = None

    # -- banked token records ----------------------------------------------------
    def _adopt_kv_artifact(self, art: CompiledBankingPlan,
                           records) -> None:
        """(Re)build the bank-major record table for a (new) artifact;
        ``records`` carries logical rows across a swap.  The rows are
        repacked by the artifact's row scatter, so the new layout's own
        resolution circuit -- the one the next gather reads through --
        places them (``pack`` would place them by the reference
        equations; the two agree, and the tests hold them to it)."""
        self._kv_art = art
        table = torch.zeros(art.layout.table_shape(self.max_batch),
                            dtype=torch.int32, device=self.device)
        if records is not None:
            for lo in range(0, self.max_len, SCATTER_MAX_T):
                hi = min(lo + SCATTER_MAX_T, self.max_len)
                table = art.scatter(table, np.arange(lo, hi), records[lo:hi])
        self.kv_records = table

    def _record(self, slot: int, tok: int) -> None:
        """Queue one token record at the slot's next position.  Records
        land in the bank-major table at the next flush, placed by the
        artifact's scatter kernel (same resolution circuit the gather
        reads through)."""
        pos = int(self.positions[slot])
        if self.kv_records is not None and pos < self.max_len:
            self._pending_records.append((pos, slot, int(tok)))
        self.positions[slot] = pos + 1

    def _flush_records(self) -> None:
        """Drain queued token records through ONE batched banked scatter
        -- the write-path twin of the tick's batched gather.  The
        artifact's BA/BO circuit places every row inside the kernel; no
        host-side bank arithmetic."""
        if not self._pending_records:
            return
        pend, self._pending_records = self._pending_records, []
        rows = np.asarray([p for p, _, _ in pend], np.int64)
        cols = np.asarray([s for _, s, _ in pend], np.int64)
        vals = np.asarray([t for _, _, t in pend], np.int32)
        self.kv_records = self._kv_art.scatter(self.kv_records, rows, vals,
                                               col=cols)

    def _gather_next_tokens(self) -> Dict[int, int]:
        """Each active slot's decode input, via ONE batched banked gather.

        Stacks every active slot's trailing ``W`` record positions into a
        ``(slots, W)`` index matrix -- a single kernel launch resolves all
        of them through the compiled BA/BO circuit.  The last column is
        the most recent record: the next decode input.
        """
        self._flush_records()     # queued writes land before any read
        slots = sorted(self.active)
        W = self._gather_window
        rows = np.zeros((len(slots), W), np.int32)
        for i, s in enumerate(slots):
            pos = min(int(self.positions[s]), self.max_len)
            rows[i] = np.clip(np.arange(pos - W, pos), 0, self.max_len - 1)
        got = self._kv_art.gather(self.kv_records, rows)
        got = got.cpu().numpy()                    # (slots, W, max_batch)
        out = {}
        for i, s in enumerate(slots):
            if int(self.positions[s]) <= self.max_len:
                out[s] = int(got[i, -1, s])
            else:  # records past max_len aren't stored; fall back
                out[s] = getattr(self.active[s], "_next", 1)
        return out

    # -- hot swap -----------------------------------------------------------------
    def _swap_to(self, art: CompiledBankingPlan) -> None:
        """Adopt a new layout atomically from the decode loop's point of
        view: the record table is unpacked from the old layout and
        repacked into the new one, the pager re-pages live slots, and
        the next tick's gather runs the new resolution circuit over
        identical logical records."""
        self._flush_records()     # pending writes belong to the old layout
        flat = self._kv_art.unpack(self.kv_records)   # logical rows survive
        self._adopt_kv_artifact(art, records=flat)
        self.pager.swap(art)

    # -- admission -------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.max_batch):
            if slot in self.active or not self.queue:
                continue
            req = self.queue[0]
            if self.pager is not None:
                need_tokens = len(req.prompt) + req.max_new
                if not self.pager.fits(need_tokens):
                    # can never fit a slot: reject instead of deadlocking
                    self.queue.popleft()
                    req.done = True
                    continue
                self.pager.try_alloc(slot, need_tokens)
            self.queue.popleft()
            self.positions[slot] = 0
            # per-request prefill: run the prompt through decode one token at
            # a time into this slot (batch=1 prefill folded into the shared
            # cache; a production server runs a separate prefill graph)
            toks = req.prompt
            for t in toks:
                self.tokens[slot, 0] = int(t)
                nxt, _, self.cache = self._decode(
                    self._params, self.cache, self.tokens)
                self._record(slot, int(t))
            nxt_tok = int(nxt[slot, 0])
            req._next = nxt_tok
            self._record(slot, nxt_tok)   # the next tick's decode input
            self.active[slot] = req

    # -- decode tick -------------------------------------------------------------
    def tick(self):
        """One decode tick.  When the KV plan's service has telemetry
        enabled, ticks that decoded (active slots) are wall-timed and
        logged as ``op="tick"`` observations against the serving
        artifact -- end-to-end evidence alongside the per-call
        gather/scatter hooks."""
        hub = getattr(self._kv_service, "telemetry", None)
        art = self._kv_art
        if hub is None or art is None or not art.signature:
            self._tick()
            return
        before = self.ticks
        t0 = time.perf_counter()
        self._tick()
        if self.ticks > before:   # idle calls (nothing active) don't count
            hub.observe(art, "tick", (self.max_batch,),
                        time.perf_counter() - t0)

    _SERVE_TRACE_TICKS = 256   # ticks per rolling serve-trace window

    def _serve_tracer(self):
        """(tracer, serve trace_id) off the answering service, or
        (None, None) -- the serve loop traces only when a plan service
        does, and none is attached in this package yet."""
        tr = getattr(self._kv_service, "tracer", None)
        if tr is None:
            return None, None
        tid = self._serve_trace
        if tid is None:
            from ..core.tracing import new_trace_id   # with the plan plane
            tid = self._serve_trace = new_trace_id()
            tr.label(tid, "serve loop")
        return tr, tid

    def _tick(self):
        tr, tid = self._serve_tracer()
        metrics = getattr(self._kv_service, "metrics", None)
        t_tick = time.perf_counter()
        self._admit()
        if not self.active:
            return
        if self.kv_records is not None:
            t_g = time.perf_counter()
            nxt_in = self._gather_next_tokens()   # one batched banked gather
            t_g_end = time.perf_counter()
            if tr is not None:
                tr.record(tid, "gather", t_g, t_g_end,
                          slots=len(self.active))
            if metrics is not None:
                metrics.observe("serve_gather_ms", (t_g_end - t_g) * 1e3)
        else:
            nxt_in = {s: getattr(r, "_next", 1)
                      for s, r in self.active.items()}
        for slot in self.active:
            self.tokens[slot, 0] = nxt_in[slot]
        t_d = time.perf_counter()
        nxt, _, self.cache = self._decode(self._params, self.cache,
                                          self.tokens)
        nxt = nxt.cpu().numpy()
        if tr is not None:
            tr.record(tid, "decode", t_d, time.perf_counter(),
                      slots=len(self.active))
        finished = []
        for slot, req in self.active.items():
            tok = int(nxt[slot, 0])
            req.out.append(tok)
            req._next = tok
            self._record(slot, tok)
            if len(req.out) >= req.max_new:
                req.done = True
                finished.append(slot)
        for slot in finished:
            del self.active[slot]
            if self.pager is not None:
                self.pager.release(slot)
        if self.kv_records is not None:
            t_s = time.perf_counter()
            self._flush_records()   # this tick's records land this tick
            t_s_end = time.perf_counter()
            if tr is not None:
                tr.record(tid, "scatter", t_s, t_s_end)
            if metrics is not None:
                metrics.observe("serve_scatter_ms",
                                (t_s_end - t_s) * 1e3)
        self.ticks += 1
        if metrics is not None:
            metrics.observe("serve_tick_ms",
                            (time.perf_counter() - t_tick) * 1e3)
        if tr is not None and self.ticks % self._SERVE_TRACE_TICKS == 0:
            # roll the window: the finished trace reaches the flight
            # recorder; the next tick starts a fresh trace_id
            tr.finish(tid, status="ok")
            self._serve_trace = None

    def run(self, max_ticks: int = 1000):
        while (self.queue or self.active) and self.ticks < max_ticks:
            self.tick()
        # flush a partial serve-trace window so short runs still land
        # their gather/decode/scatter spans in the recorder
        if self._serve_trace is not None:
            tr = getattr(self._kv_service, "tracer", None)
            if tr is not None:
                tr.finish(self._serve_trace, status="ok")
            self._serve_trace = None
