"""Batched serving loop: continuous-batching decode with a paged KV cache.

Serving structure (vLLM-style):

* requests queue in; the scheduler packs up to ``max_batch`` active
  sequences into the fixed decode batch (slots);
* prefill runs per request through the decode step, its KV written into the
  slot's region of the cache;
* one ``serve_step`` decodes a token for every active slot per tick;
* finished sequences (``max_new`` reached) free their slot for the next
  queued request -- continuous batching.

The cache pages are banks from the banking planner (pages = banks, page
size = bank volume).  The server never blocks on the solver:
``page_ticket()`` submits the KV-pool problem to the
:class:`~repro_torch.core.service.PlanService` and the :class:`Server`
starts serving immediately from the ticket's **fallback artifact** (trivial
single-bank scheme), then atomically hot-swaps the page pool -- and the
bank-major token-record table -- to the solved artifact between decode
ticks once the background solve lands (:meth:`Server._maybe_swap_kv`).

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
from typing import Deque, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.artifact import CompiledBankingPlan
from ..core.controller import AccessDecl, Counter, Ctrl, Program, Sched
from ..core.jointplan import ResourceBudget
from ..core.polytope import Affine, MemorySpec
from ..core.service import (JointTicket, PlanService, PlanTicket,
                            default_service)
from ..core.solver import SolverOptions
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


def model_memory_program(cfg: ArchConfig, max_len: int, page: int = 128,
                         readers: int = 8) -> Program:
    """One whole-model ``Program``: every banked memory the serving loop
    touches for this architecture, as children of one root controller.

    * ``kv_pool`` -- the paged KV cache every family reads per decode
      tick (``readers`` parallel lanes, ``page``-token pages);
    * ``moe_dispatch`` (MoE families) -- the per-expert token staging
      buffer the router scatters into, ``top_k`` experts in parallel;
    * ``ssm_state`` (SSM families) -- the chunked state the scan
      updates, four head lanes in parallel.

    This is what turns each config in ``configs/`` into a distinct
    joint-planning workload: one ``submit_joint`` co-selects schemes
    for all of a model's pools under a shared budget.
    """
    mems: Dict[str, MemorySpec] = {
        "kv_pool": MemorySpec("kv_pool", dims=(max_len,), word_bits=16,
                              ports=1)}
    kids = [Ctrl("decode", Sched.INNER,
                 counters=[Counter("r", 0, 1, readers, par=readers),
                           Counter("j", 0, 1, page)],
                 accesses=[AccessDecl("kv_pool",
                                      (Affine.of(r=page, j=1),))])]
    if cfg.n_experts > 0:
        slot = max(4, page // 4)
        mems["moe_dispatch"] = MemorySpec(
            "moe_dispatch", dims=(cfg.n_experts * slot,), word_bits=16,
            ports=1)
        par = max(1, cfg.top_k)
        kids.append(Ctrl(
            "route", Sched.INNER,
            counters=[Counter("e", 0, 1, par, par=par),
                      Counter("j", 0, 1, slot)],
            accesses=[AccessDecl("moe_dispatch",
                                 (Affine.of(e=slot, j=1),))]))
    if cfg.ssm_state > 0:
        lanes = 4
        mems["ssm_state"] = MemorySpec(
            "ssm_state", dims=(lanes * cfg.ssm_state,), word_bits=16,
            ports=1)
        kids.append(Ctrl(
            "scan", Sched.INNER,
            counters=[Counter("h", 0, 1, lanes, par=lanes),
                      Counter("j", 0, 1, cfg.ssm_state)],
            accesses=[AccessDecl("ssm_state",
                                 (Affine.of(h=cfg.ssm_state, j=1),))]))
    if len(kids) == 1:
        return Program(root=kids[0], memories=mems)
    return Program(root=Ctrl("model", Sched.FORKJOIN, children=kids),
                   memories=mems)


def joint_ticket(cfg: ArchConfig, max_len: int, page: int = 128,
                 readers: int = 8, *,
                 service: Optional[PlanService] = None,
                 budget: Optional[ResourceBudget] = None,
                 scorer=None, tenant: Optional[str] = None) -> JointTicket:
    """Submit the whole model's banking problems as ONE joint request;
    returns the :class:`~repro_torch.core.service.JointTicket` immediately.

    The server starts on ``ticket.fallback()`` for every pool and
    promotes all of them to the jointly co-selected layouts atomically
    between decode ticks -- never a mixed generation.  ``budget`` caps
    the summed draw (banks / volume / LUT / FF / BRAM / DSP) across all
    of the model's memories.
    """
    svc = service if service is not None else default_service()
    return svc.submit_joint(
        model_memory_program(cfg, max_len, page=page, readers=readers),
        budget=budget,
        opts=SolverOptions(b_candidates=(page, 1), allow_multidim=False),
        scorer=scorer, tenant=tenant)


def page_ticket(cfg: Optional[ArchConfig], max_len: int, page: int = 128,
                readers: int = 8, *,
                service: Optional[PlanService] = None,
                scorer=None, tenant: Optional[str] = None) -> PlanTicket:
    """Submit the KV-pool banking problem (pages = banks); returns the
    :class:`PlanTicket` immediately.

    ``readers`` concurrent decode lanes must never contend on a page.
    The server starts on ``ticket.fallback()`` (one bank = one page, no
    solver work) and hot-swaps to ``ticket.artifact()`` between ticks
    when the solve lands; a warm plan store answers before the ticket is
    even returned.  ``scorer="measured"`` ranks candidates on the
    service's telemetry log (see ``PlanService.enable_telemetry``).
    ``tenant`` names this server on a shared multi-tenant service
    (QoS band, quotas, per-tenant stats -- see
    :mod:`repro_torch.runtime.tenancy`).
    """
    svc = service if service is not None else default_service()
    return svc.submit(
        _page_program(max_len, page, readers), "kv_pool",
        opts=SolverOptions(b_candidates=(page, 1), allow_multidim=False),
        scorer=scorer, tenant=tenant)


def page_solution(cfg: Optional[ArchConfig], max_len: int, page: int = 128,
                  readers: int = 8) -> CompiledBankingPlan:
    """Blocking convenience: the *solved* compiled KV-pool artifact.

    ``page_ticket(...).artifact()`` -- tools and tests that want the final
    layout synchronously; the serving path itself uses the ticket.
    """
    return page_ticket(cfg, max_len, page=page, readers=readers).artifact()


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

    ``kv_plan`` may be a solved ``CompiledBankingPlan``, a ``PlanTicket``,
    a ``JointTicket`` or ``None`` (a server without banked token records);
    anything else raises ``TypeError``.  With a ticket the server builds
    its page pool and token-record table from the ticket's fallback --
    serving its first tick without waiting on the solver -- and atomically
    swaps in the solved artifact between ticks once the ticket resolves.
    A joint ticket brings the whole model's pools (``kv_pool`` plus e.g.
    ``moe_dispatch`` / ``ssm_state``): ALL of them promote to the jointly
    co-selected layouts in one coherent generation between decode ticks,
    never a mixed one (``server.generations`` stays uniform by
    construction; asserted by ``coherent``).

    Everything the server holds on a device -- parameters, KV cache,
    token-record table -- lies on ``device`` (default ``cuda``, which
    raises when there is no card; pass ``device="cpu"`` to run on the
    host).  ``params`` hands it ready weights (e.g. carried over from the
    JAX package); otherwise they are drawn from ``generator``, or from a
    fresh generator on ``device`` seeded with ``seed``.
    """

    def __init__(self, model: Model, max_batch: int = 4, max_len: int = 128,
                 kv_plan: Optional[Union[CompiledBankingPlan,
                                         PlanTicket, JointTicket]] = None, *,
                 device="cuda", params=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        if kv_plan is not None and not isinstance(
                kv_plan, (CompiledBankingPlan, PlanTicket, JointTicket)):
            raise TypeError(
                f"kv_plan must be a CompiledBankingPlan, a PlanTicket, a "
                f"JointTicket or None, got {type(kv_plan).__name__}")
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
        self._kv_ticket: Optional[PlanTicket] = None
        self._kv_art: Optional[CompiledBankingPlan] = None
        # the joint ticket graph and its satellite pools (every model
        # memory except kv_pool, which owns the record table below)
        self._joint: Optional[JointTicket] = None
        self.pools: Dict[str, KVPagePool] = {}
        self.generations: Dict[str, int] = {}
        self._joint_version = 0
        self._joint_adopted_final = False
        # demotion hot-swap: remember which service answered the KV plan
        # (and under which key) so _maybe_swap_kv can poll its telemetry
        # hub for a replacement ticket after the served plan is demoted;
        # tracing, metrics and telemetry spans read off it too
        self._kv_service = (kv_plan._service
                            if isinstance(kv_plan, (PlanTicket, JointTicket))
                            else None)
        self._kv_key = ((kv_plan.signature, kv_plan.scorer_name)
                        if isinstance(kv_plan, PlanTicket) else None)
        art: Optional[CompiledBankingPlan] = None
        if isinstance(kv_plan, JointTicket):
            self._joint = kv_plan
            arts = (kv_plan.artifacts() if kv_plan.done()
                    else kv_plan.fallback())
            if "kv_pool" not in arts:
                raise ValueError(
                    "joint ticket has no 'kv_pool' member; build the "
                    "program with model_memory_program()")
            art = arts["kv_pool"]
            for name, a in arts.items():
                if name != "kv_pool":
                    self.pools[name] = KVPagePool(a, slots=max_batch)
            self.generations = {name: 0 for name in arts}
            self._joint_adopted_final = kv_plan.done()
        elif isinstance(kv_plan, PlanTicket):
            # serve NOW: solved artifact when already done, else fallback.
            # Only drop the ticket once its solved artifact was actually
            # adopted -- a solve landing (or failing) between these calls
            # must still hot-swap (or keep serving the fallback) later.
            self._kv_ticket = kv_plan
            if kv_plan.done():
                try:
                    art = kv_plan.artifact()
                    self._kv_ticket = None
                except Exception:
                    art = None   # solve failed: fall back, like mid-serve
            if art is None:
                art = kv_plan.fallback()
        elif kv_plan is not None:
            art = kv_plan
        self.pager = (KVPagePool(art, slots=max_batch)
                      if art is not None else None)
        self.kv_records = None    # bank-major (banks, vol, max_batch) int32
        self._pending_records: List[tuple] = []   # (pos, slot, tok) queue
        self._gather_window = min(4, max_len)
        if art is not None:
            self._adopt_kv_artifact(art, records=None)
        self.swaps = 0            # solved layouts adopted (final plan)
        self.promotions = 0       # best-so-far adoptions before the solve
        self.joint_swaps = 0      # coherent all-pool swaps (final plan)
        self.joint_promotions = 0  # coherent all-pool best-so-far adoptions
        self._kv_best_version = 0
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

    def _maybe_swap_kv(self) -> None:
        """Between ticks: promote the page layout toward the solver.

        While the sharded search streams, the ticket's **best-so-far**
        scheme is adopted whenever it improves (the search never
        regresses, so each promotion strictly improves the layout); once
        the ticket resolves, the final solved artifact is swapped in --
        same winner the monolithic solver would have produced.

        With telemetry enabled on the answering service, a served layout
        the measurements demoted leaves a *replacement* re-solve ticket
        on the hub; adopting it here closes the self-correction loop --
        measure, demote, re-solve, hot-swap -- without the server ever
        blocking.
        """
        t = self._kv_ticket
        if t is None and self._kv_service is not None \
                and self._kv_key is not None:
            hub = getattr(self._kv_service, "telemetry", None)
            if hub is not None:
                t = hub.replacement(self._kv_key)
                if t is not None:
                    self._kv_ticket = t
                    self._kv_best_version = 0
        if t is None:
            return
        if t.done():
            self._kv_ticket = None
            try:
                art = t.artifact()
            except Exception:
                return  # solve failed: keep serving the current layout
            if art.layout == self._kv_art.layout:
                return  # a promotion already landed the winning layout
            self._swap_to(art)
            self.swaps += 1
            return
        version = t.best_version()
        if version == self._kv_best_version:
            return
        self._kv_best_version = version
        art = t.best_so_far_artifact()
        if art is None or art.layout == self._kv_art.layout:
            return
        self._swap_to(art)
        self.promotions += 1

    # -- coherent multi-pool swap ---------------------------------------------
    @property
    def coherent(self) -> bool:
        """True iff every pool serves the same joint generation -- the
        invariant the atomic all-pool swap maintains: a decode tick
        never sees a mixed generation."""
        return len(set(self.generations.values())) <= 1

    def _swap_all(self, arts: Dict[str, CompiledBankingPlan]) -> int:
        """Adopt a whole joint selection atomically between ticks: the
        KV record table repacks (``_swap_to`` flushes the pending records
        into the old layout first), every satellite pool re-pages, and ALL
        pool generations advance to one new value in the same swap --
        no tick ever reads pools from two generations.  Returns how
        many pools actually changed layout."""
        changed = 0
        kv = arts.get("kv_pool")
        if kv is not None and self._kv_art is not None \
                and kv.layout != self._kv_art.layout:
            self._swap_to(kv)
            changed += 1
        for name, pool in self.pools.items():
            a = arts.get(name)
            if a is not None and a.layout != pool.artifact.layout:
                pool.swap(a)
                changed += 1
        gen = max(self.generations.values(), default=0) + 1
        for name in self.generations:
            self.generations[name] = gen
        return changed

    def _maybe_swap_joint(self) -> None:
        """Between ticks: promote ALL pools toward the joint selection.

        While member solves stream, the joint ticket re-co-selects
        progressively; whenever the *joint* selection changes (its
        ``best_version`` bumps) every pool adopts its newly selected
        layout in one coherent swap.  Once the ticket resolves, the
        final certified selection lands the same way -- never a mixed
        generation."""
        jt = self._joint
        if jt is None:
            return
        if jt.done():
            if self._joint_adopted_final:
                return
            self._joint_adopted_final = True
            try:
                arts = jt.artifacts()
            except Exception:
                return   # selection failed: keep serving current layouts
            if self._swap_all(arts):
                self.joint_swaps += 1
            return
        version = jt.best_version()
        if version == self._joint_version:
            return
        self._joint_version = version
        try:
            arts = jt.artifacts()
        except Exception:
            return
        if self._swap_all(arts):
            self.joint_promotions += 1

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
        (None, None) -- the serve loop traces only when the plan
        service does."""
        tr = getattr(self._kv_service, "tracer", None)
        if tr is None:
            return None, None
        tid = self._serve_trace
        if tid is None:
            from ..core.tracing import new_trace_id
            tid = self._serve_trace = new_trace_id()
            tr.label(tid, "serve loop")
        return tr, tid

    def _tick(self):
        tr, tid = self._serve_tracer()
        metrics = getattr(self._kv_service, "metrics", None)
        t_tick = time.perf_counter()
        swaps0 = self.swaps + self.promotions \
            + self.joint_swaps + self.joint_promotions
        if self._joint is not None:
            self._maybe_swap_joint()
        else:
            self._maybe_swap_kv()
        if tr is not None and self.swaps + self.promotions \
                + self.joint_swaps + self.joint_promotions > swaps0:
            tr.record(tid, "promote", t_tick, time.perf_counter(),
                      swaps=self.swaps, promotions=self.promotions,
                      joint_swaps=self.joint_swaps,
                      joint_promotions=self.joint_promotions)
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
        # their gather/decode/scatter/promote spans in the recorder
        if self._serve_trace is not None:
            tr = getattr(self._kv_service, "tracer", None)
            if tr is not None:
                tr.finish(self._serve_trace, status="ok")
            self._serve_trace = None
