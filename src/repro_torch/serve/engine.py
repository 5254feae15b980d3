"""Slot-level continuous-batching serving engine (counterpart of
``repro/serve/engine.py``, DESIGN.md §11 and §15).

The engine owns ``slots`` decode slots; every engine step it (1) admits
arrived requests into free slots while other slots are mid-decode, running
each admission's prefill under its planner-resolved ``ExecutionPlan``,
(2) advances every already-active slot by one token, and (3) recycles a
slot the moment its request's token budget is spent.  Decode is batched:
the active slots' caches live in a paged K/V pool
(``serve.kv_cache.PagedKVCache``) and each step groups slots of equal KV
length into shape buckets, each advanced by one ``decode_step`` call
(``decode_batches`` counts the calls, ``decode_calls`` the per-slot token
advances).  The step timeline is the shared deterministic schedule
(``serve.schedule.build_schedule``); each decode step compiles its
``DecodePlan`` (``plan.plan_decode_step``).  Under a ``sim.replay``
recording each ``decode_step`` call runs under the plan of its own slots
instead, and that plan, with the call's records attached, lands in
``Engine.traced_plans``.

MoE decoders are served as the dense ones: grok-1's ``{"k", "v"}`` cache
is paged and decoded in buckets, deepseek-v3's latent MLA cache
``{"c", "k_rope"}`` takes the per-slot path, as in the JAX engine.

Differences from the JAX engine: it serves an ``nn.Module`` (the port's
``models.transformer.Transformer``) instead of a parameter tree, and
calls its ``decode_step`` directly where the JAX engine jits it; serving
on a mesh is not ported (ROADMAP Queue 1 item 7).  The deprecated
``mode=`` override stays, as in the JAX engine.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import ExecutionMode, ModelConfig
from repro_torch.models.transformer import check_supported
from repro_torch.obs.metrics import (METRICS_SCHEMA_VERSION,
                                     MetricsRegistry, RequestSpan,
                                     observe_spans, spans_from_steps,
                                     spans_from_timeline, summarize_spans)
from repro_torch.serve.kv_cache import PagedKVCache, shape_buckets
from repro_torch.serve.schedule import Schedule, ServeRequest, build_schedule


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    arrival_step: int = 0         # engine step the request becomes visible
    out_tokens: Optional[List[int]] = None


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """What one engine step actually executed (the engine-side half of
    the engine==simulator agreement tests)."""

    step: int
    admitted: Tuple[int, ...]            # rids prefilled
    decoded: Tuple[int, ...]             # rids advanced one token
    kv_lens: Tuple[int, ...]             # per decoded slot: attended KV len
    decode_plan: Optional[object] = None  # the step's DecodePlan (or None)
    # Shape buckets the step's decode actually dispatched: (kv_len, rids)
    # per batched decode_step call; None on the per-slot fallback path.
    buckets: Optional[Tuple[Tuple[int, Tuple[int, ...]], ...]] = None


def _recorder():
    """The active ``sim.replay`` recorder, or None (also when the replay
    module was never imported)."""
    replay = sys.modules.get("repro_torch.sim.replay")
    return None if replay is None else replay.active_recorder()


class _LRU:
    """Tiny bounded LRU mapping (OrderedDict-backed)."""

    def __init__(self, maxsize: int) -> None:
        self.maxsize = max(int(maxsize), 1)
        self._d: "OrderedDict[Any, Any]" = OrderedDict()

    def get(self, key):
        if key not in self._d:
            return None
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d


class Engine:
    def __init__(self, cfg: ModelConfig, model, *, slots: int = 4,
                 max_len: int = 512,
                 plan=None,
                 plan_cache_size: int = 32,
                 plan_decode: bool = True,
                 mode: Optional[ExecutionMode] = None,
                 mesh=None,
                 batch_decode: bool = True,
                 page_size: int = 64,
                 clock=time.perf_counter):
        """``model``: the port's ``Transformer`` for ``cfg``.  ``plan``: an
        ``ExecutionPlan`` to serve under (pins every admission); default:
        re-plan per admitted prompt length from a bounded LRU cache.
        Prefill plans and per-step ``DecodePlan``s each get their own LRU
        of ``plan_cache_size`` entries.  ``plan_decode=False`` skips the
        per-step ``DecodePlan``s.  ``mode``: deprecated explicit override
        that skips the planner.  ``mesh``: not ported, must be None.
        ``batch_decode``: group equal-KV-length slots into one
        ``decode_step`` call through a paged K/V pool of ``page_size``
        positions per page.  ``clock``: wall-time source
        (``time.perf_counter``-compatible) for the ``"wall"`` stats,
        injectable so that tests can pin percentiles."""
        if mesh is not None:
            raise NotImplementedError(
                "serving on a mesh is not ported yet (ROADMAP Queue 1 "
                "item 7)")
        check_supported(cfg)
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.plan = plan
        self.plan_decode = plan_decode
        self._forced_mode = mode
        self._plan_cache = _LRU(plan_cache_size)
        # Decode plans get their own bound: their keys (kv-length tuples)
        # change almost every step, and sharing one LRU would let that
        # churn evict the highly-reusable per-prompt-length prefill plans.
        self._decode_plan_cache = _LRU(plan_cache_size)
        self._decode = model.decode_step
        self.batch_decode = batch_decode
        self.page_size = page_size
        self._pool: Optional[PagedKVCache] = None
        self._clock = clock
        self._queue: deque = deque()
        self.step_log: List[StepRecord] = []
        # Under a sim.replay recording, per decoding step: the DecodePlan
        # each decode_step call ran under (one per bucket, or per slot on
        # the per-slot path), with that call's KernelTraces attached.
        self.traced_plans: Dict[int, Tuple[object, ...]] = {}
        self.decode_calls = 0         # per-slot token advances
        self.decode_batches = 0       # actual decode_step invocations
        self.last_schedule: Optional[Schedule] = None
        self.registry = MetricsRegistry()
        self._arrivals: Dict[int, int] = {}
        self._step_walls: Dict[int, Tuple[float, float]] = {}
        self._prefill_wall_end: Dict[int, float] = {}

    def submit(self, req: Request) -> None:
        # The cache peaks at prompt + max_new - 1 entries (the last
        # emitted token is never written back).
        if len(req.prompt) + req.max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) - 1 exceeds the "
                f"engine's max_len ({self.max_len})")
        req.out_tokens = []
        self._queue.append(req)

    # ------------------------------------------------------------------
    # Planning
    # ------------------------------------------------------------------

    def plan_for(self, seq_len: int):
        """The ``ExecutionPlan`` governing an admission of prompt length
        ``seq_len`` (bounded-LRU cached per length).  A construction-time
        ``plan=`` wins; attention-free families have nothing to plan
        (None)."""
        if self.plan is not None:
            return self.plan
        if self.cfg.num_heads == 0:
            return None
        plan = self._plan_cache.get(seq_len)
        if plan is None:
            from repro_torch.plan import plan_model
            plan = plan_model(self.cfg, seq_len=seq_len)
            self._plan_cache.put(seq_len, plan)
        return plan

    def decode_plan_for(self, kv_lens: Tuple[int, ...]):
        """The ``DecodePlan`` for one step whose active slots attend
        ``kv_lens`` (bounded-LRU cached per length tuple)."""
        if not self.plan_decode or self.cfg.num_heads == 0:
            return None
        key = tuple(kv_lens)
        dp = self._decode_plan_cache.get(key)
        if dp is None:
            from repro_torch.plan import plan_decode_step
            # The deprecated mode= override bypasses the planner for
            # prefill; decode plans must honor it too, or step records
            # would contradict the mode the engine claims to serve under.
            dp = plan_decode_step(self.cfg, key, mode=self._forced_mode,
                                  force_mode=self._forced_mode is not None)
            self._decode_plan_cache.put(key, dp)
        return dp

    def mode_for(self, seq_len: int) -> ExecutionMode:
        """Planner-resolved prefill mode summary for one admission: the
        plan's uniform mode, or its first layer's for a heterogeneous plan
        (prefill still dispatches per layer), for logging."""
        if self._forced_mode is not None:       # deprecated explicit override
            return self._forced_mode
        plan = self.plan_for(seq_len)
        if plan is None or not plan.layers:
            return self.cfg.execution_mode
        return plan.uniform_mode or plan.layers[0].mode

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    def _prefill_one(self, req: Request):
        """Prefill one request into a fresh slot cache (B=1, unpadded:
        per-request numerics never depend on the neighbours)."""
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                               device=self.model.device)
        plan = self.plan_for(len(req.prompt))
        kwargs: Dict[str, Any] = {}
        if self._forced_mode is not None:
            kwargs["mode"] = self._forced_mode
        else:
            kwargs["plan"] = plan
        logits, cache = self.model.prefill({"tokens": toks},
                                           max_len=self.max_len, **kwargs)
        return logits[:, -1], cache

    def run(self, *, greedy: bool = True) -> List[Request]:
        """Drain the queue under the continuous-batching schedule;
        returns completed requests in completion order.

        Every step admits into any free slot (other slots keep decoding),
        decodes each active slot once, and recycles finished slots
        immediately — a request with ``n`` output tokens consumes exactly
        ``n - 1`` decode steps regardless of its neighbours.
        """
        del greedy                              # argmax sampling only
        reqs = list(self._queue)
        self._queue.clear()
        schedule = build_schedule(
            [ServeRequest(r.rid, len(r.prompt), r.max_new_tokens,
                          r.arrival_step) for r in reqs],
            self.slots)
        self.last_schedule = schedule
        by_rid = {r.rid: r for r in reqs}
        slot_state: Dict[int, Dict[str, Any]] = {}
        rid_slot: Dict[int, int] = {}
        done: List[Request] = []
        self.step_log = []
        self.traced_plans = {}
        self.decode_calls = 0
        self.decode_batches = 0
        self._pool = None
        batched = self.batch_decode
        self.registry = MetricsRegistry()
        self._arrivals = {r.rid: r.arrival_step for r in reqs}
        self._step_walls = {}
        self._prefill_wall_end = {}
        V = self.cfg.vocab_size
        for st in schedule.steps:
            wall0 = self._clock()
            for slot, rid in st.admitted:
                r = by_rid[rid]
                last_logits, cache = self._prefill_one(r)
                tok = torch.argmax(last_logits[:, :V], dim=-1)[:, None]
                r.out_tokens.append(int(tok[0, 0]))
                # Token #1 just materialized: the wall-clock TTFT mark.
                self._prefill_wall_end[rid] = self._clock()
                if batched and self._pool is None:
                    # First admission decides for the run: page the pool
                    # or fall back per slot (SSM/MLA/hybrid/enc-dec
                    # trees — every later cache shares the config).
                    if PagedKVCache.supports(cache):
                        self._pool = PagedKVCache.from_cache(
                            cache, slots=self.slots,
                            page_size=self.page_size)
                    else:
                        batched = False
                if self._pool is not None:
                    self._pool.admit(slot, cache)
                    cache = None          # the pool owns the K/V now
                slot_state[slot] = {"req": r, "cache": cache, "tok": tok}
                rid_slot[rid] = slot
            dp = None
            step_buckets = traced = None
            if st.decoding:
                kv_lens = tuple(kv for _, _, kv in st.decoding)
                dp = self.decode_plan_for(kv_lens)
                if dp is not None and _recorder() is not None:
                    traced = []
                if self._pool is not None:
                    step_buckets = self._decode_buckets(
                        st, kv_lens, slot_state, V, dp, traced)
                else:
                    for slot, rid, kv in st.decoding:
                        ss = slot_state[slot]
                        logits, ss["cache"] = self._decode_call(
                            ss["cache"], ss["tok"], dp, (kv,), traced)
                        self.decode_calls += 1
                        self.decode_batches += 1
                        tok = torch.argmax(logits[:, 0, :V], dim=-1)[:, None]
                        ss["tok"] = tok
                        ss["req"].out_tokens.append(int(tok[0, 0]))
            self.step_log.append(StepRecord(
                step=st.step,
                admitted=tuple(r for _, r in st.admitted),
                decoded=tuple(r for _, r, _ in st.decoding),
                kv_lens=tuple(kv for _, _, kv in st.decoding),
                decode_plan=dp,
                buckets=step_buckets))
            if traced is not None:
                self.traced_plans[st.step] = tuple(traced)
            self._step_walls[st.step] = (wall0, self._clock())
            for rid in st.finished:
                done.append(by_rid[rid])
                slot = rid_slot.pop(rid)
                if self._pool is not None:
                    self._pool.free(slot)               # recycle the pages
                del slot_state[slot]                    # recycle the slot
        self.registry.counter("steps").inc(len(self.step_log))
        self.registry.counter("decode_calls").inc(self.decode_calls)
        observe_spans(self.registry, self.request_spans, "steps.")
        observe_spans(self.registry, self.wall_spans, "wall.")
        return done

    def decode_wall_s(self) -> float:
        """Wall seconds spent in pure-decode steps (steps that also
        prefilled are excluded, so prefill wall never pollutes the
        decode-phase number).  The denominator for decode throughput:
        batching cuts dispatch here, while prefill cost is identical on
        both paths and dominates short-generation end-to-end walls."""
        total = 0.0
        for rec in self.step_log:
            if rec.decoded and not rec.admitted:
                bounds = self._step_walls.get(rec.step)
                if bounds is not None:
                    total += bounds[1] - bounds[0]
        return total

    def _decode_call(self, cache, toks, dp, kv_lens, traced):
        """One ``decode_step`` call under the step's ``DecodePlan`` ``dp``,
        which blocks only the plain version.  Under a ``sim.replay``
        recording (``traced`` a list) the call runs under the plan of its
        own slots' ``kv_lens`` instead, so that each record has one
        ``seq_kv`` entry per row, and that plan, with the records the call
        made attached, is appended to ``traced``: buckets of one step name
        the same ops, so their records never meet in one plan."""
        if traced is None:
            return self._decode(cache, toks, plan=dp)
        rec = _recorder()
        plan = self.decode_plan_for(kv_lens)
        first = len(rec.records)
        out = self._decode(cache, toks, plan=plan)
        traced.append(plan.attach_traces(rec.records[first:]))
        return out

    def _decode_buckets(self, st, kv_lens, slot_state, V, dp, traced):
        """Advance one step's active slots bucket-by-bucket through the
        paged pool (``_decode_call`` per bucket); returns the
        (kv_len, rids) buckets dispatched."""
        out = []
        for kv, positions in shape_buckets(kv_lens):
            slots = [st.decoding[p][0] for p in positions]
            rids = tuple(st.decoding[p][1] for p in positions)
            # Bucket invariant: equal schedule KV length <=> equal cache
            # position counter (kv counts the token being decoded, the
            # cache holds everything before it).
            for s in slots:
                if self._pool.len_of(s) + 1 != kv:
                    raise RuntimeError(
                        f"slot {s}: cache len {self._pool.len_of(s)} "
                        f"inconsistent with scheduled kv {kv}")
            cache = self._pool.gather(slots)
            toks = torch.cat([slot_state[s]["tok"] for s in slots], dim=0)
            logits, cache = self._decode_call(cache, toks, dp,
                                              (kv,) * len(slots), traced)
            self._pool.scatter(slots, cache)
            self.decode_batches += 1
            self.decode_calls += len(slots)
            tok = torch.argmax(logits[:, 0, :V], dim=-1)[:, None]
            tok_np = tok.cpu().numpy()
            for i, s in enumerate(slots):
                slot_state[s]["tok"] = tok[i:i + 1]
                slot_state[s]["req"].out_tokens.append(int(tok_np[i, 0]))
            out.append((kv, rids))
        return tuple(out)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def plan_cache_len(self) -> int:
        return len(self._plan_cache)

    @property
    def request_spans(self) -> List[RequestSpan]:
        """Step-domain lifecycle spans derived from the *executed*
        ``step_log`` — the engine-side half of the serving-metrics parity
        check (``obs.metrics.assert_serve_parity``, DESIGN.md §12)."""
        return spans_from_steps(self.step_log, self._arrivals)

    @property
    def wall_spans(self) -> List[RequestSpan]:
        """Wall-clock lifecycle spans (seconds) from the per-step
        timestamps the last ``run`` recorded: first token at the instant
        each admission's prefill materialized token #1, finish at the end
        of the request's last step."""
        if not self._step_walls:
            return []
        admit: Dict[int, int] = {}
        last: Dict[int, int] = {}
        decodes: Dict[int, int] = {}
        for rec in self.step_log:
            for rid in rec.admitted:
                admit[rid] = rec.step
                last[rid] = rec.step
                decodes.setdefault(rid, 0)
            for rid in rec.decoded:
                decodes[rid] = decodes.get(rid, 0) + 1
                last[rid] = rec.step
        return spans_from_timeline(admit, last, decodes, self._arrivals,
                                   self._step_walls,
                                   self._prefill_wall_end, unit="seconds")

    def stats(self) -> Dict[str, object]:
        """Summary of the last ``run``: step count, per-request decode
        steps, admission/finish steps, plus the serving SLO summaries —
        step-domain TTFT/TPOT/queue-delay/e2e p50/p95/p99 at the top
        level (directly comparable with ``ServeSimResult.metrics`` via
        ``obs.metrics.assert_serve_parity``), wall-clock summaries under
        ``"wall"``, and the raw registry under ``"metrics"``.

        Step and decode counts are derived from ``step_log`` — what the
        engine *executed* — not from the schedule it planned to execute,
        so an execution bug cannot hide behind a correct schedule (the
        simulator lowers the same schedule; comparing executed-vs-sim is
        the meaningful check).  Before any ``run`` — or after a
        zero-request run — every field is a well-defined zero/empty,
        never a division error."""
        s = self.last_schedule
        decode_steps: Dict[int, int] = {
            rid: 0 for rid in (s.decode_steps if s is not None else {})}
        for rec in self.step_log:
            for rid in rec.decoded:
                decode_steps[rid] = decode_steps.get(rid, 0) + 1
        out: Dict[str, object] = {
            "schema_version": METRICS_SCHEMA_VERSION,
            "steps": len(self.step_log),
            "decode_steps": decode_steps,
            "admit_step": dict(s.admit_step) if s is not None else {},
            "finish_step": dict(s.finish_step) if s is not None else {},
            "decode_calls": self.decode_calls,
            "decode_batches": self.decode_batches,
            "max_concurrency": max(
                (len(r.admitted) + len(r.decoded) for r in self.step_log),
                default=0),
            "plan_cache_len": self.plan_cache_len,
        }
        out.update(summarize_spans(self.request_spans, unit="steps"))
        out["wall"] = summarize_spans(self.wall_spans, unit="seconds")
        out["metrics"] = self.registry.to_dict()
        return out
