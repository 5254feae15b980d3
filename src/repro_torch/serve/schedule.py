"""The slot-level continuous-batching schedule (copy of
``repro/serve/schedule.py``, DESIGN.md §11).

``build_schedule`` is the *single* deterministic scheduling core shared by
the live engine (``repro.serve.Engine.run``) and the serving-timeline
simulator (``repro.sim.simulate_serve``): given the request trace
(arrival step, prompt length, token budget) and a slot count, it produces
the exact per-step record of admissions, decodes, and completions.
Because both consumers execute the *same* schedule object, the simulator
reproduces the engine's per-request decode step counts by construction —
and tests still verify it empirically against the engine's executed
steps.

Semantics, per engine step ``t``:

1. slots whose request finished at the end of step ``t-1`` are free
   (immediate recycling — a short request never pads out to a wave max);
2. queued requests with ``arrival_step <= t`` are admitted FIFO into free
   slots; an admission runs that request's *prefill*, which emits its
   first token;
3. every slot that was already active (NOT admitted this step) runs one
   *decode*, emitting one token; its ``kv_len`` — the KV length the step
   attends over, including the token being decoded — is
   ``prompt_len + tokens_generated_before_this_step``;
4. a request with ``n`` output tokens therefore takes exactly ``n - 1``
   decode steps, finishing the step its last token is emitted.

This module is dependency-light on purpose (no jax, no simulator): the
simulator imports it without dragging the model stack in, and the engine
without dragging the simulator in.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """The schedule-relevant shadow of a live ``serve.Request``."""

    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival_step: int = 0

    def __post_init__(self):
        if self.prompt_len < 1:
            raise ValueError(f"request {self.rid}: prompt_len must be >= 1")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must "
                             "be >= 1")
        if self.arrival_step < 0:
            raise ValueError(f"request {self.rid}: arrival_step must "
                             "be >= 0")


@dataclasses.dataclass(frozen=True)
class ScheduleStep:
    """One engine step: who prefills, who decodes, who finishes."""

    step: int
    admitted: Tuple[Tuple[int, int], ...]        # (slot, rid)
    decoding: Tuple[Tuple[int, int, int], ...]   # (slot, rid, kv_len)
    finished: Tuple[int, ...]                    # rids done after this step


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The full deterministic timeline for one request trace."""

    slots: int
    steps: Tuple[ScheduleStep, ...]
    admit_step: Dict[int, int]       # rid -> step its prefill ran
    finish_step: Dict[int, int]      # rid -> step its last token came out
    decode_steps: Dict[int, int]     # rid -> decode steps it consumed

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def max_concurrency(self) -> int:
        """Peak number of slots busy in any one step."""
        return max((len(s.admitted) + len(s.decoding) for s in self.steps),
                   default=0)


def build_schedule(requests: Sequence[ServeRequest],
                   slots: int) -> Schedule:
    """Compute the continuous-batching timeline for ``requests``.

    Admission is FIFO over arrival order (ties broken by submission
    order); a request whose ``arrival_step`` is in the future never
    blocks an already-arrived one behind it.
    """
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    rids = [r.rid for r in requests]
    if len(set(rids)) != len(rids):
        raise ValueError(f"duplicate request ids in trace: {rids}")
    queue = deque(sorted(requests,
                         key=lambda r: r.arrival_step))  # stable: FIFO ties
    # slot -> [request, generated_tokens]
    active: Dict[int, List[object]] = {}
    steps: List[ScheduleStep] = []
    admit_step: Dict[int, int] = {}
    finish_step: Dict[int, int] = {}
    decode_steps: Dict[int, int] = {}
    t = 0
    while queue or active:
        admitted: List[Tuple[int, int]] = []
        free = deque(s for s in range(slots) if s not in active)
        while free and queue and queue[0].arrival_step <= t:
            r = queue.popleft()
            s = free.popleft()
            active[s] = [r, 1]                   # prefill emits token #1
            admitted.append((s, r.rid))
            admit_step[r.rid] = t
            decode_steps[r.rid] = 0
        admitted_slots = {s for s, _ in admitted}
        decoding: List[Tuple[int, int, int]] = []
        for s in sorted(active):
            if s in admitted_slots:
                continue                         # admission step: no decode
            r, generated = active[s]
            decoding.append((s, r.rid, r.prompt_len + generated))
            active[s][1] = generated + 1
            decode_steps[r.rid] += 1
        finished: List[int] = []
        for s in sorted(active):
            r, generated = active[s]
            if generated >= r.max_new_tokens:
                finished.append(r.rid)
                finish_step[r.rid] = t
        for s in [s for s, (r, _) in active.items()
                  if r.rid in finished]:
            del active[s]                        # recycled for step t+1
        steps.append(ScheduleStep(step=t, admitted=tuple(admitted),
                                  decoding=tuple(decoding),
                                  finished=tuple(finished)))
        if not admitted and not decoding and queue:
            # Idle gap before the next arrival: jump the clock (the
            # engine has nothing to run; recording empty steps would
            # inflate step counts with no-ops).
            steps.pop()
            t = min(r.arrival_step for r in queue)
            continue
        t += 1
    return Schedule(slots=slots, steps=tuple(steps),
                    admit_step=admit_step, finish_step=finish_step,
                    decode_steps=decode_steps)
