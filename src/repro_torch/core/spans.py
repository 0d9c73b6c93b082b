"""Spans and counters inside the scheduling pass, on the profiler's clock.

A process-wide recorder, off by default.  The engine, the prioritizer, the
MILP layer, the runtime predictor and the device copy sites each read
``ACTIVE`` once and test it against ``None``; while it is ``None`` no clock
is read, nothing is allocated and no context manager is entered, so
schedules, logits, counters and saved state are those of an engine
without the recorder.

Switching it on:

- ``enable()`` / ``disable()`` / ``reset()`` from any caller; a recorder
  switched on so stays on until ``disable()``;
- ``torch.profiler``: an engine built or restored while the profiler
  records switches the recorder on (``follow_profiler``) if it is off.
  That recorder switches itself off at the first engine step after the
  profiler stopped (or at the next build or restore), and stays readable
  as ``LAST``.  A profiled scheduler run thus carries the program's spans
  with no code of its own, and nothing is recorded once it ends.

While the recorder is on, ``repro_torch.obs.Observability`` exports its
spans into the trace document and its totals and counters into the
Prometheus text.

While on, each span reads ``time.perf_counter_ns()`` at open and at close.
Spans nest on a stack; a closing span adds its wall to its parent's child
time, so ``self = wall - children``.  Running totals per name
(``totals[name] = [count, wall_ns, self_ns]``) do not depend on the event
cap; the timeline keeps at most ``MAX_EVENTS`` events
``(start_ns, end_ns, name_id, depth)`` and counts the rest in ``dropped``.
Counters are plain integers (``count``); a tight loop folds its local
tallies in once, after the loop.  Spans are recorded only on the thread
that switched the recorder on; spans opened on other threads (the parallel
fleet's workers) are counted in ``foreign`` and not recorded, counters
from every thread are counted.

The clock: the recorder reads ``time.time_ns()`` and ``perf_counter_ns()``
back to back when it is made.  Under ``torch.profiler`` it also opens one
``record_function("rltune.anchor")`` and reads its own perf counter inside
it, so a span's perf-counter time maps exactly onto the chrome trace's
``ts`` axis (``trace_us``), where the kernels and copies lie.

Span names (prefix ``rltune.``):

========================  ===============================================
``rltune.step``           one event batch of ``SchedulerEngine.step``
``rltune.events``         heap pops, faults, arrivals, finishes
``rltune.schedule``       the scheduling pass (``_try_schedule``)
``rltune.hooks``          the ``on_tick`` / ``on_start`` / ``on_finish`` /
                          ``on_decision`` fan-outs
``rltune.rank``           one ranking; its self time is the sort
``rltune.rank.features``  feature rows, sampling, padding, critic rows
``rltune.rank.actor``     the actor: uploads, the launch, the copy back
``rltune.rank.tail``      the bucketed tail scorer
``rltune.place.head``     the head's placement that succeeded
``rltune.place.head_failed``  the head's placement that found no room
``rltune.milp.solve``     one HiGHS solve (solution-cache misses only)
``rltune.backfill``       the EASY scan, reservation included
``rltune.backfill.reserve``  the head's earliest start
``rltune.predict.rows``   predictor feature rows and anchors
``rltune.predict.forward``  the forward with its uploads, to the quantiles
``rltune.predict.sgd``    one online SGD step (``on_finish``)
``rltune.predict.submit``  a submitted job's feature row
========================  ===============================================

Counters: ``rank.decisions``, ``rank.futile`` (the head did not place and
the backfill started nothing); ``rank.shape_path`` (feature builds that
queried the cluster once per job shape, from the window's shape ids) and
``rank.shape_evals`` (the distinct shapes those builds queried);
``milp.hits`` / ``milp.solves`` / ``milp.greedy`` (requests with more than
one way: the solution cache, HiGHS, the greedy choice without a solve);
``backfill.tried`` (candidates that reached a placement attempt) and
``backfill.failed`` (attempts that found no room);
``predict.param_uploads``; ``device.h2d_copies``, ``device.h2d_bytes``,
``device.d2h_copies``, ``device.d2h_bytes`` (copies to and from a device
other than the CPU).

This module imports nothing of the package: the engine imports it, and
``repro_torch.obs`` imports the engine.
"""
from __future__ import annotations

import sys
import threading
import time

__all__ = ["ACTIVE", "LAST", "Recorder", "enable", "disable", "reset",
           "follow_profiler", "count_copy"]

#: the recorder while it is on, else None (every call site tests this)
ACTIVE: "Recorder | None" = None
#: the recorder most recently switched on; kept after ``disable`` so that
#: its totals can be read once recording stopped
LAST: "Recorder | None" = None
#: events the timeline keeps (about 80 B each); totals keep counting past it
MAX_EVENTS = 1_000_000

_perf = time.perf_counter_ns
_ident = threading.get_ident


def _profiler_on() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and bool(torch._C._autograd._profiler_enabled())


class Recorder:
    """Span totals, a bounded timeline and counters for one thread."""

    def __init__(self):
        self.thread = _ident()
        #: switched on by ``follow_profiler``, and off when the profiler stops
        self.follows_profiler = False
        self._lock = threading.Lock()
        self.clear()
        self.anchor = {"time_ns": time.time_ns(), "perf_ns": _perf()}
        if _profiler_on():
            import torch
            with torch.profiler.record_function("rltune.anchor"):
                self.anchor["profiler_perf_ns"] = _perf()

    def clear(self) -> None:
        """Drop every total, event and counter (the clock anchor stays)."""
        #: name -> [count, wall_ns, self_ns]
        self.totals: dict[str, list[int]] = {}
        #: (start_ns, end_ns, name_id, depth); names[name_id] is the name
        self.events: list[tuple[int, int, int, int]] = []
        self.names: list[str] = []
        self._ids: dict[str, int] = {}
        self.dropped = 0
        self.foreign = 0
        self.counters: dict[str, int] = {}
        #: open spans: [name, start_ns, child_ns]
        self._stack: list[list] = []

    # --------------------------------------------------------------- spans --
    def open(self, name: str) -> None:
        if _ident() != self.thread:
            self.foreign += 1
            return
        self._stack.append([name, _perf(), 0])

    def close(self, name: str | None = None) -> None:
        """Close the innermost open span; ``name`` renames it at close."""
        if _ident() != self.thread:
            return
        end = _perf()
        stack = self._stack
        if not stack:           # cleared while the span was open
            return
        opened, start, child = stack.pop()
        if name is None:
            name = opened
        wall = end - start
        if stack:
            stack[-1][2] += wall
        tot = self.totals.get(name)
        if tot is None:
            tot = self.totals[name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += wall
        tot[2] += wall - child
        if len(self.events) < MAX_EVENTS:
            nid = self._ids.get(name)
            if nid is None:
                nid = self._ids[name] = len(self.names)
                self.names.append(name)
            self.events.append((start, end, nid, len(stack)))
        else:
            self.dropped += 1

    @property
    def depth(self) -> int:
        return len(self._stack) if _ident() == self.thread else 0

    def unwind(self, depth: int) -> None:
        """Close the spans opened above ``depth`` (an exception left them
        open)."""
        if _ident() != self.thread:
            return
        while len(self._stack) > depth:
            self.close()

    # ------------------------------------------------------------ counters --
    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def add(self, *pairs: tuple[str, int]) -> None:
        """Fold several ``(counter, n)`` tallies in at once."""
        with self._lock:
            c = self.counters
            for name, n in pairs:
                c[name] = c.get(name, 0) + n

    # --------------------------------------------------------------- views --
    def trace_us(self, perf_ns: int, trace_anchor_end_us: float | None = None,
                 base_time_ns: int | None = None) -> float:
        """A perf-counter time on a chrome trace's ``ts`` axis (µs): through
        the ``rltune.anchor`` event's end where the trace has it, else
        through ``time.time_ns()`` and the trace's ``baseTimeNanoseconds``."""
        a = self.anchor
        if trace_anchor_end_us is not None and "profiler_perf_ns" in a:
            return (trace_anchor_end_us
                    + (perf_ns - a["profiler_perf_ns"]) / 1e3)
        base = 0 if base_time_ns is None else int(base_time_ns)
        return (a["time_ns"] + (perf_ns - a["perf_ns"]) - base) / 1e3


def enable() -> Recorder:
    """Switch the recorder on (a fresh one, anchored now); a recorder that
    is on already is kept, and stays on until ``disable()``."""
    global ACTIVE, LAST
    if ACTIVE is None:
        ACTIVE = LAST = Recorder()
    ACTIVE.follows_profiler = False
    return ACTIVE


def disable() -> "Recorder | None":
    """Switch the recorder off; returns it (also kept as ``LAST``)."""
    global ACTIVE
    ACTIVE = None
    return LAST


def reset() -> None:
    """Drop what the recorder holds, if it is on."""
    if ACTIVE is not None:
        ACTIVE.clear()


def follow_profiler() -> "Recorder | None":
    """Switch the recorder on when ``torch.profiler`` records and it is
    off; switch it off when the profiler stopped and it was the profiler
    that switched it on.  Returns the recorder that is on, or None.
    Engines call this when they are built or restored, and at each step
    while a recorder that follows the profiler is on."""
    if _profiler_on():
        if ACTIVE is None:
            enable().follows_profiler = True
    elif ACTIVE is not None and ACTIVE.follows_profiler:
        disable()
    return ACTIVE


def count_copy(rec: Recorder, kind: str, nbytes: int, n: int = 1) -> None:
    """``n`` host-device copies of ``nbytes`` in all: ``kind`` is ``"h2d"``
    or ``"d2h"``."""
    rec.add((f"device.{kind}_copies", n), (f"device.{kind}_bytes",
                                             int(nbytes)))
