"""In-memory spans and counters of the port's calls and steps.

A span marks one layer's part of a call, ``with span("g.trunk"): ...``,
and :func:`count` adds to a counter at the same boundaries. Spans nest:
each holds ``(id, parent_id, root_id, name, t0_ns, t1_ns)``, where
``root_id`` is the id of the outermost span open when it began, shared by
every span of one call or step, and the times are
``time.perf_counter_ns()`` readings.

Recording is off until :func:`recording` switches it on for the body of a
``with`` statement and yields the :class:`Recorder`, which holds the spans
and ``counters`` once the body has ended. Off, :func:`span` returns one
shared object that does nothing, after a single check of a module global,
and :func:`count` returns at once. On or off, no span or counter reads a
device value or synchronises: a span's times are when the host enqueued
the work, not when the device ran it.

A recorder keeps at most ``cap`` spans and counts those past it in
``dropped``. It reads a ``(perf_counter_ns, time_ns)`` pair when it starts
and another when it stops; :meth:`Recorder.to_unix_ns` maps a span's time
onto ``time.time_ns()``'s clock, on which ``torch.profiler`` stamps its
events (as offsets from ``prof.profiler.kineto_results.trace_start_ns()``),
so that spans can be laid over a device trace.

Spans are opened and closed on one thread: the recorder keeps one stack of
open spans.

The port's spans: ``p2phd.infer`` (``Pix2PixHDInference.infer_step`` and
``infer_step_int8``) with ``p2phd.stage_in`` and the generator segments
``g.encode`` / ``g.trunk`` / ``g.decode`` (and ``g.enhance``, the fine
stream of ``netG local``); ``p2phd.train_step``
(``Pix2PixHD.train_step``) with its phases ``g_forward``, ``g_backward``,
``g_adam``, ``d_forward_backward``, ``d_adam`` (a phase that an error
cuts short keeps the name ``phase``). Its one counter,
``stage_in.pageable_bytes``, counts the input bytes that ``p2phd.stage_in``
copies to the device from host memory that is not pinned.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

_now = time.perf_counter_ns

#: The recorder in use; None while recording is off.
_REC: Optional["Recorder"] = None

DEFAULT_CAP = 200_000


class Span(NamedTuple):
    """One recorded span; ``parent_id`` is None for a root, whose
    ``root_id`` is its own ``id``."""
    id: int
    parent_id: Optional[int]
    root_id: int
    name: str
    t0_ns: int
    t1_ns: int


def _clock_pair() -> tuple:
    """``(perf_counter_ns, time_ns)`` read together: the wall clock between
    two readings of the counter, paired with their midpoint."""
    a = _now()
    unix = time.time_ns()
    return (a + _now()) // 2, unix


class Recorder:
    """The spans and counters of one :func:`recording`. ``spans`` is filled
    when recording stops; spans still open then end at the stop."""

    def __init__(self, cap: int = DEFAULT_CAP):
        self.cap = cap
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.clock = [_clock_pair()]
        self._rows: List[list] = []
        self._stack: List[list] = []

    def _open(self, name: str) -> Optional[list]:
        rows = self._rows
        if len(rows) >= self.cap:
            self.dropped += 1
            return None
        stack = self._stack
        i = len(rows)
        row = ([i, stack[-1][0], stack[0][0], name, _now(), 0] if stack
               else [i, None, i, name, _now(), 0])
        rows.append(row)
        stack.append(row)
        return row

    def _close(self, row: Optional[list]) -> None:
        """End ``row`` and every span still open inside it (a phase that
        an error cut short); a row that has ended already is left as it
        is."""
        if row is None or row[5]:
            return
        end, stack = _now(), self._stack
        while stack:
            top = stack.pop()
            top[5] = end
            if top is row:
                break

    def _stop(self) -> None:
        end = _now()
        for row in self._stack:
            row[5] = end
        self._stack.clear()
        self.clock.append(_clock_pair())
        self.spans = [Span(*row) for row in self._rows]
        self._rows = []

    def to_unix_ns(self, t: int) -> int:
        """``perf_counter_ns`` reading ``t`` on ``time.time_ns()``'s clock:
        through the start and stop pairs (the start pair alone while
        recording)."""
        (p0, u0), (p1, u1) = self.clock[0], self.clock[-1]
        if p1 == p0:
            return u0 + t - p0
        return u0 + round((t - p0) * ((u1 - u0) / (p1 - p0)))


class _Off:
    """What :func:`span` returns while recording is off."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


class _On:
    __slots__ = ("rec", "name", "row")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> "_On":
        self.row = self.rec._open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        self.rec._close(self.row)


def span(name: str):
    """A context manager that records its body as the span ``name``."""
    rec = _REC
    if rec is None:
        return OFF
    return _On(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    rec = _REC
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def active() -> bool:
    """Whether recording is on (to skip work that only a counter reads)."""
    return _REC is not None


@contextlib.contextmanager
def recording(cap: int = DEFAULT_CAP) -> Iterator[Recorder]:
    """Record spans and counters for the body; yields the recorder."""
    global _REC
    if _REC is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Recorder(cap)
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None
        rec._stop()


class Phases:
    """The consecutive phases of a step, each a span from the end of the
    one before (the first from the Phases' creation) to its own end.
    :meth:`end` closes the open phase as ``label``, calls ``mark(label)``
    and, unless ``last``, opens the next phase."""
    __slots__ = ("mark", "rec", "row")

    def __init__(self, mark: Optional[Callable[[str], None]] = None):
        self.mark, self.rec = mark, _REC
        self.row = None if self.rec is None else self.rec._open("phase")

    def end(self, label: str, last: bool = False) -> None:
        rec = self.rec
        if rec is not None:
            if self.row is not None:
                self.row[3] = label
            rec._close(self.row)
            self.row = None if last else rec._open("phase")
        if self.mark is not None:
            self.mark(label)


_QUIET = Phases()


def phases(mark: Optional[Callable[[str], None]] = None) -> Phases:
    """The :class:`Phases` of a step that calls ``mark(label)`` at the end
    of each phase; one shared object when there is neither a recorder nor
    a mark."""
    if _REC is None and mark is None:
        return _QUIET
    return Phases(mark)
