"""Lightweight span tracing for the serve path.

A :class:`Span` is one timed unit of work on the request path — the whole
request, its queue wait, the batch's device execute, a shard's slice of a
fan-out — with a parent link so a request's cost decomposes hierarchically:

    serve.request (seq=17)
      └─ serve.queue_wait
    serve.batch (size=32)
      ├─ serve.batch_form
      ├─ serve.device_execute
      │    ├─ shard (shard=0, live=1)
      │    ├─ shard (1, live=0)   ← masked out by the health registry
      │    └─ ...
      └─ serve.merge

Spans use the monotonic clock (``time.perf_counter``), sequential integer
ids (deterministic — no RNG on the serve path), and land in a bounded ring
once finished.  The tracer is single-threaded by design, matching the
serve loop; the *current span* is an explicit stack, so ``with
tracer.span(...)`` nests automatically and ``start_span(parent=...)``
handles the cross-batch case where a child (batch) has many logical
parents (the requests in it) — there, requests carry a ``link`` attribute
listing the batch span instead, see ``ann_server.drain``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Optional


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    start: float                       # perf_counter seconds
    end: Optional[float] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return (self.end if self.end is not None
                else time.perf_counter()) - self.start

    @property
    def finished(self) -> bool:
        return self.end is not None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "start": self.start,
                "end": self.end, "duration_s": self.duration_s,
                "attrs": dict(self.attrs)}


def clock_anchor() -> tuple[int, int]:
    """``(time.perf_counter_ns(), time.time_ns())`` read back to back: the
    spans' monotonic clock against the Unix epoch's, which a profiler's
    trace stamps its events with."""
    return time.perf_counter_ns(), time.time_ns()


class Tracer:
    """Span factory + bounded ring of finished spans.

    ``anchors`` holds clock anchors (``clock_anchor``): one taken at
    construction and one more each time the spans are exported
    (``to_dicts``), so that the spans map onto another clock's timeline and
    the drift between the two clocks shows.  ``n_dropped`` counts the
    finished spans the ring pushed out."""

    def __init__(self, max_spans: int = 4096):
        self.finished: deque[Span] = deque(maxlen=max_spans)
        self._stack: list[Span] = []
        self._next_id = 1
        self.n_started = 0
        self.n_dropped = 0
        self.anchors: list[tuple[int, int]] = [clock_anchor()]

    # -- explicit API (non-lexical span lifetimes) ---------------------------
    def start_span(self, name: str, parent: Optional[Span] = None,
                   **attrs) -> Span:
        """Open a span.  ``parent`` wins over the implicit stack; pass
        ``parent=None`` explicitly via ``root=True`` semantics by not being
        inside a ``with tracer.span(...)`` block."""
        pid = parent.span_id if parent is not None else (
            self._stack[-1].span_id if self._stack else None)
        s = Span(name=name, span_id=self._next_id, parent_id=pid,
                 start=time.perf_counter(), attrs=dict(attrs))
        self._next_id += 1
        self.n_started += 1
        return s

    def end_span(self, span: Span, end: Optional[float] = None,
                 **attrs) -> Span:
        """Close a span.  ``end`` (a ``perf_counter`` timestamp) supports
        retroactive spans — e.g. a request span whose queue wait is only
        known at dispatch time."""
        if span.end is None:
            span.end = end if end is not None else time.perf_counter()
            span.attrs.update(attrs)
            if len(self.finished) == self.finished.maxlen:
                self.n_dropped += 1
            self.finished.append(span)
        return span

    def activate(self, span: Span) -> Span:
        """Make ``span`` the implicit parent for spans started while it is
        active (non-lexical counterpart of ``with tracer.span(...)`` — used
        where try/except control flow crosses the span boundary)."""
        self._stack.append(span)
        return span

    def deactivate(self, span: Span) -> None:
        if self._stack and self._stack[-1] is span:
            self._stack.pop()

    # -- lexical API ---------------------------------------------------------
    def span(self, name: str, parent: Optional[Span] = None, **attrs):
        return _SpanCtx(self, name, parent, attrs)

    # -- queries (tests, exporters) ------------------------------------------
    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.finished if s.name == name]

    def children_of(self, span: Span) -> list[Span]:
        return [s for s in self.finished if s.parent_id == span.span_id]

    def to_dicts(self) -> list[dict]:
        self.anchors.append(clock_anchor())
        return [s.to_dict() for s in self.finished]


_OFF = contextlib.nullcontext()


def maybe_span(tracer: Optional[Tracer], name: str, **attrs):
    """``tracer.span(name, **attrs)``, or without a tracer a null context
    that yields None: the idiom of code that takes ``tracer=None``, which
    then makes no span, launches nothing and waits for nothing."""
    if tracer is None:
        return _OFF
    return tracer.span(name, **attrs)


class _SpanCtx:
    __slots__ = ("tracer", "name", "parent", "attrs", "span")

    def __init__(self, tracer: Tracer, name: str, parent, attrs: dict):
        self.tracer, self.name, self.parent, self.attrs = \
            tracer, name, parent, attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        self.span = self.tracer.start_span(self.name, parent=self.parent,
                                           **self.attrs)
        self.tracer._stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        self.tracer._stack.pop()
        if exc_type is not None:
            self.span.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.tracer.end_span(self.span)
