"""Span-based round tracing with sampled device fencing.

A copy of the reference's ``repro.obs.trace``; the port's session fences
a sampled round with a CUDA event and its synchronize.

``RoundTracer`` records named spans — ``ingest``/``flush`` (frontend),
``stage``/``launch`` (host side of the coalesced round), ``h2d``/``drain``
(device attribution) — against an INJECTED clock, the same fake-clock
discipline the deadline batcher tests use, so every trace is
deterministic under test.

Sampling is the load-bearing design point: the serving round pipeline is
asynchronous (steps never block; per-round walls are reconstructed from
dispatch timestamps, edge counts stay pending device scalars), and a
device synchronize per round would serialize it. The tracer
therefore gates itself: ``sample_round()`` is consulted once per round
and only every ``sample_every``-th round gets spans + device fences —
callers hold a ``trace`` reference that is ``None`` on unsampled rounds,
so the fast path stays fence-free.

Export targets:

* ``to_chrome()`` / ``write_chrome(path)`` — Chrome/Perfetto
  ``trace_event`` JSON (complete "X" events, microsecond ts/dur, one
  ``tid`` track per span category). Open in ``ui.perfetto.dev`` or
  ``chrome://tracing``.
* ``write_jsonl(path)`` — one span dict per line, the grep/pandas form.

Span storage is bounded (``max_spans``); overflow increments ``dropped``
rather than growing without bound mid-serve.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Span:
    """One closed interval on the tracer's clock."""
    name: str           #: taxonomy name (ingest/flush/stage/launch/...)
    cat: str            #: category -> Perfetto track (frontend/host/device)
    t0: float           #: start, tracer-clock seconds
    t1: float           #: end, tracer-clock seconds
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def as_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat, "t0": self.t0,
                "t1": self.t1, "dur": self.dur, **self.args}


#: stable Perfetto track ids per category (unknown categories get the
#: next free track at first use).
_TRACKS = {"frontend": 1, "host": 2, "device": 3, "round": 4}


class RoundTracer:
    """Sampled span recorder over an injected clock.

    ``sample_round()`` advances the round cursor and returns True on
    sampled rounds (round 0 and every ``sample_every``-th after);
    ``would_sample()`` peeks WITHOUT advancing — the frontend uses it to
    decide whether to time its ingest/flush work before the session's
    ``step`` consumes the round slot.
    """

    def __init__(self, clock=time.monotonic, sample_every: int = 8,
                 max_spans: int = 65536):
        self.clock = clock
        self.sample_every = max(1, int(sample_every))
        self.max_spans = int(max_spans)
        self.spans: list[Span] = []
        self.dropped = 0
        self.rounds_seen = 0
        self.rounds_sampled = 0

    # ------------------------------------------------------- sampling
    def would_sample(self) -> bool:
        return (self.rounds_seen % self.sample_every) == 0

    def sample_round(self) -> bool:
        hit = self.would_sample()
        self.rounds_seen += 1
        if hit:
            self.rounds_sampled += 1
        return hit

    # ------------------------------------------------------ recording
    def add(self, name: str, t0: float, t1: float, cat: str = "round",
            **args) -> None:
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return
        self.spans.append(Span(name, cat, float(t0), float(t1), args))

    @contextmanager
    def span(self, name: str, cat: str = "round", **args):
        t0 = self.clock()
        yield
        self.add(name, t0, self.clock(), cat=cat, **args)

    # -------------------------------------------------------- reading
    def summary(self) -> dict:
        """``{span name: {count, total_s}}`` plus the sampling tallies."""
        per: dict[str, dict] = {}
        for s in self.spans:
            d = per.setdefault(s.name, {"count": 0, "total_s": 0.0})
            d["count"] += 1
            d["total_s"] += s.dur
        return {"rounds_seen": self.rounds_seen,
                "rounds_sampled": self.rounds_sampled,
                "spans": len(self.spans), "dropped": self.dropped,
                "by_name": per}

    # --------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object format: complete
        ("X") events with microsecond ``ts``/``dur``, categories mapped
        to distinct ``tid`` tracks."""
        tracks = dict(_TRACKS)
        events = []
        for s in self.spans:
            tid = tracks.setdefault(s.cat, len(tracks) + 1)
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
                "pid": 1, "tid": tid,
                "args": {k: v for k, v in s.args.items()},
            })
        # thread_name metadata gives Perfetto readable track labels
        for cat, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": cat}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(s.as_dict()) + "\n")
