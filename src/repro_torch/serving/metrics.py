"""Serving observability: per-request latency / TTFT / queue-depth
counters — the port of ``repro.serving.metrics`` (numpy and ``time``
only, so the code is the reference's).

A :class:`ServeMetrics` instance is threaded through an engine's host
loop; the engine reports lifecycle events (enqueue → admitted → first
token → finish) and per-step queue depth, and ``summary()`` folds the
traces into the percentile/throughput numbers the load bench gates on
(``repro_torch.benchmarks.bench_serving`` → ``BENCH_serving_torch.json``).

On the card a timestamp is taken only once the value it stamps is on
the host: the first token is stamped after ``int(sampler(...))`` has
read it back, a finish after the step's one device→host copy.

The clock is injected (default ``time.monotonic``) so tests drive a
fake clock and get deterministic traces; the bench passes arrival
timestamps explicitly (``enqueue(..., at=t)``) so open-loop queueing
delay — time between the *scheduled* Poisson arrival and admission —
is part of the measured latency, as a production load test requires.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestTrace:
    """One request's lifecycle timestamps (clock units, usually s)."""
    rid: int
    agent_id: int = 0
    enqueued: float = 0.0
    admitted: Optional[float] = None     # slot assigned (prefill start)
    first_token: Optional[float] = None  # TTFT reference point
    finished: Optional[float] = None
    n_tokens: int = 0
    version: int = 0                     # param-store version served

    @property
    def latency(self) -> Optional[float]:
        return (None if self.finished is None
                else self.finished - self.enqueued)

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.first_token is None
                else self.first_token - self.enqueued)

    @property
    def queue_wait(self) -> Optional[float]:
        return (None if self.admitted is None
                else self.admitted - self.enqueued)


def percentile(xs: List[float], q: float) -> float:
    """numpy linear-interpolation percentile; nan on empty."""
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


class ServeMetrics:
    """Lifecycle counters for one engine run."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.traces: Dict[int, RequestTrace] = {}
        self.queue_depth: List[int] = []     # sampled once per step
        self.live_slots: List[int] = []
        self.decode_steps = 0
        self.swaps = 0                       # param hot-swaps observed

    # -- lifecycle events ----------------------------------------------
    def enqueue(self, rid: int, agent_id: int = 0,
                at: Optional[float] = None) -> None:
        self.traces[rid] = RequestTrace(
            rid=rid, agent_id=agent_id,
            enqueued=self.clock() if at is None else at)

    def admitted(self, rid: int, version: int = 0) -> None:
        t = self.traces[rid]
        t.admitted = self.clock()
        t.version = version

    def first_token(self, rid: int) -> None:
        self.traces[rid].first_token = self.clock()

    def finish(self, rid: int, n_tokens: int) -> None:
        t = self.traces[rid]
        t.finished = self.clock()
        t.n_tokens = n_tokens

    def observe_step(self, queued: int, live: int) -> None:
        self.decode_steps += 1
        self.queue_depth.append(queued)
        self.live_slots.append(live)

    def observe_swap(self) -> None:
        self.swaps += 1

    # -- aggregation ----------------------------------------------------
    def summary(self) -> dict:
        done = [t for t in self.traces.values()
                if t.finished is not None]
        lat = [t.latency for t in done]
        ttft = [t.ttft for t in done if t.ttft is not None]
        wait = [t.queue_wait for t in done if t.queue_wait is not None]
        toks = sum(t.n_tokens for t in done)
        span = (max(t.finished for t in done)
                - min(t.enqueued for t in done)) if done else 0.0
        per_agent: Dict[int, int] = {}
        for t in done:
            per_agent[t.agent_id] = per_agent.get(t.agent_id, 0) + 1
        return {
            "requests": len(self.traces),
            "completed": len(done),
            "tokens": toks,
            "span_s": span,
            "throughput_tok_s": toks / span if span > 0 else 0.0,
            "requests_s": len(done) / span if span > 0 else 0.0,
            "latency_p50": percentile(lat, 50),
            "latency_p99": percentile(lat, 99),
            "ttft_p50": percentile(ttft, 50),
            "ttft_p99": percentile(ttft, 99),
            "queue_wait_p99": percentile(wait, 99),
            "queue_depth_mean": (float(np.mean(self.queue_depth))
                                 if self.queue_depth else 0.0),
            "queue_depth_max": (int(np.max(self.queue_depth))
                                if self.queue_depth else 0),
            "live_slots_mean": (float(np.mean(self.live_slots))
                                if self.live_slots else 0.0),
            "decode_steps": self.decode_steps,
            "swaps": self.swaps,
            "per_agent_completed": per_agent,
        }

    def rows(self) -> List[dict]:
        """Per-request records for the bench's machine-readable JSON."""
        return [{"rid": t.rid, "agent": t.agent_id,
                 "enqueued": t.enqueued, "ttft": t.ttft,
                 "latency": t.latency, "tokens": t.n_tokens,
                 "version": t.version}
                for t in sorted(self.traces.values(),
                                key=lambda t: t.rid)]
