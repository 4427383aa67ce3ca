"""One run of one cell: the serving program built from the cell's files,
driven by closed-loop clients through its own serving loop, with the
benchmark's spans around the calls into each layer.

The entry the window drives is ``repro_torch.runtime.service.ServingLoop``
(``submit``, ``pump`` and ``drain``, and a client's next query submitted
from ``on_result``), over a ``QueryDispatcher`` built as the program's
open-loop driver builds it. Each client sends its next query when its
last one is delivered; the pool of clients is fixed.

Phases of a run, on one clock (``time.perf_counter``):

1. set-up: the graph and the source pool from the seed, the program's
   objects, then warm-up through the same loop until the serving is
   settled (``Warmup``): no batch has raised the program's
   ``compile_events`` for a stretch of batches, and the sources delivered
   in each of the last few bins of seconds lie inside a band around their
   mean (batches that still raise ``compile_events`` in the window are
   counted and printed);
2. the window, ``seconds`` long: every query delivered in it counts in the
   rate and the latencies; a traced run then profiles a few more seconds
   of the same load (``_advance``);
3. the close: clients stop sending, the loop drains, and every query sent
   in the window is delivered. A seeded sample of them is kept for the
   comparison with the reference, which runs after the program is freed.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import random
import time

import numpy as np
import torch
from repro_torch.graph.csr import CSRGraph
from repro_torch.runtime import dispatch as dispatch_mod
from repro_torch.runtime.dispatch import QueryDispatcher
from repro_torch.runtime.service import ServingLoop

TRACE_SECONDS = 6.0  # the traced part of a --trace 1 run, after the window

MAX_ITERS = 64  # deeper than any configuration's BFS
FAMILY = "powerlaw"  # the learners' label for the graph
MAX_BATCH_SOURCES = 64  # one 64-lane morsel a batch at most
POOL_SOURCES = 512  # the seeded pool the clients draw their sources from
MIN_LEVELS = 3  # a pool source's BFS lasts this many levels at least


@dataclasses.dataclass(frozen=True)
class Warmup:
    """When the window opens: after ``min_batches`` and ``min_seconds``,
    once no batch has raised ``compile_events`` in the last
    ``quiet_batches``, and the sources delivered in each of the last
    ``steady_bins`` bins of ``bin_seconds`` lie within ``band`` of their
    mean. Past ``max_seconds`` it opens unsettled, and says so."""

    min_batches: int = 32
    min_seconds: float = 5.0
    quiet_batches: int = 32
    bin_seconds: float = 2.0
    steady_bins: int = 4
    band: float = 0.12
    max_seconds: float = 90.0
    rewarm_batches: int = 8  # a traced run's batches before recording


@dataclasses.dataclass
class Spans:
    """What the benchmark records around the program's layers (host
    clock, seconds), read by the per-layer metric readers."""

    window: tuple = (None, None)  # (start, end) of the window
    latency_s: list = dataclasses.field(default_factory=list)
    sources_delivered: int = 0  # in the window
    queries_delivered: int = 0  # in the window
    finalize_s: list = dataclasses.field(default_factory=list)
    phase1_ms: list = dataclasses.field(default_factory=list)
    batch_iters: list = dataclasses.field(default_factory=list)
    redispatched: int = 0  # morsels resumed in phase 2, in the window
    per_second: list = dataclasses.field(default_factory=list)  # sources
    planned: list = dataclasses.field(default_factory=list)  # (srcs, packed)
    batches_begun_traced: int = 0
    operands_s: float = 0.0
    cold_batches_window: int = 0
    warmup_batches: int = 0
    warmup_bins: list = dataclasses.field(default_factory=list)
    settled: bool = False
    harness_s: float = 0.0  # the clients' own time in the window
    lanes: int = 64


class _DispatcherSpans:
    """The dispatcher as the serving loop sees it, with the benchmark's
    spans around ``begin_batch`` and each settled batch's ``finalize``.
    Everything else is the dispatcher's own."""

    def __init__(self, disp, run: "CellRun"):
        self._disp = disp
        self._run = run

    def __getattr__(self, name):
        return getattr(self._disp, name)

    def begin_batch(self, *args, **kw):
        with self._run.span("bench.begin_batch"):
            inflight = self._disp.begin_batch(*args, **kw)
        if self._run.tracing:
            self._run.spans.batches_begun_traced += 1
        return inflight

    def settle_batch(self, inflight):
        with self._run.span("bench.settle_batch"):
            settled = self._disp.settle_batch(inflight)
        finalize = settled.finalize
        run = self._run

        def spanned():
            run.finalize_begin()
            return finalize()

        settled.finalize = spanned
        return settled


class CellRun:
    """State of one run: clients, spans and the sample kept for the
    comparison."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 control: dict | None = None, t_start: float | None = None,
                 warmup: Warmup = Warmup()):
        self.config, self.traffic = config, traffic
        self.warmup = warmup
        self.seconds, self.trace = float(seconds), trace
        self.device = device
        self.control = control or {}
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.spans = Spans()
        self.tracing = False
        self.phase = "setup"
        self.profiler = None
        self.probes = None
        self.trace_summary = None
        seeds = np.random.SeedSequence(int(seed) % 2**63).generate_state(4)
        self.graph_seed, self.pool_seed, self.client_seed, \
            self.sample_seed = (int(s) for s in seeds)

    # ------------------------------------------------------------ spans

    def span(self, name: str):
        if self.trace:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def finalize_begin(self) -> None:
        """A settled batch's finalize begins: its span lasts until its last
        query is delivered."""
        pb = self._plans.popleft()
        self._fin = [time.perf_counter(), len(pb.queries)]
        self._fin_ctx = self.span("bench.finalize")
        self._fin_ctx.__enter__()

    def _finalize_delivered(self, t: float) -> None:
        self._fin[1] -= 1
        if self._fin[1] == 0:
            self._fin_ctx.__exit__(None, None, None)
            if self.phase == "window":
                self.spans.finalize_s.append(t - self._fin[0])

    # ------------------------------------------------------------ set-up

    def build(self, indptr: np.ndarray, indices: np.ndarray,
              pool: np.ndarray) -> None:
        csr = CSRGraph(indptr=indptr, indices=indices)
        self.pool = pool
        self.n_nodes = csr.n_nodes
        # as the program's open-loop driver builds it on one card
        # (``launch/serve.py::open_loop_dispatcher``), no adjacency cut
        disp = QueryDispatcher(
            self.device, csr, max_deg=self.control.get("max_deg"),
            max_iters=MAX_ITERS, adaptive=True, backend="recommend",
            family=FAMILY, online_adapt=True, pad_pow2_morsels=True)
        disp.on_finalized = self._on_finalized
        self.disp = disp
        # the operand build happens inside the first batch: time it
        prepare = dispatch_mod.prepare_graph
        spans = self.spans

        def timed_prepare(*args, **kw):
            t0 = time.perf_counter()
            out = prepare(*args, **kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            spans.operands_s += time.perf_counter() - t0
            return out

        dispatch_mod.prepare_graph = timed_prepare
        self._restore = [(dispatch_mod, "prepare_graph", prepare)]
        self.loop = ServingLoop(
            dispatcher=_DispatcherSpans(disp, self),
            overlap=True, max_batch_sources=MAX_BATCH_SOURCES,
            on_result=self._on_result,
        )
        self.spans.lanes = self.loop.admission.lanes
        self._plans: collections.deque = collections.deque()
        plan = self.loop.admission.plan

        def spanned_plan(now=None):
            with self.span("bench.plan"):
                p = plan(now=now)
            self._plans.extend(p.batches)
            if self.phase == "window":
                self.spans.planned.extend(
                    (len(pb.sources), bool(pb.packed)) for pb in p.batches)
            return p

        self.loop.admission.plan = spanned_plan
        # clients: client c draws its queries from its own stream
        n_clients = int(self.traffic["clients"])
        self._k = int(self.traffic["sources_per_query"])
        self._rngs = [np.random.default_rng([self.client_seed, c])
                      for c in range(n_clients)]
        self._meta: dict = {}
        self._next = [0] * n_clients
        self._sample_rng = random.Random(self.sample_seed)
        self._sample: list = []  # (qid, sources, rows)
        self._sample_seen = 0
        self.submitted_window = 0
        self.shed = 0

    def install_probes(self, probes) -> None:
        self.probes = probes

    # ------------------------------------------------------------ clients

    def _sources(self, c: int) -> np.ndarray:
        """Client ``c``'s next query: ``sources_per_query`` distinct sources
        of the pool, from the client's own stream."""
        k, rng = self._k, self._rngs[c]
        if k == 1:
            i = int(rng.integers(len(self.pool)))
            return self.pool[i:i + 1]
        return self.pool[rng.choice(len(self.pool), size=k, replace=False)]

    def _submit(self, c: int) -> None:
        sources = self._sources(c)
        qid = f"c{c}.{self._next[c]}"
        self._next[c] += 1
        t = time.perf_counter()
        in_window = self.phase == "window"
        ticket = self.loop.submit(sources, qid=qid,
                                  query_kind=self.traffic["kind"])
        if in_window:
            self.submitted_window += 1
        if not ticket.admitted:
            if in_window:
                self.shed += 1
            return
        self._meta[qid] = (c, t, sources, in_window)

    def _on_result(self, qid: str, rows: np.ndarray) -> None:
        t = time.perf_counter()
        self._on_result_spans(qid, rows, t)
        if self.phase == "window":
            self.spans.harness_s += time.perf_counter() - t

    def _on_result_spans(self, qid: str, rows: np.ndarray, t: float) -> None:
        c, t_sub, sources, sent_in_window = self._meta.pop(qid)
        s = self.spans
        if self.phase == "window" and t >= s.window[1]:
            self._close_window()
        if self.phase == "warmup":
            b = int((t - self._warm_t0) / self.warmup.bin_seconds)
            while len(s.warmup_bins) <= b:
                s.warmup_bins.append(0)
            s.warmup_bins[b] += len(sources)
        if self.phase == "window":
            s.latency_s.append(t - t_sub)
            s.queries_delivered += 1
            s.sources_delivered += len(sources)
            sec = int(t - s.window[0])
            while len(s.per_second) <= sec:
                s.per_second.append(0)
            s.per_second[sec] += len(sources)
        if sent_in_window:
            self._keep(qid, sources, rows)
        self._finalize_delivered(t)
        self._advance(t)
        if self.phase != "closing":
            self._submit(c)

    def _keep(self, qid, sources, rows) -> None:
        """Reservoir sample of the queries sent in the window, seeded. The
        delivered rows are kept as delivered, not copied: a copy of a row
        as long as the graph costs the serving thread about a millisecond,
        and the first few hundred would slow the window's first seconds
        (the program hands each query rows of its own)."""
        cap = int(self.traffic["check"]["max_queries"])
        self._sample_seen += 1
        if len(self._sample) < cap:
            self._sample.append((qid, sources, rows))
            return
        j = self._sample_rng.randrange(self._sample_seen)
        if j < cap:
            self._sample[j] = (qid, sources, rows)

    def _on_finalized(self, seq, outcome) -> None:
        if self.phase == "window":
            self.spans.phase1_ms.append(float(outcome.phase_ms["phase1"]))
            it = outcome.result.iterations
            self.spans.batch_iters.append(int(it.max()) if it.numel() else 0)
            self.spans.redispatched += int(outcome.redispatched)

    # ------------------------------------------------------------ phases
    #
    # warmup -> window -> closing, and in a traced run
    # warmup -> window -> rewarm -> traced -> closing: the profiler is
    # armed once the window has closed (its start takes seconds on the
    # card), the loop serves a few more batches under the same load, then
    # TRACE_SECONDS are recorded. The window itself is never profiled.

    def _advance(self, t: float) -> None:
        st = self.loop.stats
        if self.phase == "warmup":
            if st.cold_batches != self._cold_seen:
                self._cold_seen = st.cold_batches
                self._last_cold = st.batches
            waited = t - self._warm_t0
            settled = self._settled(st.batches, waited)
            if settled or waited >= self.warmup.max_seconds:
                self.spans.settled = settled
                self.spans.warmup_batches = st.batches
                self._cold_at_window = st.cold_batches
                self.phase = "window"
                self.spans.window = (t, t + self.seconds)
        elif self.phase == "rewarm" and st.batches >= self._rewarm_until:
            self.profiler.start()
            self.tracing = True
            self.phase = "traced"
        elif self.phase == "traced" and (
                t >= self.profiler.t_start + TRACE_SECONDS):
            self._stop_trace()

    def _settled(self, batches: int, waited: float) -> bool:
        """``Warmup``'s rule, on the complete bins of deliveries so far."""
        w = self.warmup
        if batches < w.min_batches or waited < w.min_seconds:
            return False
        if batches - self._last_cold < w.quiet_batches:
            return False
        if not w.steady_bins:
            return True
        done = int(waited / w.bin_seconds)  # bins that have ended
        if done < w.steady_bins:
            return False
        last = self.spans.warmup_bins[done - w.steady_bins:done]
        if len(last) < w.steady_bins:
            return False
        mean = sum(last) / len(last)
        return mean > 0 and all(abs(x - mean) <= w.band * mean
                                for x in last)

    def _close_window(self) -> None:
        self.spans.cold_batches_window = (self.loop.stats.cold_batches
                                          - self._cold_at_window)
        if not self.trace:
            self.phase = "closing"
            return
        from .tracing import Profiler

        stream = self.probes.stream if self.probes else None
        self.profiler = Profiler(self.device, stream)
        self.profiler.arm()
        self._rewarm_until = (self.loop.stats.batches
                              + self.warmup.rewarm_batches)
        self.phase = "rewarm"

    def _stop_trace(self) -> None:
        self.tracing = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.stop()
        self.phase = "closing"

    def serve(self) -> None:
        """Warm-up, window (and traced part) and close, in one drain of
        the loop: clients send from ``on_result`` until it closes."""
        self.phase = "warmup"
        self._warm_t0 = time.perf_counter()
        self._cold_seen = self.loop.stats.cold_batches
        self._last_cold = 0
        for c in range(len(self._rngs)):
            self._submit(c)
        self.loop.drain()
        if self.phase == "window":  # no delivery came after its end
            self._close_window()
        if self.phase in ("rewarm", "traced"):
            if self.phase == "rewarm":
                self.profiler.start()
            self._stop_trace()
        self.undelivered = len(self._meta)

    def setup_seconds(self) -> float:
        return self.spans.window[0] - self.t_start

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        if self.profiler is not None and self.profiler.prof is not None:
            self.trace_summary = self.profiler.summary()
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)
        if self.probes is not None:
            self.probes.uninstall()
        self.loop = None
        self.disp = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
