"""Hierarchical scoped timers + JAX profiler integration.

The observability equivalent of Chombo's CH_TIME/CH_TIMERS/CH_TIMELEAF
scoped-timer tree, which the reference wraps around every operator method
and Fortran kernel call (VariableCoeffPoissonOperator.cpp:34-305,
VariableCoeffPoissonOperatorF_F.H glue; SURVEY §5). `scope(...)` nests, and
`report()` prints the hierarchical time table the way Chombo's time report
does. Scopes also emit jax.profiler.TraceAnnotation ranges so the same
names line up in XLA device traces captured with `trace_to(...)`.

By default timers measure host wall time around dispatch; pass `block=True`
to time completed device work (a readback barrier after the scope).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@dataclass
class _Node:
    name: str
    total: float = 0.0
    count: int = 0
    children: dict = field(default_factory=dict)

    def child(self, name: str) -> "_Node":
        if name not in self.children:
            self.children[name] = _Node(name)
        return self.children[name]


class TimerTree:
    """One global-ish tree per instance; thread-unsafe by design (matches
    the per-process CH_TIMER model)."""

    def __init__(self):
        self.root = _Node("root")
        self._stack = [self.root]

    @contextlib.contextmanager
    def scope(self, name: str, block: bool = False):
        node = self._stack[-1].child(name)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            with jax.profiler.TraceAnnotation(name):
                yield node
        finally:
            if block:
                barrier_sync()
            node.total += time.perf_counter() - t0
            node.count += 1
            self._stack.pop()

    def report(self, out=None) -> str:
        lines: list[str] = []

        def rec(node: _Node, depth: int, parent_total: float):
            if node is not self.root:
                pct = (
                    100.0 * node.total / parent_total
                    if parent_total > 0
                    else 100.0
                )
                lines.append(
                    f"{'  ' * depth}[{node.total * 1e3:10.2f} ms] "
                    f"{node.count:6d}x {pct:5.1f}%  {node.name}"
                )
            ptotal = node.total if node is not self.root else sum(
                c.total for c in node.children.values()
            )
            for c in sorted(
                node.children.values(), key=lambda c: -c.total
            ):
                rec(c, depth + (node is not self.root), ptotal)

        rec(self.root, 0, 0.0)
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text

    def reset(self):
        self.root = _Node("root")
        self._stack = [self.root]


# default process-wide tree (the CH_TIMER global)
TIMERS = TimerTree()
scope = TIMERS.scope
report = TIMERS.report
reset = TIMERS.reset


def barrier_sync():
    """Wait until all dispatched device work is done (readback barrier of
    a fresh scalar: the device queue is in order)."""
    try:
        arr = jax.numpy.zeros(())
        jax.block_until_ready(arr)
        float(arr)
    except Exception:  # pragma: no cover — never break timing on teardown
        pass


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a jax.profiler device trace for the enclosed region (view in
    TensorBoard / xprof) — the deep-dive companion to the timer tree."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
