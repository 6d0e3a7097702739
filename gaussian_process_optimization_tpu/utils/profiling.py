"""Per-phase wall-clock timers + optional XLA trace capture.

The reference's observability is wall-clock bookkeeping (SURVEY §5: per-eval
cost timing in objective.py:71-76, cumulative stop condition bo.py:125-157) and
paramz's call-level memoization. The equivalents here:

- ``PhaseTimer``: accumulating named-phase timers with device-sync-aware stops
  (``sync`` waits for the device, so a phase times the work, not the enqueue);
- ``trace``: context manager around ``jax.profiler`` for XLA device traces viewable
  in TensorBoard/Perfetto, when deep profiling is needed.

Usage::

    pt = PhaseTimer()
    with pt("fit"):
        fitted, _ = fitter(model, key)
        pt.sync(fitted.kern.variance)   # barrier inside the phase
    with pt("acq"):
        x, fx = acq_argmax(key)
        pt.sync(fx)
    print(pt.report())
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    @staticmethod
    def sync(x):
        """Barrier: waits until the enqueued computation producing `x` has
        finished, so the phase closes after the device work."""
        import jax

        return jax.block_until_ready(x)

    def report(self) -> str:
        lines = []
        for phase, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[phase]
            lines.append(f"{phase:>16s}: {total:8.3f} s  ({n} calls, "
                         f"{total / max(n, 1) * 1e3:8.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XLA profiler trace (TensorBoard/Perfetto) around a block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
