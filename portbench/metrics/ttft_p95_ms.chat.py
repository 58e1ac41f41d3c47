"""The 95th percentile of time to first token over every request of a
traced prefill window, submit to first token on the host clock: the
end-to-end ``ttft_p95_ms``'s arithmetic, read per layer in a cell whose
tail follows the host's pace, which differs from one machine to the next,
so that no bound holds it.  It is read from a ``--trace 1`` run, whose
profiler and spans lengthen every request: compare it with traced runs
only."""
import statistics


def read(t):
    if len(t.ttft_ms) < 2:
        return None
    return statistics.quantiles(t.ttft_ms, n=100, method="inclusive")[94]
