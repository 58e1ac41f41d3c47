"""Host microseconds a prompt token of the prefill call itself: the
compute spans ``prefill`` (``train/serve_step.make_prefill``) of the
traced requests, entry to return on the host clock, over their tokens.
What the host spends issuing a request's work, whether or not the card
waits on it."""
from portbench import spans


def read(t):
    got = spans.traced(t, "prefill")
    if got is None:
        return None
    roots, _ = got
    return 1e6 * sum(r.duration_s for r in roots) \
        / sum(r.attrs["tokens"] for r in roots)
