"""The card's idle share of the traced prefill window: the seconds in
which no kernel, copy or set ran, over the window's."""


def read(t):
    if t.window_s <= 0 or not t.prompts:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
