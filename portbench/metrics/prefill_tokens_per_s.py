"""All prompt tokens of the requests completed in the window, over the
window's seconds (host clock; the window ends when its last request's
logits are on the host)."""


def read(run):
    if run.work != "prefill" or not run.items:
        return None
    return sum(r["b"] * r["s"] for r in run.items) / run.window_s
