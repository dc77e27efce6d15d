"""All tokens of the train steps completed in the window, over the
window's seconds (host clock; each step ends on the device before the
next begins)."""


def read(run):
    if run.work != "train" or not run.items:
        return None
    return sum(r["b"] * r["s"] for r in run.items) / run.window_s
