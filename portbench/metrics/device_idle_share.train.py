"""1 - the device's busy time (the union of its operations) over the
traced window of a train cell, in %."""


def read(run):
    if run.work != "train" or run.traced is None or run.traced.busy_s <= 0:
        return None
    return 100 * (1 - run.traced.busy_s / run.traced.window_s)
