"""95th percentile, over every request of the window, of issue to
last-position logits on the host (time to first token), in ms."""

import numpy as np


def read(run):
    if run.work != "prefill" or not run.items:
        return None
    return float(np.percentile([r["done"] - r["issue"] for r in run.items],
                               95)) * 1e3
