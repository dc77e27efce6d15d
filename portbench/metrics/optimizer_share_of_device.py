"""Device time launched inside ``optimizer.adamw_update`` (clipping and
AdamW over every leaf) over all device time of the traced window, in %."""

SPANS = {"optimizer.adamw_update": ("repro_torch.train.step",
                                    "adamw_update")}


def read(run):
    if run.traced is None:
        return None
    total = sum(run.traced.device_ops.values())
    opt = run.traced.span_s.get("optimizer.adamw_update", 0.0)
    return 100 * opt / total if opt > 0 and total > 0 else None
