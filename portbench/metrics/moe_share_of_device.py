"""Device time launched inside ``transformer.moe_ffn`` (the mixture of
experts, every layer) over all device time of the traced window, in %."""

SPANS = {"transformer.moe_ffn": ("repro_torch.models.transformer",
                                 "moe_ffn")}


def read(run):
    if run.traced is None:
        return None
    total = sum(run.traced.device_ops.values())
    moe = run.traced.span_s.get("transformer.moe_ffn", 0.0)
    return 100 * moe / total if moe > 0 and total > 0 else None
