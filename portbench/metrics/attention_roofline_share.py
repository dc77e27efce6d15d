"""The causal attention's bound (each call's q, k, v read and output
written once, two products over the unmasked pairs, at the card's peaks),
summed over the traced calls of ``attention.mha``, over the device time
launched inside them, in %.  It reads the same work whatever implements
attention (kernel K2 on the prefill path)."""

from portbench import counting

SPANS = {"attention.mha": ("repro_torch.models.attention", "mha")}


def read(run):
    if run.traced is None or run.peaks is None:
        return None
    calls = run.span_calls.get("attention.mha", [])
    device_s = run.traced.span_s.get("attention.mha", 0.0)
    if not calls or device_s <= 0:
        return None
    bound = 0.0
    for (q, esize), (k, _), *_ in calls:     # q (b, s, h, hd), k (b, s, kvh, hd)
        b, s, h, hd = q
        bound += counting.flash_bound(b, h, k[2], s, hd, esize,
                                      run.peaks)[0]
    return 100 * bound / device_s
