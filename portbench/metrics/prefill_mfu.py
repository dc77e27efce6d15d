"""Model FLOPs of the traced window's prefill requests, as the
configuration's reference module counts them (``prefill_flops``: for the
attention families 2 x active layer weights x tokens, the causal
attention's two products over the unmasked pairs, the last positions'
unembedding), over the traced window times the card's bf16 peak, in %."""


def read(run):
    count = getattr(run.ref, "prefill_flops", None)
    if run.work != "prefill" or run.traced is None or run.peaks is None \
            or count is None:
        return None
    flops = sum(count(run.model, r["b"], r["s"]) for r in run.items)
    return 100 * flops / (run.traced.window_s
                          * run.peaks["bf16_flops_per_s"])
