"""Model FLOPs of the traced window's train steps, as the configuration's
reference module counts them (``train_flops``: for the attention families
6 x N x tokens plus the attention's forward and backward over the causal
pairs, no recompute), over the traced window times the card's bf16 peak,
in %."""


def read(run):
    count = getattr(run.ref, "train_flops", None)
    if run.work != "train" or run.traced is None or run.peaks is None \
            or count is None:
        return None
    flops = sum(count(run.model, r["b"], r["s"]) for r in run.items)
    return 100 * flops / (run.traced.window_s
                          * run.peaks["bf16_flops_per_s"])
