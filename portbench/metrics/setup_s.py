"""Process start to the first timed request or step: imports, the card's
start, the weights and tokens, the kernels' build or load, and the
warm-up of every shape the mix uses (a train cell's first, checked
steps among them)."""


def read(run):
    return run.setup_s
