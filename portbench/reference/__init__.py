"""Plain float32 PyTorch references of the benchmark's models and train
step.  They import nothing of the port, of ``jax`` or of the JAX package,
and compute from the benchmark's own inputs.

A configuration file names its reference module (``reference``, a file
of this folder), which the loops find by that path.  It offers
``make_weights(model, seed, device)`` (the weights both sides get, in the
port's tree), ``same`` (the identity rounding), and for the loops that
use them ``last_logits(model, params, tokens, rnd)`` (prefill),
``loss(model, params, tokens, labels, aux_weight, rnd)`` (train, through
:mod:`.train`), and ``prefill_flops`` / ``train_flops`` (the model FLOPs
the utilization readers divide).  A new model family is a new module
here and a configuration that names it.
"""
