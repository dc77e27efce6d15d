"""The port's benchmark: cells of a model configuration under a traffic
mix, driven by ``BENCHMARK.json`` at the root of the checkout.

Run ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root.  Nothing here imports ``jax``, ``jaxlib``
or the JAX package: the system under test is ``repro_torch``.
"""
