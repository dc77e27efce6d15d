import os

# Smoke tests and benchmarks must see the REAL device count (the dry-run
# alone forces 512 host devices, in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Deterministic jax/XLA numerics for the vcluster backend-conformance
# suite: a fixed single-threaded CPU reduction order makes kernel outputs
# reproducible across CI machines and laptops (threaded reductions may
# reassociate float sums).  setdefault only — an externally configured
# XLA_FLAGS (e.g. the dry-run's forced device count) wins.
os.environ.setdefault(
    "XLA_FLAGS",
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; the test skips itself where none is "
        "present (run them on a GPU host: python -m pytest -m cuda)",
    )


def pytest_collection_modifyitems(config, items):
    # Per-test wall-clock budget: the fault-injection and self-healing
    # sweep suites spawn worker processes, and a hung child should fail
    # its one test, not wedge the whole run.  Gated on the optional
    # pytest-timeout plugin (requirements-dev.txt) being installed —
    # without it the marker would be inert noise.
    if not config.pluginmanager.hasplugin("timeout"):
        return
    for item in items:
        if item.get_closest_marker("timeout") is None:
            item.add_marker(pytest.mark.timeout(300))


@pytest.fixture(scope="session")
def rng():
    import jax

    return jax.random.PRNGKey(0)
