def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; the test skips itself where none is "
        "present (run them on a GPU host: python -m pytest -m cuda)",
    )
