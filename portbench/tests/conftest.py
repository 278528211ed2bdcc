"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the benchmark's runs); skips without one")
