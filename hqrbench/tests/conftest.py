"""The benchmark's own tests: ``python -m pytest hqrbench/tests``. Tests
marked ``card`` need a CUDA device and skip without one, decided inside
each test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")
