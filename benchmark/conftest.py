"""pytest settings of the benchmark's own tests (``pytest benchmark/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; decides inside the test and skips without one")
