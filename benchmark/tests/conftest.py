"""The benchmark's own tests, run by hand from the repository root:

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA device and skip without one (the check is
made inside the test)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
