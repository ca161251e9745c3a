"""The benchmark's own tests: ``python -m pytest benchmark -q`` from the
repository root. Tests marked ``card`` need an NVIDIA GPU; each decides
inside the test whether one is there and skips with the reason where
not."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips on a machine without one")
