"""Repository-wide pytest settings: registers the marker of tests that need a
CUDA card (they skip with a reason where none is visible)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with a reason where none is visible")
