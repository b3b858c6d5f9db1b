"""Repository-wide pytest settings: registers the ``cuda`` marker.

Tests marked ``cuda`` need an NVIDIA card; they decide inside a fixture
whether one is present and skip with a reason where there is none.  On a
machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skipped where "
        "torch.cuda.is_available() is False)")
