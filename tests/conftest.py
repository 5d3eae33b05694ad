"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card with nvcc; skips (with a reason) where "
        "torch.cuda.is_available() is false. Run on the card with "
        "`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`",
    )
