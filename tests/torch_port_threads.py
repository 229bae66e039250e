"""The thread policy of the port's test files (tests/test_torch_*.py
that work on small tensors).  Such a file imports the fixture:

    from torch_port_threads import one_intra_op_thread  # noqa: F401
"""
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Small tensors: torch's intra-op threads only add their wake-ups
    to each op, and in a suite run with several workers they contend
    for the same cores.  One thread for the importing file; the count is
    restored for the files after it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
