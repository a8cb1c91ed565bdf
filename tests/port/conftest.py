"""Fixtures shared by the port's tests."""
import pytest
import torch


@pytest.fixture(scope="module")
def one_intra_op_thread():
    """For modules that run the port's plain path on int64 tensors: one
    intra-op thread a test process, restored after the module, keeps several
    pytest workers from oversubscribing the cores (their barriers spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
