"""A fixture that the port's CPU test files share: import it into a test
module (``from torch_threads import one_torch_thread``) and it applies to
every test there."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread for the length of a test: these small tensors
    gain nothing from more, and the suite's parallel workers would
    otherwise each spin up every core's thread (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
