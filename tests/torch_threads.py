"""One intra-op thread for the port's CPU tests.

Their tensors are small, so torch's thread pool gains nothing on them,
while it competes with the JAX reference's own pool in the same process
and with the other test processes: on a loaded machine a win trainer's
step ran some twenty times slower with the pool than on one thread.
A test module imports the fixture, which is autouse:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
