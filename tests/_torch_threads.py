"""The module fixture of the ``test_torch_*`` files, each of which imports
it (``from _torch_threads import one_thread  # noqa: F401``)."""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models gain nothing from intra-op threads, and the suite runs
    several workers on the host's cores: oversubscribed, torch's threads
    made these tests ten times slower under load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
