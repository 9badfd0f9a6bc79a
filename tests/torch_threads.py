"""Torch on one thread, for the port's tests that render through the plain
blends or the reference oracles: those are thousands of small tensor ops,
and on a loaded CPU each op's parallel region waits for its descheduled
threads (a render of 2 s took minutes among the suite's other workers; the
oracle render of envgs_synthetic, 6 s alone on 8 threads, took 565 s
there).

    from torch_threads import one_thread         # the fixture
    pytestmark = pytest.mark.usefixtures("one_thread")   # for a whole file
    with on_one_thread(): ...                    # outside a fixture
"""
import contextlib

import pytest
import torch


@contextlib.contextmanager
def on_one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture
def one_thread():
    with on_one_thread():
        yield
