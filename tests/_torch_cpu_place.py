"""An autouse fixture for port tests that build ``nn`` Layers directly:
a Layer creates its parameters on the current place, which is the card by
default (``paddle_tpu_torch.set_device``); these tests build on the CPU.
Import ``cpu_place`` into a test module to apply it there."""
import pytest

from paddle_tpu_torch.core import place


@pytest.fixture(autouse=True)
def cpu_place():
    prev = place._current_place
    place.set_device("cpu")
    yield
    place._current_place = prev
