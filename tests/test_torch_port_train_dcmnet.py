"""Training on Swin-T with (a) BasePixelDecoder + DCMNet against the JAX
package (tests/_torch_port_train_decoders.py holds the tests and their
tolerances): DCMNet's disparities come at strides 2 to 16 and its
FrozenBatchNorm keeps its stored statistics in training."""

import pytest

from _torch_port_train_decoders import *  # noqa: F401,F403 (the tests)


@pytest.fixture(scope="module")
def letter():
    return "a"
