"""Training on Swin-T with (c) MSDeformAttnPixelDecoder + DepthMSDeformAttnPixelDecoder (disparities at strides 4 to 32): the deformable attention's plain forward and gradient, K2's and K3's reference on the card, on the sequence path too, against the JAX package
(tests/_torch_port_train_decoders.py holds the tests and their
tolerances)."""

import pytest

from _torch_port_train_decoders import *  # noqa: F401,F403 (the tests)


@pytest.fixture(scope="module")
def letter():
    return "c"
