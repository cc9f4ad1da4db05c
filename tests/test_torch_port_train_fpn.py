"""Training on Swin-T with (b) TransformerEncoderPixelDecoder + DepthTransformerEncoderPixelDecoder, both FPN trunks (disparities at strides 4 to 32), against the JAX package
(tests/_torch_port_train_decoders.py holds the tests and their
tolerances)."""

import pytest

from _torch_port_train_decoders import *  # noqa: F401,F403 (the tests)


@pytest.fixture(scope="module")
def letter():
    return "b"
