"""PyTorch port: the vision model zoo against the JAX package, continued:
VGG (with and without BatchNorm), AlexNet, DenseNet and SqueezeNet 1.0
and 1.1, as test_torch_model_zoo.py holds MobileNetV2 (its module doc
says how)."""
import pytest

from test_torch_model_zoo import check_family

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("name", [
    "vgg_bn", "vgg", "alexnet", "densenet", "squeezenet1_0", "squeezenet1_1"])
def test_family_step_matches_jax(name):
    check_family(name)
