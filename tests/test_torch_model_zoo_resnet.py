"""PyTorch port: the vision model zoo against the JAX package, continued:
MobileNetV3 large (0.35) and ResNet v2 with bottleneck blocks (reduced
widths), as test_torch_model_zoo.py holds MobileNetV2 (its module doc
says how)."""
import pytest

from test_torch_model_zoo import check_family

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("name", [
    "mobilenet_v3_large", "resnet_v2_bottleneck"])
def test_family_step_matches_jax(name):
    check_family(name)
