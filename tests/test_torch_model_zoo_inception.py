"""PyTorch port: the vision model zoo against the JAX package, continued:
Inception v3's mixed blocks A to E, and ResNet v2 with basic blocks
(reduced widths), as test_torch_model_zoo.py holds MobileNetV2 (its
module doc says how)."""
import pytest

from test_torch_model_zoo import check_family

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("name", [
    "inception_a_b", "inception_c_d_e", "resnet_v2_basic"])
def test_family_step_matches_jax(name):
    check_family(name)
