"""PyTorch port: the vision model zoo against the JAX package, continued:
MobileNet v1 (0.25) and MobileNetV3 small (0.5), as
test_torch_model_zoo.py holds MobileNetV2 (its module doc says how)."""
import pytest

from test_torch_model_zoo import check_family

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("name", ["mobilenet0_25", "mobilenet_v3_small"])
def test_family_step_matches_jax(name):
    check_family(name)
