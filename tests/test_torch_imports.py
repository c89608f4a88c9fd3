"""PyTorch port: import guards.

The port, chip_smoke.py and the two precision studies
(bwd_precision_study.py, tc_precision_study.py) run on a machine without
JAX, so they may import neither JAX nor anything of the JAX
package, and importing them may need no CUDA compiler.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "incubator_mxnet_tpu_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_jax_package_imports_in_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "bwd_precision_study.py",
                                          ROOT / "tc_precision_study.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "incubator_mxnet_tpu")]
    assert not bad


def test_import_loads_no_jax_and_needs_no_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    code = ("import sys, incubator_mxnet_tpu_torch as mx; "
            "import incubator_mxnet_tpu_torch.ops.attention as a; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'incubator_mxnet_tpu')]; "
            "assert not bad, bad; assert a.flash_fwd_launches == 0; "
            "assert a.flash_bwd_dq_launches == a.flash_bwd_dkv_launches "
            "== 0; mx.autograd, mx.optimizer.Adam, mx.gluon.Trainer, "
            "mx.gluon.loss.SoftmaxCrossEntropyLoss, "
            "mx.models.FusedMLMCELoss; "
            "import incubator_mxnet_tpu_torch.ops.conv_stats as c; "
            "assert c.conv1x1_stats_launches == 0; "
            "from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import "
            "resnet50_v1b; mx.optimizer.SGD, mx.gluon.nn.Conv2D, "
            "mx.gluon.nn.BatchNorm, mx.gluon.nn.GlobalAvgPool2D, "
            "mx.autograd.train_mode, mx.ops.nn.pooling; "
            "mx.models.TransformerNMT, mx.models.transformer_nmt_base, "
            "mx.models.transformer_nmt_small, mx.models.CrossAttention, "
            "mx.models.TransformerDecoder; "
            "import incubator_mxnet_tpu_torch.contrib.amp as amp; "
            "import incubator_mxnet_tpu_torch.contrib.amp.lists; "
            "import incubator_mxnet_tpu_torch.contrib.amp.loss_scaler; "
            "amp.init, amp.LossScaler, amp.lists.FP32_OPS, mx.contrib.amp, "
            "mx.gluon.Block.cast, mx.ops.optimizer.mp_sgd_update; "
            "assert amp.current_target() is None; "
            "assert a.flash_fwd_causal_launches == "
            "a.flash_bwd_dq_causal_launches == "
            "a.flash_bwd_dkv_causal_launches == 0; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'incubator_mxnet_tpu')]; assert not bad, bad; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
