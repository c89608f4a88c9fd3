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
            "import incubator_mxnet_tpu_torch.gluon.parameter as gp; "
            "import incubator_mxnet_tpu_torch.gluon.utils as gu; "
            "gp.Parameter, gp.ParameterDict, gp.Constant, "
            "gp.DeferredInitializationError, gu.split_and_load, "
            "gu.clip_global_norm, mx.gluon.ParameterDict, mx.optimizer.NAG, "
            "mx.ops.optimizer.nag_mom_update, mx.init.MSRAPrelu, "
            "mx.init.Xavier, mx.init.Orthogonal, mx.init.Mixed, "
            "mx.lr_scheduler.CosineScheduler, mx.lr_scheduler.PolyScheduler, "
            "mx.metric.Accuracy, mx.metric.TopKAccuracy, mx.metric.create, "
            "mx.callback.Speedometer, mx.nd.save, mx.nd.load, "
            "mx.gluon.model_zoo.vision.get_model, mx.current_context, "
            "mx.gluon.Block.initialize, mx.gluon.Block.save_parameters, "
            "mx.gluon.Trainer.load_states, mx.num_gpus(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'incubator_mxnet_tpu')]; assert not bad, bad; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# the modules that generation serving brought in: importing them loads
# neither JAX nor the JAX package
GENERATION_MODULES = (
    "monitor", "fault", "profiler", "telemetry", "telemetry.flightrec",
    "telemetry.spans", "telemetry.reqtrace", "parallel.resilience",
    "serving.engine", "serving.generation")


def test_generation_modules_load_no_jax(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    code = ("import importlib, sys\n"
            "for n in %r:\n"
            "    importlib.import_module('incubator_mxnet_tpu_torch.' + n)\n"
            "from incubator_mxnet_tpu_torch.serving import (\n"
            "    GenerationEngine, GenerationStream, Shed,\n"
            "    project_generation_footprint)\n"
            "from incubator_mxnet_tpu_torch.telemetry import span, current\n"
            "from incubator_mxnet_tpu_torch.fault import TransientFault\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'incubator_mxnet_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')" % (GENERATION_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# the nine modules of the serving tier: importing them loads neither JAX
# nor the JAX package
SERVING_TIER_MODULES = (
    "config", "storage", "telemetry.costs", "telemetry.history",
    "telemetry.memwatch", "telemetry.slo", "telemetry.export",
    "serving.engine", "serving.registry")


def test_serving_tier_modules_load_no_jax(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    code = ("import importlib, sys\n"
            "for n in %r:\n"
            "    importlib.import_module('incubator_mxnet_tpu_torch.' + n)\n"
            "from incubator_mxnet_tpu_torch.serving import (\n"
            "    ModelRegistry, AdmissionDenied, CircuitOpen, UnknownModel,\n"
            "    project_footprint, InferenceEngine)\n"
            "from incubator_mxnet_tpu_torch.telemetry import (\n"
            "    MetricsExporter, slo, memwatch, history, costs)\n"
            "from incubator_mxnet_tpu_torch.graph_capture import gate\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'incubator_mxnet_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')" % (SERVING_TIER_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# the input pipeline's modules: importing them loads neither JAX nor the
# JAX package, and builds nothing (the native reader compiles at first
# use)
INPUT_PIPELINE_MODULES = (
    "integrity", "io", "io.recordio", "io.decode_service", "io.device_feed",
    "io.native", "io.resilient", "io.io", "image", "image.image",
    "image.detection", "gluon.data", "gluon.data.dataset",
    "gluon.data.sampler", "gluon.data.dataloader", "gluon.data.vision",
    "gluon.data.vision.datasets", "gluon.data.vision.transforms")


def test_input_pipeline_modules_load_no_jax(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    code = ("import importlib, sys\n"
            "for n in %r:\n"
            "    importlib.import_module('incubator_mxnet_tpu_torch.' + n)\n"
            "import incubator_mxnet_tpu_torch as mx\n"
            "mx.io.ImageRecordIter, mx.io.DeviceFeed, mx.recordio.pack_img\n"
            "mx.image.CreateAugmenter, mx.image.CreateDetAugmenter\n"
            "mx.gluon.data.DataLoader, mx.gluon.data.vision.CIFAR10\n"
            "mx.gluon.HybridBlock.set_input_transform\n"
            "from incubator_mxnet_tpu_torch.telemetry import (\n"
            "    TraceContext, emit_foreign, set_global_step)\n"
            "from incubator_mxnet_tpu_torch.fault import InjectedIOError\n"
            "from incubator_mxnet_tpu_torch.io import native\n"
            "assert native._LIB is None and not native._TRIED\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'incubator_mxnet_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')" % (INPUT_PIPELINE_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# the sparse slice's modules: importing them loads neither JAX nor the JAX
# package
SPARSE_MODULES = (
    "ndarray.sparse", "contrib.sparse_jit", "models.wide_deep", "rnn",
    "gluon.contrib.nn", "context")


def test_sparse_modules_load_no_jax(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    code = ("import importlib, sys\n"
            "for n in %r:\n"
            "    importlib.import_module('incubator_mxnet_tpu_torch.' + n)\n"
            "import incubator_mxnet_tpu_torch as mx\n"
            "mx.nd.sparse.RowSparseNDArray, mx.nd.sparse.CSRNDArray\n"
            "mx.nd.sparse.sparse_adam_update, mx.models.WideDeep\n"
            "mx.models.csr_to_fields, mx.rnn.BucketSentenceIter\n"
            "mx.contrib.sparse_jit.BucketedSparseTrainer\n"
            "mx.gluon.contrib.nn.SparseEmbedding, mx.rnn.LSTMCell\n"
            "assert mx.ops.registry.get('Embedding').sparse_invoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'incubator_mxnet_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')" % (SPARSE_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# the data-parallel slice's modules: importing them loads neither JAX nor
# the JAX package, and their entry points default to the card
PARALLEL_MODULES = (
    "base", "context", "kvstore", "kvstore.kvstore", "parallel",
    "parallel.collectives", "parallel.mesh", "parallel.functional",
    "parallel.zero", "parallel.dispatch", "parallel.trainer",
    "tools", "tools.launch", "gluon.parameter", "gluon.trainer",
    "gluon.utils", "io.device_feed", "ops.nn", "gluon.contrib.nn")


def test_parallel_modules_load_no_jax(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    code = ("import importlib, sys\n"
            "for n in %r:\n"
            "    importlib.import_module('incubator_mxnet_tpu_torch.' + n)\n"
            "import torch\n"
            "import incubator_mxnet_tpu_torch as mx\n"
            "mx.kv.create, mx.kvstore.DistKVStore, mx.base.ensure_distributed\n"
            "mx.parallel.ShardedTrainer, mx.parallel.make_mesh\n"
            "mx.parallel.BucketPlan, mx.parallel.DispatchPool\n"
            "def in_group():\n"
            "    import tempfile, torch.distributed as dist\n"
            "    with mx.cpu():\n"
            "        net = mx.gluon.nn.Dense(2, in_units=3)\n"
            "        net.initialize()\n"
            "    f = tempfile.mkdtemp() + '/store'\n"
            "    dist.init_process_group('gloo', init_method='file://' + f,\n"
            "                            world_size=1, rank=0)\n"
            "    try:\n"
            "        mx.parallel.ShardedTrainer(net)\n"
            "    finally:\n"
            "        dist.destroy_process_group()\n"
            "if not torch.cuda.is_available():\n"
            "    for fn in (mx.parallel.make_mesh,\n"
            "               lambda: mx.gluon.Parameter('w', shape=(2,))\n"
            "               .initialize(), in_group):\n"
            "        try:\n"
            "            fn()\n"
            "        except mx.MXNetError:\n"
            "            pass\n"
            "        else:\n"
            "            raise AssertionError('ran without a card')\n"
            "for name in ('ResilientTrainer', 'ElasticTrainer',\n"
            "             'pipeline_apply', 'moe_ffn', 'ring_attention',\n"
            "             'ulysses_attention'):\n"
            "    try:\n"
            "        getattr(mx.parallel, name)()\n"
            "    except NotImplementedError as e:\n"
            "        assert 'slice 23' in str(e), e\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'incubator_mxnet_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')" % (PARALLEL_MODULES,))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

