"""PyTorch port: tensor parallelism in `ShardedTrainer` (a `param_spec_fn`
that shards over a "model" mesh axis; parallel/tensor_parallel.py)
against the JAX package's `ShardedTrainer` with the same spec function
on its 8-device virtual CPU mesh, where XLA's partitioner computes the
same global step.

Nets: `bert_small` (2 layers, units 64, 4 heads, vocab 64, 16 tokens)
with query/key/value/ffn1 column parallel and proj/ffn2 row parallel,
and a 2-layer MLP whose first Dense is column and second row parallel.
The port takes the JAX net's initial weights
(`weights.load_reference_params`).  The spec function is keyed by the
MXNet parameter name ("dense0_weight"), as both trainers call it, and
built from each name's structural role, which both packages name alike.

Tolerances, of each tensor's scale (its largest value): losses and
parameters after 3 Adam steps within 1e-5 of the JAX run and of the
port's replicated run.  Adam's first steps move an element by about lr
times the sign of its gradient, so an element whose gradient is
rounding noise in some step (below 1e-6 of that step's largest
gradient: attn.key.bias's is exactly 0 in exact arithmetic, softmax
ignoring a shift of a row's scores) is held only to the 2 * steps * lr
its steps can span.  Replicated gradients equal on the model replicas
within 1e-6 of scale; the process-group form within 1e-6 of scale of
the in-process one.  Torch runs on one thread.

Run as a script (`python tests/test_torch_tensor_parallel.py worker
OUT`) the file is one rank of the 4-rank gloo test, started by the
port's launcher.
"""
import collections
import gc
import os
import signal
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.gluon.block import nameless_scope
from incubator_mxnet_tpu_torch.parallel import P
from incubator_mxnet_tpu_torch.parallel import tensor_parallel as ttp

pytestmark = pytest.mark.torch_port

ALARM_S = 120
TOL = 1e-5
SELF_TOL = 1e-6
LR = 1e-4
STEPS = 3
V, T = 64, 16
COLUMN = ("query", "key", "value", "ffn1", "mlp.0")
ROW = ("proj", "ffn2", "mlp.1")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)

    def on_alarm(signum, frame):
        raise TimeoutError("test exceeded %d s" % ALARM_S)
    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(ALARM_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    torch.set_num_threads(prev)


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _cpus(n):
    return [tmx.cpu(i) for i in range(n)]


def spec_fn(roles, tp=True):
    """The spec function over MXNet names: column parallel for
    query/key/value/ffn1 (and the MLP's first Dense), row parallel for
    proj/ffn2 (its second), by each name's structural role `roles[name]`;
    everything else replicated."""
    def fn(name, shape):
        role = roles[name]
        if tp and len(shape) == 2 and role.endswith(".weight"):
            if any(t in role for t in COLUMN):
                return P("model", None)
            if any(t in role for t in ROW):
                return P(None, "model")
        return P()
    return fn


def mlm_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def _port_bert(**kw):
    with nameless_scope():
        net = tmx.models.bert_small(vocab_size=V, max_length=T, dropout=0.0,
                                    device="cpu", **kw)
    return net


class _MLP(tmx.gluon.HybridBlock):
    def __init__(self, hidden=16):
        super().__init__()
        nn = tmx.gluon.nn
        self.mlp = nn.HybridSequential()
        self.mlp.add(nn.Dense(hidden, activation="relu", in_units=6,
                              device="cpu"),
                     nn.Dense(4, in_units=hidden, device="cpu"))

    def forward(self, x):
        return self.mlp(x)


def _port_mlp(hidden=16):
    with nameless_scope():
        return _MLP(hidden)


def _data(model, rows, steps=STEPS, seed=0):
    rs = np.random.RandomState(seed)
    if model == "bert":
        return ([rs.randint(0, V, (rows, T)).astype(np.int32)
                 for _ in range(steps)],
                [rs.randint(0, V, (rows, T)).astype(np.int32)
                 for _ in range(steps)])
    return ([rs.randn(rows, 6).astype(np.float32) for _ in range(steps)],
            [rs.randint(0, 4, rows).astype(np.int32) for _ in range(steps)])


def _roles(net):
    """{MXNet name: structural name} of the port net's parameters."""
    return {p.name: n for n, p in net.collect_params().items()}


def _port_trainer(net, shape, zero=0, tp=True, **kw):
    mesh = tpar.make_mesh(shape, ("data", "model"),
                          devices=_cpus(int(np.prod(shape))))
    loss = mlm_loss if isinstance(net, tmx.models.BERTModel) else \
        tpar.softmax_ce_loss
    return tpar.ShardedTrainer(net, loss_fn=loss, optimizer="adam", lr=LR,
                               mesh=mesh, zero=zero,
                               param_spec_fn=spec_fn(_roles(net), tp), **kw)


def _run(t, xs, ys):
    return [float(t.step(x, y)) for x, y in zip(xs, ys)]


# -- the JAX references, each computed once -------------------------------

_JAX = {}
_START = {}


def _jax_net(model):
    """The JAX net under fresh block names, and its weights by
    structural name."""
    from incubator_mxnet_tpu import gluon, nd
    from incubator_mxnet_tpu.gluon.block import nameless_scope as jscope
    from incubator_mxnet_tpu.models.transformer import bert_small
    with jscope():
        if model == "bert":
            net = bert_small(vocab_size=V, max_length=T, dropout=0.0)
            net.initialize()
            net(nd.array(np.zeros((2, T), np.int64), dtype="int32"))
        else:
            net = _jax_mlp(gluon)
    return net


def _jax_mlp(gluon):
    class MLP(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.mlp = gluon.nn.HybridSequential()
            self.mlp.add(gluon.nn.Dense(16, activation="relu", in_units=6),
                         gluon.nn.Dense(4, in_units=16))

        def forward(self, x):
            return self.mlp(x)
    net = MLP()
    net.initialize()
    return net


def _jax_run(model, shape, zero):
    """(start weights by structural name, losses, params by structural
    name, the specs the JAX trainer placed) of the JAX TP run.  With one
    data replica the JAX trainer's zero 1 places every state leaf as at
    zero 0 (`_zero_spec` returns the parameter's spec when the data axis
    has size 1), so that run is zero 0's."""
    if shape[0] == 1:
        zero = 0
    key = (model, shape, zero)
    if key in _JAX:
        return _JAX[key]
    import jax
    from incubator_mxnet_tpu import parallel as jpar
    from incubator_mxnet_tpu import nd
    net = _jax_net(model)
    jp = net._collect_params_with_prefix()
    if model in _START:
        # every run of a model starts from the first one's weights
        for k, p in jp.items():
            p.set_data(nd.array(_START[model][k]))
    start = _START.setdefault(model, {k: np.asarray(p.data().asnumpy())
                                      for k, p in jp.items()})
    roles = {p.name: k for k, p in jp.items()}
    fn = spec_fn(roles)

    def jax_spec(name, shape_):
        return jax.sharding.PartitionSpec(*fn(name, shape_))

    def jax_mlm(logits, labels):
        import jax.numpy as jnp
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        ll = jnp.take_along_axis(logp, labels[..., None].astype(jnp.int32),
                                 axis=-1)
        return -jnp.mean(ll)
    mesh = jpar.make_mesh(shape, ("data", "model"),
                          devices=jax.devices()[:int(np.prod(shape))])
    kw = dict(loss_fn=jax_mlm) if model == "bert" else {}
    t = jpar.ShardedTrainer(net, optimizer="adam", lr=LR, mesh=mesh,
                            zero=zero, param_spec_fn=jax_spec, **kw)
    xs, ys = _data(model, 4)
    losses = [float(t.step(x, y)) for x, y in zip(xs, ys)]
    params = {k: np.asarray(t.params[p.name]) for k, p in jp.items()}
    specs = {k: tuple(t.params[p.name].sharding.spec)
             for k, p in jp.items()}
    _JAX[key] = (start, losses, params, specs)
    return _JAX[key]


def _twin(model, start):
    net = _port_bert() if model == "bert" else _port_mlp()
    with tmx.cpu():
        net.initialize()
    tmx.weights.load_reference_params(net, start)
    return net


def _grads(net, params, x, y):
    """{name: gradient} of the full-batch loss at `params` (host f32)."""
    pure = tpar.functionalize(net, training=True)
    leaves = {n: v.detach().clone().requires_grad_(True)
              for n, v in params.items()}
    loss_fn = mlm_loss if isinstance(net, tmx.models.BERTModel) else \
        tpar.softmax_ce_loss
    out, _ = pure(leaves, torch.as_tensor(x))
    gs = torch.autograd.grad(loss_fn(out, torch.as_tensor(y)),
                             list(leaves.values()), allow_unused=True)
    return {n: (np.zeros(tuple(v.shape), np.float32) if g is None
                else g.numpy()) for (n, v), g in zip(leaves.items(), gs)}


_REF = {}


def _replicated(model):
    """(losses, params, the gradients of each step) of the port's
    replicated one-replica run from the JAX net's start on `_data`; the
    gradients tell which elements' gradients are rounding noise."""
    if model not in _REF:
        start = _jax_run(model, (2, 2), 0)[0]
        net = _twin(model, start)
        t = _port_trainer(net, (1, 1), tp=False)
        losses, grads = [], []
        for x, y in zip(*_data(model, 4)):
            grads.append(_grads(net, t.params, x, y))
            losses.append(float(t.step(x, y)))
        _REF[model] = (losses, {k: v.numpy() for k, v in t.params.items()},
                       grads)
    return _REF[model]


def _assert_adam_close(after, ref, ref_grads, tol=TOL):
    """`after` against `ref` ({name: array}) after len(ref_grads) Adam
    steps (module doc's rule), `tol` of scale."""
    for n, r in ref.items():
        tiny = np.zeros(r.shape, bool)
        for g in ref_grads:
            big = max(np.abs(v).max() for v in g.values())
            tiny |= np.abs(g[n]) <= 1e-6 * big
        err = np.abs(np.asarray(after[n], np.float64) - r)
        scale = max(np.abs(r).max(), 1e-6)
        assert (err[~tiny] <= tol * scale).all(), (n, err[~tiny].max()
                                                  / scale)
        assert (err[tiny] <= 2 * len(ref_grads) * LR).all(), n


# -- F6: the names param_spec_fn is called with ----------------------------

def test_spec_fn_names_match_jax():
    """One spec function keyed by the MXNet name shards the same
    parameters with the same specs in both packages (the port called it
    with its structural names, F6)."""
    jnet = _jax_net("bert")
    jroles = {p.name: k for k, p in
              jnet._collect_params_with_prefix().items()}
    net = _port_bert()
    roles = _roles(net)
    assert roles == jroles
    seen = []

    def fn(name, shape):
        seen.append(name)
        return spec_fn(roles)(name, shape)
    with tmx.cpu():
        net.initialize()
    t = tpar.ShardedTrainer(net, loss_fn=mlm_loss, param_spec_fn=fn,
                            mesh=tpar.make_mesh((2, 2), ("data", "model"),
                                                devices=_cpus(4)))
    assert sorted(seen) == sorted(roles)
    _, _, _, jspecs = _jax_run("bert", (2, 2), 0)
    want = {k: [d for d, a in enumerate(s) if a == "model"]
            for k, s in jspecs.items()}
    want = {k: d[0] for k, d in want.items() if d}
    assert t._tp_dim == want
    assert len(want) == 12


# -- tensor parallel training against the JAX package ----------------------

@pytest.mark.parametrize("model,shape,zero", [
    ("bert", (2, 2), 0), ("bert", (2, 2), 1), ("bert", (1, 2), 0),
    ("bert", (1, 2), 1), ("mlp", (2, 2), 0), ("mlp", (2, 2), 1),
    ("mlp", (1, 2), 0), ("mlp", (1, 2), 1)])
def test_tp_matches_jax(model, shape, zero):
    """The port's TP trajectory on cpu(i) replicas against the JAX TP
    run on the same mesh and ZeRO level, and against its own replicated
    run; each replica stores 1/tp of every sharded parameter."""
    start, jlosses, jparams, _ = _jax_run(model, shape, zero)
    xs, ys = _data(model, 4)
    t = _port_trainer(_twin(model, start), shape, zero)
    assert t._tp == 2
    assert t.data_parallel_size == shape[0]
    losses = _run(t, xs, ys)
    ref_losses, ref_params, ref_grads = _replicated(model)
    assert _err(losses, jlosses) <= TOL
    assert _err(losses, ref_losses) <= TOL
    got = {k: v.numpy() for k, v in t.params.items()}
    _assert_adam_close(got, jparams, ref_grads)
    _assert_adam_close(got, ref_params, ref_grads)
    full = ref_params
    for r, params in enumerate(t._rparams):
        for k, v in params.items():
            shp = list(full[k].shape)
            if k in t._tp_dim:
                shp[t._tp_dim[k]] //= 2
            assert list(v.shape) == shp, (r, k)
    sharded = sum(full[k].size * 4 for k in t._tp_dim)
    whole = sum(v.size * 4 for v in full.values())
    assert t.replica_param_bytes() == [whole - sharded // 2] * \
        (2 * shape[0])


def test_replicated_gradients_equal_on_model_replicas():
    """The gradients of replicated parameters (and the loss) are the same
    on both model replicas of a data coordinate; the sharded ones differ
    (each its own shard)."""
    start, _, _, _ = _jax_run("bert", (2, 2), 0)
    xs, ys = _data("bert", 4)
    t = _port_trainer(_twin("bert", start), (2, 2))
    res = t._forward_backward(t._split(xs[0]), t._split(ys[0]), t._rparams)
    assert t._didx == [0, 0, 1, 1] and t._midx == [0, 1, 0, 1]
    for a, b in ((0, 1), (2, 3)):
        assert _err(res[a][0], res[b][0]) <= SELF_TOL
        for k, g in res[a][1].items():
            if k not in t._tp_dim:
                assert _err(res[b][1][k].numpy(), g.numpy()) <= SELF_TOL, k
    assert events_have_tp()


def events_have_tp():
    from incubator_mxnet_tpu_torch.monitor import events
    return all(events.get(k) > 0 for k in
               ("tp.column", "tp.row", "tp.heads_local"))


def test_plan_roles_and_gathered_parameters():
    """The plan: attention on local heads, FFNs kept sharded, a Dense
    with no partner gathers its output, any other sharded parameter
    (the word embedding split on the vocab) is gathered at its use; the
    step still equals the replicated one."""
    from incubator_mxnet_tpu_torch.monitor import events
    start, _, _, _ = _jax_run("bert", (2, 2), 0)
    net = _twin("bert", start)
    roles = _roles(net)
    base = spec_fn(roles)

    def fn(name, shape):
        role = roles[name]
        if role in ("word_embed.weight", "mlm_dense.weight"):
            return P("model", None)
        return base(name, shape)
    mesh = tpar.make_mesh((1, 2), ("data", "model"), devices=_cpus(2))
    t = tpar.ShardedTrainer(net, loss_fn=mlm_loss, optimizer="adam", lr=LR,
                            mesh=mesh, param_spec_fn=fn)
    counts = dict(collections.Counter(t._tpplan.roles.values()))
    assert counts == {"heads": 2, "ffn": 2, "column_in": 8, "row_in": 4,
                      "column_gather": 1}, counts
    assert t._tpplan.gathered == {"word_embed.weight"}
    xs, ys = _data("bert", 4)
    before = events.get("tp.gathered")
    losses = _run(t, xs, ys)
    # per step and replica: the embedding and mlm_dense's output
    assert events.get("tp.gathered") - before == 2 * 2 * STEPS
    ref_losses, ref_params, ref_grads = _replicated("bert")
    assert _err(losses, ref_losses) <= TOL
    _assert_adam_close({k: v.numpy() for k, v in t.params.items()},
                       ref_params, ref_grads)


# -- refusals ---------------------------------------------------------------

def test_refusals():
    # heads that do not split over the model axis (units 48, 4 heads, tp 3)
    net = _port_bert(units=48, hidden_size=96)
    with tmx.cpu():
        net.initialize()
    with pytest.raises(ValueError, match="4 heads do not split over 3"):
        _port_trainer(net, (1, 3))
    # an indivisible sharded dimension names the parameter
    mlp = _port_mlp(hidden=15)
    with tmx.cpu():
        mlp.initialize()
    mlp(torch.zeros(1, 6))
    with pytest.raises(ValueError, match="dense0_weight .*size 15"):
        _port_trainer(mlp, (1, 2))
    # zero 2/3 with a spec
    for zero in (2, 3):
        with pytest.raises(ValueError, match="1-d"):
            _port_trainer(_port_mlp(), (1, 2), zero=zero)
    # dropout in a tensor-parallel step
    drop = _port_bert()
    drop.dropout = tmx.gluon.nn.Dropout(0.1)
    with tmx.cpu():
        drop.initialize()
    t = _port_trainer(drop, (1, 2))
    xs, ys = _data("bert", 2)
    with pytest.raises(NotImplementedError, match="Dropout"):
        t.step(xs[0], ys[0])


# -- checkpoints at global shapes ------------------------------------------

def test_checkpoint_moves_between_tp_and_data_meshes(tmp_path):
    start, _, _, _ = _jax_run("bert", (2, 2), 0)
    xs, ys = _data("bert", 4)
    tp = _port_trainer(_twin("bert", start), (2, 2), zero=1)
    _run(tp, xs[:2], ys[:2])
    tp.save_checkpoint(str(tmp_path / "tp"))
    dp = _port_trainer(_twin("bert", start), (4, 1), zero=1, tp=False)
    dp.load_checkpoint(str(tmp_path / "tp"))
    for k, v in tp.params.items():
        assert torch.equal(dp.params[k], v), k
    a, b = _run(tp, xs[2:], ys[2:]), _run(dp, xs[2:], ys[2:])
    assert _err(a, b) <= TOL
    dp.save_checkpoint(str(tmp_path / "dp"))
    back = _port_trainer(_twin("bert", start), (2, 2), zero=0)
    back.load_checkpoint(str(tmp_path / "dp"))
    for k, v in dp.params.items():
        assert torch.equal(back.params[k], v), k
    assert back._n_step == 3
    assert back.replica_param_bytes() == tp.replica_param_bytes()


# -- the planted faults must fail -------------------------------------------

@pytest.mark.parametrize("fault", ["row_without_psum", "heads_not_local"])
def test_planted_faults_fail_the_check(monkeypatch, fault):
    """The row-parallel output without its psum, and attention run on all
    num_heads heads of a smaller dim, each move the step off the
    replicated one by far more than TOL."""
    start, _, _, _ = _jax_run("bert", (2, 2), 0)
    xs, ys = _data("bert", 4)
    ref_losses, ref_params, _ = _replicated("bert")
    if fault == "row_without_psum":
        monkeypatch.setattr(ttp, "reduce_from", lambda x: x)
    else:
        monkeypatch.setattr(ttp, "local_heads", lambda block, h: h)
    t = _port_trainer(_twin("bert", start), (1, 2))
    losses = _run(t, xs, ys)
    worst = max(_err(v.numpy(), ref_params[k])
                for k, v in t.params.items())
    assert _err(losses, ref_losses) > 100 * TOL or worst > 100 * TOL


# -- the process-group form --------------------------------------------------

def _worker(out):
    """One rank of a 4-rank gloo group on a (2, 2) process mesh: the TP
    step of `test_process_group_matches_in_process` over its data
    coordinate's rows; rank 0 writes the losses and parameters."""
    signal.signal(signal.SIGALRM, lambda *a: os._exit(3))
    signal.alarm(ALARM_S)
    torch.set_num_threads(1)
    assert tmx.base.ensure_distributed(backend="gloo")
    import torch.distributed as dist
    rank = dist.get_rank()
    mesh = tpar.process_mesh(("data", "model"), device="cpu", shape=(2, 2))
    start = torch.load(out + ".start", weights_only=True)
    net = _twin("bert", {k: v.numpy() for k, v in start.items()})
    t = tpar.ShardedTrainer(net, loss_fn=mlm_loss, optimizer="adam",
                            lr=LR, mesh=mesh, zero=1,
                            param_spec_fn=spec_fn(_roles(net)))
    assert (t.data_parallel_size, t._tp) == (2, 2)
    assert t._didx == [rank // 2] and t._midx == [rank % 2]
    xs, ys = _data("bert", 4)
    rows = slice(2 * (rank // 2), 2 * (rank // 2) + 2)
    losses = [float(t.step(x[rows], y[rows])) for x, y in zip(xs, ys)]
    params = t.params
    counts = (t.eager_steps, t.captures, t.replays)
    if rank == 0:
        torch.save({"losses": losses, "params": params, "counts": counts,
                    "bytes": t.replica_param_bytes()}, out)
    dist.barrier()
    dist.destroy_process_group()


def test_process_group_matches_in_process(tmp_path):
    """4 gloo ranks through the launcher on a (2, 2) process mesh equal
    the in-process (2, 2) run within 1e-6 of scale; on the host the
    group steps eagerly (gloo cannot be captured)."""
    from incubator_mxnet_tpu_torch.tools import launch
    start, _, _, _ = _jax_run("bert", (2, 2), 0)
    out = str(tmp_path / "rank0.pt")
    torch.save({k: torch.from_numpy(v) for k, v in start.items()},
               out + ".start")
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    env = {"PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                           ""),
           "OMP_NUM_THREADS": "1"}
    with open(str(tmp_path / "log"), "w") as log:
        rc = launch.launch(4, [sys.executable, here, "worker", out], env=env,
                           timeout=100, out=log)
    assert rc == 0, open(str(tmp_path / "log")).read()[-3000:]
    got = torch.load(out, weights_only=True)
    t = _port_trainer(_twin("bert", start), (2, 2), zero=1)
    xs, ys = _data("bert", 4)
    assert _err(got["losses"], _run(t, xs, ys)) <= SELF_TOL
    for k, v in t.params.items():
        assert _err(got["params"][k].numpy(), v.numpy()) <= SELF_TOL, k
    assert got["counts"] == (STEPS, 0, 0)
    assert got["bytes"] == t.replica_param_bytes()[:1]


def _cuda_worker(out):
    """One rank of test_torch_cuda.py's two-rank NCCL group: bert_small
    tensor parallel on a (1, 2) process mesh, 4 steps captured a rank
    (eager, capture, replays) and 4 stepping eagerly from the same
    start; rank 0 writes both.  A rank still running after 150 s
    prints every thread's stack and exits."""
    import faulthandler
    faulthandler.dump_traceback_later(150, exit=True)
    assert tmx.base.ensure_distributed()
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = tpar.process_mesh(("data", "model"), shape=(1, 2))
    xs, ys = _data("bert", 4, steps=4)
    res = dict(losses={}, params={})
    start = None
    for mode in ("eager", "captured"):
        with nameless_scope():
            net = tmx.models.bert_small(
                vocab_size=V, max_length=T, dropout=0.0,
                device="cuda:%d" % torch.cuda.current_device())
        if start is None:
            start = {k: v.detach().clone() for k, v in
                     net.state_dict().items()}
        net.load_state_dict(start)
        t = tpar.ShardedTrainer(net, loss_fn=mlm_loss, optimizer="adam",
                                lr=LR, mesh=mesh,
                                param_spec_fn=spec_fn(_roles(net)))
        t._capture = mode == "captured"
        res["losses"][mode] = _run(t, xs, ys)
        res["params"][mode] = {k: v.cpu() for k, v in t.params.items()}
        res[mode + "_ran"] = [t.eager_steps, t.captures, t.replays]
        # a captured graph that holds NCCL work keeps the group from
        # being destroyed
        t.release()
        del t, net
        gc.collect()
        torch.cuda.synchronize()
    if dist.get_rank() == 0:
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2])
if __name__ == "__main__" and sys.argv[1:2] == ["cuda-worker"]:
    _cuda_worker(sys.argv[2])
