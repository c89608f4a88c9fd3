"""PyTorch port: pipeline parallelism (`pipeline_apply`,
`split_microbatches`, `stack_stage_params`) and expert parallelism
(`switch_route`, `moe_apply`, `moe_ffn`) against the JAX package: every
case of tests/python/unittest/test_pipeline_moe.py, each held against
the JAX function itself under `jax.shard_map` on the 8-device virtual
CPU mesh, the port on CPU replicas `cpu(0..N-1)`.

`moe_ffn` draws its parameters from `numpy.random.RandomState`, so both
packages' experts start from the same weights without copying.
Tolerances: outputs within 2e-5 of scale, gradients within 1e-4 of
scale; `switch_route` exactly.  Run as a script (`python
tests/test_torch_pipeline_moe.py worker OUT`) the file is one rank of
the process-group test, started by the port's launcher.
"""
import functools
import os
import signal
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.parallel import P

pytestmark = pytest.mark.torch_port

ALARM_S = 120
TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _alarm():
    def on_alarm(signum, frame):
        raise TimeoutError("test exceeded %d s" % ALARM_S)
    prev = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(ALARM_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(scope="module")
def jx():
    import jax
    from jax.sharding import Mesh, PartitionSpec
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from incubator_mxnet_tpu import parallel as jpar
    return dict(jax=jax, jnp=jax.numpy, Mesh=Mesh, P=PartitionSpec,
                shard_map=shard_map, par=jpar)


def _jmesh(jx, n, name):
    return jx["Mesh"](np.array(jx["jax"].devices()[:n]).reshape(n), (name,))


def _tmesh(n, name):
    return tpar.make_mesh(devices=[tmx.cpu(i) for i in range(n)],
                          axis_names=(name,))


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


# -- pipeline ----------------------------------------------------------------

def _stages(n, d, seed=0):
    rs = np.random.RandomState(seed)
    return [{"w": (rs.randn(d, d) / np.sqrt(d)).astype(np.float32),
             "b": (rs.randn(d) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _jstage(jnp):
    return lambda p, x: jnp.tanh(x @ p["w"] + p["b"])


def _tstage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pipelines(jx, n_stages, d):
    jpipe = jx["shard_map"](
        functools.partial(jx["par"].pipeline_apply, _jstage(jx["jnp"]),
                          axis_name="pipe"),
        mesh=_jmesh(jx, n_stages, "pipe"),
        in_specs=(jx["P"]("pipe"), jx["P"]()), out_specs=jx["P"]())
    tpipe = tpar.shard_map(
        functools.partial(tpar.pipeline_apply, _tstage, axis_name="pipe"),
        _tmesh(n_stages, "pipe"), in_specs=(P("pipe"), P()),
        out_specs=P())
    return jpipe, tpipe


@pytest.mark.parametrize("n_stages,n_mb", [(4, 8), (8, 4)])
def test_pipeline_matches_jax_and_sequential(jx, n_stages, n_mb):
    d, mb = 16, 4
    stages = _stages(n_stages, d)
    x = np.random.RandomState(1).randn(n_mb * mb, d).astype(np.float32)
    jpipe, tpipe = _pipelines(jx, n_stages, d)
    jst = jx["par"].stack_stage_params(
        [{k: jx["jnp"].asarray(v) for k, v in s.items()} for s in stages])
    want = np.asarray(jx["jax"].jit(jpipe)(
        jst, jx["par"].split_microbatches(jx["jnp"].asarray(x), n_mb)))
    tst = tpar.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    x_mb = tpar.split_microbatches(torch.from_numpy(x), n_mb)
    assert tuple(x_mb.shape) == (n_mb, mb, d)
    got = tpipe(tst, x_mb)
    assert _err(got.numpy(), want) <= TOL
    seq = torch.from_numpy(x)
    for s in stages:
        seq = _tstage({k: torch.from_numpy(v) for k, v in s.items()}, seq)
    assert _err(got.reshape(n_mb * mb, d).numpy(), seq.numpy()) <= TOL


def test_pipeline_gradients_match_jax(jx):
    n_stages, n_mb, d, mb = 4, 4, 8, 2
    stages = _stages(n_stages, d, seed=3)
    x = np.random.RandomState(4).randn(n_mb * mb, d).astype(np.float32)
    jpipe, tpipe = _pipelines(jx, n_stages, d)
    jst = jx["par"].stack_stage_params(
        [{k: jx["jnp"].asarray(v) for k, v in s.items()} for s in stages])
    jx_mb = jx["par"].split_microbatches(jx["jnp"].asarray(x), n_mb)
    want = jx["jax"].jit(jx["jax"].grad(
        lambda p: (jpipe(p, jx_mb) ** 2).sum()))(jst)
    tst = {k: v.requires_grad_() for k, v in tpar.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()}
         for s in stages]).items()}
    (tpipe(tst, tpar.split_microbatches(torch.from_numpy(x), n_mb)) ** 2) \
        .sum().backward()
    for k in want:
        assert _err(tst[k].grad.numpy(), np.asarray(want[k])) <= GRAD_TOL, k


def test_pipeline_shape_guard():
    stacked = tpar.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()}
         for s in _stages(4, 8)])
    calls = []

    def bad_stage(p, x):
        calls.append(x.device.type)
        return torch.cat([x, x], dim=-1)
    piped = tpar.shard_map(
        functools.partial(tpar.pipeline_apply, bad_stage, axis_name="pipe"),
        _tmesh(4, "pipe"), in_specs=(P("pipe"), P()), out_specs=P())
    with pytest.raises(ValueError, match="preserve activation shape"):
        piped(stacked, torch.zeros(4, 2, 8))
    assert set(calls) == {"meta"}        # raised before any step ran
    with pytest.raises(ValueError, match="not divisible"):
        tpar.split_microbatches(torch.zeros(6, 2), 4)


# -- moe ---------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [1, 2, 5])
def test_switch_route_exactly_as_jax(jx, capacity):
    logits = np.random.RandomState(5).randn(12, 4).astype(np.float32)
    want = jx["par"].switch_route(jx["jnp"].asarray(logits), capacity)
    got = tpar.switch_route(torch.from_numpy(logits), capacity)
    d, c = got[0].numpy(), got[1].numpy()
    assert np.array_equal(d, np.asarray(want[0]))
    np.testing.assert_allclose(c, np.asarray(want[1]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    assert d.shape == (12, 4, capacity)
    assert (d.sum(axis=0) <= 1.0).all()
    assert (d.reshape(12, -1).sum(axis=1) <= 1.0).all()
    assert (d.sum(axis=(0, 2)) <= capacity).all()


def _moe(jx, n, cf, x, router_w, key, d_hidden, E, axis="expert"):
    """The JAX and the port's (y, aux) and the port's parameters."""
    jp, jfn = jx["par"].moe_ffn(x.shape[1], d_hidden, E, key=key)
    tp, tfn = tpar.moe_ffn(x.shape[1], d_hidden, E, key=key, device="cpu")
    assert all(np.array_equal(np.asarray(jp[k]), tp[k].numpy()) for k in jp)
    jf = jx["shard_map"](
        lambda xs, rw, ps: jx["par"].moe_apply(xs, rw, jfn, ps,
                                               axis_name=axis,
                                               capacity_factor=cf),
        mesh=_jmesh(jx, n, axis),
        in_specs=(jx["P"](axis), jx["P"](), jx["P"](axis)),
        out_specs=(jx["P"](axis), jx["P"]()))
    tf = tpar.shard_map(
        lambda xs, rw, ps: tpar.moe_apply(xs, rw, tfn, ps, axis_name=axis,
                                          capacity_factor=cf),
        _tmesh(n, axis), in_specs=(P(axis), P(), P(axis)),
        out_specs=(P(axis), P()))
    return jf, jp, jfn, tf, tp, tfn


@pytest.mark.parametrize("n", [8, 4])
def test_moe_matches_jax_and_dense_when_capacity_ample(jx, n):
    """Capacity >= tokens: the expert-parallel layer equals each token
    through its argmax expert, gate-weighted (4 replicas: two experts a
    replica, one batched product)."""
    E, T, d = 8, 16, 12
    rs = np.random.RandomState(6)
    x = rs.randn(T, d).astype(np.float32)
    rw = (rs.randn(d, E) * 0.5).astype(np.float32)
    jf, jp, jfn, tf, tp, tfn = _moe(jx, n, float(E), x, rw, None, 24, E)
    jy, jaux = jx["jax"].jit(jf)(x, rw, jp)
    y, aux = tf(torch.from_numpy(x), torch.from_numpy(rw), tp)
    assert _err(y.numpy(), np.asarray(jy)) <= TOL
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    probs = torch.softmax(torch.from_numpy(x @ rw), dim=-1)
    e = probs.argmax(-1)
    dense = torch.stack([
        tfn({k: v[e[t]] for k, v in tp.items()}, torch.from_numpy(x[t]))
        * probs[t, e[t]] for t in range(T)])
    assert _err(y.numpy(), dense.numpy()) <= TOL


def test_moe_drops_overflow_tokens_as_jax(jx):
    E, T, d = 8, 32, 8
    rs = np.random.RandomState(8)
    x = rs.randn(T, d).astype(np.float32)
    rw = np.zeros((d, E), np.float32)
    rw[:, 0] = rs.rand(d).astype(np.float32) + 1.0
    jf, jp, _, tf, tp, _ = _moe(jx, 8, 0.25, x, rw, 7, 16, E)
    jy, _ = jx["jax"].jit(jf)(x, rw, jp)
    y, _ = tf(torch.from_numpy(x), torch.from_numpy(rw), tp)
    zero = (y.abs().sum(dim=1) == 0).numpy()
    assert np.array_equal(zero, np.abs(np.asarray(jy)).sum(axis=1) == 0)
    assert 0 < zero.sum() < T
    assert _err(y.numpy(), np.asarray(jy)) <= TOL


@pytest.mark.parametrize("n", [8, 4])
def test_moe_gradients_match_jax(jx, n):
    E, T, d = 8, 16, 8
    rs = np.random.RandomState(10)
    x = rs.randn(T, d).astype(np.float32)
    rw = (rs.randn(d, E) * 0.5).astype(np.float32)
    jf, jp, _, tf, tp, _ = _moe(jx, n, 4.0, x, rw, 9, 16, E)

    def jloss(ps, w):
        y, aux = jf(x, w, ps)
        return (y ** 2).sum() + 0.01 * aux
    gp, gr = jx["jax"].jit(jx["jax"].grad(jloss, argnums=(0, 1)))(jp, rw)
    tps = {k: v.clone().requires_grad_() for k, v in tp.items()}
    trw = torch.from_numpy(rw).requires_grad_()
    y, aux = tf(torch.from_numpy(x), trw, tps)
    ((y ** 2).sum() + 0.01 * aux).backward()
    for k in gp:
        assert _err(tps[k].grad.numpy(), np.asarray(gp[k])) <= GRAD_TOL, k
    assert _err(trw.grad.numpy(), np.asarray(gr)) <= GRAD_TOL
    assert float(trw.grad.abs().sum()) > 0


# -- the process-group form ----------------------------------------------------

def _worker(out):
    """One rank of a 4-rank gloo group: ring attention, a pipeline and
    an all_to_all MoE over `process_mesh()`, forward and gradients."""
    signal.alarm(ALARM_S)
    assert tmx.base.ensure_distributed(backend="gloo")
    import torch.distributed as dist
    rank, n = dist.get_rank(), dist.get_world_size()
    res = _process_cases(tpar.process_mesh(("x",), device="cpu"), n)
    grads = {k: v for k, v in res.items() if k.startswith("grad")}
    # each rank holds its own slice of an input's gradient
    parts = {}
    for k, g in grads.items():
        got = [torch.empty_like(g) for _ in range(n)]
        dist.all_gather(got, g.contiguous())
        parts[k] = got
    if rank == 0:
        torch.save({"res": res, "parts": parts}, out)
    dist.barrier()
    dist.destroy_process_group()


def _process_cases(mesh, n):
    """What both forms compute: outputs, and per input the gradient of
    a weighted sum of them (on a process mesh, this rank's slice)."""
    rs = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rs.randn(1, 4 * n, 2, 4).astype(np.float32))
               .requires_grad_() for _ in range(3))
    spec = P(None, "x")
    ring = tpar.shard_map(functools.partial(tpar.ring_attention,
                                            axis_name="x", causal=True),
                          mesh, in_specs=(spec,) * 3, out_specs=spec)(q, k, v)
    stages = tpar.stack_stage_params(
        [{kk: torch.from_numpy(vv) for kk, vv in s.items()}
         for s in _stages(n, 6, seed=13)])
    w = stages["w"].requires_grad_()
    xin = torch.from_numpy(rs.randn(8, 6).astype(np.float32))
    pipe = tpar.shard_map(functools.partial(tpar.pipeline_apply, _tstage,
                                            axis_name="x"),
                          mesh, in_specs=(P("x"), P()), out_specs=P())(
        {"w": w, "b": stages["b"]}, tpar.split_microbatches(xin, 4))
    tp, tfn = tpar.moe_ffn(6, 8, 2 * n, key=3, device="cpu")
    xm = torch.from_numpy(rs.randn(4 * n, 6).astype(np.float32)) \
        .requires_grad_()
    rw = torch.from_numpy(rs.randn(6, 2 * n).astype(np.float32))
    y, aux = tpar.shard_map(
        lambda a, b, c: tpar.moe_apply(a, b, tfn, c, axis_name="x",
                                       capacity_factor=4.0),
        mesh, in_specs=(P("x"), P(), P("x")), out_specs=(P("x"), P()))(
        xm, rw, tp)
    loss = (ring ** 2).sum() + (pipe ** 2).sum() + (y ** 2).sum() + aux
    loss.backward()
    return dict(ring=ring.detach(), pipe=pipe.detach(), moe=y.detach(),
                aux=aux.detach(), grad_q=q.grad, grad_k=k.grad,
                grad_v=v.grad, grad_w=w.grad, grad_x=xm.grad)


def test_process_group_form_matches_in_process(tmp_path):
    from incubator_mxnet_tpu_torch.tools import launch
    n = 4
    out = str(tmp_path / "rank0.pt")
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    env = {"PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                           ""),
           "OMP_NUM_THREADS": "1"}
    with open(str(tmp_path / "log"), "w") as log:
        rc = launch.launch(n, [sys.executable, here, "worker", out], env=env,
                           timeout=100, out=log)
    assert rc == 0, open(str(tmp_path / "log")).read()[-3000:]
    got = torch.load(out, weights_only=True)
    want = _process_cases(_tmesh(n, "x"), n)
    for k in ("ring", "pipe", "moe", "aux"):
        assert _err(got["res"][k].numpy(), want[k].numpy()) <= TOL, k
    # the input slices each rank's gradient holds, reassembled
    for k, dim in (("grad_q", 1), ("grad_k", 1), ("grad_v", 1),
                   ("grad_w", 0), ("grad_x", 0)):
        span = want[k].shape[dim] // n
        full = torch.cat([p.narrow(dim, r * span, span)
                          for r, p in enumerate(got["parts"][k])], dim)
        assert _err(full.numpy(), want[k].numpy()) <= GRAD_TOL, k


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2])
