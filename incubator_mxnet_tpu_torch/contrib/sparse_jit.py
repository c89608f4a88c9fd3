"""Bucketed row_sparse training of the PyTorch port (counterpart of
incubator_mxnet_tpu/contrib/sparse_jit.py; ref: example/sparse/wide_deep
and src/operator/optimizer_op.cc's lazy_update).

`BucketedSparseTrainer` trains a `models.WideDeep` with the lazy-update
semantics of the row_sparse path (only the embedding rows a batch touches
are read, updated and decayed) with every shape static, so that a whole
step -- the unique rows, the forward, the backward and the updates -- is
one captured program (`graph_capture.capture`, a CUDA graph on the card)
per (bucket, batch, fields) key, the counterpart of the JAX package's one
`jax.jit` per key:

* Both embedding tables carry one sentinel row (row `vocab`).  A bucket
  holds K unique rows: K = B·F by default (always enough, and the step
  never reads a device value on the host), or `bucket_rows`.  The unique
  rows are found on the device with a static size: a stable sort of the
  B·F ids, a first-occurrence flag, its cumulative sum as each id's slot
  (the inverse), and a scatter of the first occurrences into K slots
  filled with the sentinel (`static_unique`, what
  `jnp.unique(size=K, fill_value=sentinel, return_inverse=True)` gives).
  Padded slots gather from and write into the sentinel row, so real rows
  keep exact lazy-update semantics with no mask.
* The forward takes the K gathered rows as its differentiable inputs, so
  the tables' gradient is a (K, dim) segment sum; the vocabulary-sized
  gradient never exists.  The MLP and the output layer run on the state's
  tensors through `torch.func.functional_call` over the net's own blocks.
* Adam folds its bias correction into the lr from the step count t, kept
  on the device (MXNet Adam's update, as the JAX class computes it).
* With `bucket_rows` below B·F, a step whose unique count exceeds the
  bucket is skipped on the device: every state tensor keeps its value
  (`torch.where` over the update), the step returns the previous loss,
  and `overflow_steps` counts it.  No step reads the device on the host.

The first step of a key runs eagerly (it loads every kernel the capture
must not meet), the second captures, and later steps copy their inputs
into the program's static inputs and replay it.  `captures`, `replays`
and `eager_steps` count them.  `sync_to_net()` writes the trained values
back into the block (the sentinel rows dropped).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import graph_capture as _capture
from ..gluon.block import _ProgramScope
from ..ndarray.ndarray import NDArray, _wrap

__all__ = ["BucketedSparseTrainer", "static_unique"]


def static_unique(flat, K, fill):
    """(uniq, inv, n) of the 1-D integer tensor `flat` with a static size:
    `uniq` (K,) its sorted unique values, padded with `fill` (which must be
    above every value) or cut at K; `inv` the slot of each element (clamped
    to K - 1 where the cut dropped its value); `n` the true unique count,
    a 0-dim tensor.  No device value is read on the host."""
    s, perm = torch.sort(flat, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, 0) - 1
    inv = torch.empty_like(rank).scatter_(0, perm, rank)
    slot = torch.where(first & (rank < K), rank, torch.full_like(rank, K))
    buf = torch.full((K + 1,), fill, dtype=s.dtype, device=s.device)
    buf.scatter_(0, slot, s)
    return buf[:K], inv.clamp_(max=K - 1), rank[-1] + 1


def _param_name(net, param):
    for name, p in net.named_parameters():
        if p is param:
            return name
    raise ValueError("parameter not found in the net")


class _BucketStep:
    """The program of one (K, B, F) key, with its static inputs.  It holds
    no reference to its trainer, so that a trainer let go frees its CUDA
    graphs at once, never in a collection of cycles that might run
    during another capture."""

    def __init__(self, K, B, F, device):
        self.K, self.B, self.F = K, B, F
        self.idx = torch.zeros((B, F), dtype=torch.long, device=device)
        self.vals = torch.zeros((B, F), dtype=torch.float32, device=device)
        self.y = torch.zeros((B,), dtype=torch.long, device=device)
        self.program = None
        self.runs = 0

    def __call__(self, t, idx, vals, y):
        with torch.no_grad():
            self.idx.copy_(idx)
            self.vals.copy_(vals)
            self.y.copy_(y)
        if self.runs == 0:
            t.eager_steps += 1
            t._step(self)
        elif self.program is None:
            self.program, _ = _capture.capture(lambda: t._step(self),
                                               self.idx.device)
            t.captures += 1
            if not self.program.ran:
                self.program.replay()
        else:
            self.program.replay()
            t.replays += 1
        self.runs += 1


class BucketedSparseTrainer:
    """Captured lazy-update training of a `models.WideDeep` (attributes
    `wide`, `deep_embed`, `mlp`, `out`; forward `(indices, values) ->
    logits`) whose parameters have data (run one forward first).
    `optimizer`: "adam" or "sgd", the same rule for the dense parameters
    and the embedding rows (the rows lazily).

    `step(indices (B, F) int, values (B, F), labels (B,))` returns the
    step's mean softmax cross-entropy loss as an NDArray (module doc).
    `sync_to_net()` writes the state back into the block."""

    def __init__(self, net, optimizer="adam", lr=None, wd=0.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, bucket_rows=None):
        if optimizer not in ("adam", "sgd"):
            raise ValueError("optimizer must be 'adam' or 'sgd'")
        self._net = net
        self._opt = optimizer
        self._lr = float(lr if lr is not None
                         else (1e-3 if optimizer == "adam" else 0.01))
        self._wd = float(wd)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._wide_name = _param_name(net, net.wide.weight)
        self._deep_name = _param_name(net, net.deep_embed.weight)
        self._vocab = int(net.wide.weight.shape[0])
        #: the row that padded bucket slots read and write
        self._sentinel = self._vocab
        tables, dense = {}, {}
        with torch.no_grad():
            for name, p in net.named_parameters():
                v = p.detach()
                if name in (self._wide_name, self._deep_name):
                    tables[name] = torch.cat([v, v.new_zeros((1,) +
                                                             v.shape[1:])])
                else:
                    dense[name] = v.clone()
        self._device = tables[self._wide_name].device
        zero = torch.zeros((), device=self._device)
        self._state = {"tables": tables, "dense": dense,
                       "t": zero.to(torch.int32),
                       "overflow": zero.to(torch.int32),
                       "loss": zero.clone()}
        if optimizer == "adam":
            both = {**tables, **dense}
            self._state["m"] = {n: torch.zeros_like(w, dtype=torch.float32)
                                for n, w in both.items()}
            self._state["v"] = {n: torch.zeros_like(w, dtype=torch.float32)
                                for n, w in both.items()}
        self._mlp_names = {"mlp." + n: n for n, _ in
                           net.mlp.named_parameters()}
        self._out_names = {"out." + n: n for n, _ in
                           net.out.named_parameters()}
        self._bucket = int(bucket_rows) if bucket_rows else None
        self._steps = {}
        self.captures = self.replays = self.eager_steps = 0

    # ------------------------------------------------------------------
    def _upd(self, w, g, m, v, lr):
        """One update in MXNet's arithmetic; `w` is rows or a dense
        tensor.  Returns (w, m, v)."""
        g = g.float() + self._wd * w.float()
        if self._opt == "sgd":
            return (w.float() - lr * g).to(w.dtype), m, v
        nm = self._b1 * m + (1 - self._b1) * g
        nv = self._b2 * v + (1 - self._b2) * torch.square(g)
        nw = w.float() - lr * nm / (torch.sqrt(nv) + self._eps)
        return nw.to(w.dtype), nm, nv

    def _step(self, prog):
        """One step of `prog`'s key on its static inputs, in place on the
        state (captured once per key)."""
        st = self._state
        K, B, Fn = prog.K, prog.B, prog.F
        tables, dense = st["tables"], st["dense"]
        uniq, inv, n = static_unique(prog.idx.reshape(-1), K,
                                     self._sentinel)
        ovf = n > K if K < B * Fn else None
        wide_n, deep_n = self._wide_name, self._deep_name
        rows = {wide_n: tables[wide_n].index_select(0, uniq),
                deep_n: tables[deep_n].index_select(0, uniq)}
        with torch.enable_grad():
            gw = rows[wide_n].detach().requires_grad_(True)
            gd = rows[deep_n].detach().requires_grad_(True)
            names = list(self._mlp_names) + list(self._out_names)
            leaves = [dense[n].detach().requires_grad_(True) for n in names]
            params = dict(zip(names, leaves))
            v3 = prog.vals.unsqueeze(-1)
            w_rows = gw.index_select(0, inv).reshape(B, Fn, 1)
            d_rows = gd.index_select(0, inv).reshape(B, Fn, gd.shape[1])
            wide_term = (w_rows * v3).sum(1)
            deep_in = (d_rows * v3).reshape(B, -1)
            with _ProgramScope(True, True):
                h = torch.func.functional_call(
                    self._net.mlp,
                    {r: params[n] for n, r in self._mlp_names.items()},
                    (deep_in,))
                o = torch.func.functional_call(
                    self._net.out,
                    {r: params[n] for n, r in self._out_names.items()},
                    (h,))
            logp = F.log_softmax((o + wide_term).float(), dim=-1)
            loss = -logp.gather(1, prog.y[:, None]).mean()
            grads = torch.autograd.grad(loss, [gw, gd] + leaves)
        with torch.no_grad():
            t = st["t"] + 1
            if self._opt == "adam":
                tf = t.float()
                lr = self._lr * torch.sqrt(1.0 - self._b2 ** tf) / \
                    (1.0 - self._b1 ** tf)
            else:
                lr = self._lr

            def keep(old, new):
                return new if ovf is None else torch.where(ovf, old, new)

            adam = self._opt == "adam"
            # lazy row updates: only the K bucket rows (the sentinel row
            # takes the padded slots)
            for name, g in ((wide_n, grads[0]), (deep_n, grads[1])):
                wr = rows[name]
                mr = st["m"][name].index_select(0, uniq) if adam else None
                vr = st["v"][name].index_select(0, uniq) if adam else None
                nw, nm, nv = self._upd(wr, g, mr, vr, lr)
                tables[name].index_copy_(0, uniq, keep(wr, nw))
                if adam:
                    st["m"][name].index_copy_(0, uniq, keep(mr, nm))
                    st["v"][name].index_copy_(0, uniq, keep(vr, nv))
            for name, g in zip(names, grads[2:]):
                w = dense[name]
                m = st["m"][name] if adam else None
                v = st["v"][name] if adam else None
                nw, nm, nv = self._upd(w, g, m, v, lr)
                w.copy_(keep(w, nw))
                if adam:
                    m.copy_(keep(m, nm))
                    v.copy_(keep(v, nv))
            st["t"].copy_(keep(st["t"], t))
            st["loss"].copy_(keep(st["loss"], loss.float()))
            if ovf is not None:
                st["overflow"].add_(ovf.to(torch.int32))

    # ------------------------------------------------------------------
    def step(self, indices, values, labels):
        """One lazy-update step; returns the loss (an NDArray on the
        device, a copy of the state's).  A step skipped for overflowing
        its bucket returns the previous step's loss (0 before any), so
        that averaging losses stays finite; `overflow_steps` is the one
        sign of a skip (reading it waits for the device)."""
        def tensor(x):
            x = x._data if isinstance(x, NDArray) else x
            return torch.as_tensor(x).to(self._device)
        idx, vals, y = tensor(indices), tensor(values), tensor(labels)
        B, Fn = idx.shape
        K = min(self._bucket, B * Fn) if self._bucket else B * Fn
        key = (K, B, Fn)
        prog = self._steps.get(key)
        if prog is None:
            prog = self._steps[key] = _BucketStep(K, B, Fn, self._device)
        prog(self, idx, vals, y)
        return _wrap(self._state["loss"].clone())

    @property
    def bucket_keys(self):
        return sorted(self._steps)

    @property
    def overflow_steps(self):
        """Steps whose unique-row count exceeded `bucket_rows`, which were
        skipped (a host read of the device)."""
        return int(self._state["overflow"].item())

    def sync_to_net(self):
        """Write the trained values back into the block, the sentinel
        rows dropped."""
        params = dict(self._net.named_parameters())
        with torch.no_grad():
            for name, v in self._state["dense"].items():
                params[name].set_data(v)
            for name, v in self._state["tables"].items():
                params[name].set_data(v[:-1])
