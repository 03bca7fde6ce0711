"""ShardedTrainer on one device (counterpart of
``mxnet_tpu/parallel/trainer.py``).

The reference compiles forward, backward and the optimizer update into
one jitted program over a device mesh (``_compile``, ``_step``,
``trainer.py:596-760``).  The port compiles the same step into one CUDA
graph per batch signature (the batch's shapes and dtypes;
``utils/graphs.py``): the forward in training mode, the loss, the
gradients by ``torch.autograd.grad`` (``grad_accum`` microbatches
included), the guard, the clip and the loss scaler's schedule, and the
registered optimizer's update, which writes parameters and optimizer
state in place.  The first step of a signature runs once on the
capture stream as a warm-up whose writes are put back, is captured, and
is then replayed; later steps replay.  A new shape (the last short
batch) captures another program, as jax retraces.  A capture that fails
raises ``MXNetError`` naming the trainer and the signature before any
step is applied, as jax compiles before it runs.  On the CPU,
and on the card where the private ``_graphs`` is False, the same
function runs on the same static buffers at every step.  The step
semantics are the reference's:

- ``num_update += 1``, then every parameter's update sees
  ``t = num_update`` and the learning rate of that count
  (``trainer.py:711-713``, through :meth:`Optimizer.traced`): the host
  writes both into the program's static inputs (float32 and int32, as
  the reference traces them) with the batch, one copy a step;
- the parameters that take no gradient (BatchNorm's moving statistics)
  are aux state: the layers move them in place during the forward, once
  per (micro)batch in microbatch order, as the reference threads them
  through its scan (``trainer.py:391-418``);
- ``grad_accum`` splits the batch into microbatches, accumulates their
  gradients in float32 and averages them before one update
  (``trainer.py:389-423``);
- the guarded step (``guard_nonfinite``, ``clip_global_norm``,
  ``loss_scaler``; ``trainer.py:518-584``) computes an ``all_finite``
  flag on the device and applies the update through ``torch.where``, so
  a non-finite step leaves parameters, aux and optimizer state
  bit-identical and the host never waits for the flag;
- deferred parameter shapes settle at the first step (or ``build``) by
  one forward of a one-sample slice in inference mode;
- the loss scale and the count of finite steps are device scalars the
  step rewrites in place, so ``save_states``, ``load_states``,
  ``state_dict`` and ``set_learning_rate`` work between replays.

- the resilience and observability hooks (``trainer.py:679-733``): the
  ``trainer.step`` span when a tracer is active (one global load and a
  ``None`` check when not), the ``trainer.step`` fault site as the very
  first thing a step does, before ``num_update`` moves, the
  ``mxtpu_trainer_steps_total`` counter, ``attach_data_source``, and on
  the guarded step the poison splice: ``trainer.loss_nonfinite`` and
  ``trainer.grad_nonfinite`` are two float32 inputs of the step's
  program, written with the batch at every step (0.0 when no fault plan
  poisons them), and the step replaces the loss, or every gradient, by
  a non-finite value of theirs with ``torch.where`` on the device, so a
  captured graph poisons exactly the replays the plan picks.
  ``ResilientLoop`` drives the trainer through ``step``,
  ``state_dict`` and ``load_state_dict``.

**Over a mesh** (``mesh=make_mesh(dp=..., sp=..., tp=..., ep=...,
pp=...)``, one process per rank after ``init_distributed``), the
reference's pjit step becomes SPMD in each process with explicit
collectives:

- every rank passes the same global batch, as every process does in the
  reference; the step keeps this rank's block of each array under its
  ``NamedSharding`` (``batch_shardings``: dim 0 over ``dp``, ``seq_axis``
  over ``sp``, or ``data_specs`` / ``label_specs``).  A batch that is
  already this rank's block (``sharding.local_shard``, a loader over a
  mesh placement) is taken as it is;
- the parameters start equal, from rank 0's (``shard_params`` at build,
  KVStore's broadcast), and each rank keeps its block of those split
  over ``tp``, ``ep`` or ``pp``; the optimizer's states follow the
  blocks.  The device generator is made equal along the ``tp``, ``ep``
  and ``pp`` lines, so dropout draws the same masks on activations those
  ranks share;
- the forward runs under ``use_mesh``, so attention over an ``sp`` axis
  runs ring or Ulysses attention, and the layers run their ``tp``,
  ``ep`` and ``pp`` collectives (``models/transformer.py``, ``moe.py``,
  ``stacked.py``);
- the local loss is a mean over this rank's rows and positions, so each
  rank's loss and gradients carry its share of the global batch x
  sequence, 1 / (|dp| * |sp|): the gradients and the loss are summed over
  the data axes in flat buckets (``collectives.all_reduce_``) and scaled
  by that share, which gives the reference's global-mean gradient and
  loss on every rank.  Never over ``tp`` or ``ep``: there a rank's block
  of a parameter is its own, and the layers' collectives already give a
  parameter that the ranks share the same whole gradient on each.  Under
  ``pp`` every stage gets the pipeline's output and computes the head
  and the loss from it (``parallel.gpipe``), which count once: the
  loss's gradient is taken on the last stage, whose backward runs the
  reverse pipeline through every stage, and the gradients of the
  parameters every stage holds (the embeddings, ``ln_f``, the tied head)
  are summed over ``pp`` as well, each stage giving what it used.
  ``grad_accum`` accumulates locally and reduces once; the gradient
  poison is spliced before the reduction and the guard's finite flag,
  the clip's global norm (each block's squares summed over its axes, a
  shared element counted once) and the loss scaler's schedule are taken
  after it over the whole model, so every rank makes the same decision;
- the step stays one CUDA graph where its collectives can be captured
  (NCCL, or a mesh of one rank); under gloo, whose transport stages
  through the host, it runs eagerly.  The choice is made at construction
  and shown in ``stats()`` (``graphed``, ``backend``).

``save_checkpoint`` / ``load_checkpoint`` write and read
``torch.distributed.checkpoint`` directories (``utils/checkpoint.py``):
each rank writes its blocks with their offsets in the whole parameter,
so a checkpoint saved under one mesh loads under another (a tp = 2 save
at tp = 1 and the reverse).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import base as _base
from .. import optimizer as opt_mod
from .. import random as _random
from ..context import resolve_device
from ..gluon.parameter import is_initialized
from ..ndarray.ndarray import NDArray
from ..observability.trace import active as _trace_active
from ..resilience.faults import inject as _inject, poison as _poison
from ..utils.graphs import Program
from . import collectives as _coll
from .mesh import Mesh, current_mesh, make_mesh, use_mesh
from .sharding import (DATA_AXES, MODEL_AXES, NamedSharding,
                       ShardingRules, axis_size, batch_spec, global_shape,
                       is_block, is_local_shard, shard_params)

__all__ = ["ShardedTrainer"]


def _leaves(state) -> List[torch.Tensor]:
    """The tensors of an optimizer state (None, a tensor, or nested
    tuples/lists of them), in order."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in _leaves(s)]
    raise _base.MXNetError(f"unsupported optimizer state {type(state)}")


def _as_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` as a :class:`Mesh`: a mesh, a device count or a sequence
    of devices (one rank each), or None (one device, no mesh)."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    n = mesh if isinstance(mesh, int) else len(mesh)
    return make_mesh(dp=n, devices=list(range(n)))


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class ShardedTrainer:
    """Train a Block on its device (parity role: the reference's
    ``ShardedTrainer`` with a one-device mesh).

    Parameters
    ----------
    net : Block with initialized parameters; the trainer runs on their
        device.
    optimizer : str or Optimizer — any registered optimizer.
    loss : callable(out, *labels) -> tensor, reduced to its mean.
    mesh : a :class:`~mxnet_tpu_torch.parallel.Mesh` (default: the
        ambient ``use_mesh`` one), or None: one device, no collectives.
    rules : ShardingRules giving each parameter's spec, and so the
        blocks it is split into.
    data_specs/label_specs : PartitionSpecs per input; default dim 0
        over ``dp`` (and ``seq_axis`` over ``sp``).
    donate, donate_batch : accepted for the reference's signature; the
        port always updates parameters and state in place.
    grad_accum : microbatch count; the batch dim must divide by it.
    guard_nonfinite : the guarded step; ``step()`` then returns
        ``(loss, all_finite)``.
    clip_global_norm : cap the unscaled gradient's global L2 norm at
        this value before the update.  Implies the guarded step.
    loss_scaler : an :class:`mxnet_tpu_torch.amp.LossScaler` whose
        schedule runs on the device.  Implies the guarded step.
    """

    def __init__(self, net, optimizer, loss=None, optimizer_params=None,
                 mesh=None, rules=None, data_specs=None, label_specs=None,
                 seq_axis: Optional[int] = None, donate: bool = True,
                 donate_batch: bool = False, grad_accum: int = 1,
                 guard_nonfinite: bool = False,
                 clip_global_norm: Optional[float] = None,
                 loss_scaler=None):
        self.net = net
        self.loss = loss
        if grad_accum != int(grad_accum) or int(grad_accum) < 1:
            raise _base.MXNetError(
                f"grad_accum must be a positive integer, got {grad_accum}")
        self._grad_accum = int(grad_accum)
        self.mesh = _as_mesh(mesh) if mesh is not None else current_mesh()
        if self.mesh is None and any(
                x is not None for x in (data_specs, label_specs, seq_axis)):
            raise _base.MXNetError(
                "data_specs/label_specs/seq_axis shard a batch over a mesh: "
                "pass mesh= (parallel.make_mesh) or run under use_mesh")
        self.rules = rules or ShardingRules()
        self._data_specs = data_specs
        self._label_specs = label_specs
        self._seq_axis = seq_axis
        # the group of every rank of the mesh, the data axes' (the loss
        # and gradient sum) and the model axes' (the global norm, the
        # guard's flag); each rank's share of the global batch x sequence
        m = self.mesh
        self._group = m.group(m.axis_names) if m is not None else None
        self._data_group = m.group(DATA_AXES) if m is not None else None
        self._model_group = m.group(MODEL_AXES) if m is not None else None
        self._share = 1.0 / (axis_size(m, "dp") * axis_size(m, "sp")) \
            if m is not None else 1.0
        # the loss's gradient counts on the last pipeline stage only
        pp = axis_size(m, "pp") if m is not None else 1
        self._loss_weight = 1.0 if pp == 1 or \
            m.axis_index("pp") == pp - 1 else 0.0
        # each gradient's reduction group and weight in the global norm
        # (_plan_reduction, over a mesh)
        self._grad_groups = self._norm_weights = None
        self.optimizer = opt_mod.create(optimizer,
                                        **(optimizer_params or {}))
        self._guard_nonfinite = bool(guard_nonfinite)
        if clip_global_norm is not None and clip_global_norm <= 0:
            raise _base.MXNetError(
                f"clip_global_norm must be > 0, got {clip_global_norm}")
        self._clip_global_norm = clip_global_norm
        self._loss_scaler = loss_scaler
        self._scale: Optional[torch.Tensor] = None  # loss scale (device)
        self._good: Optional[torch.Tensor] = None   # finite steps in a row
        self._built = False
        self.device: Optional[torch.device] = None
        self._trainable: List[Tuple[str, torch.nn.Parameter]] = []
        self._aux: List[Tuple[str, torch.nn.Parameter]] = []
        self._states: list = []
        self._state_flat: List[torch.Tensor] = []
        self._pending_states: Optional[dict] = None
        self._programs: Dict[tuple, "_StepProgram"] = {}
        # False runs the step's function without graphs on the card; the
        # gloo transport stages through the host and cannot be captured
        self._graphs = self._group is None or \
            not _coll.staging(self._group)
        self._data_source = None   # attach_data_source: stats()/span stamp
        # fleet counter (docs/observability.md): process-wide step count,
        # shared across trainer instances
        from ..observability.registry import default_registry
        self._obs_steps = default_registry().counter(
            "mxtpu_trainer_steps_total",
            help="ShardedTrainer.step calls, all trainers")

    # ----------------------------------------------------------- guardrails
    @property
    def _guarded(self) -> bool:
        return (self._guard_nonfinite or self._loss_scaler is not None
                or self._clip_global_norm is not None)

    def attach_loss_scaler(self, scaler=None):
        """Enable the guarded step's dynamic loss scaling on the
        schedule of ``scaler`` (an :class:`~mxnet_tpu_torch.amp.LossScaler`,
        default a new one), as ``amp.init_trainer`` does.  The schedule
        runs on the device inside the step, so it must be attached before
        the first ``build()``/``step()``."""
        if self._built:
            raise _base.MXNetError(
                "attach_loss_scaler after the trainer is built: the scale "
                "schedule is part of the step — attach before the first "
                "build()/step()")
        if scaler is None:
            from .. import amp as _amp
            scaler = _amp.LossScaler()
        self._loss_scaler = scaler
        return scaler

    @property
    def loss_scale(self) -> float:
        """Current dynamic loss scale (reads the device scalar; 1.0 when
        no scaler is attached)."""
        if self._scale is not None:
            return float(self._scale)
        if self._loss_scaler is not None:
            return float(self._loss_scaler.loss_scale)
        return 1.0

    # ------------------------------------------------------------------
    def _settle(self, data):
        """Give deferred parameters their shapes and values with one
        forward of the batch's first sample, in inference mode and
        without a graph, so no moving statistic or dropout draw moves
        (the reference settles shapes the same way)."""
        if not data or all(is_initialized(p)
                           for p in self.net.parameters()):
            return
        dev = self.net.device or resolve_device(None)
        sample = [self._to_device(x, dev)[:1] for x in data]
        with torch.no_grad(), _base.training_mode(False):
            self.net(*sample)

    def _build(self, data=()):
        self._settle(data)
        for name, p in self.net.named_parameters():
            if not is_initialized(p):
                raise _base.MXNetError(
                    f"Parameter '{name}' has not been initialized: call "
                    "initialize() or load parameters before the first "
                    "build()/step()")
            (self._trainable if p.requires_grad else self._aux).append(
                (name, p))
        if not self._trainable:
            raise _base.MXNetError("the net has no trainable parameters")
        self.device = self._trainable[0][1].device
        if self.mesh is not None:
            # ranks seeded apart start from rank 0's weights, each with
            # its blocks
            shard_params(self.net, self.mesh, self.rules)
            self._same_draws()
            self._plan_reduction()
        opt = self.optimizer
        opt.param_dict = {i: p for i, (_, p) in enumerate(self._trainable)}
        self._state_param = []      # each state leaf's parameter
        for i, (_, p) in enumerate(self._trainable):
            st = opt.create_state_multi_precision(i, p.detach())
            self._states.append(st)
            self._state_flat.extend(_leaves(st))
            self._state_param.extend([p] * len(_leaves(st)))
        if self._guarded:
            init = (self._loss_scaler.loss_scale
                    if self._loss_scaler is not None else 1.0)
            self._scale = torch.tensor(float(init), dtype=torch.float32,
                                       device=self.device)
            self._good = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self._built = True
        if self._pending_states is not None:
            self._apply_loaded_states(self._pending_states)
            self._pending_states = None

    def _same_draws(self):
        """Give every rank of a ``tp``, ``ep`` or ``pp`` line the device
        generator state of the line's first rank: their layers draw
        dropout masks for activations they share."""
        if self._model_group is None:
            return
        import torch.distributed as dist
        gen = _random.generator(self.device)
        state = gen.get_state()
        buf = [state.to(self.device) if self.device.type == "cuda"
               else state.clone()]
        _coll.broadcast_(buf, src=dist.get_global_rank(self._model_group, 0),
                         group=self._model_group)
        gen.set_state(buf[0].cpu())

    def _plan_reduction(self):
        """Each trainable parameter's gradient group (the data axes, and
        ``pp`` where every stage holds the parameter) and its weight in
        the global norm (1 over the ranks of the model axes that hold the
        same block)."""
        m = self.mesh
        self._grad_groups, self._norm_weights = [], []
        for _n, p in self._trainable:
            spec = tuple(p._sharding.spec)
            shared = [a for a in MODEL_AXES
                      if axis_size(m, a) > 1 and a not in spec]
            axes = DATA_AXES + (("pp",) if "pp" in shared else ())
            self._grad_groups.append(m.group(axes))
            self._norm_weights.append(
                1.0 / float(np.prod([axis_size(m, a) for a in shared])))

    def build(self, data=(), labels=()):
        """Create optimizer state without stepping, so a resume can load
        state into a fresh trainer first.  Deferred parameter shapes are
        settled on ``data`` (see :meth:`_settle`); ``labels`` are not
        needed."""
        if not self._built:
            self._build(_as_tuple(data) if data is not None else ())
        data = _as_tuple(data) if data is not None else ()
        labels = _as_tuple(labels) if labels is not None else ()
        if (data or labels) and self.batch_shardings is None:
            self._batch_shardings = self._shardings(data, labels)
        return self

    def _shardings(self, data, labels) -> list:
        """Each batch array's placement: this device without a mesh,
        else a :class:`NamedSharding` of the mesh (``data_specs`` /
        ``label_specs``, default dim 0 over ``dp`` and ``seq_axis`` over
        ``sp``)."""
        if self.mesh is None:
            return [self.device] * (len(data) + len(labels))

        def specs(given, arrays):
            return list(given) if given is not None else [
                batch_spec(np.ndim(x) if not hasattr(x, "ndim") else x.ndim,
                           0, self._seq_axis) for x in arrays]
        return [NamedSharding(self.mesh, sp) for sp in
                specs(self._data_specs, data)
                + specs(self._label_specs, labels)]

    def _localize(self, x, sharding):
        """This rank's block of the global batch array ``x`` (a block made
        for this rank already is kept)."""
        if not isinstance(sharding, NamedSharding) or is_local_shard(x):
            return x
        if isinstance(x, NDArray):
            x = x.tensor
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return x[sharding.local_slices(tuple(x.shape))]

    # ------------------------------------------------------------------
    def _to_device(self, x, device=None) -> torch.Tensor:
        """``x`` (tensor, NDArray or array) as a tensor on ``device``
        (default: the trainer's)."""
        device = self.device if device is None else device
        if isinstance(x, NDArray):
            x = x.tensor
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.as_tensor(np.asarray(x), device=device)

    def _forward_loss(self, data, labels) -> torch.Tensor:
        """The mean loss of one (micro)batch, inside an aux-loss scope
        (``trainer.py:326-366``): stale entries are drained before the
        forward, the layers record their aux losses (MoE routers) during
        it for the loss to add, and whatever the loss left is drained
        after, so nothing outlives the (micro)batch."""
        _base.pop_aux_losses()
        prev = _base.set_aux_collection(True)
        try:
            with _base.training_mode(True), self._mesh_scope():
                out = self.net(*data)
            lval = self.loss(out, *labels) if self.loss is not None \
                else out
            return lval.mean()
        finally:
            _base.set_aux_collection(prev)
            _base.pop_aux_losses()

    def _mesh_scope(self):
        """``use_mesh(self.mesh)``, so the layers see the mesh (attention
        over ``sp``), or nothing without a mesh."""
        import contextlib
        return use_mesh(self.mesh) if self.mesh is not None else \
            contextlib.nullcontext()

    def _reduce(self, loss, grads):
        """The loss summed over the data axes and the gradients over
        their groups (the data axes, and ``pp`` for parameters every
        stage holds), scaled by this rank's share: the global mean's on
        every rank.  Unchanged without a group (no mesh, or a mesh of one
        rank outside a job)."""
        if self._group is None:
            return loss, grads
        loss = loss.reshape(1).float()
        by_group: Dict[int, list] = {}
        for i, g in enumerate(self._grad_groups):
            by_group.setdefault(id(g), [g, []])[1].append(i)
        for group, idx in by_group.values():
            flat = [grads[i] for i in idx]
            if group is self._data_group:
                flat = [loss] + flat
            _coll.all_reduce_(flat, group)
        if id(self._data_group) not in by_group:
            _coll.all_reduce_([loss], self._data_group)
        share = self._share
        return (loss.reshape(()) * share, [g.mul_(share) for g in grads])

    def _model_sum(self, x):
        """``x`` summed over the ``tp``, ``ep`` and ``pp`` lines (as it
        is without them)."""
        if self._model_group is None:
            return x
        flat = [x.clone()]
        _coll.all_reduce_(flat, self._model_group)
        return flat[0]

    def _grads(self, lval) -> List[torch.Tensor]:
        params = [p for _, p in self._trainable]
        grads = torch.autograd.grad(lval, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)]

    def _loss_and_grads(self, data, labels, scale, lpoison=None):
        """The (unscaled) loss and the gradients of the loss times
        ``scale`` (None: unscaled), over ``grad_accum`` microbatches.
        ``lpoison`` (a 0-d float32 device tensor, or None) replaces each
        microbatch's loss where it is not finite."""
        def one(d, l):
            lval = self._forward_loss(d, l)
            if lpoison is not None:
                # loss poison splice: 0.0 keeps the real loss, NaN/Inf
                # from the fault plan replaces it
                lval = torch.where(torch.isfinite(lpoison), lval,
                                   lpoison.to(lval.dtype))
            target = lval * scale.to(lval.dtype) if scale is not None \
                else lval
            if self._loss_weight != 1.0:
                # a pipeline stage before the last: its backward carries
                # the pipeline's gradients only
                target = target * self._loss_weight
            g = self._grads(target)
            return lval.detach(), g

        accum = self._grad_accum
        if accum == 1:
            return one(data, labels)
        mb = data[0].shape[0] // accum if data else 0
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for _, p in self._trainable]
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            lval, g = one([x[sl] for x in data], [x[sl] for x in labels])
            for acc, gi in zip(gsum, g):
                acc += gi.float()
            lsum += lval.float()
        grads = [(acc / accum).to(p.dtype)
                 for acc, (_, p) in zip(gsum, self._trainable)]
        return lsum / accum, grads

    @torch.no_grad()
    def _update(self, grads, lr, t, keep: Optional[torch.Tensor] = None):
        """Apply the optimizer in place, one list-wise step over every
        parameter (``Optimizer.update_multi``).  With ``keep`` (a 0-d bool
        on the device), parameters and states are restored where it is
        False, bit for bit: one ``torch._foreach_copy_`` saves them all
        before the step and a ``torch.where`` per tensor puts them back,
        with no host read of the flag."""
        opt = self.optimizer
        params = [p for _, p in self._trainable]
        live = params + self._state_flat
        if keep is not None:
            old = [torch.empty_like(x) for x in live]
            torch._foreach_copy_(old, live)
        with opt.traced(lr, t):
            opt.update_multi(list(range(len(params))), params, grads,
                             self._states)
        if keep is not None:
            for x, o in zip(live, old):
                torch.where(keep, x, o, out=x)

    def step(self, data, labels=()):
        """One training step on ``data``/``labels`` (tensors, NDArrays or
        numpy arrays; moved to the trainer's device).

        Returns the loss as a 0-d tensor on the device — or, with the
        guardrails on, ``(loss, all_finite)``: ``all_finite`` is a 0-d
        bool tensor, False iff this step's loss or gradients were not
        finite, in which case parameters and optimizer state were left
        bit-identical and the loss scale shrank.  Neither forces a host
        sync.  With a tracer active the step is a ``trainer.step`` span
        (host time: a replay's enqueue, not its device time)."""
        tr = _trace_active()
        if tr is None:              # zero-cost: one global + None check
            return self._step(data, labels)
        attrs = {}
        if self._data_source is not None:
            # per-step input-wait stamp: how long the caller's last batch
            # acquisition blocked on the input pipeline (0 = fully hidden)
            attrs["input_wait"] = round(getattr(
                self._data_source, "last_wait_seconds", 0.0), 6)
        with tr.span("trainer.step", step=self.optimizer.num_update + 1,
                     guarded=self._guarded, **attrs):
            return self._step(data, labels)

    def _step(self, data, labels=()):
        _inject("trainer.step")
        self._obs_steps.inc()
        data, labels = _as_tuple(data), _as_tuple(labels)
        if self._grad_accum > 1 and data and \
                data[0].shape[0] % self._grad_accum:
            raise _base.MXNetError(
                f"batch dim {data[0].shape[0]} not divisible by "
                f"grad_accum={self._grad_accum}")
        shardings = self._shardings(data, labels) \
            if self.mesh is not None else None
        if shardings is not None:
            data = tuple(self._localize(x, sh)
                         for x, sh in zip(data, shardings))
            labels = tuple(self._localize(x, sh) for x, sh in
                           zip(labels, shardings[len(data):]))
        if not self._built:
            self._build(data)
        opt = self.optimizer
        opt.num_update += 1
        batch = [self._as_input(x) for x in (*data, *labels)]
        key = tuple((tuple(x.shape), str(x.dtype)) for x in batch)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _StepProgram(self, key, batch,
                                                      len(data))
            self._batch_shardings = shardings or [self.device] * len(batch)
        lp = gp = None
        if self._guarded:
            lp = _poison("trainer.loss_nonfinite")
            gp = _poison("trainer.grad_nonfinite")
        try:
            return prog(batch, np.float32(opt.learning_rate),
                        np.int32(opt.num_update),
                        np.float32(0.0 if lp is None else lp),
                        np.float32(0.0 if gp is None else gp))
        except BaseException:
            if prog.prog.graphed and not prog.prog.built:
                # the capture failed before the step was applied: nothing
                # moved, and the next call of the signature builds anew
                del self._programs[key]
                opt.num_update -= 1
            raise

    def _as_input(self, x):
        """A batch array as a program input: numpy arrays stay on the
        host (the program stages them), tensors and NDArrays move to the
        trainer's device.  A batch a ``DevicePrefetcher`` handed over is
        already there: its ``next()`` made the current stream wait on the
        copy's event, and the program's ``copy_in`` copies it into the
        step's static input on that same stream, so the copy is ordered
        after the prefetch.  The copy stays (a graph reads fixed
        addresses, and the prefetched batch lives in memory the ring
        reuses): it is a device-to-device copy of the batch, 66 KB for
        GPT-2's 16 x 1025 tokens."""
        if isinstance(x, NDArray):
            x = x.tensor
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return np.asarray(x)

    def _step_fn(self, data, labels, lr, t, lpoison, gpoison):
        """The whole step over static buffers: ``lr``, ``t`` and the two
        poisons are 0-d device tensors (the poisons are read on the
        guarded step only, as the reference's).  Returns ``(loss,)`` or
        ``(loss, all_finite)``."""
        scaler = self._loss_scaler
        # the forward moves aux state (BatchNorm's moving statistics) in
        # place; a guarded step that turns out non-finite puts it back
        aux_before = [p.detach().clone() for _, p in self._aux] \
            if self._guarded else []
        loss, grads = self._loss_and_grads(
            data, labels, self._scale if scaler is not None else None,
            lpoison if self._guarded else None)
        if self._guarded:
            # grad poison splice (the loss poison's contract), before the
            # reduction so that a rank's poison reaches every rank
            keep = torch.isfinite(gpoison)
            grads = [torch.where(keep, g, gpoison.to(g.dtype))
                     for g in grads]
        loss, grads = self._reduce(loss, grads)
        if not self._guarded:
            self._update(grads, lr, t)
            return (loss,)

        if scaler is not None:       # unscale before clip/flag/update
            inv = 1.0 / self._scale
            grads = [g * inv.to(g.dtype) for g in grads]
        finite = torch.isfinite(loss)
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        if self._model_group is not None:
            # a block's non-finite value stops every rank's step
            finite = self._model_sum((~finite).float()) == 0
        if self._clip_global_norm is not None:
            weights = self._norm_weights or [1.0] * len(grads)
            gnorm = torch.sqrt(self._model_sum(sum(
                torch.sum(torch.square(g.float())) * w
                for g, w in zip(grads, weights))))
            coef = torch.clamp(self._clip_global_norm / (gnorm + 1e-6),
                               max=1.0)
            grads = [g * coef.to(g.dtype) for g in grads]
        # zero the grads of a bad step so Inf * 0 inside the optimizer
        # mints no NaN; the selects in _update make the skip exact
        grads = [torch.where(finite, g, torch.zeros_like(g)) for g in grads]
        self._update(grads, lr, t, keep=finite)
        with torch.no_grad():
            for (_n, p), old in zip(self._aux, aux_before):
                torch.where(finite, p, old, out=p)
            # the guard state is rewritten in place: a replay writes the
            # tensors it captured
            zero = torch.zeros_like(self._good)
            if scaler is not None:
                factor = float(scaler._scale_factor)
                good = self._good + 1
                grow = good >= int(scaler._scale_window)
                grown = torch.where(grow, self._scale * factor, self._scale)
                good = torch.where(grow, zero, good)
                shrunk = torch.clamp(self._scale / factor, min=1.0)
                self._scale.copy_(torch.where(finite, grown, shrunk))
                self._good.copy_(torch.where(finite, good, zero))
            else:
                self._good.copy_(torch.where(finite, self._good + 1, zero))
        return loss, finite

    # ------------------------------------------------------------------
    @property
    def batch_shardings(self):
        """The target placement of each flattened ``data + labels``
        array (None before the first step): on one device, the
        trainer's device for each — what a
        :class:`mxnet_tpu_torch.data.DevicePrefetcher` ships to."""
        return getattr(self, "_batch_shardings", None)

    def attach_data_source(self, source):
        """Associate the input pipeline (anything with ``stats()`` and
        ``last_wait_seconds``) so ``stats()['data']`` and the
        ``trainer.step`` span report it.  Returns ``source``."""
        self._data_source = source
        return source

    def stats(self) -> dict:
        """Point-in-time trainer facts: step counter, built, guarded,
        and a ``data`` section from the attached input pipeline (the
        reference's keys); over a mesh also the mesh's axis sizes,
        ``graphed`` (the step is a CUDA graph on the card; False for
        eager steps, always under gloo), the process group's backend and
        the collectives' counters."""
        import torch.distributed as dist
        out = {"num_update": int(self.optimizer.num_update),
               "built": self._built, "guarded": self._guarded}
        if self.mesh is not None:
            out.update(
                mesh=dict(self.mesh.shape),
                graphed=bool(self._graphs and self.device is not None
                             and self.device.type == "cuda"),
                backend=dist.get_backend() if dist.is_initialized()
                else None, collectives=_coll.stats())
        src = self._data_source
        if src is not None and hasattr(src, "stats"):
            out["data"] = src.stats()
        return out

    @property
    def learning_rate(self):
        return self.optimizer.learning_rate

    def set_learning_rate(self, lr):
        self.optimizer.set_learning_rate(lr)

    def _require_built(self, what):
        if not self._built:
            raise _base.MXNetError(
                f"{what} before build: run build()/step() first so "
                "optimizer states exist")

    def _guard_meta(self) -> Dict[str, np.ndarray]:
        return {"loss_scale": np.array([self.loss_scale], np.float32),
                "good_steps": np.array([int(self._good)], np.int64)}

    def save_states(self, fname):
        """Write the step counter, the guard state and every optimizer
        state leaf (``state_{i}_{j}``) into an ``MXTPU1`` container, the
        reference's layout (``trainer.py:785-802``)."""
        from ..utils.serialization import save
        self._require_built("save_states")
        data = {"num_update": np.array([self.optimizer.num_update],
                                       np.int64)}
        if self._guarded:
            data.update(self._guard_meta())
        for i, st in enumerate(self._states):
            for j, leaf in enumerate(_leaves(st)):
                data[f"state_{i}_{j}"] = leaf
        save(fname, data)

    def load_states(self, fname):
        """Read a ``save_states`` file of either package; before the
        first step it is applied once the states exist."""
        from ..utils.serialization import load
        loaded = {k: torch.from_numpy(v) for k, v in load(fname).items()}
        if not self._built:
            self._pending_states = loaded
            return
        self._apply_loaded_states(loaded)

    @torch.no_grad()
    def _apply_loaded_states(self, loaded):
        if "num_update" in loaded:
            self.optimizer.num_update = int(loaded["num_update"][0])
        self._load_guard(loaded.get("loss_scale"), loaded.get("good_steps"))
        for i, st in enumerate(self._states):
            for j, leaf in enumerate(_leaves(st)):
                leaf.copy_(loaded[f"state_{i}_{j}"])

    def _load_guard(self, scale, good):
        if not self._guarded:
            return
        if scale is not None:
            self._scale.fill_(float(scale[0]))
        if good is not None:
            self._good.fill_(int(good[0]))

    # -------------------------------------------------- sharded checkpoints
    def _ckpt_leaf(self, t, p, whole=False):
        """``t`` (parameter ``p`` or a state leaf of its shape) as a
        checkpoint leaf: itself, or where ``p`` is a block a
        ``checkpoint.Block`` with the layout of every rank's (``whole``:
        an empty tensor of the whole shape to restore into)."""
        from ..utils.checkpoint import Block
        if not is_block(p) or tuple(t.shape) != tuple(p.shape):
            return t.detach()
        shape = global_shape(p)
        if whole:
            return torch.empty(shape, dtype=t.dtype)
        import torch.distributed as dist
        sh, m = p._sharding, self.mesh
        group = self._checkpoint_group()["process_group"]
        blocks = []
        for r in (int(x) for x in m.devices.flat):
            c = m.coords(r)
            # one writer a block: index 0 on every axis it is shared over
            if all(c[a] == 0 for a in m.axis_names if a not in sh.spec):
                sl = sh.local_slices(shape, r)
                blocks.append(([x.start for x in sl],
                               [x.stop - x.start for x in sl],
                               dist.get_group_rank(group, r)))
        mine = sh.local_slices(shape)
        return Block(t.detach(), shape, [x.start for x in mine], blocks)

    def _checkpoint_tree(self, whole=False):
        leaf = functools.partial(self._ckpt_leaf, whole=whole)
        tree = {
            "params": {n: leaf(p, p) for n, p in self._trainable},
            "aux": {n: p.detach() for n, p in self._aux},
            "states": {f"s{i}": leaf(x, p) for i, (x, p) in enumerate(
                zip(self._state_flat, self._state_param))},
            "num_update": torch.tensor(self.optimizer.num_update,
                                       dtype=torch.int64)}
        if self._guarded:
            tree["loss_scale"] = self._scale.detach().float()
            tree["good_steps"] = self._good.detach().to(torch.int64)
        return tree

    def save_checkpoint(self, directory, step: int, async_save=True,
                        max_to_keep=5):
        """Checkpoint parameters, aux, optimizer states, the step counter
        and the guard state (``utils/checkpoint.py``, DCP; every rank
        calls it together and each tensor is written once).  One manager
        is kept per directory; it is returned so a caller can
        ``wait_until_finished`` before exit."""
        from ..utils.checkpoint import CheckpointManager
        import os
        self._require_built("save_checkpoint")
        if not hasattr(self, "_ckpt_managers"):
            self._ckpt_managers = {}
        key = os.path.abspath(str(directory))
        cached = self._ckpt_managers.get(key)
        if cached is not None and cached[1] != (max_to_keep, async_save):
            cached[0].close()
            cached = None
        if cached is None:
            m = CheckpointManager(directory, max_to_keep=max_to_keep,
                                  async_save=async_save,
                                  **self._checkpoint_group())
            self._ckpt_managers[key] = (m, (max_to_keep, async_save))
        else:
            m = cached[0]
        m.save(step, self._checkpoint_tree())
        return m

    def _checkpoint_group(self) -> dict:
        """The saving group's arguments: the mesh's ranks in a gloo group
        of the checkpoints' own (made once, by those ranks only), or this
        process alone."""
        if self._group is None:
            return {"no_dist": True}
        if getattr(self, "_ckpt_group", None) is None:
            import torch.distributed as dist
            ranks = sorted(int(r) for r in self.mesh.devices.flat)
            self._ckpt_group = dist.new_group(
                ranks, backend="gloo", use_local_synchronization=True)
        return {"process_group": self._ckpt_group}

    @torch.no_grad()
    def load_checkpoint(self, directory, step=None):
        """Restore a :meth:`save_checkpoint` directory (the latest step
        unless ``step``), whatever mesh saved it: each rank reads the
        whole of a parameter it holds a block of, and keeps its block."""
        from ..utils.checkpoint import CheckpointManager
        import os
        self._require_built("load_checkpoint")
        cached = getattr(self, "_ckpt_managers", {}).get(
            os.path.abspath(str(directory)))
        if cached is not None:
            cached[0].wait_until_finished()
        with CheckpointManager(directory, async_save=False,
                               **self._checkpoint_group()) as m:
            got = m.restore(step, like=self._checkpoint_tree(whole=True))

        def put(t, whole, p):
            # a block takes its slice of the whole value
            if is_block(p) and tuple(t.shape) == tuple(p.shape):
                whole = whole[p._sharding.local_slices(tuple(whole.shape))]
            t.copy_(whole)
        for n, p in self._trainable:
            put(p, got["params"][n], p)
        for n, p in self._aux:
            p.copy_(got["aux"][n])
        for i, (leaf, p) in enumerate(zip(self._state_flat,
                                          self._state_param)):
            put(leaf, got["states"][f"s{i}"], p)
        self.optimizer.num_update = int(got["num_update"])
        if self._guarded:
            self._scale.fill_(float(got["loss_scale"]))
            self._good.fill_(int(got["good_steps"]))

    # ------------------------------------------------------- flat state dict
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The trainer's restorable state as a flat dict with the
        reference's positional keys (``trainer.py:814-848``):
        ``param:i``, ``aux:i``, ``state:i`` (optimizer-state leaves in
        order) and ``meta:num_update`` (plus ``meta:loss_scale`` /
        ``meta:good_steps`` when guarded).  Values are detached tensors
        sharing the live storage: the next step changes them, so copy or
        save them first."""
        self._require_built("state_dict")
        out = {"meta:num_update": torch.tensor([self.optimizer.num_update],
                                               dtype=torch.int64)}
        if self._guarded:
            out.update({f"meta:{k}": torch.from_numpy(v)
                        for k, v in self._guard_meta().items()})
        for i, (_n, p) in enumerate(self._trainable):
            out[f"param:{i}"] = p.detach()
        for i, (_n, p) in enumerate(self._aux):
            out[f"aux:{i}"] = p.detach()
        for i, leaf in enumerate(self._state_flat):
            out[f"state:{i}"] = leaf
        return out

    @torch.no_grad()
    def load_state_dict(self, d: Dict[str, torch.Tensor]):
        """Inverse of :meth:`state_dict`, values as tensors (arrays of the
        reference go through :func:`mxnet_tpu_torch.utils.convert.
        load_numpy_state`).  Missing keys or other shapes raise before
        anything is written."""
        self._require_built("load_state_dict")
        targets = ([(f"param:{i}", p, n)
                    for i, (n, p) in enumerate(self._trainable)]
                   + [(f"aux:{i}", p, n)
                      for i, (n, p) in enumerate(self._aux)]
                   + [(f"state:{i}", leaf, "opt state")
                      for i, leaf in enumerate(self._state_flat)])
        missing = [k for k, _t, _n in targets if k not in d]
        if "meta:num_update" not in d:
            missing.append("meta:num_update")
        if missing:
            raise _base.MXNetError(
                f"state dict is missing {len(missing)} keys (e.g. "
                f"{missing[:3]}) — not a checkpoint of this trainer/model")
        for key, t, name in targets:
            if tuple(d[key].shape) != tuple(t.shape):
                raise _base.MXNetError(
                    f"state dict {key} ({name}) has shape "
                    f"{tuple(d[key].shape)}, expected {tuple(t.shape)} — "
                    "checkpoint of a different model")
        for key, t, _n in targets:
            t.copy_(d[key])
        self.optimizer.num_update = int(d["meta:num_update"][0])
        self._load_guard(d.get("meta:loss_scale"), d.get("meta:good_steps"))


class _StepProgram:
    """``ShardedTrainer``'s step for one batch signature: static inputs
    for the batch, ``lr``, ``t`` and the loss and gradient poisons, and
    on the card one CUDA graph, captured before the signature's first
    step is applied."""

    def __init__(self, trainer: ShardedTrainer, key, batch, n_data):
        self.trainer, self.key, self.n_data = trainer, key, n_data
        self.prog = Program([*batch, np.float32(0), np.int32(0),
                             np.float32(0), np.float32(0)],
                            trainer.device, trainer._graphs, self._failed,
                            draws=_random.GraphDraws(trainer.device))
        self.outputs = None

    def _failed(self, e):
        return _base.MXNetError(
            f"ShardedTrainer({type(self.trainer.net).__name__}): capturing "
            f"the step of batch signature {self.key} failed: "
            f"{type(e).__name__}: {e}")

    def _fn(self):
        *batch, lr, t, lp, gp = self.prog.inputs
        n = self.n_data
        return self.trainer._step_fn(batch[:n], batch[n:], lr, t, lp, gp)

    def _warm(self):
        """The step once, with everything it writes put back: the
        parameters, aux state, optimizer state, guard state and the
        device generator."""
        tr = self.trainer
        state = [p for _n, p in tr._trainable + tr._aux] + \
            tr._state_flat + [x for x in (tr._scale, tr._good)
                              if x is not None]
        saved = [x.detach().clone() for x in state]
        gen = _random.generator(tr.device)
        rng = gen.get_state()
        try:
            self._fn()
        finally:
            with torch.no_grad():
                for x, old in zip(state, saved):
                    x.copy_(old)
            gen.set_state(rng)

    def __call__(self, batch, lr, t, lpoison, gpoison):
        prog = self.prog
        prog.copy_in([*batch, lr, t, lpoison, gpoison])
        if not prog.graphed:
            outs = prog.run(self._fn)
        else:
            if not prog.built:
                self.outputs, = prog.build(self._warm, self._fn)
            prog.replay()
            outs = tuple(o.clone() for o in self.outputs)
        return outs[0] if len(outs) == 1 else outs
