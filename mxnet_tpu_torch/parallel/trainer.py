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

A mesh of more than one device raises: multi-GPU training is ROADMAP
queue A6, and the orbax-style ``save_checkpoint`` / ``load_checkpoint``
(the sharded format) come with it.
"""
from __future__ import annotations

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


def _mesh_size(mesh) -> int:
    """Devices in ``mesh``: an int, a sequence of devices, or an object
    with a ``devices`` array (a mesh)."""
    if isinstance(mesh, int):
        return mesh
    return int(np.asarray(getattr(mesh, "devices", mesh), dtype=object).size)


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
    mesh : None, or a mesh of one device.  More devices raise
        ``MXNetError`` (ROADMAP queue A6).
    rules, data_specs, label_specs, seq_axis : sharding specifications;
        they need a mesh, so anything but None raises.
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
        if mesh is not None and _mesh_size(mesh) != 1:
            raise _base.MXNetError(
                f"a mesh of {_mesh_size(mesh)} devices: the port's "
                "ShardedTrainer runs on one device; data/tensor/sequence "
                "parallel training is ROADMAP queue A6")
        if any(x is not None for x in (rules, data_specs, label_specs,
                                       seq_axis)):
            raise _base.MXNetError(
                "rules/data_specs/label_specs/seq_axis shard over a mesh; "
                "the port's ShardedTrainer runs on one device (ROADMAP "
                "queue A6)")
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
        # False runs the step's function without graphs on the card
        self._graphs = True
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
        opt = self.optimizer
        opt.param_dict = {i: p for i, (_, p) in enumerate(self._trainable)}
        for i, (_, p) in enumerate(self._trainable):
            st = opt.create_state_multi_precision(i, p.detach())
            self._states.append(st)
            self._state_flat.extend(_leaves(st))
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

    def build(self, data=(), labels=()):
        """Create optimizer state without stepping, so a resume can load
        state into a fresh trainer first.  Deferred parameter shapes are
        settled on ``data`` (see :meth:`_settle`); ``labels`` are not
        needed."""
        if not self._built:
            self._build(_as_tuple(data) if data is not None else ())
        n = sum(len(_as_tuple(x)) for x in (data, labels)
                if x is not None)
        if n and self.batch_shardings is None:
            self._batch_shardings = [self.device] * n
        return self

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
            with _base.training_mode(True):
                out = self.net(*data)
            lval = self.loss(out, *labels) if self.loss is not None \
                else out
            return lval.mean()
        finally:
            _base.set_aux_collection(prev)
            _base.pop_aux_losses()

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
            g = self._grads(lval * scale.to(lval.dtype)
                            if scale is not None else lval)
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
            self._batch_shardings = [self.device] * len(batch)
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
        if not self._guarded:
            self._update(grads, lr, t)
            return (loss,)

        if scaler is not None:       # unscale before clip/flag/update
            inv = 1.0 / self._scale
            grads = [g * inv.to(g.dtype) for g in grads]
        # grad poison splice (the loss poison's contract)
        keep = torch.isfinite(gpoison)
        grads = [torch.where(keep, g, gpoison.to(g.dtype)) for g in grads]
        finite = torch.isfinite(loss)
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        if self._clip_global_norm is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
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
        and a ``data`` section from the attached input pipeline."""
        out = {"num_update": int(self.optimizer.num_update),
               "built": self._built, "guarded": self._guarded}
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
