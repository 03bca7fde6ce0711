"""Preemption-safe training: checkpoint, die, resume, converge anyway.

:class:`ResilientLoop` wraps a trainer (``ShardedTrainer`` natively; any
object with ``step(data, labels)`` + ``state_dict()`` /
``load_state_dict()`` works) and turns "run N steps" into a contract
that survives the failure modes routine on preemptible hosts
(counterpart of ``mxnet_tpu/resilience/loop.py``):

- **atomic checkpoints** every ``save_every`` steps through
  :class:`~mxnet_tpu_torch.resilience.checkpoint.AtomicCheckpointer` — a kill
  mid-save can never corrupt the previous committed state;
- **automatic resume**: a fresh ``run()`` finds ``latest_step()``,
  rebuilds the trainer on the first batch's shapes, restores
  params/optimizer-state/num_update, and *replays the data iterator* to
  the committed offset, so the resumed run consumes exactly the batches
  the dead run would have;
- **per-step reseeding**: before every step (and every retry of it) the
  global RNG is reseeded from ``(seed, step)``, so a replayed step draws
  the same dropout masks as the fault-free run — this is what makes
  kill-K-times-resume-K-times produce bit-identical parameters (the
  chaos-determinism acceptance test).  :func:`mxnet_tpu_torch.random.seed`
  reseeds the generator objects in place, so on the card the reseed
  reaches the generator every captured training graph registered and
  the next replay draws from the new seed;
- **bounded retry with backoff** around transient step failures
  (:class:`~mxnet_tpu_torch.resilience.faults.RetryableFault` by default);
  :class:`~mxnet_tpu_torch.resilience.faults.SimulatedPreemption` and other
  ``BaseException`` kills are never retried — they propagate, like real
  process death;
- **SIGTERM = preemption notice**: on the standard preemption signal the
  loop finishes the in-flight step, commits a final checkpoint, and
  returns with ``report["preempted"] = True`` instead of dying dirty;
- **bad-step policy** (``on_bad_step``): when the trainer runs with the
  training-health guardrails compiled in (``step()`` returns
  ``(loss, all_finite)`` — docs/guardrails.md), the loop reads the flag
  and reacts to non-finite steps: ``"skip"`` (default) counts them and
  moves on — the guarded trainer already left its state untouched;
  ``"rewind"`` additionally restores the last committed checkpoint
  after ``rewind_after`` CONSECUTIVE bad steps (escaping a poisoned
  parameter region the skip alone can't); ``"raise"`` raises
  :class:`NonFiniteStepError` at the first bad step (CI-style
  fail-fast).

Counters (``checkpoint_commits``, ``resumes``, ``retries``,
``bad_steps``, ``rewinds``) land in a
:class:`~mxnet_tpu_torch.serving.metrics.ServingMetrics` instance so training
and serving resilience export through one stats surface.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from .. import base as _base
from .. import random as _random
from ..observability.flightrecorder import active as _fr_active
from ..observability.trace import active as _trace_active
from .checkpoint import AtomicCheckpointer
from .faults import RetryableFault

__all__ = ["ResilientLoop", "NonFiniteStepError"]


class NonFiniteStepError(_base.MXNetError):
    """A guarded training step reported a non-finite loss/gradient and
    the loop's ``on_bad_step`` policy chose to escalate (``"raise"``,
    or ``"rewind"`` with no committed checkpoint to rewind to).  The
    trainer's state is NOT poisoned — the guarded step skipped the
    update before this was raised."""


def _host(x):
    """A step's 0-d result (a tensor, or an NDArray of the Gluon surface)
    read on the host."""
    return x.asnumpy() if hasattr(x, "asnumpy") else x.item()


def _normalize_batch(batch) -> Tuple[tuple, tuple]:
    """Accept (data, labels) with each side an NDArray or tuple/list."""
    if not (isinstance(batch, (tuple, list)) and len(batch) == 2):
        raise _base.MXNetError(
            "ResilientLoop batches must be (data, labels) pairs "
            f"(got {type(batch).__name__})")
    data, labels = batch
    if not isinstance(data, (tuple, list)):
        data = (data,)
    if not isinstance(labels, (tuple, list)):
        labels = (labels,)
    return tuple(data), tuple(labels)


class ResilientLoop:
    """Drive ``trainer`` for ``steps`` steps, surviving kills.

    Parameters
    ----------
    trainer : ShardedTrainer-like — needs ``step(data, labels)``,
        ``state_dict()``, ``load_state_dict(d)``; ``build(data, labels)``
        is used when present so a resume can restore state before any
        optimizer step runs.
    directory : checkpoint directory (one run = one directory).
    save_every : commit a checkpoint every N completed steps (the final
        step always commits).  Smaller = less recomputation after a
        kill, more write traffic.
    max_to_keep : GC bound on committed checkpoints.
    max_retries : per-step budget for retryable failures.
    backoff / backoff_factor : sleep before retry k is
        ``backoff * backoff_factor**k``.
    seed : base of the per-step reseed; ``None`` disables reseeding
        (resumed runs then draw different randomness — convergence
        still holds, determinism doesn't).
    retryable : exception classes worth retrying (transient infra
        faults); anything else propagates immediately.
    on_bad_step : ``"skip"`` | ``"rewind"`` | ``"raise"`` — reaction to
        a guarded trainer reporting a non-finite step (trainers whose
        ``step()`` returns a bare loss are unaffected).  ``"skip"``:
        count it and continue (the guarded step already left state
        bit-identical).  ``"rewind"``: after ``rewind_after``
        consecutive bad steps, restore the last committed checkpoint
        (params, optimizer state AND loss scale) and keep going — the
        data stream continues FORWARD past the poisoned region
        (replaying the same batches would just fail again).
        ``"raise"``: raise :class:`NonFiniteStepError` immediately.
        Reading the flag forces per-step device sync, which unguarded
        runs don't pay.
    rewind_after : consecutive-bad-step threshold for ``"rewind"``.
    """

    def __init__(self, trainer, directory, *, save_every: int = 1,
                 max_to_keep: Optional[int] = 5, max_retries: int = 3,
                 backoff: float = 0.05, backoff_factor: float = 2.0,
                 seed: Optional[int] = 0,
                 retryable: tuple = (RetryableFault,), metrics=None,
                 on_bad_step: str = "skip", rewind_after: int = 3):
        if save_every < 1:
            raise _base.MXNetError(
                f"save_every must be >= 1, got {save_every}")
        if on_bad_step not in ("skip", "rewind", "raise"):
            raise _base.MXNetError(
                f"on_bad_step must be 'skip'|'rewind'|'raise', "
                f"got {on_bad_step!r}")
        if rewind_after < 1:
            raise _base.MXNetError(
                f"rewind_after must be >= 1, got {rewind_after}")
        self.trainer = trainer
        self.checkpointer = AtomicCheckpointer(directory,
                                               max_to_keep=max_to_keep)
        self.save_every = int(save_every)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_factor = float(backoff_factor)
        self.seed = seed
        self.retryable = tuple(retryable)
        self.on_bad_step = on_bad_step
        self.rewind_after = int(rewind_after)
        if metrics is None:
            from ..serving.metrics import ServingMetrics
            metrics = ServingMetrics("resilience")
        self.metrics = metrics
        self._stop_requested = False
        self._prev_sigterm = None

    # -------------------------------------------------------------- control
    def request_stop(self):
        """Ask the loop to checkpoint and return at the next step
        boundary (what the SIGTERM handler calls)."""
        self._stop_requested = True

    def _install_sigterm(self):
        if threading.current_thread() is not threading.main_thread():
            return False
        try:
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, lambda signum, frame: self.request_stop())
            return True
        except ValueError:       # no signal support in this context
            return False

    def _restore_sigterm(self, installed: bool):
        if installed and self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
        self._prev_sigterm = None

    # ------------------------------------------------------------ internals
    def _reseed(self, step: int):
        if self.seed is not None:
            _random.seed((self.seed * 1_000_003 + step) & 0x7FFFFFFF)

    def _ensure_built(self, data, labels):
        # key off the presence of build(), not the private _built flag:
        # a duck-typed trainer exposing build() but no _built attribute
        # must still get built (build() is required to be idempotent —
        # ShardedTrainer.build is)
        tr = self.trainer
        build = getattr(tr, "build", None)
        if build is not None and getattr(tr, "_built", None) is not True:
            build(data, labels)

    def _verified_restore(self, step: Optional[int]):
        """Restore through the checkpointer's verified path and account
        for what it did: each step it quarantined counts one
        ``checkpoint_quarantines``, and landing on an OLDER step than
        asked (corruption fallback, docs/integrity.md) counts one
        ``checkpoint_fallbacks``.  The caller keys resume/rewind off the
        returned ``meta["step"]``, so a fallback is automatically
        replayed from the right offset."""
        ck = self.checkpointer
        q_before = len(ck.quarantined())
        try:
            tree, meta = ck.restore(step)
        finally:
            # count even when the chain is exhausted and restore raises
            # CheckpointCorruptError — the total-corruption incident is
            # exactly when the counter matters most
            dq = len(ck.quarantined()) - q_before
            if dq:
                self.metrics.count("checkpoint_quarantines", dq)
                fr = _fr_active()
                if fr is not None:
                    fr.record("loop.quarantine", quarantined=dq,
                              step=step)
        if step is not None and int(meta.get("step", step)) != int(step):
            self.metrics.count("checkpoint_fallbacks")
            tr = _trace_active()
            if tr is not None:
                tr.event("checkpoint.fallback", requested=int(step),
                         restored=int(meta.get("step", step)),
                         quarantined=dq)
        return tree, meta

    def _commit(self, step: int, extra_meta: Optional[dict] = None) -> None:
        tr = _trace_active()
        if tr is None:
            sd = self.trainer.state_dict()
            self.checkpointer.save(step, sd,
                                   meta={"seed": self.seed,
                                         **(extra_meta or {})})
        else:
            with tr.span("checkpoint.commit", step=step):
                sd = self.trainer.state_dict()
                self.checkpointer.save(step, sd,
                                       meta={"seed": self.seed,
                                             **(extra_meta or {})})
        self.metrics.count("checkpoint_commits")

    def _step_with_retry(self, step: int, data, labels):
        delay = self.backoff
        for attempt in range(self.max_retries + 1):
            # reseed per ATTEMPT: a failed try must not have advanced the
            # key counter a replay would then miss
            self._reseed(step)
            try:
                tr = _trace_active()
                if tr is None:
                    return self.trainer.step(data, labels)
                # one span per ATTEMPT: a retried step shows up as two
                # loop.step spans (the first tagged error=...), so the
                # timeline tells retry storms from clean runs
                with tr.span("loop.step", step=step, attempt=attempt):
                    return self.trainer.step(data, labels)
            except self.retryable:
                if attempt >= self.max_retries:
                    raise
                self.metrics.count("retries")
                time.sleep(delay)
                delay *= self.backoff_factor

    # ------------------------------------------------------------------ run
    def run(self, make_iter: Optional[Callable[[], Iterator]] = None,
            steps: Optional[int] = None, *,
            batch_fn: Optional[Callable[[int], Any]] = None) -> Dict:
        """Run (or resume) the training loop.

        ``make_iter``: zero-arg callable returning a FRESH iterator of
        ``(data, labels)`` batches — called once per ``run()``; on
        resume the first ``latest_step()`` batches are consumed and
        discarded to replay the offset.  ``batch_fn(step)`` is the
        random-access alternative (no replay cost).  ``steps`` is the
        total global step count (not steps-remaining).

        Returns a report dict: ``completed_steps``, ``resumed_from``,
        ``preempted``, ``retries``, ``final_loss``, ``bad_steps``,
        ``rewinds`` (the latter two only move when the trainer runs
        with guardrails compiled in).
        """
        if (make_iter is None) == (batch_fn is None):
            raise _base.MXNetError(
                "pass exactly one of make_iter= or batch_fn=")
        if steps is None or steps < 0:
            raise _base.MXNetError(f"steps must be >= 0, got {steps}")
        report = {"completed_steps": 0, "resumed_from": None,
                  "preempted": False, "retries": 0, "final_loss": None,
                  "bad_steps": 0, "rewinds": 0, "checkpoint_fallbacks": 0}
        retries_before = self.metrics.counters.get("retries", 0)
        bad_before = self.metrics.counters.get("bad_steps", 0)
        rewinds_before = self.metrics.counters.get("rewinds", 0)
        fallbacks_before = self.metrics.counters.get(
            "checkpoint_fallbacks", 0)
        start = 0
        latest = self.checkpointer.latest_step()
        if latest is not None:
            # shapes must exist before state can land: build from the
            # first batch of a throwaway iterator (offset untouched)
            if batch_fn is not None:
                probe = batch_fn(min(latest, max(steps - 1, 0)))
            else:
                probe = next(iter(make_iter()))
            data, labels = _normalize_batch(probe)
            self._ensure_built(data, labels)
            # verified restore: a corrupt latest step is quarantined and
            # the loop resumes from the newest INTACT step — start comes
            # from the restored meta, so the replay offset follows the
            # fallback automatically
            tree, meta = self._verified_restore(latest)
            self.trainer.load_state_dict(tree)
            start = int(meta.get("step", latest))
            report["resumed_from"] = start
            self.metrics.count("resumes")
        it = iter(make_iter()) if make_iter is not None else None
        if it is not None:
            for i in range(start):       # replay the data-iterator offset
                try:
                    next(it)
                except StopIteration:
                    raise _base.MXNetError(
                        f"resume replay failed: checkpoint is at step "
                        f"{start} but make_iter() yielded only {i} "
                        "batches — the iterator must cover GLOBAL steps, "
                        "not steps-remaining") from None

        self._stop_requested = False
        installed = self._install_sigterm()
        loss = None
        consecutive_bad = 0
        try:
            step = start
            while step < steps:
                batch = batch_fn(step) if batch_fn is not None else next(it)
                data, labels = _normalize_batch(batch)
                self._ensure_built(data, labels)
                result = self._step_with_retry(step, data, labels)
                if isinstance(result, tuple):   # guarded: (loss, flag)
                    loss, flag = result
                    consecutive_bad = self._handle_bad_step(
                        flag, consecutive_bad, step)
                else:
                    loss = result
                step += 1
                # read the flag ONCE per boundary: a SIGTERM landing
                # between a commit-check and a break-check must not
                # break without committing — it is simply seen at the
                # next boundary instead
                stop_requested = self._stop_requested
                if (step % self.save_every == 0 or step == steps
                        or stop_requested):
                    self._commit(step)
                if stop_requested and step < steps:
                    report["preempted"] = True
                    break
            report["completed_steps"] = step
        finally:
            self._restore_sigterm(installed)
        if loss is not None:
            try:
                report["final_loss"] = float(_host(loss))
            except Exception:
                report["final_loss"] = None
        report["retries"] = \
            self.metrics.counters.get("retries", 0) - retries_before
        report["bad_steps"] = \
            self.metrics.counters.get("bad_steps", 0) - bad_before
        report["rewinds"] = \
            self.metrics.counters.get("rewinds", 0) - rewinds_before
        report["checkpoint_fallbacks"] = \
            self.metrics.counters.get("checkpoint_fallbacks", 0) \
            - fallbacks_before
        return report

    # ------------------------------------------------------ bad-step policy
    def _handle_bad_step(self, flag, consecutive_bad: int,
                         step: int) -> int:
        """Apply ``on_bad_step`` to one guarded step's finite-flag;
        returns the updated consecutive-bad counter.  Reading the flag
        is the policy's (only) per-step device sync."""
        if bool(_host(flag)):
            return 0
        self.metrics.count("bad_steps")
        consecutive_bad += 1
        if self.on_bad_step == "raise":
            raise NonFiniteStepError(
                f"non-finite loss/gradients at step {step} "
                "(on_bad_step='raise'); the update was skipped, "
                "trainer state is intact")
        if self.on_bad_step == "rewind" and \
                consecutive_bad >= self.rewind_after:
            latest = self.checkpointer.latest_step()
            if latest is None:
                raise NonFiniteStepError(
                    f"{consecutive_bad} consecutive non-finite steps "
                    f"by step {step} and no committed checkpoint to "
                    "rewind to (on_bad_step='rewind')")
            tree, _meta = self._verified_restore(latest)
            self.trainer.load_state_dict(tree)
            self.metrics.count("rewinds")
            tr = _trace_active()
            if tr is not None:
                # _meta, not latest: a corrupt latest step means the
                # verified restore fell back to an older one
                tr.event("loop.rewind", step=step,
                         restored=int(_meta.get("step", latest)),
                         consecutive_bad=consecutive_bad)
            fr = _fr_active()
            if fr is not None:
                fr.record("loop.rewind", step=step,
                          restored=int(_meta.get("step", latest)),
                          consecutive_bad=consecutive_bad)
            return 0
        return consecutive_bad
