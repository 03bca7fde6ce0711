"""Loss layers (counterpart of ``mxnet_tpu/gluon/loss.py``), written as
``hybrid_forward`` over ``F = mx.nd`` as the reference's are.  Each
returns one loss per sample (the mean over every axis but
``batch_axis``).  ``CTCLoss`` and ``SDMLLoss`` compute on tensors, as
the ops ``ctc_loss`` and ``sdml_loss`` (NDArrays go through ``invoke``
under those names): CTC is the reference's log-space forward recursion
(``optax.ctc_loss``, written here in torch), so an alignment that cannot
exist (a label longer than its input) gives its finite value, built
from ``log_epsilon``, not ``inf``."""
from __future__ import annotations

import math

import torch

from ..ndarray.ops import apply_op
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss",
           "CTCLoss", "PoissonNLLLoss", "SDMLLoss", "ctc_loss", "sdml_loss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(-F.abs(pred), act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * \
                    (F.Activation(-F.abs(pred), act_type="softrelu")
                     + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Sparse (class-index) or dense (distribution) labels."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = input1.reshape((input1.shape[0], -1))
        input2 = input2.reshape((input2.shape[0], -1))
        eps = 1e-12
        cos = F.sum(input1 * input2, axis=-1) / (
            F.norm(input1, axis=-1) * F.norm(input2, axis=-1) + eps)
        label = label.reshape((-1,))
        pos = 1.0 - cos
        neg = F.relu(cos - self._margin)
        loss = F.where(label == 1, pos, neg)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood, ``pred - target * log(pred)``
    (``exp(pred) - target * pred`` from logits), plus Stirling's
    ``ln(target!)`` term with ``compute_full``."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * F.log(target + 1e-12) - target +
                        0.5 * F.log(2 * math.pi *
                                    (target + 1e-12)))
            loss = loss + F.where(target > 1, stirling,
                                  F.zeros_like(stirling))
        # weight element by element (the upstream order), then reduce
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        if loss.ndim > 1:
            loss = F.mean(loss, axis=tuple(range(1, loss.ndim)))
        return loss


# log(+0) in the CTC recursion, as optax's ``log_epsilon``
_CTC_LOG_EPS = -1e5


def _ctc_forward(logits, logit_pad, labels, label_pad, blank=0):
    """Per-sequence CTC loss (B,) of ``logits`` (B, T, K) against
    ``labels`` (B, N) (right-padded; pads flagged 1.0 in ``label_pad``),
    frames flagged 1.0 in ``logit_pad`` skipped: the recursion of
    ``optax.ctc_loss`` over blank (phi) and label (emit) states."""
    b, t, k = logits.shape
    n = labels.shape[1]
    eps = _CTC_LOG_EPS
    logprobs = torch.log_softmax(logits, dim=-1)
    label_lens = n - label_pad.sum(dim=1).to(torch.int64)
    repeat = torch.zeros((b, n), dtype=logprobs.dtype,
                         device=logits.device)
    repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype)
    lp_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)    # (T, B, 1)
    lp_emit = torch.gather(
        logprobs, 2, labels[:, None, :].expand(b, t, n).long()
    ).transpose(0, 1)                                           # (T, B, N)
    pad = logit_pad.transpose(0, 1).to(logprobs.dtype)          # (T, B)

    def add_phi(phi, score):
        return torch.cat([phi[:, :1],
                          torch.logaddexp(phi[:, 1:], score)], dim=-1)

    phi = torch.full((b, n + 1), eps, dtype=logprobs.dtype,
                     device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), eps, dtype=logprobs.dtype,
                      device=logits.device)
    for step in range(t):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[step],
                                    emit + lp_emit[step])
        next_phi = add_phi(prev_phi + lp_phi[step],
                           emit + lp_phi[step] + eps * (1.0 - repeat))
        p = pad[step][:, None]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * prev_phi_orig + (1.0 - p) * next_phi
    last = add_phi(phi, emit)
    return -last.gather(1, label_lens[:, None])[:, 0]


def ctc_loss(pred, label, pred_lengths=None, label_lengths=None,
             layout="NTC", label_layout="NT"):
    """The ``ctc_loss`` op: blank is class 0; ``label`` padded with -1,
    or with ``label_lengths``; ``pred_lengths`` marks the frames past
    each input's end as padding."""
    tnc, tn = layout == "TNC", label_layout == "TN"
    args = [pred, label] + [x for x in (pred_lengths, label_lengths)
                            if x is not None]

    def fn(p, lab, *lens):
        if tnc:
            p = p.transpose(0, 1)
        if tn:
            lab = lab.transpose(0, 1)
        b, t, _k = p.shape
        n = lab.shape[1]
        lens = list(lens)
        if pred_lengths is not None:
            plen = lens.pop(0).to(torch.int64)
            logit_pad = (torch.arange(t, device=p.device)[None, :]
                         >= plen[:, None]).to(p.dtype)
        else:
            logit_pad = torch.zeros((b, t), dtype=p.dtype, device=p.device)
        if label_lengths is not None:
            llen = lens.pop(0).to(torch.int64)
            label_pad = (torch.arange(n, device=p.device)[None, :]
                         >= llen[:, None]).to(p.dtype)
        else:
            label_pad = (lab < 0).to(p.dtype)
        labels = torch.where(lab < 0, torch.zeros_like(lab), lab)
        return _ctc_forward(p, logit_pad, labels.to(torch.int64), label_pad)

    return apply_op("ctc_loss", fn, args)


class CTCLoss(Loss):
    """Connectionist temporal classification loss (parity:
    gluon.loss.CTCLoss): layout ``'NTC'`` or ``'TNC'``, label layout
    ``'NT'`` or ``'TN'``, blank class 0, labels padded with -1 (or given
    ``label_lengths``), ``pred_lengths`` for ragged inputs."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"unsupported layout {layout}")
        if label_layout not in ("NT", "TN"):
            raise ValueError(f"unsupported label_layout {label_layout}")
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        loss = ctc_loss(pred, label, pred_lengths, label_lengths,
                        self._layout, self._label_layout)
        if sample_weight is not None:
            loss = loss * sample_weight
        if self._weight is not None:
            loss = loss * self._weight
        return loss


def sdml_loss(x1, x2, smoothing_parameter=0.3):
    """The ``sdml_loss`` op: smoothed cross entropy over the batch of
    negative pairwise L2 distances between aligned rows."""
    def fn(a, b):
        n = a.shape[0]
        d = torch.sqrt(torch.clamp(
            torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1),
            min=1e-12))
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        smooth = smoothing_parameter / max(n - 1, 1)
        target = eye * (1 - smoothing_parameter) + (1 - eye) * smooth
        return -torch.sum(target * torch.log_softmax(-d, dim=-1), dim=-1)

    return apply_op("sdml_loss", fn, [x1, x2])


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss (parity: gluon/loss.py
    SDMLLoss): row i of ``x1`` pairs with row i of ``x2``, every other
    row of the batch is a negative."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = smoothing_parameter

    def forward(self, x1, x2):
        return sdml_loss(x1, x2, self._smoothing)
