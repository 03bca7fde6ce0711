"""Per-request seeded sampling (counterpart of
``mxnet_tpu/serving/sampling.py``).

``temperature <= 0`` is an exact argmax.  Otherwise the row's logits are
temperature-scaled, top-k then nucleus (top-p) filtered, and drawn by
Gumbel-argmax.  The noise is a counter-based hash computed on the
device: Philox-4x32-10 keyed by the request seed, its counter the
(vocabulary index, absolute position of the consumed token) pair.  So a
request's stream does not depend on which other requests share its
batch, the same seed gives the same stream, and a speculative verify,
which samples every window position at its own position, draws what
plain decode draws there.  The hash runs in 32-bit lanes held in int64
tensors, each 32 x 32-bit product split in 16-bit halves so that no
intermediate overflows, which gives the same bits on the CPU and on the
card.

Nothing here reads the device from the host: both the argmax and the
sampled token are computed for every row and one is selected by
``torch.where``, so a sampling call can be captured in a CUDA graph.
Philox is not jax's threefry: sampled streams match the reference's
contracts, not its bits; greedy streams match token for token.
"""
from __future__ import annotations

import torch

__all__ = ["sample_tokens", "philox4x32", "uniform_from_words",
           "gumbel_noise"]

_NEG = -1e30
_MASK = 0xFFFFFFFF
# Philox-4x32's multipliers and Weyl key increments (Salmon et al.,
# "Parallel random numbers: as easy as 1, 2, 3", SC 2011)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_ROUNDS = 10


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit halves of ``m * x`` for a 32-bit constant ``m``
    and int64 ``x`` in [0, 2**32): ``m`` split in 16-bit halves keeps
    every product below 2**48."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = _ROUNDS):
    """Philox-4x32 over int64 tensors holding 32-bit words (broadcast
    together): the counter (c0, c1, c2, c3) under the key (k0, k1) →
    four int64 tensors of 32-bit words."""
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def uniform_from_words(words):
    """Uniforms strictly inside (0, 1), float32, from int64 tensors of
    32-bit words: the top 23 bits plus a half, scaled by 2**-23, which
    float32 holds exactly, so the largest is 1 - 2**-24 and the noise
    ``-log(-log(u))`` stays finite (24 bits plus a half would round the
    top word to 1.0)."""
    return ((words >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def gumbel_noise(seeds, positions, vocab: int):
    """Gumbel(0, 1) noise (B, vocab) float32 for int64 request ``seeds``
    (B,) at absolute ``positions`` (B,): one Philox call gives four
    vocabulary entries, each word a uniform (``uniform_from_words``)."""
    dev = seeds.device
    groups = -(-vocab // 4)
    seeds = seeds.to(torch.int64)[:, None]
    k0, k1 = seeds & _MASK, (seeds >> 32) & _MASK
    c0 = torch.arange(groups, dtype=torch.int64, device=dev)[None, :]
    c1 = positions.to(torch.int64)[:, None] & _MASK
    zero = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32(c0, c1, zero, zero, k0, k1), dim=-1)
    words = words.reshape(seeds.shape[0], 4 * groups)[:, :vocab]
    return -torch.log(-torch.log(uniform_from_words(words)))


def _rows(x, dtype, dev):
    return torch.as_tensor(x, device=dev).to(dtype)


def sample_tokens(logits, temperature, top_k, top_p, seeds, positions):
    """One token per row of ``logits`` (B, V) → int32 (B,).

    ``temperature``/``top_p`` float32 (B,), ``top_k`` int32 (B,),
    ``seeds`` int64 (B,) request seeds, ``positions`` int (B,) the
    absolute position of the token each row just consumed (tensors on
    the logits' device, or host sequences).  ``top_k == 0`` and
    ``top_p == 1`` disable their filters; ties at the k-th value are
    kept; the top-1 token always survives the nucleus."""
    dev = logits.device
    b, v = logits.shape
    temperature = _rows(temperature, torch.float32, dev)
    top_k = _rows(top_k, torch.int64, dev)
    top_p = _rows(top_p, torch.float32, dev)
    arg = logits.argmax(dim=-1).to(torch.int32)
    # greedy rows take the argmax below; a unit temperature keeps their
    # (discarded) sampled path finite
    temp = torch.where(temperature > 0.0,
                       torch.clamp(temperature, min=1e-6),
                       torch.ones_like(temperature))
    lg = logits.float() / temp[:, None]
    desc = torch.sort(lg, dim=-1, descending=True).values
    kth = desc.gather(1, torch.clamp(top_k - 1, 0, v - 1)[:, None])
    neg = torch.full_like(lg, _NEG)
    use_k = top_k[:, None] > 0
    lg = torch.where(use_k & (lg < kth), neg, lg)
    # the top-k filtered row, sorted: the same values in the same order
    desc = torch.where(use_k & (desc < kth), neg, desc)
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    n_keep = torch.clamp(
        (cum < torch.clamp(top_p, max=1.0)[:, None]).sum(dim=-1), min=1)
    cut = desc.gather(1, (n_keep - 1)[:, None])
    lg = torch.where((top_p[:, None] < 1.0) & (lg < cut), neg, lg)
    noise = gumbel_noise(_rows(seeds, torch.int64, dev),
                         _rows(positions, torch.int64, dev), v)
    drawn = (lg + noise).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, arg, drawn)
