"""Per-request seeded sampling (counterpart of
``mxnet_tpu/serving/sampling.py``).

``temperature <= 0`` is an exact argmax.  Otherwise the row's logits are
temperature-scaled, top-k then nucleus (top-p) filtered, and drawn by
Gumbel-argmax with noise from a ``torch.Generator`` seeded by the pair
(request seed, absolute position of the consumed token) alone — so a
request's stream does not depend on which other requests share its
batch, and the same seed gives the same stream.  torch's generators are
not jax's threefry: sampled streams match the reference's contracts,
not its bits; greedy streams match token for token.
"""
from __future__ import annotations

import torch

__all__ = ["sample_tokens"]

_NEG = -1e30
_MIX = 0x9E3779B97F4A7C15


def _draw_seed(seed: int, position: int) -> int:
    """A 63-bit generator seed from (request seed, position)."""
    return ((int(seed) * _MIX) ^ (int(position) * 0xBF58476D1CE4E5B9)) \
        & 0x7FFFFFFFFFFFFFFF


def sample_tokens(logits, temperature, top_k, top_p, seeds, positions):
    """One token per row of ``logits`` (B, V) → int32 (B,).

    ``temperature``/``top_p`` float32 (B,), ``top_k`` int32 (B,),
    ``seeds`` int (B,) request seeds, ``positions`` int (B,) the absolute
    position of the token each row just consumed.  ``top_k == 0`` and
    ``top_p == 1`` disable their filters; ties at the k-th value are
    kept; the top-1 token always survives the nucleus."""
    arg = logits.argmax(dim=-1).to(torch.int32)
    greedy = temperature <= 0.0
    if bool(greedy.all()):
        return arg
    v = logits.shape[-1]
    lg = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    desc = torch.sort(lg, dim=-1, descending=True).values
    kth = desc.gather(1, torch.clamp(top_k.long() - 1, 0, v - 1)[:, None])
    neg = torch.full_like(lg, _NEG)
    lg = torch.where((top_k[:, None] > 0) & (lg < kth), neg, lg)
    desc = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    n_keep = torch.clamp(
        (cum < torch.clamp(top_p, max=1.0)[:, None]).sum(dim=-1), min=1)
    cut = desc.gather(1, (n_keep - 1)[:, None])
    lg = torch.where((top_p[:, None] < 1.0) & (lg < cut), neg, lg)
    out = arg.clone()
    for i in torch.nonzero(~greedy).flatten().tolist():
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_draw_seed(seeds[i], positions[i]))
        u = torch.rand(v, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
        out[i] = (lg[i] + gumbel).argmax().to(torch.int32)
    return out
