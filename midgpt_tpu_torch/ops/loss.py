"""Cross-entropy of the lm head (counterpart of ``midgpt_tpu.ops.loss``).

``chunked_softmax_xent`` computes the head projection and the loss
T-chunk by T-chunk; each chunk runs under ``torch.utils.checkpoint``, so
its ``[B, ct, V]`` f32 logits are recomputed in the backward instead of
kept, and the full ``[B, T, V]`` logits never exist. The math is the
dense loss's: logits in f32, ``logsumexp - target logit``, mean over all
B*T tokens.

Under a tensor axis (``tensor``, a ``parallel.tensor`` exchange) the
head weight is the held shards' ``[D, V / tp]`` columns and the loss is
vocab-parallel (:class:`_VocabXent`, one autograd Function): each rank's
f32 logits ``[.., V / tp]``, their max all-reduced (MAX), the sum of
``exp(z - max)`` all-reduced (SUM), the target logit from the rank that
owns it all-reduced (SUM); the backward is the local softmax less the
local one-hot. The head's input takes ``copy_to_tensor``. Inside the
chunked loss's checkpoint these collectives run again in the recompute.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.utils.checkpoint

from midgpt_tpu_torch.parallel.tensor import (
    TensorExchange,
    copy_to_tensor,
    held_shard,
)


class _VocabXent(torch.autograd.Function):
    """Per-token cross-entropy from the held shards' f32 logits ``zs``
    (``[..., V / tp]`` each, shard ``j`` covering vocabulary ids
    ``los[j] ..``) against ``targets``."""

    @staticmethod
    def forward(ctx, targets, ex, los, *zs):
        m = zs[0].amax(-1)
        for z in zs[1:]:
            m = torch.maximum(m, z.amax(-1))
        m = ex.all_reduce(m, "max")
        s = sum(torch.exp(z - m[..., None]).sum(-1) for z in zs)
        s = ex.all_reduce(s)
        z_y = torch.zeros_like(m)
        # each shard's minus one-hot of the targets it owns: the
        # backward's, and its dot with z the target logit
        onehots = []
        for z, lo in zip(zs, los):
            local = targets.long() - lo
            inside = (local >= 0) & (local < z.shape[-1])
            local = local.clamp(0, z.shape[-1] - 1)[..., None]
            onehots.append((local, -inside[..., None].to(z.dtype)))
            z_y = z_y + torch.where(
                inside, torch.gather(z, -1, local)[..., 0], 0.0)
        z_y = ex.all_reduce(z_y)
        lse = m + torch.log(s)
        ctx.save_for_backward(lse, *zs, *(t for o in onehots for t in o))
        return lse - z_y

    @staticmethod
    def backward(ctx, g):
        lse, *rest = ctx.saved_tensors
        n = len(rest) // 3
        grads = []
        g = g[..., None]
        for i, z in enumerate(rest[:n]):
            local, neg = rest[n + 2 * i], rest[n + 2 * i + 1]
            # g p + (-g) one-hot, summed as autograd sums the whole
            # loss's logsumexp and gather gradients: one shard gives the
            # whole loss's bits
            grads.append((torch.exp(z - lse[..., None]) * g).scatter_add(
                -1, local, neg * g))
        return (None, None, None, *grads)


def xent_sum(h: torch.Tensor, head_w: torch.Tensor,
             targets: torch.Tensor,
             tensor: tp.Optional[TensorExchange] = None) -> torch.Tensor:
    """Summed cross-entropy of ``h [..., D] @ head_w [D, V]`` against
    integer ``targets [...]``, with the logits in f32 (under ``tensor``
    vocab-parallel: ``head_w`` the held shards' columns)."""
    if tensor is None:
        z = (h @ head_w).to(torch.float32)
        lse = torch.logsumexp(z, dim=-1)
        z_y = torch.gather(z, -1, targets[..., None].long())[..., 0]
        return (lse - z_y).sum()
    h = copy_to_tensor(h, tensor)
    shards = tensor.shards()
    vl = head_w.shape[-1] // len(tensor.held)
    zs = [(h @ held_shard(head_w, j, tensor, -1)).to(torch.float32)
          for j, _ in shards]
    return _VocabXent.apply(targets, tensor, [r * vl for _, r in shards],
                            *zs).sum()


def dense_softmax_xent(h: torch.Tensor, head_w: torch.Tensor,
                       targets: torch.Tensor,
                       tensor: tp.Optional[TensorExchange] = None
                       ) -> torch.Tensor:
    """Mean cross-entropy over all tokens from the full logits."""
    return xent_sum(h, head_w, targets, tensor) / targets.numel()


def chunked_softmax_xent(
    h: torch.Tensor,  # [B, T, D] final hidden states (compute dtype)
    head_w: torch.Tensor,  # [D, V] lm-head weight (compute dtype)
    targets: torch.Tensor,  # [B, T] int
    *,
    chunk_t: int = 128,
    tensor: tp.Optional[TensorExchange] = None,
) -> torch.Tensor:
    """Mean cross-entropy over all B*T tokens, the dense loss's math."""
    b, t, _ = h.shape
    if t % chunk_t:
        raise ValueError(f"T={t} not divisible by chunk_t={chunk_t}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, t, chunk_t):
        sl = slice(lo, lo + chunk_t)
        # no RNG state to keep: reading the card's is refused while a CUDA
        # graph captures the train step
        total = total + torch.utils.checkpoint.checkpoint(
            xent_sum, h[:, sl], head_w, targets[:, sl], tensor,
            use_reentrant=False, preserve_rng_state=False)
    return total / (b * t)
