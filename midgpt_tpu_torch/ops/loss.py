"""Cross-entropy of the lm head (counterpart of ``midgpt_tpu.ops.loss``).

``chunked_softmax_xent`` computes the head projection and the loss
T-chunk by T-chunk; each chunk runs under ``torch.utils.checkpoint``, so
its ``[B, ct, V]`` f32 logits are recomputed in the backward instead of
kept, and the full ``[B, T, V]`` logits never exist. The math is the
dense loss's: logits in f32, ``logsumexp - target logit``, mean over all
B*T tokens. One card, so none of the JAX version's mesh branches.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint


def xent_sum(h: torch.Tensor, head_w: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of ``h [..., D] @ head_w [D, V]`` against
    integer ``targets [...]``, with the logits in f32."""
    z = (h @ head_w).to(torch.float32)
    lse = torch.logsumexp(z, dim=-1)
    z_y = torch.gather(z, -1, targets[..., None].long())[..., 0]
    return (lse - z_y).sum()


def dense_softmax_xent(h: torch.Tensor, head_w: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over all tokens from the full logits."""
    return xent_sum(h, head_w, targets) / targets.numel()


def chunked_softmax_xent(
    h: torch.Tensor,  # [B, T, D] final hidden states (compute dtype)
    head_w: torch.Tensor,  # [D, V] lm-head weight (compute dtype)
    targets: torch.Tensor,  # [B, T] int
    *,
    chunk_t: int = 128,
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
            xent_sum, h[:, sl], head_w, targets[:, sl], use_reentrant=False,
            preserve_rng_state=False)
    return total / (b * t)
