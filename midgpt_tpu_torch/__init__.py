"""midgpt_tpu_torch: the PyTorch/CUDA port of ``midgpt_tpu``.

A package of its own beside the JAX reference: it imports PyTorch, NumPy
and the standard library, never JAX and nothing of ``midgpt_tpu``. It
keeps the JAX package's module names and, at its public functions, its
tensor layouts. Two slices so far:

- serving: ``models.gpt`` (the decode and prefill paths),
  ``ops.paged_attn`` (the hand-written CUDA paged-decode kernel and its
  plain version), ``serving`` (paged KV pool and the continuous-batching
  engine);
- training: ``models.gpt`` (``GPT.hidden`` / ``GPT.forward``),
  ``ops.fused_attn`` (the hand-written CUDA fused QK-LayerNorm + RoPE +
  attention forward and combined backward, and their plain versions),
  ``ops.attention`` (the naive oracle), ``ops.loss``, ``data``,
  ``train``, ``checkpoint``, ``utils.metrics`` and ``launch``;

and ``convert`` (weights to and from the JAX model).
"""

from midgpt_tpu_torch.config import MODEL_CONFIGS, ModelConfig, get_model_config

__all__ = ["MODEL_CONFIGS", "ModelConfig", "get_model_config"]
