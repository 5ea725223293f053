"""Training on one card (counterpart of ``midgpt_tpu.train``).

The optimizer is the JAX package's optax chain written out, not
``torch.optim.AdamW``: clip by global norm -> Adam (eps 1e-8, bias
correction with count + 1) -> ``+ (wd / lr_peak) * p`` on every
parameter -> ``x schedule(step)`` -> ``x -1``. AdamW's decay is
``lr_t * wd``; this chain's is ``lr_t * wd / lr_peak``, added after the
Adam normalisation.

The step keeps the JAX step's numerics:

- the forward runs on a compute-dtype copy of the f32 master parameters
  (``shadow``, refreshed from the masters before each step and eval);
- gradients are taken with respect to that copy and accumulate in its
  dtype across microbatches (``.grad +=`` in bf16, as JAX adds bf16
  gradient trees);
- the sum is divided by the microbatch count G and only then promoted to
  f32 for the update.

Dropout (``cfg.model.dropout > 0``) draws its masks from integer keys:
step ``s`` takes ``fold_in(cfg.seed, s)``, split into one key per
microbatch, as the JAX trainer folds the step into its PRNG key and
splits it G ways. The masks depend on (seed, step, microbatch) alone, so
a resumed run draws what an uninterrupted one would. Evals are
deterministic.

Left out against the JAX trainer: meshes and multi-process, K-step
dispatch windows, the remat out-of-memory step-down ladder, SIGTERM
handling, telemetry and anomaly monitors, MoE and pipeline stages,
``remat="dots"``, Orbax restore, the prefetch thread and the native
gather.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.checkpoint import Checkpointer, config_fingerprint
from midgpt_tpu_torch.config import ExperimentConfig, to_dict
from midgpt_tpu_torch.data import Loader, load_shard
from midgpt_tpu_torch.models.gpt import GPT, count_params, mlp_hidden_dim
from midgpt_tpu_torch.models.layers import fold_in, split
from midgpt_tpu_torch.ops.loss import chunked_softmax_xent, dense_softmax_xent
from midgpt_tpu_torch.utils.metrics import MetricLogger, mfu
from midgpt_tpu_torch.utils.platform import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# what the JAX package assumes when a backend reports no memory size
_DEFAULT_HBM_BYTES = int(16e9)


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def make_lr_schedule(cfg: ExperimentConfig) -> tp.Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, decay,
    min_lr)`` in f32: linear from 0 (the first lr is 0) to the peak over
    ``warmup_steps``, then cosine to ``min_lr`` over ``lr_decay_steps -
    warmup_steps`` (``decay_steps`` counts the warmup)."""
    f32 = np.float32
    peak, end = f32(cfg.learning_rate), f32(cfg.min_lr)
    warm = cfg.warmup_steps
    decay = cfg.lr_decay_steps - warm
    if decay <= 0:
        raise ValueError("lr_decay_steps must exceed warmup_steps")
    alpha = f32(0.0) if peak == 0 else f32(cfg.min_lr / cfg.learning_rate)

    def schedule(step: int) -> float:
        if step < warm:
            frac = f32(1) - f32(min(max(step, 0), warm)) / f32(warm)
            return float((f32(0) - peak) * frac + peak)
        count = f32(min(step - warm, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / f32(decay)))
        return float(peak * ((f32(1) - alpha) * cosine + alpha))

    return schedule


@dataclasses.dataclass
class TrainState:
    """f32 master parameters, Adam moments and the optimizer step (the
    Adam count and the schedule's step alike)."""

    model: GPT
    mu: tp.List[torch.Tensor]
    nu: tp.List[torch.Tensor]
    step: int = 0

    def items(self) -> tp.Dict[str, tp.Any]:
        names = [n for n, _ in self.model.named_parameters()]
        return {"params": self.model.state_dict(),
                "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu)),
                "step": self.step}

    def load_items(self, items: tp.Mapping[str, tp.Any]) -> None:
        self.model.load_state_dict(items["params"])
        names = [n for n, _ in self.model.named_parameters()]
        with torch.no_grad():
            for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
                for d, n in zip(dst, names):
                    d.copy_(items[key][n])
        self.step = int(items["step"])


def init_state(cfg: ExperimentConfig,
               device: tp.Union[None, str, torch.device] = None) -> TrainState:
    """Random init from ``cfg.seed`` in ``param_dtype``, zero moments."""
    model = GPT.init(cfg.model, torch.Generator().manual_seed(cfg.seed),
                     device=device, dtype=_dtype(cfg.param_dtype))
    return state_from_model(model)


def state_from_model(model: GPT) -> TrainState:
    params = list(model.parameters())
    return TrainState(model=model,
                      mu=[torch.zeros_like(p) for p in params],
                      nu=[torch.zeros_like(p) for p in params])


def make_shadow(model: GPT, dtype: torch.dtype) -> GPT:
    """A copy of ``model`` in the compute dtype, whose parameters take the
    gradients (refresh it with :func:`refresh_shadow`)."""
    return copy.deepcopy(model).to(dtype)


@torch.no_grad()
def refresh_shadow(shadow: GPT, model: GPT) -> None:
    for pc, pm in zip(shadow.parameters(), model.parameters()):
        pc.copy_(pm)  # casts to the compute dtype


def effective_loss_chunk(cfg: ExperimentConfig) -> tp.Optional[int]:
    """``cfg.loss_chunk``, disabled when the block size doesn't divide by
    it."""
    chunk = cfg.loss_chunk
    if chunk is None or cfg.model.block_size % chunk:
        return None
    return chunk


def loss_fn(model: GPT, x: torch.Tensor, y: torch.Tensor,
            loss_chunk: tp.Optional[int] = None,
            attn_impl: tp.Optional[str] = None,
            key: tp.Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy of ``model`` on ``x -> y`` (``[B, T]``), logits
    in f32; T-chunked with ``loss_chunk``; dropout drawn from ``key``,
    deterministic without one."""
    h = model.hidden(x, attn_impl, key, deterministic=key is None)
    head_w = model.head_weight(h.dtype)
    if loss_chunk is not None:
        return chunked_softmax_xent(h, head_w, y, chunk_t=loss_chunk)
    return dense_softmax_xent(h, head_w, y)


def global_norm(tensors: tp.Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor."""
    return torch.sqrt(torch.stack([torch.sum(t * t) for t in tensors]).sum())


@torch.no_grad()
def optimizer_update(state: TrainState, grads: tp.List[torch.Tensor],
                     cfg: ExperimentConfig, lr: float) -> torch.Tensor:
    """One update of the optax chain, in place on the f32 masters and
    moments. ``grads`` are f32, aligned with ``state.model.parameters()``.
    Returns the gradient's global norm (before clipping). No host sync."""
    params = list(state.model.parameters())
    norm = global_norm(grads)
    keep = norm < cfg.grad_clip
    grads = [torch.where(keep, g, (g / norm) * cfg.grad_clip) for g in grads]
    b1, b2 = cfg.beta1, cfg.beta2
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_add_(state.nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - b2))
    count = np.float32(state.step + 1)
    bc1 = float(np.float32(1) - np.float32(b1) ** count)
    bc2 = float(np.float32(1) - np.float32(b2) ** count)
    denom = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
    torch._foreach_add_(denom, 1e-8)
    upd = torch._foreach_div(torch._foreach_div(state.mu, bc1), denom)
    # the JAX package's decay, independent of the lr: wd / lr_peak
    wd = cfg.weight_decay / cfg.learning_rate
    torch._foreach_add_(upd, torch._foreach_mul(params, wd))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(params, upd)
    state.step += 1
    return norm


def train_step(state: TrainState, shadow: GPT, x: torch.Tensor,
               y: torch.Tensor, cfg: ExperimentConfig, lr: float,
               loss_chunk: tp.Optional[int] = None,
               step_key: tp.Optional[int] = None,
               ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on ``x, y [G, B, T]``: the G microbatches'
    gradients accumulate in the shadow's dtype, are divided by G, promoted
    to the masters' dtype and applied. With dropout, ``step_key`` is split
    into one key per microbatch. Returns ``(loss, grad_norm)`` as device
    scalars."""
    refresh_shadow(shadow, state.model)
    comp = list(shadow.parameters())
    for p in comp:
        p.grad = None
    g = x.shape[0]
    has_dropout = cfg.model.dropout > 0.0
    if has_dropout and step_key is None:
        raise ValueError("a config with dropout > 0 needs a step key")
    keys = split(step_key, g) if has_dropout else [None] * g
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(g):
        loss = loss_fn(shadow, x[i], y[i], loss_chunk, key=keys[i])
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    param_dtype = state.mu[0].dtype
    grads = [(p.grad / g).to(param_dtype) for p in comp]
    norm = optimizer_update(state, grads, cfg, lr)
    return loss_sum / g, norm


@torch.no_grad()
def evaluate(shadow: GPT, loader: Loader, n_batches: int, device,
             loss_chunk: tp.Optional[int] = None,
             seed_offset: int = 0) -> float:
    """Mean loss over every microbatch of ``n_batches`` peeked batches
    (steps disjoint from the training steps)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    n = 0
    for i in range(n_batches):
        xs, ys = loader.peek(10_000_000 + seed_offset + i)
        for x, y in zip(_to_device(xs, device), _to_device(ys, device)):
            total += loss_fn(shadow, x, y, loss_chunk)
            n += 1
    return float(total / n)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device=device, dtype=torch.long)


def estimate_hbm_fill(cfg: ExperimentConfig, hbm_bytes: int) -> float:
    """Estimated fraction of the card's memory filled by f32 params + Adam
    state + remat='none' activations (the JAX package's fit model on one
    device)."""
    m = cfg.model
    c, hkv = m.head_dim, m.kv_heads
    f = (m.n_head + 2 * hkv) * c
    mh = mlp_hidden_dim(m)
    hidden = 2 * mh if m.mlp == "swiglu" else mh
    per_layer_params = (m.n_embd * f + m.n_head * c * m.n_embd
                        + (3 if m.mlp == "swiglu" else 2) * m.n_embd * mh)
    n_params = m.n_layer * per_layer_params + 2 * m.vocab_size * m.n_embd
    state_bytes = n_params * 12  # f32 params + Adam m, v
    tokens = cfg.microbatch_size * m.block_size
    per_token_act = m.n_layer * (4 * m.n_embd + f + m.n_head * c + hidden) * 2
    return (state_bytes + tokens * per_token_act) / hbm_bytes


def resolve_auto_knobs(cfg: ExperimentConfig,
                       hbm_bytes: int) -> ExperimentConfig:
    """Resolve ``remat="auto"`` by the JAX package's memory-fit estimate,
    with the card's memory in place of the TPU's HBM: none below 0.78 of
    it (0.84 away from 16 GB), full above 0.92 (0.98). Between the two
    the JAX package picks "dots", which the port does not have: it
    raises."""
    m = cfg.model
    if m.remat != "auto":
        return cfg
    fill = estimate_hbm_fill(cfg, hbm_bytes)
    margin = 0.0 if abs(hbm_bytes - 16e9) / 16e9 < 0.25 else 0.06
    if fill <= 0.78 + margin:
        remat = "none"
    elif fill <= 0.92 + margin:
        raise ValueError(
            f"remat='auto' resolves to 'dots' (estimated fill {fill:.2f} of "
            f"{hbm_bytes / 1e9:.1f} GB), which the port does not have; set "
            f"model.remat='full' (or 'none' to risk running out of memory)")
    else:
        remat = "full"
    return dataclasses.replace(cfg, model=dataclasses.replace(m, remat=remat))


def model_fingerprint(cfg: ExperimentConfig) -> str:
    """Hash of the fields that change the parameters or the math; the
    implementation knobs may differ between save and resume."""
    fp = {k: v for k, v in to_dict(cfg.model).items()
          if k not in ("attn_impl", "norm_impl", "remat")}
    fp["mlp_hidden"] = mlp_hidden_dim(cfg.model)
    return config_fingerprint(fp)


def train(cfg: ExperimentConfig) -> tp.Dict[str, tp.Any]:
    """The training loop: eval at every ``eval_interval`` (and at the
    first step), one optimizer step per iteration, metrics every
    ``log_interval`` steps, checkpoints every ``ckpt_interval`` steps and
    at the end; resumes from the newest checkpoint in ``cfg.rundir``.
    Returns the final metrics: every step's loss under ``losses``; the
    loop's host seconds (``loop_s``) and the evals' and saves' share of
    them (``eval_s``, ``ckpt_s``); ``tokens_per_sec`` (and ``mfu`` on the
    card), every trained token over ``loop_s``."""
    if not cfg.rundir:
        raise ValueError("rundir required")
    device = resolve_device(cfg.device)
    hbm = (torch.cuda.get_device_properties(device).total_memory
           if device.type == "cuda" else _DEFAULT_HBM_BYTES)
    cfg = resolve_auto_knobs(cfg, hbm)
    t = cfg.model.block_size
    shape = (cfg.g_accum_iters, cfg.microbatch_size)
    train_loader = Loader(load_shard(os.path.join(cfg.data_dir, "train.bin")),
                          t, shape, cfg.data_seed)
    val_loader = Loader(load_shard(os.path.join(cfg.data_dir, "val.bin")),
                        t, shape, cfg.data_seed, stream=1)
    train_eval_loader = Loader(train_loader.tokens, t, shape, cfg.data_seed,
                               stream=2)
    schedule = make_lr_schedule(cfg)
    loss_chunk = effective_loss_chunk(cfg)
    ckpt_every = (cfg.ckpt_interval if cfg.ckpt_interval is not None
                  else cfg.eval_interval)
    ckpt = Checkpointer(cfg.rundir, keep=cfg.ckpt_keep,
                        save_interval_steps=ckpt_every)
    logger = MetricLogger(cfg.rundir, cfg)
    fingerprint = model_fingerprint(cfg)
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else None)

    state = init_state(cfg, device)
    print(f"parameters (non-embedding): {count_params(state.model) / 1e6:.2f}M")
    first_step = 0
    if ckpt.latest_step() is not None:
        items, meta = ckpt.restore(map_location=device)
        if meta.get("model_fingerprint") != fingerprint:
            raise ValueError("checkpoint was trained with a different model "
                             "config")
        state.load_items(items)
        train_loader.load_state_dict(meta["loader"])
        first_step = int(meta["step"]) + 1
        print(f"resumed from step {meta['step']}")
    shadow = make_shadow(state.model, _dtype(cfg.compute_dtype))

    def save(step: int, force: bool) -> None:
        ckpt.save(step, state.items(),
                  meta={"step": step, "loader": train_loader.state_dict(),
                        "model_fingerprint": fingerprint,
                        "config": to_dict(cfg)},
                  force=force)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def eval_loss(loader: Loader, itr: int) -> float:
        return evaluate(shadow, loader, cfg.eval_batches, device, loss_chunk,
                        0 if cfg.eval_fixed else itr)

    tokens_per_step = cfg.batch_size * t
    # eval_s / ckpt_s: host seconds of the evals and saves, each timed from
    # a synced card to a synced card; loop_s holds them and the steps
    final: tp.Dict[str, tp.Any] = {"remat": cfg.model.remat, "eval_s": 0.0,
                                   "ckpt_s": 0.0}

    def timed(key: str, fn: tp.Callable[[], tp.Any]) -> tp.Any:
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        final[key] += time.perf_counter() - t0
        return out

    losses: tp.List[torch.Tensor] = []
    sync()
    loop_t0 = time.perf_counter()
    # the first log's interval holds every step from the first one on
    last_log_time, last_log_step = loop_t0, first_step - 1
    for itr in range(first_step, cfg.max_steps):
        if itr % cfg.eval_interval == 0 or itr == first_step:
            refresh_shadow(shadow, state.model)
            train_loss, val_loss = timed("eval_s", lambda: (
                eval_loss(train_eval_loader, itr), eval_loss(val_loader, itr)))
            logger.log(itr, {"loss/train": train_loss, "loss/val": val_loss})
            final.update({"train_loss": train_loss, "val_loss": val_loss})
        x, y = train_loader.next()
        loss, gnorm = train_step(state, shadow, _to_device(x, device),
                                 _to_device(y, device), cfg, schedule(itr),
                                 loss_chunk, fold_in(cfg.seed, itr))
        losses.append(loss)
        if itr % cfg.log_interval == 0 and itr > 0:
            loss_v = float(loss)  # the one host read of a logging step
            now = time.perf_counter()
            tps = (tokens_per_step * (itr - last_log_step)
                   / max(now - last_log_time, 1e-9))
            last_log_time, last_log_step = now, itr
            metrics = {"loss/optimized": loss_v, "lr": schedule(itr),
                       "grad_norm": float(gnorm), "tokens_per_sec": tps}
            if device_name is not None:
                metrics["mfu"] = mfu(tps, cfg.model, device_name)
            logger.log(itr, metrics)
            final["loss"] = loss_v
        if itr % ckpt_every == 0:
            timed("ckpt_s", lambda: save(itr, force=False))

    refresh_shadow(shadow, state.model)
    final["val_loss"] = timed("eval_s",
                              lambda: eval_loss(val_loader, cfg.max_steps))
    logger.log(cfg.max_steps, {"loss/val": final["val_loss"]})
    if (cfg.max_steps > first_step
            and ckpt.latest_step() != cfg.max_steps - 1):
        timed("ckpt_s", lambda: save(cfg.max_steps - 1, force=True))
    sync()
    final["loop_s"] = time.perf_counter() - loop_t0
    # end to end: every trained token over the whole loop, evals and saves
    # included
    final["tokens_per_sec"] = (tokens_per_step * (cfg.max_steps - first_step)
                               / final["loop_s"])
    if device_name is not None:
        final["mfu"] = mfu(final["tokens_per_sec"], cfg.model, device_name)
    logger.close()
    final["losses"] = torch.stack(losses).tolist() if losses else []
    final["first_step"] = first_step
    return final
