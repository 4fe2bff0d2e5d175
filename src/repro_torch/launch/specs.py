"""The training step builder and the guard's default configuration.

The step trains every family: `lm_loss` for the decoder LMs (dense,
MoE, the Mamba2 hybrid, xLSTM), `encdec_loss` for the encoder-decoder,
whose batches carry `src_emb` beside `tokens`.  The reference's module
also builds `ShapeDtypeStruct` cells for XLA's dry run; those are XLA
tooling and wait for ROADMAP.md queue 1: multi-device and XLA tooling.
"""
from __future__ import annotations

import torch

from repro_torch.core.guard import GuardConfig, guard_step
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import encdec_loss
from repro_torch.models.transformer import lm_loss
from repro_torch.optim import adamw

__all__ = ["GUARD_CFG", "make_train_step"]

GUARD_CFG = GuardConfig(m=3.0, warmup_steps=50, channels=2)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    accum_steps: int = 1,
                    guard_cfg: GuardConfig = GUARD_CFG):
    """Train step with optional gradient accumulation (microbatching).

    `train_step(model, opt_state, guard_state, batch)` returns
    `(model, opt_state, guard_state, metrics)`: the model's parameters
    and the optimizer's moments are updated in place, and every metric
    is a 0-dim device tensor (nothing is read back to the host).  With
    `accum_steps` = k the batch is split into k microbatches whose
    gradients are summed in `opt_cfg.grad_dtype` and divided by k
    (every batch entry, `src_emb` included, is split along its first
    axis).
    """
    loss_fn = encdec_loss if cfg.family == "encdec" else lm_loss

    def train_step(model, opt_state, guard_state, batch):
        params = dict(model.named_parameters())
        if accum_steps == 1:
            model.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(model, batch, cfg)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
        else:
            k = accum_steps
            acc_dt = getattr(torch, opt_cfg.grad_dtype)
            grads = {n: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for n, p in params.items()}
            lsum, per_micro = 0.0, []
            for micro in _split(batch, k):
                loss_i, m_i = loss_fn(model, micro, cfg)
                gi = torch.autograd.grad(loss_i, list(params.values()))
                for a, g in zip(grads.values(), gi):
                    a.add_(g.to(acc_dt))
                lsum = lsum + loss_i.detach()
                per_micro.append({n: v.detach() for n, v in m_i.items()})
            grads = {n: g / k for n, g in grads.items()}
            loss = lsum / k
            metrics = {n: torch.stack([m[n] for m in per_micro]).mean()
                       for n in per_micro[0]}
        loss = loss.detach()
        metrics = {n: v.detach() for n, v in metrics.items()}
        gnorm = adamw.global_norm(grads)
        # TEDA guard on (loss, grad-norm) telemetry — the paper's
        # detector deciding whether this step may touch the weights
        guard_state, verdict = guard_step(
            guard_state, torch.stack([loss.float(), gnorm]), guard_cfg)
        _, opt_state, om = adamw.update(
            grads, opt_state, params, opt_cfg, skip=verdict.skip)
        del grads
        model.zero_grad(set_to_none=True)
        metrics = dict(metrics, loss=loss, **om)
        return model, opt_state, guard_state, metrics

    return train_step


def _split(batch, k: int):
    """k microbatches along the batch axis."""
    for n, v in batch.items():
        if v.shape[0] % k:
            raise ValueError(f"batch {n!r} of {v.shape[0]} rows does not "
                             f"split into {k} microbatches")
    parts = {n: torch.chunk(v, k, dim=0) for n, v in batch.items()}
    return [{n: parts[n][i] for n in batch} for i in range(k)]
