"""train_step / prefill_step / decode_step builders — twin of
``repro.train.steps`` for the decoder-only families of part 1.

Gradients come from ``torch.autograd``.  Microbatched gradient
accumulation sums each microbatch's gradients in fp32 and averages them
(the reference's ``lax.scan`` over microbatches).  The encoder-decoder
raises :data:`repro_torch.models.PART2`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig, cross_entropy
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def _loss_fn(params, cfg: ModelConfig, rules, batch):
    tokens = batch["tokens"]
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    logits, _, _aux = tfm.forward(params, cfg, rules, tokens[:, :-1],
                                  prefix_embeds=prefix)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    loss = cross_entropy(logits, tokens[:, 1:])
    return loss, {"loss": loss}


def loss_and_grads(params, cfg: ModelConfig, rules, batch):
    """(loss, metrics, grads): grads a tree like ``params`` in the
    parameters' dtypes (zeros for a leaf the loss does not reach)."""
    tfm.check_supported(cfg)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = _loss_fn(p, cfg, rules, batch)
        flat = tree_leaves(p)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(x): (g if g is not None else torch.zeros_like(x))
             for x, g in zip(flat, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda x: by_id[id(x)], p))


def accumulate_grads(params, cfg: ModelConfig, rules, batch,
                     microbatches: int = 1):
    """(metrics, grads) of ``batch``; with microbatches, each one's
    gradients summed in fp32 and averaged, and the loss averaged."""
    if microbatches == 1:
        _, metrics, grads = loss_and_grads(params, cfg, rules, batch)
        return metrics, grads
    mb = batch["tokens"].shape[0] // microbatches
    grads = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    loss = 0.0
    for i in range(microbatches):
        mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l_i, _, g_i = loss_and_grads(params, cfg, rules, mbatch)
        grads = _tree_add(grads, g_i)
        loss = loss + l_i
    grads = tree_map(lambda g: g / microbatches, grads)
    return {"loss": loss / microbatches}, grads


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    return a + b


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig, rules, *,
                    microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch):
        metrics, grads = accumulate_grads(state.params, cfg, rules, batch,
                                          microbatches)
        new_params, new_opt, opt_metrics = adamw.update(
            grads, state.opt, state.params, opt_cfg)
        metrics.update(opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, rules, *, max_len: int):
    """prefill(params, batch) -> (next_token_logits, caches)."""
    tfm.check_supported(cfg)

    @torch.no_grad()
    def prefill(params, batch):
        tokens = batch["tokens"]
        prefix = batch.get("patches") if cfg.family == "vlm" else None
        s = tokens.shape[1] + (prefix.shape[1] if prefix is not None else 0)
        caches = tfm.init_caches(cfg, tokens.shape[0], max_len, cfg.cdtype,
                                 tokens.device)
        logits, caches, _ = tfm.forward(
            params, cfg, rules, tokens, prefix_embeds=prefix, caches=caches,
            positions=torch.arange(s, device=tokens.device))
        return logits[:, -1], caches

    return prefill


def make_decode_step(cfg: ModelConfig, rules):
    """decode(params, carry, token [B,1], position []) ->
    (logits [B, V], new_carry).  carry = caches."""
    tfm.check_supported(cfg)

    @torch.no_grad()
    def decode(params, carry, token, position):
        pos = torch.as_tensor(position, device=token.device).reshape(1)
        logits, caches, _ = tfm.forward(params, cfg, rules, token,
                                        positions=pos, caches=carry)
        return logits[:, -1], caches

    return decode


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: adamw.OptConfig):
    params, specs = tfm.init_model(gen, cfg)
    return TrainState(params, adamw.init(params, opt_cfg)), specs
