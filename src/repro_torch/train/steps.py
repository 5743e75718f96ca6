"""train_step / prefill_step / decode_step builders for every family —
twin of ``repro.train.steps``.

Gradients come from ``torch.autograd``.  Microbatched gradient
accumulation sums each microbatch's gradients in fp32 and averages them
(the reference's ``lax.scan`` over microbatches).  The loss adds the
MoE router's aux loss and the multi-token-prediction term where the
config has them; the encoder-decoder encodes ``frames`` and decodes the
tokens, and its prefill and decode carry ``(caches, enc_out)``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig, cross_entropy
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def _loss_fn(params, cfg: ModelConfig, rules, batch):
    if cfg.is_encoder_decoder:
        enc_out = encdec_lib.encode(params, cfg, rules, batch["frames"])
        tokens = batch["tokens"]
        logits, _ = encdec_lib.decode(params, cfg, rules, tokens[:, :-1],
                                      enc_out)
        loss = cross_entropy(logits, tokens[:, 1:])
        return loss, {"loss": loss}
    tokens = batch["tokens"]
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    logits, _, aux, hidden = tfm.forward(params, cfg, rules, tokens[:, :-1],
                                         prefix_embeds=prefix,
                                         return_hidden=True)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
        hidden = hidden[:, prefix.shape[1]:]
    loss = cross_entropy(logits, tokens[:, 1:])
    metrics = {"loss": loss}
    total = loss
    if cfg.num_experts:
        total = total + cfg.router_aux_weight * aux
        metrics["aux_loss"] = aux
    if cfg.mtp_depth:
        # MTP: predict token t+2 from (hidden_t, emb(token_{t+1})).
        mtp = tfm.mtp_logits(params, cfg, rules, hidden[:, :-1],
                             tokens[:, 1:-1],
                             torch.arange(tokens.shape[1] - 2,
                                          device=tokens.device))
        mtp_loss = cross_entropy(mtp, tokens[:, 2:])
        total = total + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    return total, metrics


def loss_and_grads(params, cfg: ModelConfig, rules, batch):
    """(loss, metrics, grads): grads a tree like ``params`` in the
    parameters' dtypes (zeros for a leaf the loss does not reach)."""
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
    """prefill(params, batch) -> (next_token_logits, carry); the carry is
    the caches, and the encoder-decoder's ``(caches, enc_out)``."""

    @torch.no_grad()
    def prefill(params, batch):
        if cfg.is_encoder_decoder:
            enc_out = encdec_lib.encode(params, cfg, rules, batch["frames"])
            caches = encdec_lib.init_caches(
                cfg, batch["tokens"].shape[0], max_len, cfg.cdtype,
                enc_out.device)
            logits, caches = encdec_lib.decode(
                params, cfg, rules, batch["tokens"], enc_out, caches=caches)
            return logits[:, -1], (caches, enc_out)
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
    (logits [B, V], new_carry).  carry = caches (+ enc_out)."""

    @torch.no_grad()
    def decode(params, carry, token, position):
        pos = torch.as_tensor(position, device=token.device).reshape(1)
        if cfg.is_encoder_decoder:
            caches, enc_out = carry
            logits, caches = encdec_lib.decode(params, cfg, rules, token,
                                               enc_out, positions=pos,
                                               caches=caches)
            return logits[:, -1], (caches, enc_out)
        logits, caches, _ = tfm.forward(params, cfg, rules, token,
                                        positions=pos, caches=carry)
        return logits[:, -1], caches

    return decode


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: adamw.OptConfig):
    init = (encdec_lib.init_model if cfg.is_encoder_decoder
            else tfm.init_model)
    params, specs = init(gen, cfg)
    return TrainState(params, adamw.init(params, opt_cfg)), specs
