"""Model registry: config -> init / steps bundle — twin of
``repro.models.model``.

The logical-name spec trees that init returns and the mesh rules are
plain data here.  The reference's ``param_pspecs``, ``state_pspecs``,
``cache_pspecs``, ``specs_to_pspecs`` and ``concretize_pspecs`` build
JAX ``PartitionSpec`` objects for a device mesh, which has no object on
one card: they are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import resolve_device
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig, generator, mesh_rules
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_lib


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    opt_cfg: adamw.OptConfig
    rules: dict
    device: torch.device

    def init_state(self, seed: int):
        """(TrainState, specs) with weights drawn from a generator on the
        bundle's device seeded with ``seed``."""
        return steps_lib.init_train_state(generator(seed, self.device),
                                          self.cfg, self.opt_cfg)

    def train_step(self, microbatches: int = 1):
        return steps_lib.make_train_step(self.cfg, self.opt_cfg,
                                         self.rules,
                                         microbatches=microbatches)

    def prefill_step(self, max_len: int):
        return steps_lib.make_prefill_step(self.cfg, self.rules,
                                           max_len=max_len)

    def decode_step(self):
        return steps_lib.make_decode_step(self.cfg, self.rules)

    def init_caches(self, batch: int, max_len: int):
        if self.cfg.is_encoder_decoder:
            return encdec_lib.init_caches(self.cfg, batch, max_len,
                                          self.cfg.cdtype, self.device)
        return tfm.init_caches(self.cfg, batch, max_len, self.cfg.cdtype,
                               self.device)


def build(cfg: ModelConfig, opt_cfg: Optional[adamw.OptConfig] = None,
          multi_pod: bool = False, sharded: bool = True, *,
          device="cuda") -> ModelBundle:
    """The bundle of ``cfg`` on ``device``.  ``sharded`` keeps the
    reference's mesh rules as data (nothing is sharded on one card)."""
    return ModelBundle(cfg=cfg, opt_cfg=opt_cfg or adamw.OptConfig(),
                       rules=mesh_rules(multi_pod) if sharded else {},
                       device=resolve_device(device))
