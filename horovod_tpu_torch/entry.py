"""Entry point: the flagship transformer's forward at full width, with its
example arguments.

Mirrors ``__graft_entry__.py`` (``_flagship_cfg`` and ``entry``) at the
root of the repository: the same configuration and the same numpy seeds
(0 for the parameters, 1 for the batch), so both packages start from the
same weights and tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  from_jax_params,
                                                  init_params, make_forward)

BATCH = 8


def _flagship_cfg(tiny: bool = False) -> TransformerConfig:
    if tiny:
        return TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                 n_layers=4, d_ff=128, max_seq=64,
                                 dtype=torch.float32)
    return TransformerConfig(vocab_size=32000, d_model=512, n_heads=8,
                             n_layers=4, d_ff=2048, max_seq=256,
                             dtype=torch.bfloat16)


def entry(device=None, tiny: bool = False):
    """``(fn, (model, tokens, targets))``: the flagship's loss-only forward
    and its arguments, batch 8 at ``max_seq``. ``device=None`` means this
    process's card and raises without one; ``device="cpu"`` runs on the
    CPU."""
    cfg = _flagship_cfg(tiny)
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    model.load_state_dict(from_jax_params(init_params(np.random.RandomState(0),
                                                      cfg)))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (BATCH, cfg.max_seq)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    tokens = torch.from_numpy(tokens).long().to(dev)
    targets = torch.from_numpy(targets).long().to(dev)
    return make_forward(cfg), (model, tokens, targets)
