"""Inputs and weights from ``--seed``: the one general generator that every
traffic mix's data file feeds.

Everything is drawn on the device the run uses, with a ``torch.Generator``
on that device, in a few large calls. A batch is the GLOBAL batch (every
rank's rows); each rank takes its block. Every seed gives the same sizes
and the same amount of work: a seed changes values, never shapes.

Traffic kinds (the ``kind`` key of a mix's file):

* ``images``: ``rows_per_rank`` images of ``channels`` x ``image_size`` x
  ``image_size``, uniform in [0, 1), and labels uniform over
  ``classes``.
* ``mlm_nsp``: ``rows_per_rank`` sequences of ``seq_len`` token ids
  uniform over the configuration's vocabulary; each row's length uniform
  in [``min_len``, ``max_len``] (the rest is padding, masked out of
  attention); segment ids 0 for the first half of the positions and 1 for
  the rest; each kept token masked for the masked-LM loss with
  probability ``mask_prob``, its label uniform over the vocabulary; the
  next-sentence labels uniform over {0, 1}.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

_M64 = (1 << 64) - 1


def sub_seed(seed: int, *tags) -> int:
    """A generator seed (63 bits) for one purpose of one run, from the
    run's seed and a few tags (splitmix64 over each)."""
    x = int(seed) & _M64
    for t in tags:
        t = t if isinstance(t, int) else int.from_bytes(
            str(t).encode()[:8].ljust(8, b"\0"), "little")
        x = (x + 0x9E3779B97F4A7C15 + (t & _M64)) & _M64
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
        x ^= x >> 31
    return x >> 1


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def draw_weights(shapes: Dict[str, Tuple[Tuple[int, ...], str]],
                 init: Callable[[Tuple[int, ...], str], Tuple[str, float]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``shapes`` (``name -> (shape, role)``) in float32:
    ``init(shape, role)`` gives ``("normal", std)`` or ``("fill",
    value)``. The normal ones are slices of ONE draw, scaled in place."""
    plan = {n: init(s, r) for n, (s, r) in shapes.items()}
    total = sum(torch.Size(shapes[n][0]).numel()
                for n, (how, _) in plan.items() if how == "normal")
    flat = torch.randn(total, generator=_gen(device, sub_seed(seed, "w")),
                       device=device)
    out, off = {}, 0
    for n, (how, v) in plan.items():
        shape = shapes[n][0]
        if how == "normal":
            k = torch.Size(shape).numel()
            out[n] = flat[off:off + k].view(shape).mul_(v)
            off += k
        elif how == "fill":
            out[n] = torch.full(shape, float(v), device=device)
        else:
            raise ValueError(f"unknown initializer {how!r} for {n}")
    return out


def images(traffic: dict, cfg: dict, seed: int, index: int, ranks: int,
           device) -> Dict[str, torch.Tensor]:
    g = _gen(device, sub_seed(seed, "batch", index))
    rows, size = traffic["rows_per_rank"] * ranks, traffic["image_size"]
    return {"images": torch.rand(rows, traffic["channels"], size, size,
                                 generator=g, device=device),
            "labels": torch.randint(0, traffic["classes"], (rows,),
                                    generator=g, device=device)}


def mlm_nsp(traffic: dict, cfg: dict, seed: int, index: int, ranks: int,
            device) -> Dict[str, torch.Tensor]:
    g = _gen(device, sub_seed(seed, "batch", index))
    rows, S = traffic["rows_per_rank"] * ranks, traffic["seq_len"]
    vocab = cfg["vocab_size"]
    pos = torch.arange(S, device=device)[None]
    lengths = torch.randint(traffic["min_len"], traffic["max_len"] + 1,
                            (rows, 1), generator=g, device=device)
    keep = pos < lengths
    ids = torch.randint(0, vocab, (rows, S), generator=g, device=device)
    labels = torch.randint(0, vocab, (rows, S), generator=g, device=device)
    masked = (torch.rand(rows, S, generator=g, device=device)
              < traffic["mask_prob"]) & keep
    return {"input_ids": ids,
            "token_type_ids": (pos >= S // 2).long().expand(rows, S)
            .contiguous(),
            "attention_mask": keep,
            "mlm_labels": labels,
            "mlm_mask": masked.float(),
            "nsp_labels": torch.randint(0, 2, (rows,), generator=g,
                                        device=device)}


KINDS = {"images": images, "mlm_nsp": mlm_nsp}


def batch(traffic: dict, cfg: dict, seed: int, index: int, device
          ) -> Dict[str, torch.Tensor]:
    """Global batch ``index`` of a run: every rank's rows."""
    return KINDS[traffic["kind"]](traffic, cfg, seed, index,
                                  traffic["ranks"], device)


def rank_block(b: Dict[str, torch.Tensor], rank: int, ranks: int
               ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s contiguous block of a global batch's rows."""
    out = {}
    for k, t in b.items():
        n = t.shape[0] // ranks
        out[k] = t.narrow(0, rank * n, n)
    return out
