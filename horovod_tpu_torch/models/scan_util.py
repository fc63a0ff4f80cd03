"""Multi-step chaining for the train-step factories.

Mirrors ``horovod_tpu/models/scan_util.py::multi_step``, whose ``lax.scan``
becomes a Python loop: PyTorch runs eagerly, so there is no compiled
program to put the chain in.
"""

from __future__ import annotations


def multi_step(one_step, n_carry: int, scan_steps: int):
    """Chain ``one_step`` into ``scan_steps`` sequential optimizer steps.

    ``one_step(*carry, *consts) -> (*carry, *outs)``: the first ``n_carry``
    arguments (and results) are the training state threaded through the
    chain, the rest are loop-invariant inputs. Returns a function of the
    same signature giving the final carry plus the LAST step's outs.

    SAME-BATCH semantics, as in the JAX package: every chained step
    consumes the same batch, so ``scan_steps > 1`` is K optimizer steps on
    one batch, not multi-batch training. ``scan_steps <= 1`` returns
    ``one_step`` unchanged.
    """
    if scan_steps <= 1:
        return one_step

    def chained(*args):
        carry, consts = args[:n_carry], args[n_carry:]
        for _ in range(scan_steps):
            res = one_step(*carry, *consts)
            carry, outs = res[:n_carry], res[n_carry:]
        return (*carry, *outs)

    return chained
