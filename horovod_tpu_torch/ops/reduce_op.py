"""Reduction-op enumeration.

Mirrors ``horovod_tpu/ops/reduce_op.py``: the reference's
``horovod_reduce_op_average/sum/adasum/min/max/product`` codes, with the
same int values, and the module-level aliases of its public names
(``horovod.torch.mpi_ops.Average`` etc.).
"""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
