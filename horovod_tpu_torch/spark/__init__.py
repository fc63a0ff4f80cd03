"""Spark cluster integration.

A copy of ``horovod_tpu/spark/__init__.py`` (reference:
``horovod/spark/runner.py``): ``horovod.spark.run(fn, ...)`` spawns task
services in Spark executors, collects host info on the driver, launches
the distributed job over them, and returns per-rank results (:197-306).
This module provides the same contract on top of the port: each Spark task
hosts one worker process, which drives one card (``cuda:<local_rank>``,
the local rank counted among the tasks on its executor's host).
``run_elastic`` rides the agent transport
(:mod:`horovod_tpu_torch.runner.elastic.agent`).

Importing it needs no pyspark: ``run`` and ``run_elastic`` check for it
when called. The Store abstraction (reference:
``spark/common/store.py:36-530``) and the estimators (torch, and Keras over
the port's TF shim) work without Spark.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional

from horovod_tpu_torch.spark.store import (  # noqa: F401
    FilesystemStore, LocalStore, Store)
from horovod_tpu_torch.spark.estimator import (  # noqa: F401
    HorovodEstimator, HorovodModel)
from horovod_tpu_torch.spark.torch_estimator import (  # noqa: F401
    TorchEstimator, TorchModel)
from horovod_tpu_torch.spark.keras_estimator import (  # noqa: F401
    KerasEstimator, KerasModel)


def run_elastic(*args, **kwargs):
    """Elastic Spark launch (reference: ``horovod.spark.run_elastic``,
    ``spark/runner.py:309``); see :mod:`horovod_tpu_torch.spark.elastic`."""
    from horovod_tpu_torch.spark.elastic import run_elastic as _impl
    return _impl(*args, **kwargs)


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark, which is not "
            "installed in this environment. Install pyspark to use "
            "Spark-cluster launching; the rest of horovod_tpu_torch works "
            "without it.") from e


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        num_proc: Optional[int] = None, env: Optional[dict] = None,
        verbose: int = 1) -> List[Any]:
    """Run ``fn`` on ``num_proc`` Spark tasks with horovod_tpu_torch
    initialized (reference: ``horovod.spark.run``,
    ``spark/runner.py:197-306``).

    Strategy: a barrier-mode Spark job where every task reports its host to
    the driver via the accumulated host list, then rank 0's host runs the
    rendezvous store and each task execs the worker fn — mirroring the
    reference's task-service handshake with Spark's own scheduling.
    """
    _require_pyspark()
    from pyspark.sql import SparkSession

    from horovod_tpu_torch.common import payload as _payload

    kwargs = kwargs or {}
    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    num_proc = num_proc or int(sc.defaultParallelism)
    blob = _payload.dumps((fn, args, kwargs))
    extra_env = dict(env or {})

    def task(idx_it):
        import socket

        from pyspark import BarrierTaskContext

        from horovod_tpu_torch.common import payload
        from horovod_tpu_torch.runner.exec_run import reserve_port
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        hosts = [info.address.split(":")[0] for info in ctx.getTaskInfos()]
        coord = hosts[0]
        # rank 0 holds a free port on ITS host until its store binds it
        held = reserve_port() if rank == 0 else None
        my_port = str(held.getsockname()[1]) if held else ""
        coord_port = ctx.allGather(my_port)[0]
        os.environ.update(extra_env)
        os.environ.update({
            "HOROVOD_RANK": str(rank),
            "HOROVOD_SIZE": str(len(hosts)),
            # one card a task: the local rank among the tasks on this host
            "HOROVOD_LOCAL_RANK": str(hosts[:rank].count(hosts[rank])),
            "HOROVOD_LOCAL_SIZE": str(hosts.count(hosts[rank])),
            "HVD_TPU_COORD_ADDR": coord,
            "HVD_TPU_COORD_PORT": coord_port,
            "HVD_TPU_RENDEZVOUS_ADDR": coord,
            "HVD_TPU_RENDEZVOUS_PORT": coord_port,
            "HOROVOD_GLOO_RENDEZVOUS_ADDR": coord,
            "HOROVOD_GLOO_RENDEZVOUS_PORT": coord_port,
            "HOROVOD_HOSTNAME": socket.gethostname(),
        })
        ctx.barrier()
        f, a, k = payload.loads(blob)
        import horovod_tpu_torch as hvd
        try:
            hvd.init()
        finally:
            if held is not None:
                held.close()
        result = f(*a, **k)
        hvd.shutdown()
        return [(rank, payload.dumps(result))]

    rdd = sc.parallelize(range(num_proc), num_proc).barrier()
    gathered = rdd.mapPartitions(task).collect()
    out: List[Any] = [None] * num_proc
    for rank, res in gathered:
        out[rank] = _payload.loads(res)
    return out
