"""Elastic training on Spark clusters.

A copy of ``horovod_tpu/spark/elastic.py``. Reference:
``horovod.spark.run_elastic`` (``spark/runner.py:309-430``) — there, Spark
tasks host task services the driver execs workers through, and the
elastic driver treats the set of live task services as its host universe.
Same architecture here over the shared agent transport
(:mod:`horovod_tpu_torch.runner.elastic.agent`): every Spark task runs the
host agent loop; executor loss → heartbeat expiry → the driver shrinks;
Spark's task retry respawns the agent → the driver grows back. The data
plane is the ordinary ``torch.distributed`` rendezvous the workers set
up among themselves.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from horovod_tpu_torch.runner.elastic.agent import run_agent_elastic


def run_elastic(fn: Callable, args: tuple = (),
                kwargs: Optional[dict] = None,
                num_proc: Optional[int] = None,
                min_np: Optional[int] = None,
                max_np: Optional[int] = None,
                env: Optional[dict] = None,
                reset_limit: Optional[int] = None,
                verbose: int = 0) -> List[Any]:
    """Elastic ``horovod.spark.run_elastic`` contract
    (``spark/runner.py:309-430``): run ``fn`` — which uses the
    ``horovod_tpu_torch.elastic`` API internally, reference-style — on
    Spark tasks that may come and go, returning per-rank results of the
    generation that completed."""
    from horovod_tpu_torch.spark import _require_pyspark

    _require_pyspark()
    from pyspark.sql import SparkSession

    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    num_proc = num_proc or int(sc.defaultParallelism)

    def start_agents(ctx) -> Callable[[], None]:
        kv_addr, kv_port = ctx["kv_addr"], ctx["kv_port"]
        secret_hex = ctx["secret_hex"]
        world_secret_hex = ctx["world_secret_hex"]
        n = ctx["max_np"]

        def spark_job():
            def task(it):
                from horovod_tpu_torch.runner.elastic.agent import (
                    agent_loop, resolve_kv_addr)
                for ordinal in it:
                    agent_loop(int(ordinal), resolve_kv_addr(kv_addr),
                               kv_port, secret_hex, world_secret_hex)
                return iter([(0, b"")])

            sc.parallelize(range(n), n).mapPartitions(task).collect()

        job = threading.Thread(target=spark_job, daemon=True)
        job.start()
        return lambda: job.join(timeout=30)

    return run_agent_elastic(
        start_agents, fn, args, kwargs, num_proc=num_proc, min_np=min_np,
        max_np=max_np, env=env, reset_limit=reset_limit, verbose=verbose)
