"""Elastic training on a Spark cluster with ``spark.run_elastic``.

Run from a Spark driver (pyspark required; the workers compute on the
host):
    python horovod_tpu_torch/examples/spark/elastic_run.py

Reference analog: ``horovod.spark.run_elastic`` (``spark/runner.py:309``)
— the training fn uses the ``hvd.elastic`` API exactly as it would under
``hvdrun``; Spark tasks host the worker processes, executor loss shrinks
the job, and Spark's task retry grows it back. Synthetic data keeps the
example hermetic.
"""

import numpy as np


def train():
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.elastic as elastic

    hvd.init()

    rng = np.random.RandomState(0)
    w_true = rng.randn(8, 1)
    x = rng.randn(512, 8).astype(np.float32)
    y = (x @ w_true).astype(np.float32)

    w = np.zeros((8, 1), np.float32)
    state = elastic.ObjectState(name="spark_elastic", w=w, step=0)

    @elastic.run
    def fit(state):
        lr = 0.1
        for step in range(state.step, 200):
            shard = np.arange(hvd.rank(), len(x), hvd.size())
            xb, yb = x[shard], y[shard]
            grad = 2 * xb.T @ (xb @ state.w - yb) / len(shard)
            gsum = hvd.allreduce(grad, op=hvd.Average, name="g")
            state.w = state.w - lr * np.asarray(gsum)
            state.step = step + 1
            if state.step % 50 == 0:
                state.commit()
        state.commit()

    fit(state)
    loss = float(np.mean((x @ state.w - y) ** 2))
    rank = hvd.rank()
    hvd.shutdown()
    return {"rank": rank, "loss": loss}


def main():
    import horovod_tpu_torch.spark as spark

    results = spark.run_elastic(train, num_proc=2, min_np=1, max_np=4)
    print("per-rank results:", results)
    assert all(r["loss"] < 1e-3 for r in results)


if __name__ == "__main__":
    main()
