"""Elastic training on a Ray cluster with ``ElasticRayExecutor.run(fn)``.

Run from a Ray driver (ray required; the workers compute on the host):
    python horovod_tpu_torch/examples/ray/ray_elastic.py

Reference analog: ``horovod.ray.ElasticRayExecutor`` (``ray/elastic.py``)
— actors host the agent transport, actor loss shrinks the job, the
respawner grows it back; the training fn uses the ``hvd.elastic`` API
exactly as under ``hvdrun``. Synthetic data keeps the example hermetic.
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

    state = elastic.ObjectState(name="ray_elastic",
                                w=np.zeros((8, 1), np.float32), step=0)

    @elastic.run
    def fit(state):
        lr = 0.1
        for step in range(state.step, 200):
            shard = np.arange(hvd.rank(), len(x), hvd.size())
            xb, yb = x[shard], y[shard]
            grad = 2 * xb.T @ (xb @ state.w - yb) / len(shard)
            state.w = state.w - lr * np.asarray(
                hvd.allreduce(grad, op=hvd.Average, name="g"))
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
    from horovod_tpu_torch.ray import ElasticRayExecutor

    ex = ElasticRayExecutor(min_np=1, max_np=4)
    ex.start()
    results = ex.run(train)
    print("per-rank results:", results)
    assert all(r["loss"] < 1e-3 for r in results)


if __name__ == "__main__":
    main()
