"""Elastic Keras training: model.fit + the elastic fit-callback trio.

Run with a changing world:
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \
        --host-discovery-script ./discover.sh \
        python horovod_tpu_torch/examples/keras/keras_elastic_mnist.py
(Keras runs on the host: the CPU only.)

Reference analog:
``examples/elastic/tensorflow2/tensorflow2_keras_mnist_elastic.py`` —
``@hvd.elastic.run`` retries a fit-based training function; the state
tracks model + optimizer + epoch/batch counters, and the callbacks keep
them current (Update* first, CommitStateCallback LAST). Synthetic data
keeps the example hermetic.
"""

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.keras as hvd


def make_data(n=2048, d=64, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int64)
    return x, y


def main():
    hvd.init()
    tf.random.set_seed(0)
    x, y = make_data()

    model = tf.keras.Sequential([
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])
    base_lr = 1e-3
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.Adam(base_lr * hvd.size()))
    model.compile(optimizer=opt,
                  loss=tf.keras.losses.SparseCategoricalCrossentropy(
                      from_logits=True),
                  run_eagerly=True)
    model.fit(x[:64], y[:64], epochs=1, batch_size=64, verbose=0)  # build

    state = hvd.elastic.KerasState(model, opt, epoch=0, batch=0)

    @hvd.elastic.run
    def train(state):
        opt.learning_rate.assign(base_lr * hvd.size())
        shard = np.arange(hvd.rank(), len(x), hvd.size())
        model.fit(
            x[shard], y[shard],
            epochs=3, initial_epoch=state.epoch, batch_size=64,
            verbose=1 if hvd.rank() == 0 else 0,
            callbacks=[
                hvd.callbacks.MetricAverageCallback(),
                hvd.elastic.UpdateBatchStateCallback(state),
                hvd.elastic.UpdateEpochStateCallback(state),
                hvd.elastic.CommitStateCallback(state,
                                                batches_per_commit=8),
            ])

    train(state)
    if hvd.rank() == 0:
        print(f"done at epoch {state.epoch} (world size {hvd.size()})")
    hvd.shutdown()


if __name__ == "__main__":
    main()
