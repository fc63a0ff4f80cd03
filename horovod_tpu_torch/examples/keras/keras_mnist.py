"""Keras ``model.fit`` training with the Keras adapter.

Run single-process:          python horovod_tpu_torch/examples/keras/keras_mnist.py
Run multi-process (2 ranks): python -m horovod_tpu_torch.runner.launch -np 2 \
                                 python horovod_tpu_torch/examples/keras/keras_mnist.py
(Keras runs on the host: the CPU only.)

Reference analog: ``examples/keras/keras_mnist.py`` — wrap the optimizer
with ``hvd.DistributedOptimizer``, scale the LR by world size, and plug in
the three callbacks (broadcast at start, metric averaging, LR warmup).
Synthetic data keeps it hermetic.
"""

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.keras as hvd


def make_data(n=4096, d=64, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(n, classes)).argmax(-1)
    return x, tf.keras.utils.to_categorical(y, classes)


def main():
    hvd.init()
    x, y = make_data()
    shard = slice(max(hvd.rank(), 0), None, hvd.size())
    x, y = x[shard], y[shard]

    model = tf.keras.Sequential([
        tf.keras.layers.Dense(128, activation="tanh", input_shape=(64,)),
        tf.keras.layers.Dense(10, activation="softmax"),
    ])

    # reference recipe: scale LR by world size, warm it up over the first
    # epochs, and average gradients through the wrapped optimizer
    base_lr = 0.05
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=base_lr * hvd.size()))
    model.compile(optimizer=opt, loss="categorical_crossentropy",
                  metrics=["accuracy"], run_eagerly=True)

    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        # initial_lr is the UNSCALED base rate: the callback itself ramps
        # base_lr -> base_lr * size over the warmup epochs
        hvd.callbacks.LearningRateWarmupCallback(
            base_lr, warmup_epochs=2,
            steps_per_epoch=len(x) // 128, verbose=hvd.rank() == 0),
    ]
    model.fit(x, y, batch_size=128, epochs=4,
              callbacks=callbacks, verbose=2 if hvd.rank() == 0 else 0)
    hvd.shutdown()


if __name__ == "__main__":
    main()
