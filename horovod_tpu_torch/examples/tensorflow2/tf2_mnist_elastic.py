"""Elastic TF2 training: TensorFlowKerasState + @hvd.elastic.run.

Run with a changing world:
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \
        --host-discovery-script ./discover.sh \
        python horovod_tpu_torch/examples/tensorflow2/tf2_mnist_elastic.py
(TensorFlow runs on the host: the CPU only.)

Reference analog: ``examples/elastic/tensorflow2/tensorflow2_mnist_elastic.py``
— the ``@hvd.elastic.run`` decorator retries the training function across
world-size changes; ``TensorFlowKerasState`` snapshots model + optimizer
variables together with scalar progress counters, restores them after a
failed commit window, and re-broadcasts from the coordinator after each
resize. Synthetic data keeps the example hermetic.
"""

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd
from horovod_tpu_torch.tensorflow.elastic import TensorFlowKerasState


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
    opt = tf.keras.optimizers.Adam(base_lr * hvd.size())
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)

    @tf.function
    def training_step(images, labels):
        with tf.GradientTape() as tape:
            logits = model(images, training=True)
            loss_value = loss_fn(labels, logits)
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss_value, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss_value

    # Materialise variables before building the elastic state so the
    # snapshot covers the full model + optimizer slot set.
    batch = 64
    training_step(x[:batch], y[:batch])

    state = TensorFlowKerasState(model, opt, batch=0, epoch=0)

    @hvd.elastic.run
    def train(state):
        # re-entered after every resize: keep lr proportional to the
        # CURRENT world size (reference analog: the on_state_reset
        # callback's opt.lr.assign)
        opt.learning_rate.assign(base_lr * hvd.size())
        for epoch in range(state.epoch, 3):
            loss_value = float("nan")  # a restore may land past the last step
            shard = np.arange(hvd.rank(), len(x), hvd.size())
            steps = len(shard) // batch
            for i in range(state.batch, steps):
                idx = shard[i * batch:(i + 1) * batch]
                loss_value = training_step(x[idx], y[idx])
                state.batch = i + 1
                if state.batch % 10 == 0:
                    state.commit()
            state.batch = 0
            state.epoch = epoch + 1
            state.commit()
            if hvd.rank() == 0:
                print(f"epoch {epoch} done, loss={float(loss_value):.4f} "
                      f"(world size {hvd.size()})")

    train(state)
    hvd.shutdown()


if __name__ == "__main__":
    main()
