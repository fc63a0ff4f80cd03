"""Drop-in TensorFlow 2 training with the TF adapter.

Run single-process:          python horovod_tpu_torch/examples/tensorflow2/tf2_mnist.py
Run multi-process (2 ranks): python -m horovod_tpu_torch.runner.launch -np 2 \
                                 python horovod_tpu_torch/examples/tensorflow2/tf2_mnist.py
(TensorFlow runs on the host: the CPU only.)

Reference analog: ``examples/tensorflow2/tensorflow2_mnist.py`` — change
``import horovod.tensorflow as hvd`` to ``import
horovod_tpu_torch.tensorflow as hvd`` and keep the script:
DistributedGradientTape averages gradients across ranks, the first step
broadcasts variables from rank 0, the loss metric is allreduced. Synthetic
data keeps it hermetic.
"""

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd


def make_data(n=4096, d=64, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(n, classes)).argmax(-1).astype(np.int64)
    return x, y


def main():
    hvd.init()
    tf.random.set_seed(42)

    x, y = make_data()
    ds = (tf.data.Dataset.from_tensor_slices((x, y))
          .shard(hvd.size(), max(hvd.rank(), 0))
          .shuffle(1024, seed=1).batch(128).repeat(3))

    model = tf.keras.Sequential([
        tf.keras.layers.Dense(128, activation="tanh"),
        tf.keras.layers.Dense(10),
    ])
    loss_obj = tf.keras.losses.SparseCategoricalCrossentropy(
        from_logits=True)
    opt = tf.keras.optimizers.SGD(learning_rate=0.05, momentum=0.9)

    def training_step(images, labels, first_batch):
        with tf.GradientTape() as tape:
            loss = loss_obj(labels, model(images, training=True))
        # DistributedGradientTape averages gradients across ranks
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        if first_batch:
            # after the first apply so slot variables exist
            # (reference: tensorflow2_mnist.py broadcast on batch 0)
            hvd.broadcast_variables(model.variables, root_rank=0)
            opt_vars = opt.variables() if callable(opt.variables) \
                else opt.variables
            hvd.broadcast_variables(opt_vars, root_rank=0)
        return loss

    for step, (images, labels) in enumerate(ds):
        loss = training_step(images, labels, step == 0)
        if step % 20 == 0:
            avg = hvd.allreduce(loss, name="loss")
            if hvd.rank() == 0:
                print(f"step {step}: loss {float(avg):.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
