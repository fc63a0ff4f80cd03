"""TF-side synchronized batch normalization over the port's eager
collectives.

Mirrors ``horovod_tpu/tensorflow/sync_batch_norm.py`` (reference:
``horovod/tensorflow/sync_batch_norm.py``: SyncBatchNormalization
subclassing keras BatchNormalization and allreducing the moments). The TF
path is host-side (see the package docstring), so the layer is a
standalone ``tf.keras.layers.Layer`` whose training-time mean and mean of
squares are averaged over the process set by one grouped allreduce of
torch tensors, instead of hooking keras' private moment internals (which
moved between keras 2 and 3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from horovod_tpu_torch.common.basics import size
from horovod_tpu_torch.common.process_sets import (ProcessSet,
                                                   global_process_set)
from horovod_tpu_torch.ops import collectives as _C
from horovod_tpu_torch.ops.reduce_op import Average


def _tf():
    import tensorflow as tf
    return tf


def SyncBatchNormalization(axis: int = -1, momentum: float = 0.99,
                           epsilon: float = 1e-3, center: bool = True,
                           scale: bool = True,
                           process_set: ProcessSet = global_process_set,
                           name: Optional[str] = None):
    """Build a BatchNormalization layer whose training-time moments are
    averaged across the process set (reference behavior: per-rank moments
    allreduced so every replica normalizes with GLOBAL batch statistics)."""
    tf = _tf()

    # keras names an unnamed layer after its class: a leading underscore
    # ("_sync_batch_normalization", the JAX package's class name) is no
    # valid root name scope, so a first call under tf.function failed
    class SyncBatchNormalization(tf.keras.layers.Layer):
        def __init__(self) -> None:
            super().__init__(name=name)
            self.axis = axis
            self.momentum = momentum
            self.epsilon = epsilon
            self.center = center
            self.scale = scale
            self._process_set = process_set

        def build(self, input_shape):
            dim = int(input_shape[self.axis])
            self.gamma = self.add_weight(
                name="gamma", shape=(dim,), initializer="ones",
                trainable=self.scale)
            self.beta = self.add_weight(
                name="beta", shape=(dim,), initializer="zeros",
                trainable=self.center)
            self.moving_mean = self.add_weight(
                name="moving_mean", shape=(dim,), initializer="zeros",
                trainable=False)
            self.moving_variance = self.add_weight(
                name="moving_variance", shape=(dim,), initializer="ones",
                trainable=False)
            super().build(input_shape)

        def call(self, x, training=False):
            ndim = len(x.shape)
            ax = self.axis % ndim
            red = [d for d in range(ndim) if d != ax]
            if training:
                xf = tf.cast(x, tf.float32)
                mean = tf.reduce_mean(xf, axis=red)
                mean_sq = tf.reduce_mean(tf.square(xf), axis=red)
                if size() > 1:
                    # tf.py_function keeps this usable under tf.function
                    # (keras model.fit compiles train_step by default)
                    def _reduce(m, msq):
                        outs = _C.grouped_allreduce(
                            [torch.tensor(m.numpy()),
                             torch.tensor(msq.numpy())], op=Average,
                            name=f"sbn.{self.name}",
                            process_set=self._process_set)
                        return [o.numpy() for o in outs]

                    mean, mean_sq = tf.py_function(
                        _reduce, [mean, mean_sq],
                        [tf.float32, tf.float32])
                    mean.set_shape([x.shape[self.axis]])
                    mean_sq.set_shape([x.shape[self.axis]])
                var = mean_sq - tf.square(mean)
                # unbiased correction over the GLOBAL element count for the
                # running variance (as the reference torch SyncBatchNorm)
                n = int(np.prod([int(x.shape[d]) for d in red])) \
                    * max(self._process_set.size(), 1)
                corr = n / (n - 1) if n > 1 else 1.0
                self.moving_mean.assign(
                    self.momentum * self.moving_mean
                    + (1 - self.momentum) * mean)
                self.moving_variance.assign(
                    self.momentum * self.moving_variance
                    + (1 - self.momentum) * var * corr)
            else:
                mean = self.moving_mean
                var = self.moving_variance
            shape = [1] * ndim
            shape[ax] = -1
            mean = tf.reshape(mean, shape)
            var = tf.reshape(var, shape)
            gamma = tf.reshape(tf.cast(self.gamma, tf.float32), shape)
            beta = tf.reshape(tf.cast(self.beta, tf.float32), shape)
            y = (tf.cast(x, tf.float32) - mean) * tf.math.rsqrt(
                var + self.epsilon)
            return tf.cast(y * gamma + beta, x.dtype)

    return SyncBatchNormalization()
