"""``horovod_tpu_torch.keras``: Keras callbacks and the optimizer wrapper
over the port's eager collectives.

Mirrors ``horovod_tpu/keras/__init__.py`` (reference: ``horovod/keras`` +
``horovod/_keras/callbacks.py``: ``BroadcastGlobalVariablesCallback`` :23,
``MetricAverageCallback`` :49, ``LearningRateWarmupCallback`` :118). The
framework-neutral logic lives in :mod:`horovod_tpu_torch.train.callbacks`
(the metric average is one fp64 allreduce over the process group, the
warmup its ``schedule()``); these classes plug it into ``model.fit``. The
gradients go through :mod:`horovod_tpu_torch.tensorflow`. TensorFlow and
Keras are imported at first use.
"""

from __future__ import annotations

from typing import Optional

from horovod_tpu_torch.common.basics import (  # noqa: F401
    local_rank, local_size, mpi_threads_supported, rank, size)
from horovod_tpu_torch.tensorflow import (  # noqa: F401
    allreduce, allgather, broadcast, broadcast_global_variables,
    broadcast_variables, init, shutdown)
from horovod_tpu_torch.train import callbacks as _cb


def DistributedOptimizer(optimizer, op=None, compression=None,
                         backward_passes_per_step: int = 1):
    """Keras-compatible wrapper: a dynamic SUBCLASS of the given optimizer's
    class whose ``apply_gradients`` syncs gradients first (reference:
    ``horovod/_keras/__init__.py create_distributed_optimizer`` — same
    dynamic-subclass trick, required because ``model.compile`` validates
    the optimizer's type). A fresh instance is built from the config; to
    distribute an already-built optimizer while keeping its slot state
    (the load_model path), see ``_wrap_in_place``."""
    dist = optimizer.__class__.from_config(optimizer.get_config())
    return _wrap_in_place(dist, op, compression, backward_passes_per_step)


def _keras():
    import tensorflow as tf
    return tf.keras


class BroadcastGlobalVariablesCallback:
    """Broadcast model+optimizer variables from root at train begin
    (reference: ``_keras/callbacks.py:23-47``)."""

    def __new__(cls, root_rank: int = 0):
        keras = _keras()

        class _Impl(keras.callbacks.Callback):
            def __init__(self, root):
                super().__init__()
                self._root = root
                self._done = False

            def on_batch_begin(self, batch, logs=None):
                if self._done:
                    return
                broadcast_variables(self.model.variables, self._root)
                if getattr(self.model, "optimizer", None) is not None and \
                        hasattr(self.model.optimizer, "variables"):
                    vars = self.model.optimizer.variables
                    vars = vars() if callable(vars) else vars
                    broadcast_variables(vars, self._root)
                self._done = True

        return _Impl(root_rank)


class MetricAverageCallback:
    """Average epoch metrics across workers (reference:
    ``_keras/callbacks.py:49-93``)."""

    def __new__(cls):
        keras = _keras()
        impl = _cb.MetricAverageCallback()

        class _Impl(keras.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                if logs:
                    logs.update(impl.on_epoch_end(logs))

        return _Impl()


class LearningRateWarmupCallback:
    """LR warmup from base lr to lr*size (reference:
    ``_keras/callbacks.py:118-192``)."""

    def __new__(cls, initial_lr: float, warmup_epochs: int = 5,
                steps_per_epoch: Optional[int] = None, verbose: int = 0):
        keras = _keras()
        sched = _cb.LearningRateWarmupCallback(
            initial_lr, warmup_epochs, steps_per_epoch or 1).schedule()

        class _Impl(keras.callbacks.Callback):
            def __init__(self):
                super().__init__()
                self._step = 0

            def on_train_batch_begin(self, batch, logs=None):
                lr = float(sched(self._step))
                self._step += 1
                opt = self.model.optimizer
                if hasattr(opt, "learning_rate"):
                    try:
                        opt.learning_rate.assign(lr)
                    except AttributeError:
                        opt.learning_rate = lr

        return _Impl()


callbacks = type("callbacks", (), {
    "BroadcastGlobalVariablesCallback": BroadcastGlobalVariablesCallback,
    "MetricAverageCallback": MetricAverageCallback,
    "LearningRateWarmupCallback": LearningRateWarmupCallback,
})


def _wrap_in_place(optimizer, op=None, compression=None,
                   backward_passes_per_step: int = 1):
    """Make an optimizer instance distributed by swapping in a dynamic
    subclass WITHOUT re-instantiating, so built variables and restored
    slot state (momentum, Adam moments, ...) stay live. Shared engine of
    DistributedOptimizer (which feeds it a fresh from_config instance)
    and load_model (which feeds it the checkpoint-loaded one)."""
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.ops.reduce_op import Average
    from horovod_tpu_torch.tensorflow import _DistributedOptimizer

    cls = optimizer.__class__

    class _KerasDistributed(cls):
        _hvd_sync = None

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            # sync (+ accumulation when backward_passes_per_step > 1, incl.
            # the tf.function/graph path) lives in the TF helper; its _opt
            # shim applies via THIS instance's base class so keras variable
            # state stays consistent
            return self._hvd_sync.apply_gradients(
                list(grads_and_vars), *args, **kwargs)

    _KerasDistributed.__name__ = "Distributed" + cls.__name__
    optimizer.__class__ = _KerasDistributed
    sync = _DistributedOptimizer(optimizer, op or Average,
                                 compression or Compression.none,
                                 backward_passes_per_step)

    class _SuperApply:
        """Routes the helper's final apply to the base-class method of the
        keras-registered instance; other attribute access falls through so
        the helper's __getattr__ proxy contract keeps working."""

        def apply_gradients(self, gv, *args, **kwargs):
            return cls.apply_gradients(optimizer, list(gv), *args, **kwargs)

        def __getattr__(self, item):
            return getattr(optimizer, item)

    sync._opt = _SuperApply()
    optimizer._hvd_sync = sync
    return optimizer


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None):
    """Load a saved keras model and make its optimizer distributed so the
    restored model keeps training across workers (reference:
    ``horovod/keras/__init__.py:167`` — there via load-time custom-object
    substitution of every optimizer class; here the loaded instance's
    class is swapped for the distributed subclass in place, which keeps
    its checkpointed slot state). ``custom_optimizers`` are extra
    optimizer classes needed for deserialization; they merge into
    ``custom_objects``."""
    keras = _keras()
    co = dict(custom_objects or {})
    for c in (custom_optimizers or []):
        co.setdefault(c.__name__, c)
    model = keras.models.load_model(filepath, custom_objects=co)
    opt = getattr(model, "optimizer", None)
    if opt is not None:
        _wrap_in_place(opt, compression=compression)
    return model


def __getattr__(name):
    if name == "elastic":
        # lazy (the elastic submodule pulls the TF adapter); import_module
        # directly — a from-import here would recurse through this very
        # __getattr__ via importlib's fromlist handling
        import importlib
        mod = importlib.import_module("horovod_tpu_torch.keras.elastic")
        globals()["elastic"] = mod
        return mod
    raise AttributeError(name)
