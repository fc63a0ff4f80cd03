"""Keras backend for the Spark estimator API, over the port.

Mirrors ``horovod_tpu/spark/keras_estimator.py`` (reference:
``horovod/spark/keras/estimator.py``: KerasEstimator serializing the
compiled model, remote.py training loop with hvd.keras), on the port's
:class:`~horovod_tpu_torch.spark.estimator.HorovodEstimator`, ``read_shard``,
``xy_arrays`` and Store, and its Keras shim: the model travels as
architecture JSON + weight arrays through the Store (one pickled dict a
checkpoint, the JAX package's layout, so a Store written by either package
reads back in the other), each worker compiles with
``horovod_tpu_torch.keras.DistributedOptimizer`` and trains its rank's
shard on the host, and rank 0 checkpoints the final weights back to the
Store. TensorFlow is imported on the workers and at load, never at import.
"""

from __future__ import annotations

import json
import pickle
from typing import Callable

import numpy as np

from horovod_tpu_torch.spark.estimator import (HorovodEstimator, HorovodModel,
                                         load_transform, read_shard,
                                         xy_arrays)


def _save_keras(store, ckpt_dir: str, model, tag: str,
                arch: str = None) -> None:
    # arch override: the trained model is compiled with the dynamic
    # DistributedOptimizer subclass, whose compile config would not
    # deserialize — persist weights against the original UNCOMPILED
    # architecture instead
    spec = dict(arch=arch if arch is not None else model.to_json(),
                weights=[np.asarray(w) for w in model.get_weights()])
    store.write(store.join(ckpt_dir, f"{tag}.pkl"), pickle.dumps(spec))


def _load_keras(store, ckpt_dir: str, tag: str, custom_objects):
    """Returns (model, arch_json) from one deserialization."""
    import tensorflow as tf
    spec = pickle.loads(store.read(store.join(ckpt_dir, f"{tag}.pkl")))
    model = tf.keras.models.model_from_json(
        spec["arch"], custom_objects=custom_objects or {})
    model.set_weights(spec["weights"])
    return model, spec["arch"]


class KerasModel(HorovodModel):
    """Reference: ``KerasModel`` (``spark/keras/estimator.py``)."""

    def __init__(self, **kwargs) -> None:
        self._custom_objects = kwargs.pop("custom_objects", {})
        super().__init__(**kwargs)

    def _predict_batch(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self._model.predict(X, verbose=0))


class KerasEstimator(HorovodEstimator):
    """Reference: ``KerasEstimator`` (``spark/keras/estimator.py``).

    ``model`` is an UNCOMPILED tf.keras model; ``optimizer`` a keras
    optimizer name (e.g. ``"sgd"``), ``loss`` a keras loss name.
    """

    def _save_model_spec(self, ckpt_dir: str) -> None:
        store = self._store
        _save_keras(store, ckpt_dir, self._model, "initial")
        store.write(store.join(ckpt_dir, "train_spec.json"), json.dumps(
            dict(optimizer=self._optimizer or "sgd",
                 learning_rate=self._learning_rate,
                 loss=self._loss or "mse",
                 metrics=list(self._metrics or []),
                 feature_cols=list(self._feature_cols),
                 label_cols=list(self._label_cols),
                 batch_size=self._batch_size,
                 epochs=self._epochs,
                 sample_weight_col=self._sample_weight_col,
                 train_steps_per_epoch=self._train_steps_per_epoch,
                 validation_steps_per_epoch=self
                 ._validation_steps_per_epoch,
                 verbose=self._verbose)).encode())

    def _make_remote_fn(self, ckpt_dir: str, train_path: str,
                        val_path: str) -> Callable:
        custom_objects = self._custom_objects
        user_callbacks = list(self._callbacks or [])  # cloudpickled along
        store = self._store  # pickled into the worker closure

        def remote_train():
            import tensorflow as tf
            import horovod_tpu_torch as hvd
            import horovod_tpu_torch.keras as hvd_keras

            spec = json.loads(store.read_text(
                store.join(ckpt_dir, "train_spec.json")))
            model, initial_arch = _load_keras(store, ckpt_dir, "initial",
                                              custom_objects)
            opt = tf.keras.optimizers.get(
                {"class_name": spec["optimizer"],
                 "config": {"learning_rate":
                            spec["learning_rate"] * hvd.size()}})
            model.compile(
                optimizer=hvd_keras.DistributedOptimizer(opt),
                loss=spec["loss"], metrics=spec["metrics"])

            transform = load_transform(store, ckpt_dir)
            pdf = read_shard(store, train_path, hvd.rank(), hvd.size(),
                             transform=transform)
            X, Y = xy_arrays(pdf, spec["feature_cols"], spec["label_cols"])
            sample_weight = None
            if spec.get("sample_weight_col"):
                sample_weight = pdf[spec["sample_weight_col"]].to_numpy(
                    dtype=np.float32)
            val = None
            if val_path:
                vpdf = read_shard(store, val_path, 0, 1,
                                  transform=transform)
                vX, vY = xy_arrays(vpdf, spec["feature_cols"],
                                   spec["label_cols"])
                val = (vX, vY)
            cb = [hvd_keras.callbacks.BroadcastGlobalVariablesCallback(0),
                  hvd_keras.callbacks.MetricAverageCallback()]
            cb += user_callbacks  # reference: the callbacks param rides
            # along after the distributed ones (spark/keras/estimator.py)
            hist = model.fit(X, Y, batch_size=spec["batch_size"],
                             epochs=spec["epochs"], validation_data=val,
                             sample_weight=sample_weight,
                             steps_per_epoch=spec.get(
                                 "train_steps_per_epoch"),
                             validation_steps=spec.get(
                                 "validation_steps_per_epoch")
                             if val is not None else None,
                             verbose=spec["verbose"] if hvd.rank() == 0
                             else 0, callbacks=cb)
            if hvd.rank() == 0:
                _save_keras(store, ckpt_dir, model, "final",
                            arch=initial_arch)
            return {k: [float(x) for x in v]
                    for k, v in hist.history.items()}

        return remote_train

    def _load_trained_model(self, ckpt_dir: str) -> KerasModel:
        model, _ = _load_keras(self._store, ckpt_dir, "final",
                               self._custom_objects)
        return KerasModel(model=model, feature_cols=self._feature_cols,
                          label_cols=self._label_cols,
                          custom_objects=self._custom_objects,
                          run_id=self._run_id)
