"""Elastic state for TF/Keras training over the port's ``ObjectState``.

A copy of ``horovod_tpu/tensorflow/elastic.py`` (reference:
``horovod/tensorflow/elastic.py``, ``TensorFlowKerasState`` /
``TensorFlowState``: snapshot + broadcast-based sync of variables, and
``horovod/_keras/elastic.py``'s fit callbacks). Same pattern as the
port's ``TorchState``: model weights (and keras optimizer variables) are
snapshotted as numpy arrays WITH the scalar attributes as one
commit/restore/sync unit (the sync a pickled broadcast over the process
group), persisted across generation restarts when the elastic driver
manages the job. TensorFlow is imported at the first callback built.
"""

from __future__ import annotations

import numpy as np

from horovod_tpu_torch.elastic import ObjectState, run  # noqa: F401


def _opt_vars(optimizer):
    if optimizer is None:
        return None
    v = getattr(optimizer, "variables", None)
    if v is None:
        return None
    return v() if callable(v) else v


class TensorFlowKerasState(ObjectState):
    """Reference: ``TensorFlowKerasState`` (``tensorflow/elastic.py``)."""

    def __init__(self, model, optimizer=None,
                 name: str = "tf_keras_state", **kwargs) -> None:
        self._model = model
        self._optimizer = optimizer
        super().__init__(name=name, keras_snaps=self._capture(), **kwargs)
        self._apply(self.keras_snaps)

    def _capture(self) -> dict:
        opt = _opt_vars(self._optimizer)
        return dict(
            weights=[np.asarray(w) for w in self._model.get_weights()],
            opt_weights=[np.asarray(v) for v in opt] if opt else None)

    def _apply(self, snaps: dict) -> None:
        if snaps.get("weights"):
            self._model.set_weights(snaps["weights"])
        opt = _opt_vars(self._optimizer)
        if snaps.get("opt_weights") and opt:
            for var, val in zip(opt, snaps["opt_weights"]):
                if tuple(var.shape) == np.asarray(val).shape:
                    var.assign(val)

    def save(self) -> None:
        self.keras_snaps = self._capture()
        super().save()

    def restore(self) -> None:
        super().restore()
        self._apply(self.keras_snaps)

    def sync(self) -> None:
        # rank 0's live weights are the source of truth; ObjectState.sync
        # broadcasts the snapshot dict together with the scalars
        self.keras_snaps = self._capture()
        super().sync()
        self._apply(self.keras_snaps)


class TensorFlowState(ObjectState):
    """Raw-variable elastic state (reference: ``TensorFlowState`` — the
    non-Keras variant syncing an explicit variable list rather than a
    model object)."""

    def __init__(self, variables, name: str = "tf_state",
                 **kwargs) -> None:
        self._vars = list(variables)
        super().__init__(name=name, var_snaps=self._capture(), **kwargs)
        self._apply(self.var_snaps)

    def _capture(self) -> list:
        return [np.asarray(v) for v in self._vars]

    def _apply(self, snaps: list) -> None:
        if not snaps:
            return
        for var, val in zip(self._vars, snaps):
            if tuple(var.shape) == np.asarray(val).shape:
                var.assign(val)

    def save(self) -> None:
        self.var_snaps = self._capture()
        super().save()

    def restore(self) -> None:
        super().restore()
        self._apply(self.var_snaps)

    def sync(self) -> None:
        self.var_snaps = self._capture()
        super().sync()
        self._apply(self.var_snaps)


def _keras_callbacks_base():
    import tensorflow as tf
    return tf.keras.callbacks.Callback


def CommitStateCallback(state, batches_per_commit: int = 1):
    """Commit the elastic state every ``batches_per_commit`` batches and
    at every epoch end (reference: ``CommitStateCallbackImpl``,
    ``_keras/elastic.py:17-40``).

    List this LAST in ``callbacks`` (reference usage order) so each
    commit captures the Update*StateCallback counters for the same
    batch/epoch — keras runs callbacks in list order. Factory function
    returning a ``tf.keras.callbacks.Callback`` instance."""

    class _Impl(_keras_callbacks_base()):
        def __init__(self):
            super().__init__()
            self._remaining = batches_per_commit

        def on_train_begin(self, logs=None):
            # reset on every sync event for cross-rank consistency
            self._remaining = batches_per_commit

        def on_batch_end(self, batch, logs=None):
            self._remaining -= 1
            if self._remaining == 0:
                state.commit()
                self._remaining = batches_per_commit

        def on_epoch_end(self, epoch, logs=None):
            state.commit()

    return _Impl()


def UpdateBatchStateCallback(state):
    """Track the COMPLETED-batch count in ``state.batch`` through fit
    (reference: ``UpdateBatchStateCallbackImpl``,
    ``_keras/elastic.py:42-63``).

    Like the reference, the first ``on_epoch_begin`` after a restore
    with ``state.batch > 0`` reduces ``self.params["steps"]`` by the
    already-committed batch count (restored at epoch end so later
    epochs run full length). Only LEGACY training loops (tf.keras
    before the 2.2 DataHandler rewrite) honor that mutation; every
    modern tf.keras / Keras 3 loop takes its step count from the data
    handler and merely shows the shrunk count in the progress bar. On
    modern keras the CALLER must therefore compensate — pass
    ``steps_per_epoch - state.batch`` (or slice the dataset) to the
    post-restore ``fit`` — else the committed epoch's earlier batches
    replay.

    ``state.batch`` counts completed batches WITHIN THE CURRENT RUN of
    the epoch (matching the reference). After a mid-epoch resume the
    count therefore lags the true position in the original epoch by
    the resumed offset, so a commit taken inside a resumed epoch can
    only cause a later restore to RE-train a few batches — never to
    skip training. Callers wanting exact positions after a resume
    should commit at epoch boundaries (``batches_per_commit`` large,
    or rely on the epoch-end commit). Factory function returning a
    callback."""

    class _Impl(_keras_callbacks_base()):
        def __init__(self):
            super().__init__()
            self._saved_steps = None

        def on_epoch_begin(self, epoch, logs=None):
            if state.batch > 0:
                steps = (self.params or {}).get("steps")
                if steps:
                    self._saved_steps = steps
                    self.params["steps"] = max(steps - state.batch, 0)

        def on_batch_end(self, batch, logs=None):
            state.batch = batch + 1  # completed count, not last index

        def on_epoch_end(self, epoch, logs=None):
            if self._saved_steps is not None:
                # later epochs start from 0 and must run full length
                self.params["steps"] = self._saved_steps
                self._saved_steps = None
            state.batch = 0

    return _Impl()


def UpdateEpochStateCallback(state):
    """Track the GLOBAL epoch number in ``state.epoch`` across resets —
    keras restarts epoch numbering at 0 on every retry (reference:
    ``UpdateEpochStateCallbackImpl``, ``_keras/elastic.py:66-89``).
    Factory function returning a callback."""

    class _Impl(_keras_callbacks_base()):
        def __init__(self):
            super().__init__()
            self._initial_epoch = state.epoch

        def on_train_begin(self, logs=None):
            self._initial_epoch = state.epoch

        def on_epoch_end(self, epoch, logs=None):
            # +1: a reset after state.batch returns to 0 must not repeat
            # the finished epoch
            state.epoch = self._initial_epoch + epoch + 1

    return _Impl()
