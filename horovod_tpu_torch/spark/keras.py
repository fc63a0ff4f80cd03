"""Drop-in module path alias: ``horovod.spark.keras`` →
``horovod_tpu_torch.spark.keras`` (reference:
``horovod/spark/keras/__init__.py`` re-exporting KerasEstimator/
KerasModel)."""

from horovod_tpu_torch.spark.keras_estimator import (  # noqa: F401
    KerasEstimator, KerasModel)
