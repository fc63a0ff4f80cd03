"""Drop-in module path alias: ``horovod.spark.torch`` →
``horovod_tpu_torch.spark.torch`` (reference:
``horovod/spark/torch/__init__.py`` re-exporting TorchEstimator/
TorchModel)."""

from horovod_tpu_torch.spark.torch_estimator import (  # noqa: F401
    TorchEstimator, TorchModel)
