"""``horovod_tpu_torch.tensorflow.keras``: the alias namespace for users
who import ``horovod.tensorflow.keras as hvd`` (reference:
``horovod/tensorflow/keras/__init__.py`` re-exports the surface of
``horovod.keras`` built on the TF backend; here both namespaces are the one
Keras shim, :mod:`horovod_tpu_torch.keras`, as in the JAX package's
``horovod_tpu/tensorflow/keras.py``)."""

from horovod_tpu_torch.keras import *  # noqa: F401,F403
from horovod_tpu_torch.keras import DistributedOptimizer, callbacks  # noqa: F401
from horovod_tpu_torch.keras import elastic  # noqa: F401
