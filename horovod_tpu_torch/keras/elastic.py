"""``horovod_tpu_torch.keras.elastic``: the reference's
``horovod.tensorflow.keras.elastic`` / ``horovod.keras.elastic`` surface
(``horovod/tensorflow/keras/elastic.py``): the run decorator, the Keras
state and the fit-loop elastic callbacks. Mirrors
``horovod_tpu/keras/elastic.py``."""

from horovod_tpu_torch.elastic import run  # noqa: F401
from horovod_tpu_torch.tensorflow.elastic import (  # noqa: F401
    CommitStateCallback, TensorFlowKerasState, UpdateBatchStateCallback,
    UpdateEpochStateCallback)

KerasState = TensorFlowKerasState  # reference alias
