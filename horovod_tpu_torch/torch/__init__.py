"""The torch adapter's elastic surface (mirrors ``horovod_tpu/torch/``,
of which only ``elastic`` is ported: the port is torch throughout)."""
