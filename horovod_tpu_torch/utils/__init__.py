"""Back-compat import paths (mirrors ``horovod_tpu/utils/``)."""
