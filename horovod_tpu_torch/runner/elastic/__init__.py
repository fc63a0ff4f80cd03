"""The elastic control plane: host discovery, the worker registry, the
driver's write-ahead journal and the driver (mirrors
``horovod_tpu/runner/elastic/``, less the agent transport)."""
