"""Runner: the control plane's processes and their HTTP planes — the
launcher (``python -m horovod_tpu_torch.runner.launch``, ``hvdrun``), host
parsing and slot assignment, process execution, the KV store and its relay
tree, and the elastic driver (``runner/elastic/``). Mirrors
``horovod_tpu/runner/`` less the agent transport (``service``,
``task_server``) and TPU pod discovery (ROADMAP queue 1 item 7)."""
