"""Runner: the control plane's processes and their HTTP planes. Only
:class:`~horovod_tpu_torch.runner.http_kv.ThreadedHTTPServer` is ported
so far (the serving plane needs it); the launcher, the KV store and the
elastic driver are ROADMAP queue 1 item 7."""
