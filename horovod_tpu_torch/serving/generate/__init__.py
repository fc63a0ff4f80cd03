"""Token-level continuous batching: the generative decode engine.

Mirrors ``horovod_tpu/serving/generate/``: one fixed-shape decode step over
a static slot array (captured once in a CUDA graph on the card), K/V
history in a byte-budgeted paged pool, prompts prefilled in chunks that
never stall live decode. The pieces:

* :mod:`.pages` — the paged KV-cache pool (plan + allocator);
* :mod:`.scheduler` — slot membership: FIFO page-gated admission,
  prefill chunking, step-boundary eviction;
* :mod:`.engine` — the engine itself plus the request-level gang
  baseline it is measured against.
"""

from horovod_tpu_torch.serving.generate.engine import (GenerateEngine,
                                                       demo_gen_setup,
                                                       flagship_gen_setup,
                                                       request_level_generate)
from horovod_tpu_torch.serving.generate.pages import (KVPagePlan, PagePool,
                                                      plan_kv_pages,
                                                      resolve_page_bytes)
from horovod_tpu_torch.serving.generate.scheduler import (GenRequest,
                                                          SlotScheduler)

__all__ = [
    "GenerateEngine", "demo_gen_setup", "flagship_gen_setup",
    "request_level_generate", "KVPagePlan", "PagePool", "plan_kv_pages",
    "resolve_page_bytes", "GenRequest", "SlotScheduler",
]
