"""One rank of a two-rank world that checks what ``TorchState.sync`` makes
of the ranks' sampler progress, in either package (``--pkg jax`` or
``--pkg port``): each rank draws its share of 12 rows, records the first
two it drew (rank r: rows r and r + 2), syncs one ``TorchState`` holding
the sampler, and writes ``DIR/<pkg>.rank<r>.json`` with the rows it had
processed, the processed set after the sync and the rows it draws next.
Launched by ``test_torch_port_elastic.py`` under
``torch_port_worker.launch_env_world`` (a world runs one package)."""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", choices=("jax", "port"), required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    if a.pkg == "jax":
        import horovod_tpu as hvd
        from horovod_tpu.torch.elastic import ElasticSampler, TorchState
    else:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.torch.elastic import ElasticSampler, TorchState
    hvd.init()
    sampler = ElasticSampler(list(range(12)), shuffle=False)
    mine = list(iter(sampler))[:2]
    sampler.record_indices(mine)
    state = TorchState(sampler=sampler, name=f"sampler_{a.pkg}")
    state.sync()
    doc = dict(rank=hvd.rank(), processed=sorted(mine),
               after=sorted(sampler.processed_indices),
               left=list(iter(sampler)))
    with open(os.path.join(a.out, f"{a.pkg}.rank{hvd.rank()}.json"),
              "w") as f:
        json.dump(doc, f)
    hvd.shutdown()
    if a.pkg == "port":
        os._exit(0)   # torch's gloo threads can abort the teardown


if __name__ == "__main__":
    main()
