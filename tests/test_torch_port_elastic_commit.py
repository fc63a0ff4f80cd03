"""The elastic commit's host-update check agrees across the world: the
ranks of a gloo world of two raise ``HostsUpdatedInterrupt`` at the same
commit, with the newest world document any of them holds, though only
one of them has seen it (the reference's broadcast in
``common/elastic.py``; the JAX package checks each rank alone, and a rank
that has not seen the document enters its next collective alone)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import spawn_world, worker_main  # noqa: E402

# what each rank's own check finds: (rank 0's, rank 1's) generations
CASES = {"rank0_only": (7, None), "rank1_only": (None, 7),
         "both_newest_wins": (7, 8), "none": (None, None)}


def _w(case):
    def run():
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import elastic
        gen = CASES[case][hvd.rank()]
        elastic._world_update = lambda poll=True: \
            None if gen is None else {"generation": gen, "size": 2}

        class S(elastic.State):
            def save(self):
                pass

        try:
            S().commit()
            got = -1
        except elastic.HostsUpdatedInterrupt as e:
            got = e.update["generation"]
        return {"got": np.array(got)}
    return run


WORKERS = {case: _w(case) for case in CASES}


def test_every_rank_raises_with_the_newest_document(tmp_path):
    want = {"rank0_only": 7, "rank1_only": 7, "both_newest_wins": 8,
            "none": -1}
    for case in CASES:
        ranks = spawn_world(__file__, case, 2, tmp_path, timeout=90)
        assert [int(r["got"]) for r in ranks] == [want[case]] * 2, case


if __name__ == "__main__":
    sys.exit(worker_main(WORKERS, sys.argv[1:]))
