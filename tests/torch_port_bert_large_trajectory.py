"""BERT-Large at full width and depth: five AdamW(1e-4) steps of the JAX
package's ``make_bert_train_step`` and of the port's, from the same weights
(the JAX ``init_bert``, carried across with ``from_flax``) on the same
seeded batch, on the CPU in fp32. Prints both loss trajectories.

    PYTHONPATH=. JAX_PLATFORMS=cpu \
        python tests/torch_port_bert_large_trajectory.py [ROWS]

(ROWS defaults to 4; S 128; about 4 minutes on 8 cores.) Not a tier-1
test: it is the evidence that the rise of the loss over BERT's first
AdamW steps without warmup (the NSP head overshoots), which chip_smoke's
``[zoo]`` phase meets on the card, is the reference's own behaviour.
"""

import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(rows: int = 4) -> int:
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    import chip_smoke
    from horovod_tpu.models import bert as jbert
    from horovod_tpu.parallel.mesh import build_mesh
    from horovod_tpu_torch.models import bert

    jax.config.update("jax_platforms", "cpu")
    model = jbert.Bert(jbert.bert_large(jnp.float32))
    params = jbert.init_bert(model, jax.random.PRNGKey(0), 128)
    flat = jax.tree_util.tree_map(
        lambda x: np.asarray(x.unbox() if hasattr(x, "unbox") else x),
        params, is_leaf=lambda x: hasattr(x, "unbox"))
    batch = chip_smoke.zoo_batch(torch, "bert_large", rows, 128,
                                 torch.device("cpu"), seed=1)
    tx = optax.adamw(1e-4)
    step = jbert.make_bert_train_step(
        model, tx, build_mesh(dp=1, devices=jax.devices()[:1]))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    opt, losses, t0 = tx.init(params), [], time.perf_counter()
    for _ in range(5):
        params, opt, loss = step(params, opt, jbatch)
        losses.append(float(loss))
    print(f"jax  {losses} {time.perf_counter() - t0:.0f} s", flush=True)
    del params, opt
    m = bert.Bert(bert.bert_large(torch.float32), "cpu")
    m.load_state_dict(bert.from_flax(flat))
    opt, pstep = bert.adamw(m.parameters()), bert.make_bert_train_step(m)
    t0 = time.perf_counter()
    ported = [float(pstep(m, opt, batch)[2]) for _ in range(5)]
    print(f"port {ported} {time.perf_counter() - t0:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:2])))
