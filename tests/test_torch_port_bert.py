"""The port's BERT against the JAX package's, on the CPU, in fp32.

The tiny config of ``tests/test_parity_tail.py:68-74`` (vocab 64, hidden
32, 2 layers, 4 heads, FFN 64), B 8, S 16, with a key-padding mask that
hides the tail of half the rows. The JAX ``init_bert`` weights go through
``from_flax`` into the port's ``Bert``. The oracles, at 1e-4:

* one process: the MLM and NSP logits, ``pretrain_loss``, every
  parameter's gradient (``jax.grad`` of the JAX loss) and one
  ``optax.adamw(1e-3)`` step of ``make_bert_train_step``;
* ``{tp: 2}`` as two gloo ranks (``python tests/test_torch_port_bert.py
  --worker tp2 --out DIR``, the ``from_flax`` state in the npz
  ``BERT_WEIGHTS`` names):
  the loss, each leaf's gradient reassembled from both ranks' shards, and
  one AdamW step, against JAX at ``dp = 1`` and against JAX GSPMD on
  ``{dp: 2, tp: 2}`` (its gradient is checked against ``dp = 1`` first:
  GSPMD's, unlike the flagship's ``shard_map`` one, is the true one);
* a tp that does not divide the vocabulary (63 over tp = 2): the port pads
  the word embedding to 64 rows and masks the pad out of the loss;
* ``{dp: 2}`` in the same world (``shard_batch``: 4 rows a rank): the loss
  of the global batch and one AdamW step against JAX at ``dp = 1``;
* the full-width configs (BERT base and large) have JAX's parameter names,
  shapes and counts.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import worker_main  # noqa: E402

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    import optax
    import pytest
    import torch

    from horovod_tpu.models import bert as jbert
    from horovod_tpu.parallel.mesh import batch_sharding, build_mesh

    from test_torch_port_dp import spawn

B, S, LR = 8, 16, 1e-3
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=32)
ODD_VOCAB = 63


def bert_batch(vocab, seed=0):
    """``_bert_batch`` of ``tests/test_parity_tail.py`` with segment ids
    and a padding mask: rows 4-7 keep their first 10 tokens."""
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), bool)
    mask[B // 2:, 10:] = False
    return {
        "input_ids": rng.randint(0, vocab, (B, S)).astype(np.int32),
        "token_type_ids": (np.arange(S)[None] >= S // 2).repeat(B, 0)
        .astype(np.int32),
        "attention_mask": mask,
        "mlm_labels": rng.randint(0, vocab, (B, S)).astype(np.int32),
        "mlm_mask": (rng.rand(B, S) < 0.3).astype(np.float32),
        "nsp_labels": rng.randint(0, 2, (B,)).astype(np.int32),
    }


def torch_batch(b):
    import torch
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


# -- the worker (torch only) ---------------------------------------------------

def _w_tp2():
    import dataclasses

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert

    mesh = hvd.build_mesh(dp=1, tp=2)
    weights = dict(np.load(os.environ["BERT_WEIGHTS"]))
    out = {}
    for tag, vocab in (("v64", TINY["vocab_size"]), ("v63", ODD_VOCAB)):
        cfg = dataclasses.replace(bert.BertConfig(**TINY, dtype=torch.float32),
                                  vocab_size=vocab)
        full = {k.split(".", 1)[1]: torch.from_numpy(v)
                for k, v in weights.items() if k.startswith(tag + ".")}
        sd = bert.shard_state_dict(full, cfg, mesh)
        batch = torch_batch(bert_batch(vocab))
        model = bert.Bert(cfg, "cpu", mesh)
        model.load_state_dict(sd)
        mlm, nsp = model(batch["input_ids"], batch["token_type_ids"],
                         batch["attention_mask"])
        loss = bert.pretrain_loss(mlm, nsp, batch["mlm_labels"],
                                  batch["mlm_mask"], batch["nsp_labels"],
                                  mesh, vocab)
        loss.backward()
        out[f"{tag}_loss"] = loss.detach().numpy().copy()
        out[f"{tag}_mlm"] = mlm.detach().numpy().copy()
        for k, p in model.named_parameters():
            out[f"{tag}_grad.{k}"] = p.grad.numpy().copy()
        model = bert.Bert(cfg, "cpu", mesh)
        model.load_state_dict(sd)
        opt = bert.adamw(model.parameters(), LR)
        _, _, step_loss = bert.make_bert_train_step(model, mesh)(model, opt,
                                                                 batch)
        out[f"{tag}_step_loss"] = step_loss.numpy().copy()
        for k, p in model.state_dict().items():
            out[f"{tag}_param.{k}"] = p.numpy().copy()
    # the same world as {dp: 2}: each rank its 4 rows, the loss's
    # denominators global, the gradients summed over dp
    cfg = bert.BertConfig(**TINY, dtype=torch.float32)
    dp = hvd.build_mesh(dp=2)
    model = bert.Bert(cfg, "cpu", dp)
    model.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(v)
                           for k, v in weights.items()
                           if k.startswith("v64.")})
    opt = bert.adamw(model.parameters(), LR)
    _, _, loss = bert.make_bert_train_step(model, dp)(
        model, opt, bert.shard_batch(torch_batch(bert_batch(64)), dp))
    out["dp2_loss"] = loss.numpy().copy()
    for k, p in model.state_dict().items():
        out[f"dp2_param.{k}"] = p.numpy().copy()
    return out


if __name__ == "__main__":
    sys.exit(worker_main({"tp2": _w_tp2}, sys.argv[1:]))


# -- JAX side ------------------------------------------------------------------

def _cfg(vocab=TINY["vocab_size"]):
    return jbert.BertConfig(**dict(TINY, vocab_size=vocab), dtype=jnp.float32)


def _unboxed(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x.unbox() if hasattr(x, "unbox") else x), tree,
        is_leaf=lambda x: hasattr(x, "unbox"))


def _jax_loss_fn(model, batch):
    def loss_fn(p):
        mlm, nsp = model.apply({"params": p}, batch["input_ids"],
                               batch["token_type_ids"],
                               batch["attention_mask"])
        return jbert.pretrain_loss(mlm, nsp, batch["mlm_labels"],
                                   batch["mlm_mask"], batch["nsp_labels"])
    return loss_fn


def jax_reference(vocab, mesh=None):
    """The JAX BERT (init key 0): params, logits, loss, gradients and the
    params after one ``optax.adamw(1e-3)`` step; on ``mesh`` with GSPMD
    (params placed by ``init_bert``, the batch over ``batch_sharding``)."""
    model = jbert.Bert(_cfg(vocab))
    params = jbert.init_bert(model, jax.random.PRNGKey(0), S, mesh)
    batch = {k: jnp.asarray(v) for k, v in bert_batch(vocab).items()}
    if mesh is not None:
        batch = jax.device_put(batch, batch_sharding(mesh))
    mlm, nsp = jax.jit(model.apply)({"params": params}, batch["input_ids"],
                                    batch["token_type_ids"],
                                    batch["attention_mask"])
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(model, batch)))(
        params)
    tx = optax.adamw(LR)
    upd, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    return dict(params=_unboxed(params), mlm=np.asarray(mlm),
                nsp=np.asarray(nsp), loss=float(loss), grads=_unboxed(grads),
                new=_unboxed(new))


@pytest.fixture(scope="module")
def ref():
    return {vocab: jax_reference(vocab) for vocab in (TINY["vocab_size"],
                                                      ODD_VOCAB)}


@pytest.fixture(scope="module")
def ref_dp2tp2():
    return jax_reference(TINY["vocab_size"],
                         build_mesh(dp=2, tp=2, devices=jax.devices()[:4]))


def _sd(tree):
    from horovod_tpu_torch.models.bert import from_flax
    return {k: v.numpy() for k, v in from_flax(tree).items()}


def _port_model(params, vocab=TINY["vocab_size"]):
    import dataclasses
    from horovod_tpu_torch.models import bert
    cfg = dataclasses.replace(bert.BertConfig(**TINY, dtype=torch.float32),
                              vocab_size=vocab)
    m = bert.Bert(cfg, "cpu")
    m.load_state_dict(bert.from_flax(params))
    return m


def _close(got, want, rtol=1e-4, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# -- one process ------------------------------------------------------------------

def test_logits_and_loss_match_jax(ref):
    from horovod_tpu_torch.models.bert import pretrain_loss
    r = ref[TINY["vocab_size"]]
    m = _port_model(r["params"])
    b = torch_batch(bert_batch(TINY["vocab_size"]))
    mlm, nsp = m(b["input_ids"], b["token_type_ids"], b["attention_mask"])
    np.testing.assert_allclose(mlm.detach().numpy(), r["mlm"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(nsp.detach().numpy(), r["nsp"], rtol=1e-4,
                               atol=1e-4)
    loss = pretrain_loss(mlm, nsp, b["mlm_labels"], b["mlm_mask"],
                         b["nsp_labels"])
    np.testing.assert_allclose(float(loss.detach()), r["loss"], rtol=1e-4)


def test_gradients_match_jax(ref):
    from horovod_tpu_torch.models.bert import pretrain_loss
    r = ref[TINY["vocab_size"]]
    m = _port_model(r["params"])
    b = torch_batch(bert_batch(TINY["vocab_size"]))
    pretrain_loss(*m(b["input_ids"], b["token_type_ids"],
                     b["attention_mask"]), b["mlm_labels"], b["mlm_mask"],
                  b["nsp_labels"]).backward()
    _close({k: p.grad.numpy() for k, p in m.named_parameters()},
           _sd(r["grads"]))


def test_adamw_step_matches_jax(ref):
    from horovod_tpu_torch.models import bert
    r = ref[TINY["vocab_size"]]
    m = _port_model(r["params"])
    opt = bert.adamw(m.parameters(), LR)
    _, _, loss = bert.make_bert_train_step(m)(
        m, opt, torch_batch(bert_batch(TINY["vocab_size"])))
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-4)
    _close({k: v.numpy() for k, v in m.state_dict().items()}, _sd(r["new"]))


# -- {tp: 2} ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp2(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_tp2")
    path = str(d / "weights.npz")
    flat = {}
    for tag, vocab in (("v64", TINY["vocab_size"]), ("v63", ODD_VOCAB)):
        for k, v in _sd(ref[vocab]["params"]).items():
            flat[f"{tag}.{k}"] = v
    np.savez(path, **flat)
    return spawn("tp2", 2, d, {"BERT_WEIGHTS": path}, script=__file__)


def _assemble(ranks, prefix, vocab):
    """Each leaf from the two ranks' shards (``bert.tp_split_dim``), the
    word embedding's pad rows dropped; replicated leaves bit-identical on
    both ranks."""
    from horovod_tpu_torch.models.bert import tp_split_dim
    out = {}
    for k in [key[len(prefix) + 1:] for key in ranks[0]
              if key.startswith(prefix + ".")]:
        parts = [r[f"{prefix}.{k}"] for r in ranks]
        d = tp_split_dim(k)
        if d is None:
            np.testing.assert_array_equal(parts[0], parts[1], err_msg=k)
            out[k] = parts[0]
        else:
            out[k] = np.concatenate(parts, d)
    out["word_embeddings.embedding"] = \
        out["word_embeddings.embedding"][:vocab]
    return out


def test_jax_dp2tp2_gradient_is_the_dp1_one(ref, ref_dp2tp2):
    """GSPMD differentiates the global program: the JAX ``{dp:2, tp:2}``
    loss and gradient equal ``dp = 1``'s, so both are oracles."""
    r = ref[TINY["vocab_size"]]
    assert ref_dp2tp2["loss"] == pytest.approx(r["loss"], rel=1e-5)
    _close(_sd(ref_dp2tp2["grads"]), _sd(r["grads"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("vocab", [TINY["vocab_size"], ODD_VOCAB])
def test_tp2_loss_and_gradients_match_jax(tp2, ref, ref_dp2tp2, vocab):
    """Both ranks report the global loss; the gradients reassembled from
    their shards (replicated leaves bit-identical on both) are the JAX ones
    (vocab 63: the pad row masked out, its gradient zero)."""
    tag = f"v{vocab}"
    r = ref[vocab]
    for res in tp2:
        np.testing.assert_allclose(float(res[f"{tag}_loss"]), r["loss"],
                                   rtol=1e-4)
    pad = [res[f"{tag}_grad.word_embeddings.embedding"] for res in tp2][-1]
    if vocab % 2:
        np.testing.assert_array_equal(pad[-1], 0.0)
    got = _assemble(tp2, f"{tag}_grad", vocab)
    _close(got, _sd(r["grads"]))
    if vocab == TINY["vocab_size"]:
        _close(got, _sd(ref_dp2tp2["grads"]))


@pytest.mark.parametrize("vocab", [TINY["vocab_size"], ODD_VOCAB])
def test_tp2_logits_are_the_vocab_shards(tp2, ref, vocab):
    tag = f"v{vocab}"
    mlm = np.concatenate([res[f"{tag}_mlm"] for res in tp2], -1)
    np.testing.assert_allclose(mlm[..., :vocab], ref[vocab]["mlm"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("vocab", [TINY["vocab_size"], ODD_VOCAB])
def test_tp2_adamw_step_matches_jax(tp2, ref, vocab):
    tag = f"v{vocab}"
    for res in tp2:
        np.testing.assert_allclose(float(res[f"{tag}_step_loss"]),
                                   ref[vocab]["loss"], rtol=1e-4)
    _close(_assemble(tp2, f"{tag}_param", vocab), _sd(ref[vocab]["new"]))


def test_dp2_step_matches_jax(tp2, ref):
    """``{dp: 2}``, each rank 4 of the 8 rows: the loss of the global batch
    (the MLM term over the global count of masked tokens) and one AdamW
    step equal JAX's at ``dp = 1``; both ranks hold the same parameters."""
    r = ref[TINY["vocab_size"]]
    want = _sd(r["new"])
    for res in tp2:
        np.testing.assert_allclose(float(res["dp2_loss"]), r["loss"],
                                   rtol=1e-4)
        _close({k[len("dp2_param."):]: v for k, v in res.items()
                if k.startswith("dp2_param.")}, want)
    for k in want:
        np.testing.assert_array_equal(tp2[0][f"dp2_param.{k}"],
                                      tp2[1][f"dp2_param.{k}"], err_msg=k)


# -- full width ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bert_base", "bert_large"])
def test_full_width_names_shapes_and_counts_match_jax(name):
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.models._flax import _flax_leaf
    jcfg = getattr(jbert, name)()
    model = jbert.Bert(jcfg)
    v = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128), jnp.int32),
        jnp.zeros((1, 128), jnp.int32), jnp.ones((1, 128), bool)))
    leaves = jax.tree_util.tree_flatten_with_path(
        v["params"], is_leaf=lambda x: hasattr(x, "unbox"))[0]
    want = {".".join(str(p.key) for p in path):
            tuple((a.unbox() if hasattr(a, "unbox") else a).shape)
            for path, a in leaves}
    port = {k: tuple(t.shape) for k, t in
            bert.Bert(getattr(bert, name)(), "meta").state_dict().items()}
    assert set(port) == set(want)
    for k, shape in want.items():
        conv = _flax_leaf(k, np.broadcast_to(np.float32(0), shape)).shape
        assert port[k] == conv, (k, port[k], shape)
    assert sum(np.prod(s) for s in port.values()) == \
        sum(np.prod(s) for s in want.values())


def test_init_draws_flax_distributions():
    """``init_bert`` gives JAX's shapes, not its values: normal 0.02 for the
    word embedding and the tp-split kernels, flax's defaults elsewhere
    (embeddings of std 1/sqrt(hidden), lecun-normal dense kernels, zero
    biases, LayerNorm ones and zeros)."""
    from horovod_tpu_torch.common.tree import flatten_dotted
    from horovod_tpu_torch.models import bert
    from test_torch_port_zoo import _init_distributions_match
    size = dict(TINY, vocab_size=512, hidden_size=128, num_layers=1,
                intermediate_size=256, max_position=64)
    model = jbert.Bert(jbert.BertConfig(**size, dtype=jnp.float32))
    v = jbert.init_bert(model, jax.random.PRNGKey(0), S)
    pm = bert.init_bert(bert.Bert(bert.BertConfig(**size,
                                                  dtype=torch.float32),
                                  "cpu"), 0)
    _init_distributions_match(flatten_dotted(_unboxed(v)), pm.state_dict())
