"""The plain references against the port's models at a tiny width, both in
float32 on the CPU: the same loss, every leaf's gradient and the running
statistics. The one file that loads both."""

import pytest
import torch
import torch.nn.functional as F

from perfbench import generator, harness

# 64x64 images: the last stage's batch norms see 2x2 pixels of 8 images
TINY_RESNET = {"stage_sizes": [1, 1, 1, 1], "num_classes": 10,
               "image_size": 64}
TINY_BERT = {"hidden_size": 64, "num_attention_heads": 4,
             "num_hidden_layers": 2, "intermediate_size": 128,
             "vocab_size": 100, "max_position_embeddings": 64}


def _weights(cell, seed):
    ref, cfg = cell.module.reference, cell.cfg
    w = generator.draw_weights(ref.param_shapes(cfg),
                               lambda s, r: cell.module.init(s, r, cfg),
                               seed, "cpu")
    return w, ref.init_buffers(cfg, "cpu")


def _close(got, want, tol, floor=0.0):
    """Largest element gap over the largest reference element, or over
    ``floor`` where that is larger (a leaf whose gradient is nought to
    rounding, as a bias under a batch norm)."""
    assert got.shape == want.shape
    scale = max(float(want.abs().max()), floor, 1e-30)
    assert float((got - want).abs().max()) / scale < tol


def _grads_close(named, g, tol):
    floor = sorted(float(v.abs().max()) for v in g.values())[len(g) // 2]
    for k, p in named.items():
        _close(p.grad, g[k], tol, 1e-3 * floor)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_resnet50_reference_matches_the_port(seed):
    from horovod_tpu_torch.models import resnet
    cell = harness.Cell("resnet50.b256", cfg=TINY_RESNET,
                        traffic={"rows_per_rank": 8, "image_size": 64,
                                 "classes": 10})
    w, stats = _weights(cell, seed)
    model = resnet.ResNet([1, 1, 1, 1], 10, torch.float32, "conv",
                          device="cpu")
    model.load_state_dict({**w, **stats})
    batch = generator.batch(cell.traffic, cell.cfg, seed, 0, "cpu")
    loss = F.cross_entropy(model(batch["images"]).float(), batch["labels"])
    loss.backward()
    ref = cell.module.reference
    ref_stats = {k: v.clone() for k, v in stats.items()}
    ref_loss, g = ref.grads(w, ref_stats, batch, cell.cfg)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(g)
    _grads_close(named, g, 1e-4)
    for k, b in model.named_buffers():
        _close(b, ref_stats[k], 1e-5)


@pytest.mark.parametrize("seed", [4, 2 ** 31 + 9])
def test_bert_reference_matches_the_port(seed):
    from horovod_tpu_torch.models import bert
    cell = harness.Cell("bert_large.s128.b128", cfg=TINY_BERT,
                        traffic={"rows_per_rank": 5, "seq_len": 16,
                                 "min_len": 8, "max_len": 16})
    w, _ = _weights(cell, seed)
    c = cell.cfg
    model = bert.Bert(bert.BertConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position=c["max_position_embeddings"], dtype=torch.float32),
        device="cpu")
    model.load_state_dict(w)
    b = generator.batch(cell.traffic, c, seed, 0, "cpu")
    mlm, nsp = model(b["input_ids"], b["token_type_ids"],
                     b["attention_mask"])
    loss = bert.pretrain_loss(mlm, nsp, b["mlm_labels"], b["mlm_mask"],
                              b["nsp_labels"])
    loss.backward()
    # blocks of 2 rows: the reference's accumulation over blocks
    ref_loss, g = cell.module.reference.grads(w, {}, b, c, block_rows=2)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(g)
    _grads_close(named, g, 1e-4)
