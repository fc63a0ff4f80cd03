"""DeepSeek-V2 in the port (``models/deepseek.py``, ``parallel/moe.py``'s
dropless layer, ``ops/attention.py`` with a separate value width) against
the benchmark's plain reference (``perfbench/reference/deepseek_v2.py``), in
float32 on the CPU at a tiny size: M 64, 4 heads, nope 16 / rope 8 / v 16,
``kv_lora_rank`` 32, 16 experts, top-3, 2 shared, 1 dense + 2 MoE layers,
S 64, vocabulary 256."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import deepseek
from horovod_tpu_torch.ops import attention
from horovod_tpu_torch.parallel import moe
from horovod_tpu_torch import profiling
from perfbench import generator, harness, judge

ROOT = Path(__file__).resolve().parents[1]
CELL = "deepseek_v2_lite.s4096.b8"
CFG_FILE = json.loads((ROOT / "perfbench/configs/deepseek_v2_lite.json")
                      .read_text())
TINY = {"hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
        "router_experts": 16, "n_routed_experts": 16,
        "num_experts_per_tok": 3, "n_shared_experts": 2,
        "moe_intermediate_size": 32, "intermediate_size": 96,
        "num_hidden_layers": 3, "vocab_size": 256,
        "precision": {**CFG_FILE["precision"], "compute": "float32"}}
TRAFFIC = {"rows_per_rank": 3, "seq_len": 64, "min_len": 64, "max_len": 64,
           "reference_block_rows": 2}
# Both sides compute in float32 from the same weights and batch; they differ
# only in the order of their sums (the blockwise flash backward against a
# materialized softmax, grouped products over sorted pairs against a loop
# over the experts, a deterministic gather-and-sum against index_add). That
# leaves ~1e-7 of the largest element (8e-7 seen on a leaf), so 1e-5 holds
# with room and still fails a dropped term or a wrong scale by far.
TOL = 1e-5

# DeepSeek-V2-Lite's config.json as the public catalog reads it
# (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json)
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
    "vocab_size": 102400}


def _cell(**cfg):
    return harness.Cell(CELL, cfg={**TINY, **cfg}, traffic=TRAFFIC)


def _weights(cell, seed):
    mod, cfg = cell.module, cell.cfg
    return generator.draw_weights(mod.reference.param_shapes(cfg),
                                  lambda s, r: mod.init(s, r, cfg), seed,
                                  "cpu")


def _program(cell, w):
    model, opt, call, local = cell.module.build(cell.cfg, None,
                                                torch.device("cpu"))
    model.load_state_dict(w)
    return model, opt, call, local


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_loss_and_every_gradient_match_the_reference(seed):
    cell = _cell()
    w = _weights(cell, seed)
    model, _, _, local = _program(cell, w)
    batch = generator.batch(cell.traffic, cell.cfg, seed, 0, "cpu")
    feed = local(batch)
    lm = deepseek.lm_loss(model(feed["input_ids"]), feed["labels"],
                          feed["loss_mask"])
    lm.backward()
    loss = float(lm.detach() + model.aux_loss())
    ref_loss, g = cell.module.reference.grads(w, {}, batch, cell.cfg,
                                              block_rows=2)
    assert abs(loss - ref_loss) / abs(ref_loss) <= TOL
    named = dict(model.named_parameters())
    assert set(named) == set(g)
    for name, p in named.items():
        assert _rel(p.grad, g[name]) <= TOL, name


def test_balance_loss_reaches_the_router():
    """The balance loss is in the objective: without it the router's
    gradient moves (the published ``AddAuxiliaryLoss`` path)."""
    cell, seed = _cell(), 17
    w = _weights(cell, seed)
    batch = generator.batch(cell.traffic, cell.cfg, seed, 0, "cpu")
    grads = []
    for alpha in (cell.cfg["aux_loss_alpha"], 0.0):
        c = _cell(aux_loss_alpha=alpha)
        model, _, _, local = _program(c, w)
        feed = local(batch)
        deepseek.lm_loss(model(feed["input_ids"]), feed["labels"],
                         feed["loss_mask"]).backward()
        grads.append(model.layers[1].mlp.gate.weight.grad.clone())
        assert (float(model.aux_loss()) > 0) == (alpha > 0)
    assert _rel(grads[0], grads[1]) > 1e-4


def _layer_weights(M=64, F=32, E=16, seed=0):
    g = torch.Generator().manual_seed(seed)

    def n(*s):
        return torch.randn(*s, generator=g) * 0.2
    return {"router": n(E, M), "gate": n(E, F, M), "up": n(E, F, M),
            "down": n(E, M, F), "s_gate": n(2 * F, M), "s_up": n(2 * F, M),
            "s_down": n(M, 2 * F)}


def _moe_module(w, first, held, k=3):
    cfg = deepseek.DeepseekV2Config(
        hidden_size=64, moe_intermediate_size=32, n_routed_experts=16,
        n_shared_experts=2, num_experts_per_tok=k, first_expert=first,
        held_experts=held, dtype=torch.float32)
    m = deepseek.DeepseekMoE(cfg, device="cpu")
    sl = slice(first, first + held)
    m.load_state_dict({
        "gate.weight": w["router"], "experts.gate_proj": w["gate"][sl],
        "experts.up_proj": w["up"][sl], "experts.down_proj": w["down"][sl],
        "shared_experts.gate_proj.weight": w["s_gate"],
        "shared_experts.up_proj.weight": w["s_up"],
        "shared_experts.down_proj.weight": w["s_down"]})
    return m


def _reference_layer(w, x, k=3):
    """The uncut layer from the plain reference: all 16 experts held."""
    from perfbench.reference import deepseek_v2 as ref
    p = "layers.1"
    params = {f"{p}.mlp.gate.weight": w["router"],
              f"{p}.mlp.experts.gate_proj": w["gate"],
              f"{p}.mlp.experts.up_proj": w["up"],
              f"{p}.mlp.experts.down_proj": w["down"],
              f"{p}.mlp.shared_experts.gate_proj.weight": w["s_gate"],
              f"{p}.mlp.shared_experts.up_proj.weight": w["s_up"],
              f"{p}.mlp.shared_experts.down_proj.weight": w["s_down"]}
    cfg = {"router_experts": 16, "num_experts_per_tok": k,
           "routed_scaling_factor": 1, "first_expert": 0,
           "n_routed_experts": 16, "aux_loss_alpha": 0.001}
    y, _ = ref._moe(x, params, p, cfg, x.shape[0], "fp32")
    return y


def test_the_shares_add_up_to_the_uncut_layer():
    """Four cards of 4 experts each: their routed parts, plus the shared
    experts (which every card computes alike) counted once, give the
    uncut reference layer."""
    w = _layer_weights()
    x = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(1))
    shares = [_moe_module(w, first, 4) for first in (0, 4, 8, 12)]
    with torch.no_grad():
        shared = shares[0].shared_experts(x)
        outs = [m(x) for m in shares]
    total = sum(o - shared for o in outs) + shared
    want = _reference_layer(w, x)
    assert _rel(total, want) <= TOL
    with torch.no_grad():
        whole = _moe_module(w, 0, 16)(x)
    assert _rel(whole, want) <= TOL
    # every pick lands on exactly one share
    pairs = torch.stack([m.routed_pairs for m in shares]).sum()
    assert int(pairs) == 2 * 40 * 3


def test_dropless_a_token_does_not_depend_on_the_others():
    """Every token routed to one expert (a router biased to it): nothing is
    dropped, so a token's output is the same alone and in the crowd."""
    w = _layer_weights(seed=3)
    w["router"][5] += 5.0                      # every token prefers 5
    m = _moe_module(w, 4, 4)
    x = torch.randn(1, 48, 64, generator=torch.Generator().manual_seed(2)) \
        + 1.0
    with torch.no_grad():
        crowd = m(x)
        assert int(m.routed_pairs[1]) >= 40    # expert 5, most tokens
        alone = torch.cat([m(x[:, t:t + 1]) for t in range(48)], dim=1)
        rev = m(x.flip(1)).flip(1)
    assert _rel(alone, crowd) <= TOL
    assert _rel(rev, crowd) <= TOL


def test_dropless_layer_gradients_match_autograd_of_a_loop():
    """The layer's hand-written backward (grouped products recomputed over
    the sorted pairs) against autograd through a loop over the experts."""
    g = torch.Generator().manual_seed(4)
    T, M, F, E, k, first, held = 50, 24, 16, 8, 3, 2, 4
    x = torch.randn(T, M, generator=g, requires_grad=True)
    logits = torch.randn(T, E, generator=g, requires_grad=True)
    wg, wu = (torch.randn(held, F, M, generator=g, requires_grad=True)
              for _ in range(2))
    wd = torch.randn(held, M, F, generator=g, requires_grad=True)
    cot = torch.randn(T, M, generator=g)
    y, routing, pairs = moe.dropless_moe(x, logits, k, first, held, wg, wu,
                                         wd)
    got = torch.autograd.grad((y * cot).sum() + routing.weight.sum(),
                              [x, logits, wg, wu, wd])
    scores = torch.softmax(logits, -1)
    weight, index = torch.topk(scores, k, -1)
    want_y = torch.zeros(T, M)
    for e in range(held):
        sel = (index == first + e).float()
        w_e = (weight * sel).sum(-1, keepdim=True)
        h = torch.nn.functional.silu(x @ wg[e].t()) * (x @ wu[e].t())
        want_y = want_y + w_e * (h @ wd[e].t())
    want = torch.autograd.grad((want_y * cot).sum() + weight.sum(),
                               [x, logits, wg, wu, wd])
    assert _rel(y, want_y) <= TOL
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL
    assert int(pairs.counts.sum()) == int(
        ((index >= first) & (index < first + held)).sum())


def test_dropless_refuses_a_live_ep_axis_and_wrong_ranges():
    class Axis:
        size = 2
    x, logits = torch.zeros(4, 8), torch.zeros(4, 8)
    w, d = torch.zeros(2, 4, 8), torch.zeros(2, 8, 4)
    with pytest.raises(NotImplementedError):
        moe.dropless_moe(x, logits, 2, 0, 2, w, w, d, axis=Axis())
    with pytest.raises(ValueError):
        moe.dropless_moe(x, logits, 2, 7, 2, w, w, d)


def test_yarn_frequencies_and_softmax_scale_at_the_published_config():
    cfg = deepseek.DeepseekV2Config()
    mscale = 0.1 * 0.707 * math.log(40) + 1.0
    assert deepseek.softmax_scale(cfg) == pytest.approx(
        192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert deepseek.softmax_scale(cfg) == pytest.approx(0.11472, abs=5e-6)
    assert deepseek.rope_mscale(cfg) == 1.0

    # the correction range and ramp written out from the YaRN paper's form
    def corr(rot):
        return 64 * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(1e4))
    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == deepseek.yarn_find_correction_range(32, 1, 64, 1e4,
                                                              4096)
    i = np.arange(32)
    base = 1e4 ** (-2.0 * i / 64)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    want = base / 40 * ramp + base * (1 - ramp)
    got = deepseek.yarn_inv_freq(cfg).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    from perfbench.reference import deepseek_v2 as ref
    np.testing.assert_allclose(ref.yarn_frequencies(CFG_FILE).numpy(),
                               want, rtol=1e-6)
    assert ref.softmax_scale(CFG_FILE) == deepseek.softmax_scale(cfg)


def test_rope_deinterleaves_before_rotating():
    """``q_pe``'s pairs (2i, 2i+1) rotate as the halves (i, i + d/2)."""
    t = torch.arange(8.0).view(1, 1, 1, 8)
    cos, sin = torch.ones(8), torch.zeros(8)
    assert deepseek._rotate(t, cos, sin).flatten().tolist() == \
        [0, 2, 4, 6, 1, 3, 5, 7]
    cos, sin = torch.zeros(8), torch.ones(8)
    assert deepseek._rotate(t, cos, sin).flatten().tolist() == \
        [-1, -3, -5, -7, 0, 2, 4, 6]


def _plain(q, k, v, causal, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                          float("-inf"))
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return o, lse.reshape(-1, q.shape[1])


@pytest.mark.parametrize("causal", [True, False])
def test_attention_with_a_separate_value_width(causal):
    """q/k of 24 dims and v of 16: the plain forward and the blockwise
    backward against autograd of a plain version; 300 keys cross the
    backward's 128-key blocks."""
    g = torch.Generator().manual_seed(6)
    q, k = (torch.randn(2, 300, 3, 24, generator=g, requires_grad=True)
            for _ in range(2))
    v = torch.randn(2, 300, 3, 16, generator=g, requires_grad=True)
    scale = 0.3
    o, lse = attention.flash_attention_with_lse(q, k, v, causal, scale)
    o_ref, lse_ref = _plain(q, k, v, causal, scale)
    assert o.shape == (2, 300, 3, 16)
    assert _rel(o, o_ref) <= TOL and _rel(lse, lse_ref) <= TOL
    do = torch.randn(o.shape, generator=g)
    dlse = torch.randn(lse.shape, generator=g)
    got = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), [q, k, v])
    want = torch.autograd.grad((o_ref * do).sum() + (lse_ref * dlse).sum(),
                               [q, k, v])
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL


def test_flash_operations_count_both_widths():
    assert attention.flash_attn_fwd_flops(2, 4, 4, 3, 192, True, 128) == \
        2 * 2 * 3 * (192 + 128) * 10
    assert attention.flash_attn_fwd_flops(2, 4, 4, 3, 64, False) == \
        4 * 2 * 3 * 64 * 16


def test_the_config_file_keeps_the_published_widths():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "deepseek_v2_lite")
    assert CFG_FILE["published"] == PUBLISHED
    assert entry["source"] == CFG_FILE["source"]
    changed = sorted(key for key, v in PUBLISHED.items()
                     if CFG_FILE[key] != v)
    assert changed == sorted(entry["reduced"]) == sorted(CFG_FILE["reduced"])
    assert (CFG_FILE["num_hidden_layers"], CFG_FILE["n_routed_experts"],
            CFG_FILE["vocab_size"]) == (9, 8, 12800)
    assert CFG_FILE["router_experts"] == PUBLISHED["n_routed_experts"]


def test_the_step_trains_and_opens_its_spans():
    cell, seed = _cell(), 23
    w = _weights(cell, seed)
    model, opt, call, local = _program(cell, w)
    feeds = [local(generator.batch(cell.traffic, cell.cfg, seed, i, "cpu"))
             for i in range(2)]
    with profiling.record_spans() as rec:
        losses = [float(call(model, opt, feeds[0])) for _ in range(3)]
    names = {s.name for s in rec.spans}
    assert {"hvd.step", "hvd.forward", "hvd.mla", "hvd.moe.route",
            "hvd.moe.dispatch", "hvd.moe.experts", "hvd.moe.combine",
            "hvd.optimizer"} <= names
    assert losses[2] < losses[0]
    assert model.routed_pairs().shape == (2, 16)
    assert int(model.routed_pairs().sum()) == 2 * 3 * 64 * 3


def test_the_counter_averages_the_forwards_since_it_was_reset():
    """``routed_pairs`` is the pairs a forward, averaged over the forwards
    since the counter was zeroed; the cell's ``ranges`` (called just before
    the traced steps) zeroes it, so ``work`` reads those steps alone."""
    cell, seed = _cell(n_routed_experts=4, first_expert=4), 31
    model, _, _, _ = _program(cell, _weights(cell, seed))
    ids = [generator.batch(cell.traffic, cell.cfg, seed, i, "cpu")
           ["input_ids"] for i in range(2)]
    one = []
    with torch.no_grad():
        for t in ids:
            model.reset_routed_pairs()
            model(t)
            one.append(model.routed_pairs())
        assert not torch.equal(one[0], one[1])
        cell.module.ranges(model)
        assert float(model.routed_pairs().abs().sum()) == 0
        for t in ids:
            model(t)
    mean = (one[0] + one[1]) / 2
    assert torch.equal(model.routed_pairs(), mean)
    assert cell.module.routed_pairs() == float(mean.sum())


def test_the_model_refuses_meshes_it_cannot_train_on():
    class Mesh:
        shape = {"dp": 1, "tp": 2, "pp": 1, "sp": 1, "ep": 1}
    with pytest.raises(ValueError):
        deepseek.DeepseekV2(deepseek.DeepseekV2Config(
            num_hidden_layers=1, dtype=torch.float32), "cpu", Mesh())
    model = deepseek.DeepseekV2(deepseek.DeepseekV2Config(
        vocab_size=32, hidden_size=16, intermediate_size=8,
        num_hidden_layers=1, num_attention_heads=2, kv_lora_rank=8,
        qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
        dtype=torch.float32), "cpu")
    with pytest.raises(ValueError):
        deepseek.make_deepseek_train_step(model, Mesh())
    deepseek.init_deepseek(model, seed=3)
    for name, p in model.named_parameters():
        if p.dim() == 1:
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert abs(float(p.std()) - 0.02) < 0.01, name


# -- the benchmark's run of the cell at the tiny size -------------------------

def test_a_tiny_run_of_the_cell_is_correct_and_counts_the_routed_pairs():
    cell = _cell()
    rec = harness.run_rank(cell, 2 ** 31 + 41, 0.2, False, device="cpu")
    out = harness.summarize(cell, [rec], 0.0, False, "cpu")
    assert out["correct"] is True, out["checks"]
    numbers = judge.compare(rec["program"], rec["reference"])
    assert numbers["loss_gap"] <= TOL
    # the routed pairs came from the counter: 2 MoE layers, 3 picks of 16
    # experts, all held, for every token
    mod = cell.module
    rows, S = TRAFFIC["rows_per_rank"], TRAFFIC["seq_len"]
    assert rec["flops_per_step"] == pytest.approx(mod.step_flops(
        cell.cfg, rows, S, 2 * rows * S * 3))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "leaf_doubled"])
def test_a_fault_in_the_cell_comes_out_not_correct(fault):
    cell = _cell()
    rec = harness.run_rank(cell, 2 ** 31 + 43, 0.2, False, device="cpu",
                           fault=fault)
    out = harness.summarize(cell, [rec], 0.0, False, "cpu")
    assert out["correct"] is False, out["checks"]


def _metric(name):
    return harness.load_module(ROOT / "perfbench" / "metrics"
                               / f"{name}.py").read


def test_the_cells_metric_readers_on_a_recorded_trace():
    peak = {"flops": 989e12, "bytes_per_s": 3.35e12}
    trace = {"steps": 2, "window_s": 1.0, "busy_s": 0.9,
             "kernel_us": {"void (anonymous namespace)::flash_fwd_kernel_"
                           "bf16<192, 128, true>(CUtensorMap_st, ...)":
                           4000.0,
                           "void (anonymous namespace)::flash_fwd_kernel_"
                           "bf16<128, 128, true>(CUtensorMap_st, ...)": 9.0},
             "range_us": {"mla": 300000.0, "moe": 100000.0}}
    rec = {"trace": trace, "peak": peak,
           "work": {"mla_flash_flops": 0.989e12, "mla_flash_bytes": 1e6,
                    "moe_flops": 9.89e12, "moe_bytes": 3.35e9}}
    assert _metric("mla_ms")(rec) == pytest.approx(150.0)
    assert _metric("moe_ms")(rec) == pytest.approx(50.0)
    assert _metric("mla_flash_roofline")(rec) == pytest.approx(50.0)
    assert _metric("moe_roofline")(rec) == pytest.approx(20.0)
    empty = {**rec, "trace": {**trace, "kernel_us": {}, "range_us": {}}}
    for name in ("mla_ms", "moe_ms", "mla_flash_roofline", "moe_roofline"):
        assert _metric(name)(empty) is None
        assert _metric(name)({**rec, "trace": None}) is None
        assert _metric(name)({**rec, "work": {}, "trace": {
            **trace, "range_us": {}}}) is None


def test_the_cells_operations_at_the_published_widths():
    """~99 TFLOP a step at 8 x 4096 with the held experts' expected pairs;
    the MLA flash forward's causal count at 2·(192 + 128) a pair."""
    mod = harness.Cell(CELL).module
    cfg = CFG_FILE
    pairs = 8 * 32768 * 6 * 8 / 64
    got = mod.step_flops(cfg, 8, 4096, pairs)
    assert 95e12 < got < 103e12
    work = mod.layer_work(cfg, 8, 4096, pairs)
    assert work["mla_flash_flops"] == 9 * attention.flash_attn_fwd_flops(
        8, 4096, 4096, 16, 192, True, 128)
