"""The port's CNN zoo (ResNet, VGG, Inception V3) against the JAX
package's, on the CPU.

Weights come across from flax: the JAX model's ``init`` (with its BN
scales, biases and running statistics perturbed, so that none sits at its
initial value) goes through ``from_flax`` into the port's module, and the
same numpy images (NHWC for JAX, NCHW for the port) go through both. The
oracles, at 1e-4 unless a line says otherwise:

* ResNet ``[1, 1, 1, 1]`` with 10 classes at 64x64 (``tests/test_resnet.py``),
  both stems: train-mode logits, the loss and the new ``batch_stats``;
  eval-mode logits; one SGD-momentum step of ``make_resnet_train_step``
  (parameters and BN statistics) against the JAX step on one device;
  ``scan_steps=3`` against three single steps and ``remat=True`` against
  plain (the port's own); ``space_to_depth`` equal to JAX's;
* a 2-rank gloo world of ``make_resnet_train_step`` on ``{dp: 2}`` against
  the JAX step on a 2-device dp mesh: the loss, every parameter and the
  running statistics of the GLOBAL batch (a local BN fails it);
* VGG with the narrow stages of ``tests/test_resnet.py`` at 64x64 and
  Inception V3 at full width, 95x95, 8 classes, at dropout 0: logits, loss
  (and Inception's new statistics), one step; dropout's masks fresh for
  each step index, repeatable from the seed, and an indexed ``scan_steps``
  chain equal to the same steps in order; the Inception channel geometry;
* the full-width models (ResNet-50/101, VGG-16, Inception V3) have JAX's
  parameter and statistic names, shapes and counts (JAX's side from
  ``jax.eval_shape`` of ``init``, the port's on the meta device);
* ``MODEL_ZOO`` has JAX's keys and ``get_model`` JAX's error.

ResNet's forward, loss and BN statistics and all of VGG compare in fp32.
Two things compare in fp64 on both sides instead (JAX with x64 on; the
fp32 heads stay fp32 in both), each for a reason measured by
``tests/torch_port_zoo_fp32_drift.py``:

* the optimizer steps of the BN models (ResNet, the 2-rank world,
  Inception): at fp32 a ReLU input may lie within the two frameworks'
  rounding difference of zero and land on the other side of the kink. On
  the tiny ResNet below, one input of ``BottleneckBlock_3``'s second ReLU
  sits at 2.65e-6: its channel's BN-bias gradient is 1.69e-3 off JAX's
  fp64 one, every other channel within 2.7e-8 (the worst leaf 1.74e-2 rel
  L2 from the port, 3.7e-2 from JAX in fp32);
* all of Inception: a randomly initialised deep stack of conv-BN-ReLU
  (about 45 along its longest path, without ResNet's zero-initialised
  residual scales) multiplies a rounding difference at each layer: the
  two frameworks' fp32 outputs drift from 2.5e-5 after the stem to 3.5e-2
  after the last block (6.1e-3 on the logits), while an InceptionC block
  alone agrees within 4.5e-5.

The torch side of the 2-rank world runs as ``python
tests/test_torch_port_zoo.py --worker dp2 --out DIR`` with the flax
weights in the npz that ``ZOO_WEIGHTS`` names.
"""

import functools
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

    from horovod_tpu.models import inception as jinc
    from horovod_tpu.models import resnet as jres
    from horovod_tpu.models import vgg as jvgg
    from horovod_tpu.parallel.mesh import build_mesh

    from test_torch_port_dp import spawn

IMG, CLASSES, B = 64, 10, 8
SGD_LR, SGD_MOMENTUM = 0.1, 0.9
VGG_STAGES = ((1, 8), (1, 16), (1, 16), (1, 32), (1, 32))
INC_IMG, INC_CLASSES = 95, 8


def batch(n, size, classes, seed=0):
    """``n`` seeded NHWC images in [0, 1) and their labels."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size, 3).astype(np.float32),
            rng.randint(0, classes, (n,)).astype(np.int32))


def nchw(x):
    import torch
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def split_weights(flat):
    """An npz of ``params.<path>`` and ``batch_stats.<path>`` leaves → the
    two flat trees ``from_flax`` takes."""
    trees = {"params": {}, "batch_stats": {}}
    for k, v in flat.items():
        col, path = k.split(".", 1)
        trees[col][path] = v
    return trees["params"], trees["batch_stats"]


# -- the worker (torch only) ---------------------------------------------------

def _w_dp2():
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    mesh = hvd.build_mesh(dp=2)
    params, stats = split_weights(dict(np.load(os.environ["ZOO_WEIGHTS"])))
    model = resnet.ResNet([1, 1, 1, 1], CLASSES, torch.float64,
                          device="cpu", mesh=mesh)
    model.load_state_dict(resnet.from_flax(params, stats))
    model.double()
    x, y = batch(2 * B, IMG, CLASSES, seed=1)
    xb, yb = hvd.shard_batch(nchw(x).double(), torch.from_numpy(y).long(),
                             mesh)
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR,
                          momentum=SGD_MOMENTUM)
    step = resnet.make_resnet_train_step(model, mesh)
    out = {}
    for i in range(2):
        _, _, loss = step(model, opt, xb, yb)
        out[f"loss{i}"] = loss.numpy().copy()
        for k, v in model.state_dict().items():
            out[f"s{i}.{k}"] = v.numpy().copy()
    return out


if __name__ == "__main__":
    sys.exit(worker_main({"dp2": _w_dp2}, sys.argv[1:]))


# -- JAX references ----------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _perturb(variables, seed=3):
    """The init's BN leaves moved off their initial values: scales around 1,
    biases and running means around 0, running variances in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def walk(tree, col):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, col)
                continue
            a = np.asarray(v)
            if col == "params" and k == "scale":
                a = 1.0 + 0.2 * rng.randn(*a.shape)
            elif col == "params" and k == "bias" and a.ndim == 1 \
                    and "BatchNorm" in str(tree):
                a = 0.1 * rng.randn(*a.shape)
            elif col == "batch_stats":
                a = 0.1 * rng.randn(*a.shape) if k == "mean" else \
                    0.5 + rng.rand(*a.shape)
            out[k] = jnp.asarray(a, jnp.float32)
        return out

    return {col: walk(tree, col) for col, tree in variables.items()}


def _init(model, size, train):
    v = jax.jit(functools.partial(model.init, train=train))(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32))
    return _perturb(jax.tree_util.tree_map(np.asarray, dict(v)))


def _xent(logits, labels):
    logits = logits.astype(np.float64)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    return float(np.mean(lse - logits[np.arange(len(labels)), labels]))


def _mesh(n):
    return build_mesh(dp=n, devices=jax.devices()[:n])


def _jax_step(make, model, v, tx, x, y, n=1, x64=True):
    """One JAX train step on an n-device dp mesh: (params, stats, loss);
    with ``x64`` in fp64 (``model`` built with ``dtype=jnp.float64``)."""
    dt = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        mesh = _mesh(n)
        sh = jres.batch_sharding(mesh)

        def cast(tree):      # a copy: the step donates its state
            return jax.tree_util.tree_map(lambda a: jnp.array(a, dt), tree)

        p = cast(v["params"])
        step = make(model, tx, mesh)
        xs = jax.device_put(jnp.asarray(x, dt), sh)
        ys = jax.device_put(jnp.asarray(y), sh)
        if "batch_stats" in v:
            p, bs, _, loss = step(p, cast(v["batch_stats"]), tx.init(p), xs,
                                  ys)
            return _flat(p), _flat(bs), float(loss)
        p, _, loss = step(p, tx.init(p), xs, ys)
        return _flat(p), {}, float(loss)


def _port(model_cls, v, *args, **kw):
    """The port's model from the flax weights ``v``; built with
    ``dtype=torch.float64`` its leaves are fp64 too."""
    from horovod_tpu_torch.models._flax import from_flax
    m = model_cls(*args, device="cpu", **kw)
    m.load_state_dict(from_flax(v["params"], v.get("batch_stats")))
    return m.double() if m.dtype == torch.float64 else m


def _close_state(model, params, stats, rtol=1e-4, atol=1e-5):
    from horovod_tpu_torch.models._flax import from_flax
    want = from_flax(params, stats)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the port's CPU steps then keep their pace
    beside other test processes on a loaded box."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# -- ResNet --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["conv", "s2d"])
def resnet_ref(request):
    """The JAX tiny ResNet of one stem: weights, train/eval forwards and
    one SGD-momentum step on one device."""
    stem = request.param
    model = jres.ResNet([1, 1, 1, 1], num_classes=CLASSES, dtype=jnp.float32,
                        stem=stem)
    v = _init(model, IMG, True)
    x, y = batch(B, IMG, CLASSES)
    logits, mut = jax.jit(functools.partial(
        model.apply, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    eval_logits = jax.jit(functools.partial(model.apply, train=False))(
        v, jnp.asarray(x))
    p1, s1, loss1 = _jax_step(
        jres.make_resnet_train_step, jres.ResNet(
            [1, 1, 1, 1], num_classes=CLASSES, dtype=jnp.float64, stem=stem),
        v, optax.sgd(SGD_LR, momentum=SGD_MOMENTUM), x, y)
    return dict(stem=stem, v=v, x=x, y=y, logits=np.asarray(logits),
                stats=_flat(mut["batch_stats"]),
                eval_logits=np.asarray(eval_logits), p1=p1, s1=s1,
                loss1=loss1)


def _resnet(ref, dtype=torch.float32, **kw):
    from horovod_tpu_torch.models.resnet import ResNet
    return _port(ResNet, ref["v"], [1, 1, 1, 1], CLASSES, dtype,
                 ref["stem"], **kw)


def test_resnet_forward_loss_and_batch_stats_match_jax(resnet_ref):
    from horovod_tpu_torch.models._flax import from_flax
    m = _resnet(resnet_ref)
    m.train()
    logits = m(nchw(resnet_ref["x"])).detach().numpy()
    np.testing.assert_allclose(logits, resnet_ref["logits"], rtol=1e-4,
                               atol=1e-4)
    loss = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(resnet_ref["y"]).long())
    np.testing.assert_allclose(float(loss),
                               _xent(resnet_ref["logits"], resnet_ref["y"]),
                               rtol=1e-4)
    want = from_flax({}, resnet_ref["stats"])
    for k, w in want.items():
        np.testing.assert_allclose(m.state_dict()[k].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_resnet_eval_logits_match_jax(resnet_ref):
    m = _resnet(resnet_ref)
    m.eval()
    with torch.no_grad():
        logits = m(nchw(resnet_ref["x"])).numpy()
    np.testing.assert_allclose(logits, resnet_ref["eval_logits"], rtol=1e-4,
                               atol=1e-4)


def _sgd(model):
    return torch.optim.SGD(model.parameters(), lr=SGD_LR,
                           momentum=SGD_MOMENTUM)


def _step(model, scan_steps=1):
    from horovod_tpu_torch.models.resnet import make_resnet_train_step
    return make_resnet_train_step(model, None, scan_steps)


def test_resnet_sgd_step_matches_jax_step(resnet_ref):
    """In fp64 on both sides (the module docstring says why)."""
    m = _resnet(resnet_ref, torch.float64)
    _, _, loss = _step(m)(m, _sgd(m), nchw(resnet_ref["x"]).double(),
                          torch.from_numpy(resnet_ref["y"]))
    np.testing.assert_allclose(float(loss), resnet_ref["loss1"], rtol=1e-4)
    _close_state(m, resnet_ref["p1"], resnet_ref["s1"])


def _state(m):
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


def test_resnet_scan_steps_equal_single_steps(resnet_ref):
    x, y = nchw(resnet_ref["x"]), torch.from_numpy(resnet_ref["y"])
    a, b = _resnet(resnet_ref), _resnet(resnet_ref)
    oa, ob = _sgd(a), _sgd(b)
    for _ in range(3):
        _, _, la = _step(a)(a, oa, x, y)
    _, _, lb = _step(b, scan_steps=3)(b, ob, x, y)
    assert float(la) == float(lb)
    sa, sb = _state(a), _state(b)
    for k in sa:
        np.testing.assert_allclose(sa[k].numpy(), sb[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_resnet_remat_matches_plain(resnet_ref):
    """Recomputing each block in the backward changes memory, not math: the
    loss, the parameters and the BN statistics (updated once, not again by
    the recompute) of one step equal the plain model's."""
    x, y = nchw(resnet_ref["x"]), torch.from_numpy(resnet_ref["y"])
    outs = []
    for remat in (False, True):
        m = _resnet(resnet_ref, remat=remat)
        _, _, loss = _step(m)(m, _sgd(m), x, y)
        outs.append((float(loss), _state(m)))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for k, v in outs[0][1].items():
        np.testing.assert_allclose(outs[1][1][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_space_to_depth_matches_jax():
    from horovod_tpu_torch.models.resnet import space_to_depth
    x = np.random.RandomState(5).randn(2, 8, 6, 3).astype(np.float32)
    want = np.asarray(jres.space_to_depth(jnp.asarray(x), 2))
    got = space_to_depth(nchw(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    # pixel_unshuffle's channel order is another one
    other = torch.nn.functional.pixel_unshuffle(nchw(x), 2)
    assert not np.array_equal(other.permute(0, 2, 3, 1).numpy(), want)


def test_same_pad_puts_the_odd_pixel_at_the_end():
    from horovod_tpu_torch.models._flax import same_pad
    assert same_pad(56, 3, 2) == (0, 1)      # 3x3/s2 on an even input
    assert same_pad(112, 4, 1) == (1, 2)     # the s2d stem
    assert same_pad(56, 1, 2) == (0, 0)
    assert same_pad(35, 3, 1) == (1, 1)
    assert same_pad(17, 7, 1) == (3, 3)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """The JAX tiny ResNet's weights, its step on a 2-device dp mesh over
    the 16-image global batch, and the port's 2-rank gloo world from the
    same weights (two steps a rank)."""
    model = jres.ResNet([1, 1, 1, 1], num_classes=CLASSES, dtype=jnp.float32)
    v = _init(model, IMG, True)
    d = tmp_path_factory.mktemp("zoo_dp2")
    path = str(d / "weights.npz")
    np.savez(path, **{f"{col}.{k}": a for col in v
                      for k, a in _flat(v[col]).items()})
    x, y = batch(2 * B, IMG, CLASSES, seed=1)
    tx = optax.sgd(SGD_LR, momentum=SGD_MOMENTUM)
    p1, s1, loss1 = _jax_step(
        jres.make_resnet_train_step,
        jres.ResNet([1, 1, 1, 1], num_classes=CLASSES, dtype=jnp.float64),
        v, tx, x, y, n=2)
    ranks = spawn("dp2", 2, d, {"ZOO_WEIGHTS": path}, script=__file__)
    return dict(v=v, x=x, y=y, p1=p1, s1=s1, loss1=loss1, ranks=ranks)


def test_resnet_dp2_step_matches_jax_dp2_step(dp2):
    """The JAX step on a dp = 2 mesh normalizes with the GLOBAL batch's
    moments (GSPMD); the port's two ranks, each holding 8 of the 16 images,
    reduce their BN moments over dp and match its loss, parameters and
    running statistics (both in fp64)."""
    from horovod_tpu_torch.models._flax import from_flax
    want = from_flax(dp2["p1"], dp2["s1"])
    for res in dp2["ranks"]:
        np.testing.assert_allclose(float(res["loss0"]), dp2["loss1"],
                                   rtol=1e-4)
        for k, w in want.items():
            np.testing.assert_allclose(res[f"s0.{k}"], w.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_resnet_dp2_ranks_stay_bit_identical(dp2):
    a, b = dp2["ranks"]
    for key in a:
        if key.startswith("s") or key.startswith("loss"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_resnet_dp2_local_batch_norm_would_differ(dp2):
    """The check above has teeth: a model whose BN takes each rank's own
    block (no mesh) ends the step away from the JAX dp = 2 statistics."""
    from horovod_tpu_torch.models._flax import from_flax
    from horovod_tpu_torch.models.resnet import ResNet
    x, y = nchw(dp2["x"]).double(), torch.from_numpy(dp2["y"])
    m = _port(ResNet, dp2["v"], [1, 1, 1, 1], CLASSES, torch.float64)
    _step(m)(m, _sgd(m), x[:B], y[:B])
    want = from_flax({}, dp2["s1"])
    worst = max(float((m.state_dict()[k] - w).abs().max() / w.abs().max())
                for k, w in want.items())
    assert worst > 1e-2, worst


# -- VGG -----------------------------------------------------------------------------

def _vgg(v, dropout=0.0):
    from horovod_tpu_torch.models.vgg import VGG
    return _port(VGG, v, VGG_STAGES, 8, torch.float32, dropout, IMG)


@pytest.fixture(scope="module")
def vgg_ref():
    model = jvgg.VGG(stages=VGG_STAGES, num_classes=8, dtype=jnp.float32,
                     dropout=0.0)
    v = _init(model, IMG, False)
    x, y = batch(B, IMG, 8, seed=2)
    logits = jax.jit(functools.partial(model.apply, train=True))(
        v, jnp.asarray(x))
    p1, _, loss1 = _jax_step(jvgg.make_vgg_train_step, model, v,
                             optax.sgd(0.05, momentum=0.9), x, y, x64=False)
    return dict(v=v, x=x, y=y, logits=np.asarray(logits), p1=p1, loss1=loss1)


def test_vgg_forward_loss_and_step_match_jax(vgg_ref):
    from horovod_tpu_torch.models.vgg import make_vgg_train_step
    m = _vgg(vgg_ref["v"])
    m.train()
    logits = m(nchw(vgg_ref["x"])).detach().numpy()
    np.testing.assert_allclose(logits, vgg_ref["logits"], rtol=1e-4,
                               atol=1e-4)
    opt = torch.optim.SGD(m.parameters(), lr=0.05, momentum=0.9)
    _, _, loss = make_vgg_train_step(m)(m, opt, nchw(vgg_ref["x"]),
                                        torch.from_numpy(vgg_ref["y"]), 0)
    np.testing.assert_allclose(float(loss), vgg_ref["loss1"], rtol=1e-4)
    np.testing.assert_allclose(float(loss),
                               _xent(vgg_ref["logits"], vgg_ref["y"]),
                               rtol=1e-4)
    _close_state(m, vgg_ref["p1"], None)


def test_vgg_dropout_masks_fresh_per_step_and_repeatable(vgg_ref):
    """Dropout 0.5 through the step: the same seed and step index give the
    same loss and parameters, another index another mask."""
    from horovod_tpu_torch.models.vgg import make_vgg_train_step
    x, y = nchw(vgg_ref["x"]), torch.from_numpy(vgg_ref["y"])
    runs = {}
    for name, idx in (("a", 0), ("b", 0), ("c", 1)):
        m = _vgg(vgg_ref["v"], dropout=0.5)
        opt = torch.optim.SGD(m.parameters(), lr=0.05, momentum=0.9)
        _, _, loss = make_vgg_train_step(m, dropout_seed=7)(m, opt, x, y, idx)
        runs[name] = (float(loss), _state(m))
    assert runs["a"][0] == runs["b"][0]
    for k in runs["a"][1]:
        assert torch.equal(runs["a"][1][k], runs["b"][1][k]), k
    assert runs["a"][0] != runs["c"][0]
    m = _vgg(vgg_ref["v"], dropout=0.5)
    m.eval()      # no dropout outside training
    with torch.no_grad():
        np.testing.assert_allclose(m(x).numpy(), vgg_ref["logits"],
                                   rtol=1e-4, atol=1e-4)


def test_vgg_indexed_scan_steps_match_sequential_dropout_indices(vgg_ref):
    """The port of ``test_vgg_scan_steps_matches_sequential_dropout_
    indices``: a ``scan_steps=2`` call with ``step_idx=0`` equals two
    single steps with ``step_idx`` 0 then 1."""
    from horovod_tpu_torch.models.vgg import make_vgg_train_step
    x, y = nchw(vgg_ref["x"]), torch.from_numpy(vgg_ref["y"])
    a, b = _vgg(vgg_ref["v"], 0.5), _vgg(vgg_ref["v"], 0.5)
    oa = torch.optim.SGD(a.parameters(), lr=0.05, momentum=0.9)
    ob = torch.optim.SGD(b.parameters(), lr=0.05, momentum=0.9)
    for i in range(2):
        _, _, la = make_vgg_train_step(a)(a, oa, x, y, i)
    _, _, lb = make_vgg_train_step(b, scan_steps=2)(b, ob, x, y, 0)
    assert float(la) == float(lb)
    sa, sb = _state(a), _state(b)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# -- Inception V3 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def inception_ref():
    """JAX Inception V3 at full width, 95x95, 8 classes, dropout 0, in fp64
    (the module docstring says why): the train-mode forward and one
    SGD-momentum step (``tests/test_inception.py``'s optimizer)."""
    model = jinc.InceptionV3(num_classes=INC_CLASSES, dtype=jnp.float64,
                             dropout=0.0)
    v = _init(jinc.InceptionV3(num_classes=INC_CLASSES, dtype=jnp.float32,
                               dropout=0.0), INC_IMG, False)
    x, y = batch(4, INC_IMG, INC_CLASSES, seed=4)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.array(a, jnp.float64), v)
        logits, mut = jax.jit(functools.partial(
            model.apply, train=True, mutable=["batch_stats"]))(
                v64, jnp.asarray(x, jnp.float64))
        logits, stats = np.asarray(logits), _flat(mut["batch_stats"])
    p1, s1, loss1 = _jax_step(jinc.make_inception_train_step, model, v,
                              optax.sgd(0.01, momentum=0.9), x, y)
    return dict(v=v, x=x, y=y, logits=logits, stats=stats, p1=p1, s1=s1,
                loss1=loss1)


def test_inception_forward_stats_and_step_match_jax(inception_ref):
    from horovod_tpu_torch.models._flax import from_flax
    from horovod_tpu_torch.models.inception import (InceptionV3,
                                                    make_inception_train_step)
    x = nchw(inception_ref["x"]).double()
    m = _port(InceptionV3, inception_ref["v"], INC_CLASSES, torch.float64,
              0.0)
    m.train()
    logits = m(x).detach().numpy()
    np.testing.assert_allclose(logits, inception_ref["logits"], rtol=1e-4,
                               atol=1e-4)
    for k, w in from_flax({}, inception_ref["stats"]).items():
        np.testing.assert_allclose(m.state_dict()[k].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    m = _port(InceptionV3, inception_ref["v"], INC_CLASSES, torch.float64,
              0.0)
    opt = torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9)
    _, _, loss = make_inception_train_step(m)(
        m, opt, x, torch.from_numpy(inception_ref["y"]), 0)
    np.testing.assert_allclose(float(loss), inception_ref["loss1"], rtol=1e-4)
    np.testing.assert_allclose(
        float(loss), _xent(inception_ref["logits"], inception_ref["y"]),
        rtol=1e-4)
    _close_state(m, inception_ref["p1"], inception_ref["s1"])


def test_inception_v3_channel_geometry():
    """``tests/test_inception.py::test_inception_v3_channel_geometry``:
    35x35 stages end at 288, 17x17 at 768, 8x8 at 2048."""
    from horovod_tpu_torch.models import inception as inc
    x = torch.zeros(1, 192, 35, 35)
    with torch.no_grad():
        for pf, want in ((32, 256), (64, 288), (64, 288)):
            x = inc.InceptionA(x.shape[1], pf, torch.float32).eval()(x)
            assert x.shape[1] == want
        x = inc.ReductionA(x.shape[1], dtype=torch.float32).eval()(x)
        assert tuple(x.shape) == (1, 768, 17, 17)
        x = inc.InceptionB(x.shape[1], 128, torch.float32).eval()(x)
        assert x.shape[1] == 768
        x = inc.ReductionB(x.shape[1], dtype=torch.float32).eval()(x)
        assert tuple(x.shape) == (1, 1280, 8, 8)
        x = inc.InceptionC(x.shape[1], torch.float32).eval()(x)
        assert x.shape[1] == 2048


# -- full width and the index ------------------------------------------------------------

FULL = {
    "resnet50": (lambda: jres.ResNet50(), 224, True),
    "resnet101": (lambda: jres.ResNet101(stem="s2d"), 224, True),
    "vgg16": (lambda: jvgg.VGG16(), 224, False),
    "inception3": (lambda: jinc.InceptionV3(), 299, False),
} if __name__ != "__main__" else {}


def _jax_shapes(model, size, train):
    """``{flax path with dots: shape}`` of params and batch_stats, from
    ``jax.eval_shape`` (nothing computed)."""
    v = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=train))
    leaves = jax.tree_util.tree_flatten_with_path(v)[0]
    return {".".join(str(p.key) for p in path[1:]): tuple(a.shape)
            for path, a in leaves}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_names_shapes_and_counts_match_jax(name):
    """Every flax leaf (params and batch_stats) is a ``state_dict`` key of
    the port's model built on the meta device, of the shape ``from_flax``
    gives it, and the counts agree."""
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models._flax import _flax_leaf
    make, size, train = FULL[name]
    want = _jax_shapes(make(), size, train)
    kw = {"stem": "s2d"} if name == "resnet101" else {}
    port = {k: tuple(v.shape) for k, v in
            get_model(name, device="meta", **kw).state_dict().items()}
    assert set(port) == set(want)
    for k, shape in want.items():
        conv = _flax_leaf(k, np.broadcast_to(np.float32(0), shape)).shape
        assert port[k] == conv, (k, port[k], shape)
    assert sum(np.prod(s) for s in port.values()) == \
        sum(np.prod(s) for s in want.values())


def test_model_zoo_keys_and_unknown_name_match_jax():
    from horovod_tpu.models import MODEL_ZOO as JZOO
    from horovod_tpu.models import get_model as jget
    from horovod_tpu_torch.models import MODEL_ZOO, get_model
    assert sorted(MODEL_ZOO) == sorted(JZOO)
    with pytest.raises(KeyError) as jerr:
        jget("resnet18")
    with pytest.raises(KeyError) as err:
        get_model("resnet18")
    assert str(err.value) == str(jerr.value)
    assert get_model("bert_base").hidden_size == 768


def _init_distributions_match(jax_flat, port_sd):
    """Each leaf of the port's init drawn as flax draws it: constants equal,
    large random leaves of the same std (within 10%) and zero mean."""
    assert set(jax_flat) == set(port_sd)
    for k, a in jax_flat.items():
        b = port_sd[k].double().numpy()
        if np.all(a == a.flat[0]):
            np.testing.assert_array_equal(b, a.flat[0], err_msg=k)
        elif a.size >= 4096:
            assert abs(b.std() / a.std() - 1.0) < 0.1, (k, b.std(), a.std())
            assert abs(b.mean()) < 0.1 * a.std(), (k, b.mean())


@pytest.mark.parametrize("family", ["resnet", "vgg"])
def test_init_draws_flax_distributions(family):
    """``create_*_state`` gives JAX's shapes, not its values: the same
    initializers (lecun-normal kernels truncated at 2 std, zero biases, BN
    ones and zeros with the last scale of each block 0)."""
    from horovod_tpu_torch.models import resnet, vgg
    if family == "resnet":
        jm = jres.ResNet([1, 1, 1, 1], num_classes=CLASSES, dtype=jnp.float32)
        pm = resnet.create_resnet_state(resnet.ResNet(
            [1, 1, 1, 1], CLASSES, torch.float32, device="cpu"), 0)
        train = True
    else:
        jm = jvgg.VGG(stages=VGG_STAGES, num_classes=8, dtype=jnp.float32)
        pm = vgg.create_vgg_state(vgg.VGG(VGG_STAGES, 8, torch.float32,
                                          image_size=IMG, device="cpu"), 0)
        train = False
    v = jax.jit(functools.partial(jm.init, train=train))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    flat = {k: a for col in v for k, a in _flat(v[col]).items()}
    _init_distributions_match(flat, pm.state_dict())
