"""The port's TensorFlow and Keras shims (``horovod_tpu_torch.tensorflow``,
``.keras``) against the JAX package's, on the CPU.

Every case of ``tests/test_tf_adapter.py`` runs once with each package on
the same seeded inputs (each package in its own world of one, both in this
process): the case's own checks hold for both, and the results compare,
collectives and identity ops to the bit (values and dtype), losses and
trained weights within 1e-6 relative. Models are built once per package and
take the same numpy-seeded weights (``set_weights``); ``fit``'s shuffling
follows ``keras.utils.set_random_seed``. The dtype cases hold every dtype
that the JAX tests use, plus bf16, fp16 and int32, to the exact dtype and
value that come back, against the numpy reference (in a world of one, the
inputs themselves) and the JAX package's results. The two-rank world
(``tests/torch_port_tf_worker.py``) runs the shim over the port's core.
"""

import importlib
import os
import re
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import build_core, launch_env_world  # noqa: E402

TF_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_port_tf_worker.py")
RTOL = 1e-6


@pytest.fixture
def pkgs(hvd):
    """``{"jax": (tf shim, keras shim), "port": (...)}``, each package
    initialized in a world of one."""
    import horovod_tpu.keras as jk
    import horovod_tpu.tensorflow as jt
    import horovod_tpu_torch
    import horovod_tpu_torch.keras as pk
    import horovod_tpu_torch.tensorflow as pt
    horovod_tpu_torch.shutdown()
    horovod_tpu_torch.init()
    yield {"jax": (jt, jk), "port": (pt, pk)}
    horovod_tpu_torch.shutdown()


def _np(x):
    """numpy of a TF tensor or variable (bf16 as its uint16 bits), or of a
    plain value."""
    if hasattr(x, "dtype") and getattr(x.dtype, "name", "") == "bfloat16" \
            and hasattr(x, "numpy"):
        return tf.bitcast(tf.convert_to_tensor(x), tf.uint16).numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _dtype(x) -> str:
    return x.dtype.name


def _run(case, pkgs, tmp_path, monkeypatch):
    """``case`` with each package, and the results compared. A case gets
    ``(tf shim, keras shim, directory)`` and returns a dict: keys starting
    with ``=`` compare to the bit (values and dtype), the others within
    ``RTOL``."""
    out = {}
    for name, (t, k) in pkgs.items():
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("HVD_ELASTIC_CKPT", str(d / "ckpt"))
        tf.keras.utils.set_random_seed(0)
        out[name] = case(t, k, d)
    jx, pt = out["jax"], out["port"]
    assert sorted(jx) == sorted(pt)
    for key in jx:
        if key.startswith("="):
            a, b = jx[key], pt[key]
            assert _dtype(a) == _dtype(b), (key, a, b)
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=key)
        else:
            np.testing.assert_allclose(_np(pt[key]), _np(jx[key]),
                                       rtol=RTOL, err_msg=key)


def _seeded(model, seed=0):
    """Give ``model`` weights drawn from numpy's seeded generator."""
    rng = np.random.RandomState(seed)
    model.set_weights([rng.randn(*w.shape).astype(w.dtype) * 0.5
                       for w in model.get_weights()])
    return model


def _xy(n):
    x = np.random.RandomState(0).randn(n, 4).astype(np.float32)
    return x, x @ np.asarray([[1.0], [2.0], [3.0], [4.0]], np.float32)


# -- the cases of tests/test_tf_adapter.py ----------------------------------

def c_tf_allreduce(t, k, d):
    out = t.allreduce(tf.constant([1.0, 2.0, 3.0]), op=t.Sum)
    np.testing.assert_allclose(out.numpy(), [1.0, 2.0, 3.0])
    return {"=out": out}


def c_tf_allgather_broadcast_alltoall(t, k, d):
    g = t.allgather(tf.eye(2))
    assert g.shape == (2, 2)
    b = t.broadcast(tf.constant([5.0]), root_rank=0)
    np.testing.assert_allclose(b.numpy(), [5.0])
    a = t.alltoall(tf.constant([[1.0], [2.0]]))
    assert a.shape == (2, 1)  # no splits -> the bare tensor
    a2, rs = t.alltoall(tf.constant([[1.0], [2.0]]), splits=[2])
    assert a2.shape == (2, 1) and list(rs.numpy()) == [2]
    return {"=g": g, "=b": b, "=a": a, "=a2": a2, "=rs": rs}


def c_tf_distributed_gradient_tape(t, k, d):
    w = tf.Variable([[1.0], [2.0]])
    x = tf.constant([[3.0, 4.0]])
    with t.DistributedGradientTape(tf.GradientTape()) as tape:
        y = tf.reduce_sum(tf.matmul(x, w))
    (grad,) = tape.gradient(y, [w])
    np.testing.assert_allclose(grad.numpy(), [[3.0], [4.0]])
    return {"=grad": grad}


def c_tf_distributed_optimizer_trains(t, k, d):
    w = tf.Variable(tf.zeros((4, 1)))
    x = tf.constant(np.random.RandomState(0).randn(16, 4).astype(np.float32))
    target = tf.matmul(x, tf.constant([[1.0], [2.0], [3.0], [4.0]]))
    opt = t.DistributedOptimizer(tf.keras.optimizers.SGD(learning_rate=0.1))
    losses = []
    for _ in range(100):
        with tf.GradientTape() as tape:
            loss = tf.reduce_mean((tf.matmul(x, w) - target) ** 2)
        grads = tape.gradient(loss, [w])
        opt.apply_gradients(zip(grads, [w]))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.05
    return {"losses": losses, "w": w.numpy()}


def c_tf_backward_passes_per_step(t, k, d):
    w = tf.Variable([0.0])
    opt = t.DistributedOptimizer(tf.keras.optimizers.SGD(learning_rate=1.0),
                                 backward_passes_per_step=2)
    assert opt.apply_gradients([(tf.constant([1.0]), w)]) is None
    w1 = w.numpy()
    np.testing.assert_allclose(w1, [0.0])  # accumulating
    opt.apply_gradients([(tf.constant([3.0]), w)])
    np.testing.assert_allclose(w.numpy(), [-2.0])  # mean(1,3) applied
    return {"=w1": w1, "=w2": w.numpy()}


def c_tf_backward_passes_graph_mode(t, k, d):
    w = tf.Variable([0.0])
    opt = t.DistributedOptimizer(tf.keras.optimizers.SGD(learning_rate=1.0),
                                 backward_passes_per_step=2)

    @tf.function
    def step(g):
        return opt.apply_gradients([(g, w)])

    seen, applied = [], []
    for g in (1.0, 3.0, 5.0, 7.0):
        applied.append(bool(step(tf.constant([g]))))
        seen.append(float(w.numpy()[0]))
    assert seen == [0.0, -2.0, -2.0, -8.0]
    assert applied == [False, True, False, True]
    return {"=w": np.asarray(seen, np.float32),
            "=applied": np.asarray(applied)}


def c_tf_sync_batch_norm(t, k, d):
    rng = np.random.RandomState(0)
    x = tf.constant(rng.randn(16, 4).astype(np.float32))
    layer = t.SyncBatchNormalization(momentum=0.0)
    y = layer(x, training=True)
    np.testing.assert_allclose(np.asarray(y).mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y).std(0), 1.0, atol=1e-2)
    n = x.shape[0]
    np.testing.assert_allclose(layer.moving_variance.numpy(),
                               np.asarray(x).var(0) * n / (n - 1),
                               rtol=1e-5)
    y2 = layer(x, training=False)
    assert np.all(np.isfinite(np.asarray(y2)))
    return {"y": y, "var": layer.moving_variance.numpy(), "y2": y2}


def c_keras_optimizer_backward_passes(t, k, d):
    w = tf.Variable([0.0])
    opt = k.DistributedOptimizer(tf.keras.optimizers.SGD(learning_rate=1.0),
                                 backward_passes_per_step=2)

    @tf.function
    def step(g):
        opt.apply_gradients([(g, w)])

    step(tf.constant([1.0]))
    w1 = w.numpy()
    np.testing.assert_allclose(w1, [0.0])  # accumulating
    step(tf.constant([3.0]))
    np.testing.assert_allclose(w.numpy(), [-2.0])  # mean(1,3) applied
    return {"=w1": w1, "=w2": w.numpy()}


def c_tf_keras_elastic_state(t, k, d):
    model = _seeded(tf.keras.Sequential(
        [tf.keras.layers.Input((3,)), tf.keras.layers.Dense(2)]))
    opt = tf.keras.optimizers.SGD(learning_rate=0.1)
    model.compile(optimizer=opt, loss="mse")
    state = t.elastic.TensorFlowKerasState(model, opt, epoch=0, name="tfk")
    state.save()
    before = [w.copy() for w in model.get_weights()]
    model.set_weights([w + 1.0 for w in model.get_weights()])
    state.epoch = 4
    state.restore()
    for a, b in zip(model.get_weights(), before):
        np.testing.assert_allclose(a, b)
    assert state.epoch == 0
    state.sync()  # size 1: a no-op that doesn't fail
    restored = model.get_weights()
    model2 = _seeded(tf.keras.Sequential(
        [tf.keras.layers.Input((3,)), tf.keras.layers.Dense(2)]), seed=1)
    state.epoch = 2
    state.save()
    state2 = t.elastic.TensorFlowKerasState(model2, None, epoch=0,
                                            name="tfk")
    assert state2.epoch == 2
    for a, b in zip(model2.get_weights(), before):
        np.testing.assert_allclose(a, b)
    return {"=restored": np.concatenate([w.ravel() for w in restored]),
            "=resumed": np.concatenate([w.ravel()
                                        for w in model2.get_weights()]),
            "=epoch": np.asarray(state2.epoch)}


def c_tf_raw_variable_elastic_state(t, k, d):
    v1 = tf.Variable([1.0, 2.0])
    v2 = tf.Variable([[3.0]])
    state = t.elastic.TensorFlowState([v1, v2], step=7, name="tfraw")
    state.save()
    v1.assign([9.0, 9.0])
    state.step = 0
    state.restore()
    np.testing.assert_allclose(v1.numpy(), [1.0, 2.0])
    assert state.step == 7
    state.sync()  # size 1 no-op
    return {"=v1": v1.numpy(), "=v2": v2.numpy(),
            "=step": np.asarray(state.step)}


def c_tf_graph_mode_identity_ops(t, k, d):
    @tf.function
    def g():
        return (t.size_op(), t.rank_op(), t.local_size_op(),
                t.local_rank_op(), t.process_set_included_op(0),
                t.process_set_included_op(99))

    got = [int(x) for x in g()]
    assert got == [t.size(), t.rank(), t.local_size(), t.local_rank(), 1,
                   t.PROCESS_SET_ERROR_UNKNOWN_SET]
    return {"=ops": np.asarray(got)}


def c_tensorflow_keras_alias_namespace(t, k, d):
    tk = importlib.import_module(t.__name__ + ".keras")
    assert tk.DistributedOptimizer is k.DistributedOptimizer
    assert tk.callbacks.BroadcastGlobalVariablesCallback is \
        k.callbacks.BroadcastGlobalVariablesCallback
    assert tk.rank() == t.rank() and tk.size() == t.size()
    return {"=ids": np.asarray([tk.rank(), tk.size()])}


def c_tf_broadcast_variables(t, k, d):
    v = tf.Variable([7.0, 8.0])
    t.broadcast_variables([v], root_rank=0)
    np.testing.assert_allclose(v.numpy(), [7.0, 8.0])
    return {"=v": v.numpy()}


def c_keras_callbacks_fit(t, k, d):
    model = _seeded(tf.keras.Sequential(
        [tf.keras.layers.Input((4,)), tf.keras.layers.Dense(1)]))
    opt = k.DistributedOptimizer(tf.keras.optimizers.SGD(learning_rate=0.05))
    model.compile(optimizer=opt, loss="mse", run_eagerly=True)
    x, y = _xy(64)
    lrs = []

    class _Lr(tf.keras.callbacks.Callback):
        def on_train_batch_end(self, batch, logs=None):
            lrs.append(float(np.asarray(self.model.optimizer.learning_rate)))

    hist = model.fit(
        x, y, epochs=2, batch_size=16, verbose=0,
        callbacks=[k.callbacks.BroadcastGlobalVariablesCallback(0),
                   k.callbacks.MetricAverageCallback(),
                   k.callbacks.LearningRateWarmupCallback(
                       0.05, warmup_epochs=1, steps_per_epoch=4), _Lr()])
    assert hist.history["loss"][-1] < hist.history["loss"][0]
    assert len(lrs) == 8
    return {"loss": hist.history["loss"], "=lr": np.asarray(lrs),
            "w": np.concatenate([w.ravel() for w in model.get_weights()])}


def c_indexed_slices_passthrough_size1(t, k, d):
    emb = tf.Variable(np.zeros((4, 3), np.float32))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(tf.nn.embedding_lookup(emb, [1, 1, 2]))
    g = t.DistributedGradientTape(tape).gradient(loss, [emb])[0]
    assert isinstance(g, tf.IndexedSlices)
    opt = t.DistributedOptimizer(tf.keras.optimizers.SGD(1.0))
    opt.apply_gradients([(g, emb)])
    got = emb.numpy()
    assert got[1, 0] == -2.0 and got[2, 0] == -1.0 and got[0, 0] == 0.0
    return {"=values": g.values, "=indices": g.indices, "=emb": got}


def c_tape_single_variable_source(t, k, d):
    w = tf.Variable(np.ones((3, 2), np.float32))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(w * w)
    g = t.DistributedGradientTape(tape).gradient(loss, w)
    assert not isinstance(g, (list, tuple))
    np.testing.assert_allclose(g.numpy(), 2 * np.ones((3, 2)), rtol=1e-6)
    return {"=g": g}


def c_accumulation_with_sparse_grads(t, k, d):
    emb = tf.Variable(np.zeros((4, 2), np.float32))
    opt = t.DistributedOptimizer(tf.keras.optimizers.SGD(1.0),
                                 backward_passes_per_step=2)
    for _ in range(2):
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(tf.nn.embedding_lookup(emb, [1, 2]))
        g = tape.gradient(loss, [emb])[0]
        opt.apply_gradients([(g, emb)])
    got = emb.numpy()
    assert got[1, 0] == -1.0 and got[2, 0] == -1.0 and got[0, 0] == 0.0
    return {"=emb": got}


def c_keras_load_model_wraps_optimizer(t, k, d):
    model = _seeded(tf.keras.Sequential(
        [tf.keras.layers.Input((4,)), tf.keras.layers.Dense(1)]))
    model.compile(optimizer=tf.keras.optimizers.Adam(0.05), loss="mse",
                  run_eagerly=True)
    x, y = _xy(32)
    model.fit(x, y, epochs=1, batch_size=16, verbose=0)
    path = str(d / "m.keras")
    model.save(path)
    saved_slots = [np.asarray(v) for v in model.optimizer.variables]
    assert any(np.abs(s).sum() > 0 for s in saved_slots)  # moments moved
    loaded = k.load_model(path)
    assert type(loaded.optimizer).__name__ == "DistributedAdam"
    for got, want in zip(loaded.optimizer.variables, saved_slots):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)
    hist = loaded.fit(x, y, epochs=2, batch_size=16, verbose=0)
    assert hist.history["loss"][-1] < hist.history["loss"][0]
    return {"slots": np.concatenate([s.ravel().astype(np.float64)
                                     for s in saved_slots]),
            "loss": hist.history["loss"],
            "w": np.concatenate([w.ravel() for w in loaded.get_weights()])}


def c_keras_elastic_callbacks(t, k, d):
    e = t.elastic
    model = _seeded(tf.keras.Sequential(
        [tf.keras.layers.Input((4,)), tf.keras.layers.Dense(1)]))
    opt = tf.keras.optimizers.SGD(0.05)
    model.compile(optimizer=opt, loss="mse", run_eagerly=True)
    state = e.TensorFlowKerasState(model, opt, epoch=0, batch=0, name="kcb")
    commits = []
    orig_commit = state.commit
    state.commit = lambda: (commits.append(1), orig_commit())[1]
    x, y = _xy(32)
    # Update* first, Commit LAST so every commit captures the counters
    # of the same batch and epoch
    model.fit(x, y, epochs=3, batch_size=8, verbose=0, callbacks=[
        e.UpdateBatchStateCallback(state),
        e.UpdateEpochStateCallback(state),
        e.CommitStateCallback(state, batches_per_commit=2)])
    assert state.epoch == 3 and state.batch == 0
    # 4 batches an epoch: 2 cadence commits + 1 at the epoch's end, x3
    assert len(commits) == 9, commits
    return {"=counters": np.asarray([state.epoch, state.batch,
                                     len(commits)]),
            "w": np.concatenate([w.ravel() for w in model.get_weights()])}


def c_batch_state_callback_resumed_epoch_shrink(t, k, d):
    class _State:
        batch = 30
    state = _State()
    cb = t.elastic.UpdateBatchStateCallback(state)
    cb.params = {"steps": 100}
    seen = []
    cb.on_epoch_begin(0)
    seen.append(cb.params["steps"])            # the remainder: 70
    cb.on_batch_end(0)
    seen.append(state.batch)
    cb.on_batch_end(1)
    seen.append(state.batch)
    cb.on_epoch_end(0)
    seen += [cb.params["steps"], state.batch]  # full length again, 0
    cb.on_epoch_begin(1)
    seen.append(cb.params["steps"])
    assert seen == [70, 1, 2, 100, 0, 100]
    state2 = _State()
    cb2 = t.elastic.UpdateBatchStateCallback(state2)
    cb2.params = {"steps": None}
    cb2.on_epoch_begin(0)
    assert cb2.params["steps"] is None
    cb2.on_batch_end(49)
    assert state2.batch == 50
    return {"=seen": np.asarray(seen)}


def c_keras_elastic_namespace(t, k, d):
    tk = importlib.import_module(t.__name__ + ".keras")
    for ns in (k.elastic, tk.elastic):
        assert callable(ns.run)
        assert ns.KerasState is ns.TensorFlowKerasState
        assert callable(ns.CommitStateCallback)
        assert callable(ns.UpdateBatchStateCallback)
        assert callable(ns.UpdateEpochStateCallback)
    return {"=ok": np.asarray(True)}


CASES = [c_tf_allreduce, c_tf_allgather_broadcast_alltoall,
         c_tf_distributed_gradient_tape, c_tf_distributed_optimizer_trains,
         c_tf_backward_passes_per_step, c_tf_backward_passes_graph_mode,
         c_tf_sync_batch_norm, c_keras_optimizer_backward_passes,
         c_tf_keras_elastic_state, c_tf_raw_variable_elastic_state,
         c_tf_graph_mode_identity_ops, c_tensorflow_keras_alias_namespace,
         c_tf_broadcast_variables, c_keras_callbacks_fit,
         c_indexed_slices_passthrough_size1, c_tape_single_variable_source,
         c_accumulation_with_sparse_grads,
         c_keras_load_model_wraps_optimizer, c_keras_elastic_callbacks,
         c_batch_state_callback_resumed_epoch_shrink,
         c_keras_elastic_namespace]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[2:] for c in CASES])
def test_case_matches_the_jax_package(case, pkgs, tmp_path, monkeypatch):
    _run(case, pkgs, tmp_path, monkeypatch)


def test_every_jax_case_has_a_counterpart():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "test_tf_adapter.py")) as f:
        jax_cases = re.findall(r"^def test_(\w+)\(", f.read(), re.M)
    assert len(jax_cases) == len(CASES) == 21
    assert sorted(jax_cases) == sorted(c.__name__[2:] for c in CASES)


# -- dtypes ------------------------------------------------------------------

DTYPES = ["float32", "float64", "float16", "bfloat16", "int32", "int64",
          "uint8", "int8"]


def _make(dtype: str, shape, seed: int):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * 3
    if dtype.startswith(("float", "bfloat")):
        return tf.cast(tf.constant(x, tf.float32), dtype)
    return tf.constant(np.abs(x).astype(dtype))


def _dtype_ops(t, dtype):
    x = _make(dtype, (3, 4), 1)
    y = _make(dtype, (2, 4), 2)
    out = {"allreduce": t.allreduce(x, op=t.Sum),
           "grouped": t.grouped_allreduce([x, y], op=t.Sum),
           "allgather": t.allgather(x),
           "broadcast": t.broadcast(y, root_rank=0),
           "alltoall": t.alltoall(x)}
    v = tf.Variable(y)
    t.broadcast_variables([v], root_rank=0)
    out["variable"] = v
    return x, y, out


@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_comes_back_exact(dtype, pkgs):
    """Each collective of the shim returns the input's dtype and values
    (in a world of one, the inputs themselves: the numpy reference), to
    the bit what the JAX package returns."""
    x, y, got = _dtype_ops(pkgs["port"][0], dtype)
    ref = _dtype_ops(pkgs["jax"][0], dtype)[2]
    want = {"allreduce": [x], "grouped": [x, y], "allgather": [x],
            "broadcast": [y], "alltoall": [x], "variable": [y]}
    for key, ws in want.items():
        gs, rs = ([o] if not isinstance(o, list) else o
                  for o in (got[key], ref[key]))
        assert len(gs) == len(rs) == len(ws)
        for g, r, w in zip(gs, rs, ws):
            assert _dtype(g) == _dtype(r) == _dtype(w) == dtype, key
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=key)
            np.testing.assert_array_equal(_np(g), _np(r), err_msg=key)


def test_bfloat16_round_trips_through_torch_by_its_bits():
    """``_to_torch``/``_from_torch`` move TF bfloat16 by a bitcast, so
    every bit pattern (NaN payloads and negative zero included) comes back
    unchanged, and the torch tensor holds the same bits."""
    import torch

    from horovod_tpu_torch.tensorflow import _from_torch, _to_torch
    bits = np.arange(0, 1 << 16, 7, dtype=np.uint16)
    x = tf.bitcast(tf.constant(bits), tf.bfloat16)
    t = _to_torch(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  bits)
    back = _from_torch(t, x)
    assert back.dtype == tf.bfloat16
    np.testing.assert_array_equal(tf.bitcast(back, tf.uint16).numpy(), bits)


def test_identity_ops_before_init():
    """Before ``init`` the execution-time identity ops return -1 (the
    reference C API's sentinel), and the process-set op its init error
    code, in both packages."""
    import horovod_tpu
    import horovod_tpu.tensorflow as jt
    import horovod_tpu_torch
    import horovod_tpu_torch.tensorflow as pt
    horovod_tpu.shutdown()
    horovod_tpu_torch.shutdown()
    got = {}
    for name, t in (("jax", jt), ("port", pt)):
        got[name] = [int(t.size_op()), int(t.rank_op()),
                     int(t.local_size_op()), int(t.local_rank_op()),
                     int(t.process_set_included_op(0))]
    assert got["port"] == got["jax"] == [-1] * 4 + [
        pt.PROCESS_SET_ERROR_INIT]


# -- two ranks ---------------------------------------------------------------

def test_two_rank_tf_world_over_the_core(tmp_path):
    """The port's counterpart of ``tests/tf_worker.py``: a gloo world of
    two runs the shim over the port's core (``torch_port_tf_worker.py``:
    the tape inside and outside ``tf.function``, sparse pass-through, fp16
    and int8 compression, bf16/fp16/int32 reductions to the bit, keras
    ``fit`` with the broadcast callback), each rank checking the cross-rank
    result that it computes locally."""
    build_core()
    launch_env_world([TF_WORKER], 2, tmp_path, name="tf", timeout=240)
    for r in range(2):
        with open(tmp_path / f"tf.rank{r}.log") as f:
            assert "tf worker ok" in f.read()
