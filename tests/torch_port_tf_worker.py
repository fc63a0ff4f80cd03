"""One rank of a two-rank world of the port's TensorFlow shim, the port's
counterpart of ``tests/tf_worker.py``: ``DistributedGradientTape`` inside
and outside a ``tf.function`` (eager equal to traced, the cross-rank
average that each rank computes locally), a None gradient passing
through, sparse ``IndexedSlices`` gradients gathered and not densified,
two tapes over the same variables in one traced step, a lone Variable
source, fp16 and int8 compression through the traced optimizer,
bf16, fp16 and int32 summed, averaged, gathered and broadcast to the bit
of a numpy reduction, ``SyncBatchNormalization`` with the world's moments,
and a keras ``model.fit`` with the broadcast callback leaving the ranks equal.

It imports nothing of the JAX package, and no JAX of its own (TensorFlow
imports jax by itself where jax is installed). Launched by
``test_torch_port_tf.py`` under ``torch_port_worker.launch_env_world``
(``HOROVOD_RANK``/``SIZE`` and the rendezvous in the environment, gloo);
the eager plane is the core unless ``HVD_TPU_EAGER_BACKEND=dist`` picks the
``torch.distributed`` one. Prints ``tf worker ok`` and exits 0 when every
check passed."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import tensorflow as tf  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch.tensorflow as hvd  # noqa: E402


def _jax_package_loaded() -> bool:
    return any(m.split(".")[0] == "horovod_tpu" for m in sys.modules)


def rank_grads(data_rank, w):
    """The local gradient each rank produces, computable on any rank, so
    the cross-rank average needs no extra collective."""
    x = np.full((4, 3), float(data_rank + 1), np.float32)
    with tf.GradientTape() as tape:
        y = tf.linalg.matmul(tf.constant(x), w)
        loss = tf.reduce_sum(y * y)
    return tape.gradient(loss, [w])[0].numpy()


def bf16_bits(v):
    """The bfloat16 bits of float32 ``v``, rounded to nearest even."""
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_value(bits):
    """The float32 value of bfloat16 ``bits`` (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def seeded(data_rank, kind):
    """Rank ``data_rank``'s input of dtype ``kind`` (bf16 as its bits),
    computable on any rank."""
    v = np.random.RandomState(20 + data_rank).randn(64).astype(np.float32)
    if kind == "int32":
        return np.round(v * 1e6).astype(np.int32)
    if kind == "float16":
        return (v * 4).astype(np.float16)
    return bf16_bits(v * 4)


def dtype_reductions(rank, size):
    """bf16, fp16 and int32 through a real reduction over the eager plane:
    Sum and Average allreduce, allgather and broadcast, each held to the
    dtype and the bits of a numpy reduction of every rank's seeded input
    (bf16 summed in float32 and rounded to nearest even, as fp16 is by
    numpy). An integral Average is refused on every rank."""
    for kind in ("bfloat16", "float16", "int32"):
        ins = [seeded(r, kind) for r in range(size)]
        if kind == "bfloat16":
            to_tf = lambda a: tf.bitcast(tf.constant(a), tf.bfloat16)  # noqa
            bits = lambda t: tf.bitcast(t, tf.uint16).numpy()  # noqa
            total = np.sum([bf16_value(a) for a in ins], axis=0,
                           dtype=np.float32)
            want_sum = bf16_bits(total)
            want_avg = bf16_bits(total / np.float32(size))
        else:
            to_tf = tf.constant
            bits = lambda t: t.numpy()  # noqa
            want_sum = ins[0].copy()
            for a in ins[1:]:
                want_sum = want_sum + a
            want_avg = None if kind == "int32" else \
                (np.sum(ins, axis=0, dtype=np.float32)
                 / np.float32(size)).astype(np.float16)
        x = to_tf(ins[rank])
        got = {"sum": hvd.allreduce(x, op=hvd.Sum, name=f"dt.{kind}.sum"),
               "gather": hvd.allgather(x, name=f"dt.{kind}.ag"),
               "bcast": hvd.broadcast(x, root_rank=1, name=f"dt.{kind}.bc")}
        want = {"sum": want_sum, "gather": np.concatenate(ins),
                "bcast": ins[1]}
        if want_avg is not None:
            got["avg"] = hvd.allreduce(x, op=hvd.Average,
                                       name=f"dt.{kind}.avg")
            want["avg"] = want_avg
        else:
            try:
                hvd.allreduce(x, op=hvd.Average, name=f"dt.{kind}.avg")
            except ValueError:
                pass
            else:
                raise AssertionError("an int32 Average was not refused")
        for key, g in got.items():
            assert g.dtype == x.dtype, (kind, key, g.dtype)
            np.testing.assert_array_equal(bits(g), want[key],
                                          err_msg=f"{kind} {key}")


def main():
    rank = int(os.environ["HOROVOD_RANK"])
    size = int(os.environ["HOROVOD_SIZE"])
    hvd.init()
    assert hvd.rank() == rank and hvd.size() == size
    assert not _jax_package_loaded()

    w = tf.Variable(np.arange(6, dtype=np.float32).reshape(3, 2) / 10.0)
    unused = tf.Variable(1.0)  # tape.gradient yields None for it

    @tf.function
    def step(x):
        with tf.GradientTape() as tape:
            y = tf.linalg.matmul(x, w)
            loss = tf.reduce_sum(y * y)
        dtape = hvd.DistributedGradientTape(tape)
        return dtape.gradient(loss, [w, unused])

    x = tf.constant(np.full((4, 3), float(rank + 1), np.float32))
    gw, gu = step(x)
    assert gu is None, "None gradient must pass through the graph tape"
    expect = np.mean([rank_grads(r, w) for r in range(size)], axis=0)
    np.testing.assert_allclose(gw.numpy(), expect, rtol=1e-5)

    # the eager path gives what the traced path gave
    with tf.GradientTape() as tape:
        y = tf.linalg.matmul(x, w)
        loss = tf.reduce_sum(y * y)
    eg = hvd.DistributedGradientTape(tape).gradient(loss, [w])[0]
    np.testing.assert_array_equal(eg.numpy(), gw.numpy())

    # sparse gradients stay sparse inside the tf.function: every rank's
    # (indices, values) are gathered and the values averaged
    emb = tf.Variable(np.zeros((5, 2), np.float32))

    @tf.function
    def emb_step(ids):
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(tf.nn.embedding_lookup(emb, ids))
        return hvd.DistributedGradientTape(tape).gradient(loss, [emb])[0]

    g = emb_step(tf.constant([rank, rank]))  # rank r touches row r twice
    assert isinstance(g, tf.IndexedSlices), type(g)
    assert int(tf.shape(g.indices)[0]) == 2 * size
    exp = np.zeros((5, 2), np.float32)
    for r in range(size):
        exp[r] += 2.0
    exp /= size
    np.testing.assert_allclose(np.asarray(tf.convert_to_tensor(g)), exp,
                               rtol=1e-6)

    # two tapes over the SAME variables in one traced step, in two name
    # scopes: only the graph-unique suffix keeps their allreduces apart
    def local_pair(data_rank):
        x_r = tf.constant(np.full((4, 3), float(data_rank + 1), np.float32))
        with tf.GradientTape() as t1:
            l1 = tf.reduce_sum(tf.linalg.matmul(x_r, w))
        with tf.GradientTape() as t2:
            l2 = tf.reduce_sum(tf.linalg.matmul(x_r, w) ** 2)
        return (t1.gradient(l1, [w])[0].numpy(),
                t2.gradient(l2, [w])[0].numpy())

    @tf.function
    def double_step(xx):
        with tf.GradientTape() as t1:
            l1 = tf.reduce_sum(tf.linalg.matmul(xx, w))
        with tf.GradientTape() as t2:
            l2 = tf.reduce_sum(tf.linalg.matmul(xx, w) ** 2)
        with tf.name_scope("gen"):
            g1 = hvd.DistributedGradientTape(t1).gradient(l1, [w])[0]
        with tf.name_scope("disc"):
            g2 = hvd.DistributedGradientTape(t2).gradient(l2, [w])[0]
        return g1, g2

    g1, g2 = double_step(x)
    pairs = [local_pair(r) for r in range(size)]
    np.testing.assert_allclose(
        g1.numpy(), np.mean([p[0] for p in pairs], axis=0), rtol=1e-5)
    np.testing.assert_allclose(
        g2.numpy(), np.mean([p[1] for p in pairs], axis=0), rtol=1e-5)

    # a lone Variable source keeps its structure at size > 1 too
    with tf.GradientTape() as tape:
        y = tf.linalg.matmul(x, w)
        loss = tf.reduce_sum(y * y)
    sg = hvd.DistributedGradientTape(tape).gradient(loss, w)
    assert not isinstance(sg, (list, tuple))
    np.testing.assert_allclose(sg.numpy(), expect, rtol=1e-5)

    # fp16 compression through the traced optimizer path: the wire is
    # fp16, the variable's dtype comes back, the ranks agree
    wc = tf.Variable(np.ones((3,), np.float32))
    copt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(1.0), compression=hvd.Compression.fp16)

    @tf.function
    def cstep(g):
        copt.apply_gradients([(g, wc)])

    cstep(tf.constant(np.full(3, float(rank + 1), np.float32)))
    np.testing.assert_allclose(wc.numpy(),
                               1.0 - (sum(range(size)) + size) / size,
                               rtol=1e-3)

    # int8 through the same path: each rank's gradient quantized, the
    # codes gathered and summed dequantized, so the step is the mean of
    # every rank's quantize-dequantize
    rng = np.random.RandomState(7)
    grads = [rng.randn(300).astype(np.float32) * (r + 1)
             for r in range(size)]
    wq = tf.Variable(np.zeros((300,), np.float32))
    qopt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(1.0), compression=hvd.Compression.int8)

    @tf.function
    def qstep(g):
        qopt.apply_gradients([(g, wq)])

    qstep(tf.constant(grads[rank]))
    q = hvd.Compression.int8
    want = sum(q.qdq(torch.from_numpy(g_r)) for g_r in grads) / size
    np.testing.assert_allclose(wq.numpy(), -want.numpy(), rtol=1e-6,
                               atol=1e-7)

    # SyncBatchNormalization: each rank normalizes its rows with the
    # world's moments, under the tf.function that keras compiles
    rows = [np.random.RandomState(10 + r).randn(8, 3).astype(np.float32)
            for r in range(size)]
    every = np.concatenate(rows)
    bn = hvd.SyncBatchNormalization(momentum=0.0)
    y = tf.function(lambda v: bn(v, training=True))(tf.constant(rows[rank]))
    n = every.shape[0]
    np.testing.assert_allclose(bn.moving_mean.numpy(), every.mean(0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.moving_variance.numpy(),
                               every.var(0) * n / (n - 1), rtol=1e-5)
    np.testing.assert_allclose(
        y.numpy(), (rows[rank] - every.mean(0))
        / np.sqrt(every.var(0) + bn.epsilon), rtol=1e-4, atol=1e-5)

    dtype_reductions(rank, size)

    # keras model.fit at size 2: the wrapped optimizer's graph-mode sync
    # and the broadcast callback leave every rank with IDENTICAL weights
    import horovod_tpu_torch.keras as khvd
    tf.random.set_seed(rank)  # a different init on each rank
    model = tf.keras.Sequential([tf.keras.layers.Input((4,)),
                                 tf.keras.layers.Dense(1)])
    model.compile(
        optimizer=khvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.05)),
        loss="mse")
    rng = np.random.RandomState(0)
    fx = rng.randn(32, 4).astype(np.float32)
    fy = (fx @ np.asarray([[1.0], [2.0], [3.0], [4.0]], np.float32))
    mine = slice(rank * 16, (rank + 1) * 16)
    model.fit(fx[mine], fy[mine], epochs=2, batch_size=8, verbose=0,
              callbacks=[khvd.callbacks.BroadcastGlobalVariablesCallback(0)])
    final = np.concatenate([v.reshape(-1) for v in model.get_weights()])
    gathered = hvd.allgather(tf.constant(final[None, :]))
    np.testing.assert_array_equal(np.asarray(gathered)[0],
                                  np.asarray(gathered)[1])

    assert not _jax_package_loaded()
    print("tf worker ok", flush=True)
    hvd.barrier()
    hvd.shutdown()
    os._exit(0)   # torch's gloo threads can abort the interpreter teardown


if __name__ == "__main__":
    main()
