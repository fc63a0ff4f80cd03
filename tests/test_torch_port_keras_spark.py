"""The port's Keras estimator (``horovod_tpu_torch.spark.KerasEstimator``)
against the JAX package's, over ``tests/fake_pyspark``.

One fit per package, on the same seeded model and data: a partitioned
(fake-)Spark DataFrame materialized by the fake executors, two workers
under each package's launcher, the Keras cases of
``tests/test_spark_estimator.py`` folded into the one fit (a
``transformation_fn`` that sets the sample-weight column zeroing poisoned
rows, a user callback that must run on every worker, a validation split,
``fit`` then ``transform``). The trained weights and the loss history
compare within 1e-6, and each package reads the checkpoint and the shards
that the other wrote to its Store.

The transform also seeds Keras on each worker, so that ``fit``'s shuffling
is the same in both packages' runs.
"""

import json
import os
import sys

import numpy as np
import pandas as pd
import pytest

tf = pytest.importorskip("tensorflow")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_spark import jax_reference  # noqa: E402
from torch_port_worker import build_core  # noqa: E402

import horovod_tpu.spark as jx_spark  # noqa: E402
import horovod_tpu_torch.spark as pt_spark  # noqa: E402
from horovod_tpu.core import core_available  # noqa: E402
from horovod_tpu.spark import estimator as jx_est  # noqa: E402
from horovod_tpu.spark import keras_estimator as jx_keras  # noqa: E402
from horovod_tpu_torch.spark import estimator as pt_est  # noqa: E402
from horovod_tpu_torch.spark import keras_estimator as pt_keras  # noqa: E402

FAKE_PYSPARK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fake_pyspark")
FEATURES = [f"x{i}" for i in range(4)]
EPOCHS = 6

pytestmark = pytest.mark.skipif(not core_available(),
                                reason="the JAX package's libhvdcore.so is "
                                       "not built")


def _frame(n=60, seed=0):
    """Seeded regression rows; every even row's label is poisoned."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    w = rng.randn(4).astype(np.float32)
    df = pd.DataFrame({f"x{i}": X[:, i] for i in range(4)})
    df["y"] = X @ w + 0.01 * rng.randn(n).astype(np.float32)
    df.loc[np.arange(0, n, 2), "y"] = 100.0
    return df


class _EpochStamp:
    """A user callback, built on the worker's side of the pickle: it
    appends each finished epoch to ``path``."""

    def __new__(cls, path):
        class _Impl(tf.keras.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                with open(path, "a") as f:
                    f.write(f"{epoch}\n")

        return _Impl()


def _fit(spark_mod, root):
    from pyspark.sql import SparkSession

    def add_weights(pdf):
        import tensorflow as tf
        tf.keras.utils.set_random_seed(0)   # fit's shuffle, both packages
        out = pdf.copy()
        out["w"] = (out["y"] < 50.0).astype("float32")
        return out

    model = tf.keras.Sequential([tf.keras.layers.Input((4,)),
                                 tf.keras.layers.Dense(1)])
    rng = np.random.RandomState(0)
    model.set_weights([rng.randn(*w.shape).astype(np.float32) * 0.5
                       for w in model.get_weights()])
    sdf = SparkSession.builder.getOrCreate().createDataFrame(
        _frame()).repartition(2)
    est = spark_mod.KerasEstimator(
        model=model, optimizer="SGD", loss="mse", feature_cols=FEATURES,
        label_cols=["y"], store=spark_mod.LocalStore(str(root)), num_proc=2,
        epochs=EPOCHS, batch_size=8, learning_rate=0.05, validation=0.25,
        verbose=0, sample_weight_col="w", transformation_fn=add_weights,
        callbacks=[_EpochStamp(str(root / "epochs.log"))], run_id="parity")
    return est, est.fit(sdf)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """``{"jax": (estimator, model, root), "port": (...)}``: one fit each,
    with the fake pyspark on the path for the module's tests."""
    root = tmp_path_factory.mktemp("keras_spark")
    sys.path.insert(0, FAKE_PYSPARK)
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.split(".")[0] == "pyspark"}
    try:
        build_core()
        (root / "jax").mkdir()
        (root / "port").mkdir()
        out = {"jax": jax_reference(lambda: _fit(jx_spark, root / "jax")),
               "port": _fit(pt_spark, root / "port")}
    finally:
        sys.path.remove(FAKE_PYSPARK)
        for m in [m for m in sys.modules if m.split(".")[0] == "pyspark"]:
            sys.modules.pop(m)
        sys.modules.update(saved)
    return {k: (*v, root / k) for k, v in out.items()}


def _weights(model):
    return model.getModel().get_weights()


def test_keras_fit_matches_the_jax_package(fits):
    """The same seeded model and data: the trained weights and the loss
    and validation-loss history within 1e-6, and the loss falls."""
    (_, jm, _), (_, pm, _) = fits["jax"], fits["port"]
    for a, b in zip(_weights(jm), _weights(pm)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert sorted(jm.history) == sorted(pm.history) == ["loss", "val_loss"]
    for k in jm.history:
        assert len(pm.history[k]) == EPOCHS
        np.testing.assert_allclose(pm.history[k], jm.history[k], rtol=1e-6)
    assert pm.history["loss"][-1] < pm.history["loss"][0]


def test_sample_weight_column_from_the_transform_reaches_the_workers(fits):
    """The transform sets the weight column that zeroes the poisoned rows,
    so the trained model predicts the clean rows (the Keras cases of
    ``test_spark_estimator.py``); ``transform`` gives the JAX package's
    predictions."""
    clean = _frame()
    clean = clean[clean["y"] < 50.0].head(10)
    outs = {}
    for name, (_, model, _) in fits.items():
        out = model.transform(clean)
        assert "y__output" in out.columns
        err = np.mean((out["y__output"].to_numpy()
                       - out["y"].to_numpy()) ** 2)
        assert err < 1.0, (name, err)
        outs[name] = out["y__output"].to_numpy()
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5,
                               atol=1e-6)


def test_user_callback_runs_on_every_worker(fits):
    for name, (*_, root) in fits.items():
        with open(root / "epochs.log") as f:
            epochs = f.read().split()
        assert sorted(map(int, epochs)) == sorted(list(range(EPOCHS)) * 2), \
            name


def test_each_package_reads_the_others_store(fits):
    """The checkpoint is the architecture JSON plus the weight arrays in
    one pickled dict in both packages: each loads the other's ``final``
    checkpoint to the trained weights, and reads the other's
    materialized shards as the other does."""
    for load, theirs in ((pt_keras._load_keras, "jax"),
                         (jx_keras._load_keras, "port")):
        est, model, _ = fits[theirs]
        store = est.getStore()
        loaded, arch = load(store, store.get_checkpoint_path("parity"),
                            "final", {})
        assert json.loads(arch)["class_name"] == "Sequential"
        for a, b in zip(loaded.get_weights(), _weights(model)):
            np.testing.assert_array_equal(a, b)
        for r in range(2):
            path = store.get_train_data_path("parity")
            a = jx_est.read_shard(store, path, r, 2)
            b = pt_est.read_shard(store, path, r, 2)
            assert len(a) > 0
            pd.testing.assert_frame_equal(a, b)


def test_reference_module_path_aliases():
    """``horovod.spark.keras`` resolves under the port as in the JAX
    package, and the package exports both estimators."""
    from horovod_tpu_torch.spark.keras import KerasEstimator, KerasModel
    from horovod_tpu_torch.spark.torch import TorchEstimator, TorchModel
    assert KerasEstimator is pt_spark.KerasEstimator is \
        pt_keras.KerasEstimator
    assert KerasModel is pt_spark.KerasModel
    assert TorchEstimator is pt_spark.TorchEstimator
    assert TorchModel is pt_spark.TorchModel
    assert issubclass(KerasEstimator, pt_est.HorovodEstimator)
