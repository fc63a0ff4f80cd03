"""Spark ML estimator API: fit a model on a DataFrame via distributed
training, get back a model that transforms DataFrames.

A copy of ``horovod_tpu/spark/estimator.py`` (reference:
``horovod/spark/common/estimator.py:25-110``, HorovodEstimator /
HorovodModel and their Params, with the Torch backend
``spark/torch/estimator.py``): data is materialized through the
:class:`Store` as parquet, training runs under the port's launcher
(``runner.run`` locally, the Spark barrier runner on a cluster), and each
worker reads its shard by rank — no Petastorm dependency. The workers
train on their card (``cuda:<local_rank>``) unless the estimator's
``device`` names another (``"cpu"``).

DataFrame duck-typing: anything with ``toPandas()`` (a Spark DataFrame) or
a pandas DataFrame directly, so the estimators are fully usable and
testable without a Spark session.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Callable, Dict, Sequence

import numpy as np

from horovod_tpu_torch.common import payload
from horovod_tpu_torch.spark.store import LocalStore, Store


def _to_pandas(df):
    if hasattr(df, "toPandas"):
        return df.toPandas()
    return df


def _split_frame(pdf, shuffle: bool, validation, seed: int,
                 min_one: bool = True):
    """THE split semantics, shared by both materialization paths:
    optional seeded shuffle, then either a float-fraction validation cut
    or a boolean-column selection. Returns ``(train_pdf,
    val_pdf_or_None)``.

    ``min_one`` floors a float-fraction cut at 1 row — right for the
    local path (the WHOLE dataset must yield a validation split when one
    was asked for), wrong per partition on the distributed path: a
    per-partition floor over many small partitions inflates
    ``validation=0.01`` far past 1% (each 20-row partition would donate
    a row = 5%), so that path passes ``min_one=False`` and lets the
    global fraction emerge from honest per-partition rounding."""
    if shuffle:
        pdf = pdf.sample(frac=1.0, random_state=seed)
    pdf = pdf.reset_index(drop=True)
    val_pdf = None
    if isinstance(validation, float) and validation > 0:
        n_val = int(round(len(pdf) * validation))
        if min_one:
            n_val = max(1, n_val)
        val_pdf, pdf = pdf.iloc[:n_val], pdf.iloc[n_val:]
    elif isinstance(validation, str):
        mask = pdf[validation].astype(bool)
        val_pdf, pdf = pdf[mask], pdf[~mask]
    if val_pdf is not None:
        val_pdf = val_pdf.reset_index(drop=True)
    return pdf.reset_index(drop=True), val_pdf


class Params:
    """Getter/setter param surface (reference: the Params mixins in
    ``spark/common/params.py`` — ``setX``/``getX`` returning self)."""

    _param_names: Sequence[str] = ()

    def _init_params(self, values: Dict[str, Any]) -> None:
        for k in self._param_names:
            setattr(self, "_" + k, values.get(k))

    def __getattr__(self, item):
        # setEpochs / getEpochs style accessors, generated from param names
        if item.startswith(("set", "get")) and len(item) > 3:
            name = item[3].lower() + item[4:]
            # translate camelCase -> snake_case
            snake = "".join("_" + c.lower() if c.isupper() else c
                            for c in name)
            if snake in self._param_names:
                if item.startswith("set"):
                    def setter(value):
                        setattr(self, "_" + snake, value)
                        return self
                    return setter
                return lambda: getattr(self, "_" + snake)
        raise AttributeError(item)


class HorovodModel(Params):
    """Trained model wrapper (reference: ``HorovodModel``,
    ``spark/common/estimator.py:79-110``)."""

    _param_names = ("model", "feature_cols", "label_cols", "output_cols",
                    "run_id")

    def __init__(self, **kwargs) -> None:
        self._init_params(kwargs)

    def _predict_batch(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, df):
        """Append prediction columns to the DataFrame (reference:
        ``HorovodModel.transform``). Returns a pandas DataFrame."""
        pdf = _to_pandas(df).copy()
        X = np.stack([pdf[c].to_numpy(dtype=np.float32)
                      for c in self._feature_cols], axis=1)
        preds = np.asarray(self._predict_batch(X))
        out_cols = self._output_cols or \
            [f"{c}__output" for c in self._label_cols]
        if preds.ndim == 1:
            preds = preds[:, None]
        for i, c in enumerate(out_cols):
            pdf[c] = preds[:, i] if preds.shape[1] > i else preds[:, -1]
        return pdf


class HorovodEstimator(Params):
    """Distributed-training estimator (reference: ``HorovodEstimator``,
    ``spark/common/estimator.py:25-78``)."""

    _param_names = ("num_proc", "model", "store", "optimizer", "loss",
                    "metrics", "feature_cols", "label_cols", "validation",
                    "batch_size", "epochs", "verbose", "run_id",
                    "callbacks", "custom_objects", "shuffle",
                    "learning_rate", "sample_weight_col",
                    "train_steps_per_epoch", "validation_steps_per_epoch",
                    "transformation_fn", "backward_passes_per_step",
                    "device")

    def __init__(self, **kwargs) -> None:
        defaults = dict(num_proc=1, metrics=[], validation=None,
                        batch_size=32, epochs=1, verbose=1, shuffle=True,
                        callbacks=[], custom_objects={},
                        learning_rate=1e-3, sample_weight_col=None,
                        train_steps_per_epoch=None,
                        validation_steps_per_epoch=None,
                        transformation_fn=None,
                        backward_passes_per_step=1, device=None)
        defaults.update(kwargs)
        self._init_params(defaults)
        if self._store is None:
            self._store = LocalStore.create(
                os.path.join(os.path.expanduser("~"), ".hvd_tpu_store"))

    # -- backend hooks -------------------------------------------------------
    def _validate_params(self) -> None:
        """Config errors detectable up front raise HERE, before any data
        is materialized or artifacts written (fail fast on a cluster)."""

    def _save_model_spec(self, ckpt_dir: str) -> None:
        raise NotImplementedError

    def _make_remote_fn(self, ckpt_dir: str, train_path: str,
                        val_path: str) -> Callable:
        raise NotImplementedError

    def _load_trained_model(self, ckpt_dir: str) -> HorovodModel:
        raise NotImplementedError

    # -- data materialization ------------------------------------------------
    def _materialize_pandas(self, pdf, store: "Store", train_path: str,
                            val_path: str) -> str:
        """Driver-local path (pandas input): one parquet per split."""
        pdf, val_pdf = _split_frame(pdf, self._shuffle, self._validation,
                                    seed=0)
        if not len(pdf):
            raise ValueError("DataFrame produced no training rows")
        store.makedirs(train_path)
        store.write(store.join(train_path, "data.parquet"),
                    _parquet_bytes(pdf))
        if val_pdf is not None and len(val_pdf):
            store.makedirs(val_path)
            store.write(store.join(val_path, "data.parquet"),
                        _parquet_bytes(val_pdf))
        else:
            val_path = ""
        return val_path

    def _materialize_distributed(self, df, store: "Store", train_path: str,
                                 val_path: str) -> str:
        """Spark path: EXECUTORS write one parquet shard per partition
        through the (pickled) Store — the dataset never moves through the
        driver (reference: ``spark/common/util.py`` prepare_data, which
        materializes via distributed ``df.write.parquet``; the previous
        ``toPandas()`` here collected everything to one node).

        Shuffle/validation-split happen per partition via
        :func:`_split_frame` (seeded by partition id): a float
        ``validation`` takes that fraction of each partition — globally
        equivalent to the reference's random-split semantics as long as
        partitions are not pathologically skewed. A string ``validation``
        selects rows where that boolean column is set, exactly as the
        reference does. A partition whose train split comes up empty
        writes NO shard (``read_shard`` falls back to row striping when
        shards are scarce, so no rank ends up with a poisoned 0-row
        file)."""
        shuffle, validation = self._shuffle, self._validation
        store.makedirs(train_path)
        store.makedirs(val_path)

        def write_partition(idx, row_iter):
            import pandas as pd
            rows = [r.asDict() for r in row_iter]
            if not rows:
                return iter([(idx, 0, 0)])
            pdf, val_pdf = _split_frame(pd.DataFrame(rows), shuffle,
                                        validation, seed=idx,
                                        min_one=False)
            if len(pdf):
                store.write(
                    store.join(train_path, f"part-{idx:05d}.parquet"),
                    _parquet_bytes(pdf))
            n_val_rows = 0
            if val_pdf is not None and len(val_pdf):
                store.write(
                    store.join(val_path, f"part-{idx:05d}.parquet"),
                    _parquet_bytes(val_pdf))
                n_val_rows = len(val_pdf)
            return iter([(idx, len(pdf), n_val_rows)])

        meta = df.rdd.mapPartitionsWithIndex(write_partition).collect()
        n_train = sum(m[1] for m in meta)
        n_val = sum(m[2] for m in meta)
        if n_train == 0:
            raise ValueError("DataFrame produced no training rows")
        if n_val == 0 and isinstance(validation, float) and validation > 0:
            # honest per-partition rounding (no 1-row floor) can land on
            # zero when every partition is tiny relative to the fraction;
            # don't silently train without the requested validation set
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning(
                "validation=%s yielded 0 rows across %d partitions "
                "(partitions too small for the fraction); training "
                "proceeds WITHOUT a validation set — repartition the "
                "DataFrame or raise the fraction", validation, len(meta))
        return val_path if n_val else ""

    # -- fit -----------------------------------------------------------------
    def fit(self, df) -> HorovodModel:
        """Materialize data through the Store, train under the launcher,
        return the trained model (reference: ``Estimator.fit``)."""
        self._validate_params()
        # serialize the transformation up front: an unpicklable closure
        # must fail in seconds, not after a full-dataset materialization
        transform_bytes = payload.dumps(self._transformation_fn)
        run_id = self._run_id or f"run_{uuid.uuid4().hex[:8]}"
        self._run_id = run_id
        store: Store = self._store
        # ALL artifact IO goes through the Store's path algebra + byte API
        # so gs://-class object stores work identically to local paths
        # (reference: store.py:36-530 — estimators read/write exclusively
        # through the Store)
        train_path = store.get_train_data_path(run_id)
        val_path = store.get_val_data_path(run_id)
        # a reused run_id must not leave stale shards behind: read_shard
        # globs the whole directory, so leftovers from a previous fit
        # (different partition count, or the single-parquet pandas path)
        # would silently mix into this run's data
        for stale in store.ls(train_path) + store.ls(val_path):
            store.delete(stale)
        if hasattr(df, "rdd"):  # a Spark DataFrame: executors materialize
            val_path = self._materialize_distributed(
                df, store, train_path, val_path)
        else:
            val_path = self._materialize_pandas(
                _to_pandas(df), store, train_path, val_path)

        ckpt_dir = store.get_checkpoint_path(run_id)
        store.makedirs(ckpt_dir)
        self._save_model_spec(ckpt_dir)
        # transformation_fn: fn(pdf) -> pdf applied to every worker's
        # shard before train AND validation (reference: the param of the
        # same name, spark/common/params.py); serialized above, fail-fast
        store.write(store.join(ckpt_dir, "transform.pkl"),
                    transform_bytes)

        remote = self._make_remote_fn(ckpt_dir, train_path, val_path)
        in_spark = False
        try:
            from pyspark.sql import SparkSession
            in_spark = SparkSession.getActiveSession() is not None
        except Exception:
            pass
        if in_spark:
            from horovod_tpu_torch.spark import run as spark_run
            histories = spark_run(remote, num_proc=self._num_proc)
        else:
            from horovod_tpu_torch.runner import run as local_run
            histories = local_run(remote, np=self._num_proc)

        model = self._load_trained_model(ckpt_dir)
        model.history = histories[0]
        return model


def _parquet_bytes(pdf) -> bytes:
    import io
    buf = io.BytesIO()
    pdf.to_parquet(buf)
    return buf.getvalue()


def load_transform(store: Store, ckpt_dir: str):
    """Worker-side: the estimator's transformation_fn (or None)."""
    return payload.loads(store.read(store.join(ckpt_dir, "transform.pkl")))


def read_shard(store: Store, data_path: str, rank: int, size: int,
               transform=None):
    """Worker-side shard read through the Store (the reference partitions
    Petastorm row groups per rank). The store travels to the worker by
    pickle, so remote backends reconnect there. ``transform`` (the
    estimator's transformation_fn) is applied to the shard before it is
    returned — ONE site, so train/val and keras/torch can't drift.

    With at least ``size`` part files (the distributed materialization
    writes one per DataFrame partition), files are assigned round-robin
    by rank — each worker reads ONLY its own shards. With fewer files
    (the driver-local single-parquet path), every worker reads the file
    set and takes rows ``[rank::size]``."""
    import io

    import pandas as pd
    files = [p for p in store.ls(data_path) if p.endswith(".parquet")]
    if not files:
        raise FileNotFoundError(f"no parquet shards under {data_path}")

    def load(paths):
        frames = [pd.read_parquet(io.BytesIO(store.read(p)))
                  for p in paths]
        return frames[0] if len(frames) == 1 else pd.concat(
            frames, ignore_index=True)

    if len(files) >= size:
        pdf = load(files[rank::size]).reset_index(drop=True)
    else:
        pdf = load(files).iloc[rank::size].reset_index(drop=True)
    if transform is not None:
        pdf = transform(pdf).reset_index(drop=True)
    return pdf


def xy_arrays(pdf, feature_cols: Sequence[str], label_cols: Sequence[str]):
    X = np.stack([pdf[c].to_numpy(dtype=np.float32)
                  for c in feature_cols], axis=1)
    Y = np.stack([pdf[c].to_numpy(dtype=np.float32)
                  for c in label_cols], axis=1)
    return X, Y
