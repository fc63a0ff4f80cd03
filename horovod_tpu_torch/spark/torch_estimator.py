"""Torch backend for the Spark estimator API.

A copy of ``horovod_tpu/spark/torch_estimator.py`` (reference:
``horovod/spark/torch/estimator.py``: TorchEstimator serializing the
model/optimizer/loss, remote.py loop with hvd.torch) over the port's
adapter: the model travels as a pickled module + state_dict through the
Store, each worker moves it to its device (``cuda:<local_rank>``, or the
estimator's ``device``), wraps its optimizer in
``horovod_tpu_torch.torch.DistributedOptimizer`` and trains its rank's
shard, and rank 0 checkpoints the final state (on the CPU) back to the
Store.
"""

from __future__ import annotations

import json
import pickle
from typing import Callable

import numpy as np

from horovod_tpu_torch.common import payload
from horovod_tpu_torch.spark.estimator import (HorovodEstimator,
                                               HorovodModel, load_transform,
                                               read_shard, xy_arrays)


class TorchModel(HorovodModel):
    """Reference: ``TorchModel`` (``spark/torch/estimator.py``)."""

    def _predict_batch(self, X: np.ndarray) -> np.ndarray:
        import torch
        self._model.eval()
        with torch.no_grad():
            return self._model(torch.from_numpy(X)).numpy()


class TorchEstimator(HorovodEstimator):
    """Reference: ``TorchEstimator`` (``spark/torch/estimator.py``).

    ``model`` is a ``torch.nn.Module``; ``optimizer`` an optimizer NAME
    from ``torch.optim`` (e.g. ``"SGD"``); ``loss`` a callable
    ``loss(pred, target)`` or a ``torch.nn`` loss name (e.g.
    ``"MSELoss"``).
    """

    def _loss_value(self):
        """The effective loss param (single source of the default)."""
        return self._loss if self._loss is not None else "MSELoss"

    def _validate_params(self) -> None:
        if self._sample_weight_col and \
                not isinstance(self._loss_value(), str):
            raise ValueError(
                "sample_weight_col needs a NAMED torch loss (it is "
                "rebuilt with reduction='none' on the workers); weight "
                "inside your custom loss callable instead")

    def _save_model_spec(self, ckpt_dir: str) -> None:
        store = self._store
        store.write(store.join(ckpt_dir, "initial.pkl"),
                    pickle.dumps(self._model))
        loss_value = self._loss_value()
        loss = loss_value if isinstance(loss_value, str) else None
        store.write(store.join(ckpt_dir, "loss.pkl"),
                    pickle.dumps(loss_value if loss is None else None))
        # metrics: callables metric(pred, target) -> scalar, evaluated per
        # epoch on the worker's shard and rank-averaged (reference:
        # spark/torch/estimator.py metrics param + remote.py aggregation).
        # cloudpickle serializes them BY VALUE, so user-module / notebook
        # functions survive the trip to worker processes.
        store.write(store.join(ckpt_dir, "metrics.pkl"),
                    payload.dumps(list(self._metrics or [])))
        store.write(store.join(ckpt_dir, "train_spec.json"), json.dumps(
            dict(optimizer=self._optimizer or "SGD",
                 learning_rate=self._learning_rate,
                 loss_name=loss,
                 feature_cols=list(self._feature_cols),
                 label_cols=list(self._label_cols),
                 batch_size=self._batch_size,
                 epochs=self._epochs,
                 sample_weight_col=self._sample_weight_col,
                 train_steps_per_epoch=self._train_steps_per_epoch,
                 validation_steps_per_epoch=self
                 ._validation_steps_per_epoch,
                 backward_passes_per_step=self._backward_passes_per_step,
                 device=self._device,
                 verbose=self._verbose)).encode())

    def _make_remote_fn(self, ckpt_dir: str, train_path: str,
                        val_path: str) -> Callable:
        store = self._store  # pickled into the worker closure

        def remote_train():
            import torch

            import horovod_tpu_torch as hvd
            import horovod_tpu_torch.torch as thvd

            spec = json.loads(store.read_text(
                store.join(ckpt_dir, "train_spec.json")))
            # the rank's card unless the estimator named a device
            dev = torch.device(spec["device"]) if spec.get("device") \
                else hvd.device()
            model = pickle.loads(store.read(
                store.join(ckpt_dir, "initial.pkl"))).to(dev)
            weight_col = spec.get("sample_weight_col")
            eval_loss_fn = None
            if spec["loss_name"]:
                # validation stays UNWEIGHTED (reference semantics:
                # sample weights shape training only)
                eval_loss_fn = getattr(torch.nn, spec["loss_name"])()
                if weight_col:
                    # per-row losses, weighted mean below (reference:
                    # torch estimator sample_weight_col)
                    per_row = getattr(torch.nn, spec["loss_name"])(
                        reduction="none")

                    def loss_fn(pred, target, w):
                        r = per_row(pred, target)
                        r = r.reshape(r.shape[0], -1).mean(dim=1)
                        return (r * w).sum() / w.sum().clamp_min(1e-12)
                else:
                    loss_fn = eval_loss_fn
            else:
                loss_fn = pickle.loads(store.read(
                    store.join(ckpt_dir, "loss.pkl")))
            if eval_loss_fn is None:
                eval_loss_fn = loss_fn
            metric_fns = payload.loads(store.read(
                store.join(ckpt_dir, "metrics.pkl")))
            opt_cls = getattr(torch.optim, spec["optimizer"])
            bpps = max(1, int(spec.get("backward_passes_per_step") or 1))
            opt = thvd.DistributedOptimizer(
                opt_cls(model.parameters(),
                        lr=spec["learning_rate"] * hvd.size()),
                named_parameters=model.named_parameters(),
                backward_passes_per_step=bpps)
            thvd.broadcast_parameters(model.state_dict(), root_rank=0)
            thvd.broadcast_optimizer_state(opt, root_rank=0)

            transform = load_transform(store, ckpt_dir)
            pdf = read_shard(store, train_path, hvd.rank(), hvd.size(),
                             transform=transform)
            X, Y = xy_arrays(pdf, spec["feature_cols"], spec["label_cols"])
            X_t = torch.from_numpy(X).to(dev)
            Y_t = torch.from_numpy(Y).to(dev)
            W_t = torch.from_numpy(pdf[weight_col].to_numpy(
                dtype=np.float32)).to(dev) if weight_col else None
            val = None
            if val_path:
                vpdf = read_shard(store, val_path, 0, 1,
                                  transform=transform)
                vX, vY = xy_arrays(vpdf, spec["feature_cols"],
                                   spec["label_cols"])
                val = (torch.from_numpy(vX).to(dev),
                       torch.from_numpy(vY).to(dev))
            def metric_name(i, fn):
                return getattr(fn, "__name__", None) or f"metric_{i}"

            bs = spec["batch_size"]
            # optional per-epoch step caps (reference:
            # train_steps_per_epoch / validation_steps_per_epoch). The
            # train window ROTATES through the shard across epochs, like
            # a dataloader that keeps advancing — a fixed prefix would
            # silently never train the tail rows.
            n_train = len(X_t)
            if spec.get("train_steps_per_epoch"):
                n_train = min(n_train,
                              spec["train_steps_per_epoch"] * bs)
            if val is not None and spec.get("validation_steps_per_epoch"):
                cap = spec["validation_steps_per_epoch"] * bs
                val = (val[0][:cap], val[1][:cap])

            def epoch_window(epoch):
                if n_train == len(X_t):
                    return X_t, Y_t, W_t
                idx = (torch.arange(n_train, device=dev)
                       + epoch * n_train) % len(X_t)
                return (X_t[idx], Y_t[idx],
                        W_t[idx] if W_t is not None else None)

            history = {"loss": []}
            for i, fn in enumerate(metric_fns):
                history[metric_name(i, fn)] = []
            if val is not None:
                history["val_loss"] = []
            # with gradient accumulation, only FULL k-backward groups
            # step (a trailing partial group would leave hook enqueues
            # mid-countdown across the epoch boundary)
            batch_starts = list(range(0, n_train, bs))
            if bpps > 1:
                batch_starts = batch_starts[
                    :(len(batch_starts) // bpps) * bpps]
            for epoch in range(spec["epochs"]):
                model.train()
                losses = []
                Xe, Ye, We = epoch_window(epoch)
                opt.zero_grad()
                for k, i in enumerate(batch_starts, start=1):
                    pred = model(Xe[i:i + bs])
                    if We is not None:
                        loss = loss_fn(pred, Ye[i:i + bs],
                                       We[i:i + bs])
                    else:
                        loss = loss_fn(pred, Ye[i:i + bs])
                    loss.backward()
                    if k % bpps == 0:
                        opt.step()
                        opt.zero_grad()
                    losses.append(float(loss.detach()))
                # epoch loss averaged across workers, WEIGHTED by batch
                # count, so an unequal (or empty) shard can't poison the
                # mean with a NaN (reference: remote.py metric
                # aggregation)
                sums = np.asarray(thvd.allreduce(
                    torch.tensor([float(np.sum(losses)),
                                  float(len(losses))]),
                    op=thvd.Sum, name=f"ep.{epoch}"))
                mean = float(sums[0] / sums[1]) if sums[1] else 0.0
                history["loss"].append(mean)
                if metric_fns:
                    model.eval()
                    with torch.no_grad():
                        pred = model(X_t)
                    for i, fn in enumerate(metric_fns):
                        m = float(fn(pred, Y_t))
                        m = float(np.asarray(thvd.allreduce(
                            torch.tensor([m]), op=thvd.Average,
                            name=f"ep.{epoch}.m{i}"))[0])
                        history[metric_name(i, fn)].append(m)
                if val is not None:
                    model.eval()
                    with torch.no_grad():
                        vloss = float(eval_loss_fn(model(val[0]), val[1]))
                    history["val_loss"].append(vloss)
                if spec["verbose"] and hvd.rank() == 0:
                    print(f"[torch-estimator] epoch {epoch}: loss={mean}",
                          flush=True)
            if hvd.rank() == 0:
                store.write(store.join(ckpt_dir, "final.pkl"),
                            pickle.dumps(model.cpu()))
            return history

        return remote_train

    def _load_trained_model(self, ckpt_dir: str) -> TorchModel:
        model = pickle.loads(self._store.read(
            self._store.join(ckpt_dir, "final.pkl")))
        return TorchModel(model=model, feature_cols=self._feature_cols,
                          label_cols=self._label_cols,
                          run_id=self._run_id)
