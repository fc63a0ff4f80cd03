"""Spark ML estimator example: fit a torch model on a DataFrame with
distributed training, then score it with transform().

Reference analog: ``examples/spark/pytorch/pytorch_spark_mnist.py``
(TorchEstimator over a Spark DataFrame + Store). Works with a real Spark
session (DataFrames duck-type ``toPandas``) or plain pandas, as here (then
the workers are local processes). Each worker trains on its card, or on
the CPU with ``--device cpu``.

    python horovod_tpu_torch/examples/spark/estimator_regression.py [--np 2]
"""

import argparse
import tempfile

import numpy as np
import pandas as pd
import torch

from horovod_tpu_torch.spark import LocalStore, TorchEstimator


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--np", type=int, default=2, dest="num_proc")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="where the workers train: each one's card by "
                        "default, or e.g. cpu")
    args = p.parse_args()

    rng = np.random.RandomState(0)
    X = rng.randn(512, 8).astype(np.float32)
    w = rng.randn(8).astype(np.float32)
    df = pd.DataFrame({f"x{i}": X[:, i] for i in range(8)})
    df["y"] = X @ w + 0.05 * rng.randn(512).astype(np.float32)

    est = TorchEstimator(
        model=torch.nn.Sequential(
            torch.nn.Linear(8, 32), torch.nn.ReLU(),
            torch.nn.Linear(32, 1)),
        optimizer="Adam", loss="MSELoss",
        feature_cols=[f"x{i}" for i in range(8)], label_cols=["y"],
        store=LocalStore(tempfile.mkdtemp(prefix="hvd_est_")),
        num_proc=args.num_proc, epochs=args.epochs, batch_size=64,
        learning_rate=1e-3, validation=0.1, verbose=1, device=args.device)

    model = est.fit(df)
    print("loss history:", [round(v, 4) for v in model.history["loss"]])
    print("val loss:   ", [round(v, 4)
                           for v in model.history.get("val_loss", [])])
    scored = model.transform(df.head(5))
    print(scored[["y", "y__output"]])


if __name__ == "__main__":
    main()
