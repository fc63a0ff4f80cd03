"""The port's documented examples (``horovod_tpu_torch/examples/``) run on
the CPU, each as a user runs it: a file given to ``python`` or to the
port's launcher, ``--device cpu`` where the script trains in torch.

* ``torch/torch_synthetic_benchmark.py`` (the tiny argv of
  ``tests/test_examples.py``) and ``native/mnist_dp.py`` under
  ``python -m horovod_tpu_torch.runner.launch -np 2``, over gloo and the
  core: their printed lines.
* ``torch/torch_mnist.py`` in a world of one under each package (the JAX
  package's ``examples/torch/torch_mnist.py`` with JAX on the CPU): the
  epoch losses equal to the bit (each package's ``allreduce`` of
  ``epoch_loss`` recorded at full precision) and the printed lines equal.
* the TensorFlow 2 and Keras scripts in one process, one after the other
  (TensorFlow's import is most of each one's time), in a world of one;
  ``adasum/adasum_small_model.py`` in a world of one; the Spark scripts
  (``elastic_run.py`` over ``tests/fake_pyspark``, ``estimator_regression``
  over local worker processes) and the Ray scripts over ``tests/fake_ray``.

Every script starts when the module's first test asks for one, all side
by side, so the file's worker time is about that of the slowest."""

import os
import re
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "horovod_tpu_torch", "examples")
TESTS = os.path.join(REPO, "tests")
LAUNCH = [sys.executable, "-m", "horovod_tpu_torch.runner.launch"]
TINY_BENCH = ["--batch-size", "8", "--image-size", "16",
              "--num-warmup-batches", "1", "--num-batches-per-iter", "2",
              "--num-iters", "2"]
TIMEOUT_S = 300
LOSS_MARK = "epoch_loss="

# the TensorFlow and Keras scripts, and the line each prints last
TF_SCRIPTS = {"tensorflow2/tf2_mnist.py": "step 80: loss",
              "tensorflow2/tf2_mnist_elastic.py": "epoch 2 done, loss=",
              "keras/keras_mnist.py": "Epoch 4/4",
              "keras/keras_elastic_mnist.py": "done at epoch 3"}


def _runpy(path, argv=(), jax=False, record=None):
    """``python -c`` running ``path`` as ``__main__`` with ``argv``; with
    ``jax``, JAX pinned to the CPU first (as ``tests/test_examples.py``
    does); ``record`` names a package whose ``torch.allreduce`` then
    prints each ``epoch_loss`` at full precision."""
    code = "import os, sys, runpy\n"
    if jax:
        code += ("os.environ['JAX_PLATFORMS'] = 'cpu'\n"
                 "import jax\njax.config.update('jax_platforms', 'cpu')\n")
    if record:
        code += (f"import {record}.torch as t\n"
                 "_ar = t.allreduce\n"
                 "def allreduce(tensor, *a, **k):\n"
                 "    out = _ar(tensor, *a, **k)\n"
                 "    if k.get('name') == 'epoch_loss':\n"
                 f"        print({LOSS_MARK!r} + repr(float(out)))\n"
                 "    return out\n"
                 "t.allreduce = allreduce\n")
    code += (f"sys.argv = [{path!r}] + {list(argv)!r}\n"
             f"runpy.run_path({path!r}, run_name='__main__')\n")
    return [sys.executable, "-c", code]


def _tf_sequence():
    """One process running each TensorFlow/Keras script in turn, a
    ``=== <script>`` line before each and ``=== ok`` after."""
    code = "import sys, runpy\n"
    for rel in TF_SCRIPTS:
        path = os.path.join(EX, rel)
        code += (f"print('\\n=== {rel}', flush=True)\n"
                 f"sys.argv = [{path!r}]\n"
                 f"runpy.run_path({path!r}, run_name='__main__')\n"
                 "print('\\n=== ok', flush=True)\n")
    return [sys.executable, "-c", code]


def _ex(rel):
    return os.path.join(EX, rel)


RUNS = {
    "synthetic_2": (LAUNCH + ["-np", "2", sys.executable,
                              _ex("torch/torch_synthetic_benchmark.py"),
                              *TINY_BENCH, "--device", "cpu"], None),
    "mnist_dp_2": (LAUNCH + ["-np", "2", sys.executable,
                             _ex("native/mnist_dp.py"), "--device", "cpu"],
                   None),
    "torch_mnist_jax": (_runpy(os.path.join(REPO, "examples", "torch",
                                            "torch_mnist.py"),
                               jax=True, record="horovod_tpu"), None),
    "torch_mnist_port": (_runpy(_ex("torch/torch_mnist.py"),
                                ["--device", "cpu"],
                                record="horovod_tpu_torch"), None),
    "tf_keras": (_tf_sequence(), None),
    "adasum": ([sys.executable, _ex("adasum/adasum_small_model.py"),
                "--device", "cpu"], None),
    "spark_elastic": ([sys.executable, _ex("spark/elastic_run.py")],
                      "fake_pyspark"),
    "spark_estimator": ([sys.executable, _ex("spark/estimator_regression.py"),
                         "--epochs", "3", "--device", "cpu"], None),
    "ray_mnist": ([sys.executable, _ex("ray/ray_mnist.py")], "fake_ray"),
    "ray_elastic": ([sys.executable, _ex("ray/ray_elastic.py")], "fake_ray"),
}


class _Runs:
    """Every entry of ``RUNS`` started side by side; :meth:`result` waits
    for one and returns ``(exit code, output)``."""

    def __init__(self, tmp):
        self.procs = {}
        for name, (argv, fake) in RUNS.items():
            path = os.pathsep.join(
                ([os.path.join(TESTS, fake)] if fake else []) + [REPO])
            env = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                       OMP_NUM_THREADS="1", TF_CPP_MIN_LOG_LEVEL="2")
            log = open(os.path.join(tmp, f"{name}.log"), "w+")
            p = subprocess.Popen(argv, cwd=tmp, env=env, stdout=log,
                                 stderr=subprocess.STDOUT,
                                 start_new_session=True)
            self.procs[name] = (p, log, time.monotonic())

    def result(self, name):
        p, log, t0 = self.procs[name]
        try:
            rc = p.wait(timeout=max(1.0, TIMEOUT_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            rc = p.wait()
        log.seek(0)
        return rc, log.read()

    def close(self):
        for p, log, _ in self.procs.values():
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
            log.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(str(tmp_path_factory.mktemp("examples")))
    yield r
    r.close()


def _ok(runs, name):
    rc, out = runs.result(name)
    assert rc == 0, f"{name} exited {rc}:\n{out[-3000:]}"
    return out


def test_synthetic_benchmark_under_hvdrun_np2(runs):
    out = _ok(runs, "synthetic_2")
    assert "Model: small_conv, batch size 8, 2 process(es)" in out, out
    assert re.search(r"Img/sec per process: [\d.]+ \+- [\d.]+", out), out
    assert re.search(r"Total img/sec on 2 process\(es\): [\d.]+", out), out


def test_native_mnist_dp_under_hvdrun_np2(runs):
    out = _ok(runs, "mnist_dp_2")
    losses = [float(x) for x in
              re.findall(r"^epoch \d: loss ([\d.]+)$", out, re.M)]
    assert len(losses) == 3, out
    assert losses[2] < losses[0], losses


def _epoch_lines(out):
    return re.findall(r"^epoch \d: loss [\d.]+$", out, re.M)


def test_torch_mnist_epoch_losses_equal_the_jax_package(runs):
    """A world of one in each package: the same hook-driven fp16-compressed
    steps give the same epoch losses, bit for bit."""
    jx, pt = _ok(runs, "torch_mnist_jax"), _ok(runs, "torch_mnist_port")
    full = [re.findall(rf"^{LOSS_MARK}(\S+)$", o, re.M) for o in (jx, pt)]
    assert len(full[0]) == 3 and full[0] == full[1], full
    assert len(_epoch_lines(jx)) == 3 and _epoch_lines(jx) == _epoch_lines(pt)


@pytest.mark.parametrize("script", sorted(TF_SCRIPTS))
def test_tensorflow_and_keras_scripts_in_a_world_of_one(runs, script):
    rc, out = runs.result("tf_keras")
    seg = out.split(f"\n=== {script}\n", 1)
    assert len(seg) == 2, f"{script} did not start (exit {rc}):\n" \
                          f"{out[-3000:]}"
    body, _, rest = seg[1].partition("\n=== ")
    assert rest.startswith("ok"), f"{script} failed:\n{body[-3000:]}"
    assert TF_SCRIPTS[script] in body, body[-2000:]


def test_adasum_in_a_world_of_one(runs):
    out = _ok(runs, "adasum")
    assert re.search(r"^final param \[.*\] \(target \[5, -20, -5\]\)$", out,
                     re.M), out
    assert len(re.findall(r"^step \d+: loss ", out, re.M)) == 4, out


def test_spark_run_elastic_over_fake_pyspark(runs):
    out = _ok(runs, "spark_elastic")   # the script asserts each loss
    assert "per-rank results: [{'rank': 0" in out, out[-2000:]


def test_spark_estimator_over_local_workers(runs):
    out = _ok(runs, "spark_estimator")
    hist = re.search(r"^loss history: \[(.*)\]$", out, re.M)
    assert hist, out[-2000:]
    losses = [float(x) for x in hist.group(1).split(",")]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    assert "y__output" in out


def test_ray_executor_over_fake_ray(runs):
    out = _ok(runs, "ray_mnist")
    assert re.search(r"^final loss [\d.]+$", out, re.M), out[-2000:]
    assert "per-rank results: [" in out


def test_elastic_ray_executor_over_fake_ray(runs):
    out = _ok(runs, "ray_elastic")   # the script asserts each loss
    assert "per-rank results: [{'rank': 0" in out, out[-2000:]
