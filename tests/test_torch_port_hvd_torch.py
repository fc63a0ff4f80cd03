"""``horovod_tpu_torch.torch``, the reference's ``horovod.torch`` surface,
against the JAX package's adapter (``horovod_tpu.torch``) on the CPU.

The single-process cases are ``tests/test_torch_adapter.py``'s, with the
trajectories held to the JAX adapter's on the same model; the two-rank
cases are ``torch_worker.py``'s (``torch_port_eager_worker.py``, group
``torch``); and the tiny flagship trained by each adapter over its own
core for three AdamW steps (``torch_port_adapter_worker.py``) gives the
same losses, synchronized gradients and parameters, whose first-step
gradients are the full batch's in one process within 1e-5."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import (REPO, build_core, launch_env_world,  # noqa
                               spawn_world)

EAGER_WORKER = os.path.join(REPO, "tests", "torch_port_eager_worker.py")
ADAPTER_WORKER = os.path.join(REPO, "tests", "torch_port_adapter_worker.py")


@pytest.fixture(scope="module", autouse=True)
def _core_built():
    """The core is built before any world starts (a cold build under load
    must not eat a world's timeout)."""
    build_core()


@pytest.fixture
def thvd(hvd, monkeypatch):
    """The port's adapter in a world of one; ``hvd`` (the JAX package's,
    initialized by its fixture) backs ``horovod_tpu.torch``."""
    import horovod_tpu_torch.torch as thvd
    thvd.shutdown()
    for k in ("HVD_TPU_SIZE", "HOROVOD_SIZE", "HVD_TPU_RANK", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    thvd.init()
    yield thvd
    thvd.shutdown()


def test_torch_allreduce(thvd):
    x = torch.arange(6, dtype=torch.float32)
    assert torch.equal(thvd.allreduce(x, op=thvd.Sum), x)
    y = x.clone()
    assert thvd.allreduce_(y, op=thvd.Average) is y
    assert torch.equal(y, x)


def test_torch_grouped_and_gather(thvd):
    outs = thvd.grouped_allreduce([torch.ones(3), torch.zeros(2)],
                                  op=thvd.Sum)
    assert torch.equal(outs[0], torch.ones(3))
    assert thvd.allgather(torch.eye(2)).shape == (2, 2)


def test_torch_broadcast_parameters_and_state(thvd):
    model = torch.nn.Linear(4, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    thvd.broadcast_parameters(model.state_dict(), root_rank=0)
    thvd.broadcast_parameters(model.named_parameters(), root_rank=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    thvd.broadcast_optimizer_state(opt, root_rank=0)


def _train(hvd_mod, steps=50, bpps=1):
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 1)
    opt = hvd_mod.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=bpps)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 8, generator=g)
    y = x @ torch.randn(8, 1, generator=g)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        for _ in range(bpps):
            loss = torch.nn.functional.mse_loss(model(x), y)
            loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, model


def test_torch_distributed_optimizer_trains_as_the_jax_adapter(thvd):
    """The loss falls tenfold, and every loss equals the JAX adapter's on
    the same model and data (a world of one: the same torch arithmetic)."""
    import horovod_tpu.torch as jthvd
    losses, _ = _train(thvd)
    assert losses[-1] < losses[0] * 0.1
    assert losses == _train(jthvd)[0]


def test_torch_backward_passes_per_step(thvd):
    """k backwards, then one step that syncs and applies the mean (the
    reference's ``_allreduce_delay`` contract; 1/k at every world size),
    as the JAX adapter."""
    import horovod_tpu.torch as jthvd
    torch.manual_seed(0)
    model = torch.nn.Linear(2, 1)
    ref = torch.nn.Linear(2, 1)
    ref.load_state_dict(model.state_dict())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        backward_passes_per_step=2)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    x1, x2 = torch.ones(1, 2), torch.full((1, 2), 2.0)
    model(x1).sum().backward()
    model(x2).sum().backward()
    opt.step()
    ref(x1).sum().backward()
    ref(x2).sum().backward()
    for p in ref.parameters():
        p.grad.div_(2)
    ref_opt.step()
    assert torch.equal(model.weight, ref.weight)
    assert _train(thvd, steps=5, bpps=2)[0] == \
        _train(jthvd, steps=5, bpps=2)[0]


def test_torch_join_barrier(thvd):
    assert thvd.join() == 0
    thvd.barrier()


def test_torch_sparse_allreduce(thvd):
    """Allgather-based sparse allreduce: coordinates that meet sum on
    coalesce; a world of one gives the input back, for Sum and Average."""
    i = torch.tensor([[0, 2, 2], [1, 0, 0]])
    sp = torch.sparse_coo_tensor(i, torch.tensor([3.0, 4.0, 5.0]), (4, 3))
    expect = sp.coalesce().to_dense()
    for name, op in (("sp", thvd.Sum), ("sp2", thvd.Average)):
        out = thvd.synchronize(thvd.sparse_allreduce_async(sp, name=name,
                                                           op=op))
        assert torch.equal(out.to_dense(), expect)


def test_torch_synchronize_then_step_applies_once(thvd):
    """A manual ``synchronize()`` (to clip) then ``step()`` syncs once."""
    model = torch.nn.Linear(2, 1)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        backward_passes_per_step=2)
    ref = torch.nn.Linear(2, 1)
    ref.load_state_dict(model.state_dict())
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    x = torch.ones(1, 2)
    model(x).sum().backward()
    model(x).sum().backward()
    opt.synchronize()
    grad_after_sync = model.weight.grad.clone()
    opt.step()
    assert torch.equal(model.weight.grad, grad_after_sync)
    ref(x).sum().backward()
    ref(x).sum().backward()
    for p in ref.parameters():
        p.grad.div_(2)
    ref_opt.step()
    assert torch.allclose(model.weight, ref.weight)
    with opt.skip_synchronize():
        pass


def test_torch_sync_batch_norm_single_process(thvd):
    """A world of one: plain ``BatchNorm2d`` in training and eval mode,
    with its running statistics (momentum 0.1 and the cumulative
    average), within 1e-6 as the JAX adapter's test holds it."""
    torch.manual_seed(0)
    sbn = thvd.SyncBatchNorm(3, momentum=0.1)
    bn = torch.nn.BatchNorm2d(3, momentum=0.1)
    bn.load_state_dict({k: v.clone() for k, v in sbn.state_dict().items()})
    x = torch.randn(4, 3, 5, 5)
    assert torch.allclose(sbn(x), bn(x), atol=1e-6)
    assert torch.allclose(sbn.running_mean, bn.running_mean, atol=1e-6)
    assert torch.allclose(sbn.running_var, bn.running_var, atol=1e-6)
    sbn.eval(), bn.eval()
    y = torch.randn(2, 3, 5, 5)
    assert torch.allclose(sbn(y), bn(y), atol=1e-6)
    sbn2 = thvd.SyncBatchNorm(3, momentum=None)
    bn2 = torch.nn.BatchNorm2d(3, momentum=None)
    bn2.load_state_dict({k: v.clone() for k, v in sbn2.state_dict().items()})
    for _ in range(3):
        z = torch.randn(4, 3, 5, 5)
        sbn2(z), bn2(z)
    assert torch.allclose(sbn2.running_mean, bn2.running_mean, atol=1e-6)
    assert torch.allclose(sbn2.running_var, bn2.running_var, atol=1e-6)


def test_torch_adapter_two_ranks(tmp_path):
    """``torch_worker.py`` over the port's core: dense and sparse
    allreduce, the in-place and grouped variants, the optimizer against
    full-batch SGD (atol 1e-5), hook mode, ``backward_passes_per_step``,
    the ``HVD_TORCH_HOOKS=0`` fallback, SyncBatchNorm against full-batch
    BN (atol 1e-5) and join with uneven batches."""
    res = spawn_world(EAGER_WORKER, "torch", 2, tmp_path, timeout=90)
    assert int(res[0]["last"][0]) == int(res[1]["last"][0])


def test_flagship_trajectory_matches_the_jax_adapter(tmp_path):
    """The tiny flagship over two ranks, three AdamW steps through each
    package's adapter and core: the same losses, synchronized gradients
    and final parameters, bit for bit; and the first step's gradients are
    the full batch's in one process within 1e-5."""
    for pkg in ("jax", "port"):
        launch_env_world([ADAPTER_WORKER, "--pkg", pkg, "--out",
                          str(tmp_path)], 2, tmp_path, name=pkg,
                         timeout=180)
    for r in range(2):
        a = dict(np.load(tmp_path / f"jax.rank{r}.npz"))
        b = dict(np.load(tmp_path / f"port.rank{r}.npz"))
        assert sorted(a) == sorted(b)
        differ = [k for k in a if not np.array_equal(a[k], b[k])]
        assert not differ, differ

    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models.transformer import forward_loss_spmd
    _, (model, tokens, targets) = entry(device="cpu", tiny=True)
    loss, aux = forward_loss_spmd(model, tokens, targets)
    (loss + 0.01 * aux).backward()
    port = dict(np.load(tmp_path / "port.rank0.npz"))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(port[f"grad0.{name}"], p.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
