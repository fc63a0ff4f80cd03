"""Why the zoo's BN-model steps and Inception compare with JAX in fp64:
two measurements on the CPU, printed.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_zoo_fp32_drift.py

1. The tiny ResNet of ``tests/test_torch_port_zoo.py`` (the same perturbed
   flax weights and images): each parameter's gradient in fp32, from the
   port and from JAX, against JAX's in fp64 (rel L2 of the worst leaf and
   the worst element), and the ReLU input nearest zero in the channel
   whose BN-bias gradient differs most.
2. Inception V3 at 95x95, batch 4, fp32 in both packages from the same
   weights: the largest difference of each top-level block's output
   (train mode), end to end, and of one InceptionC block run alone.
3. The port's Inception V3 (and ResNet-50 beside it) at full width and
   input, batch 4, train mode, in bf16 against fp32 on the CPU: the
   logits' largest difference over the largest fp32 logit, and both
   losses (chip_smoke.py's ``ZOO_LOGITS_PRINTED``).

Not a tier-1 test (about a minute): the evidence behind the fp64
comparisons of the zoo tests.
"""

import functools
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def resnet_gradients(Z):
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from horovod_tpu.models import resnet as jres
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models._flax import from_flax

    x, y = Z.batch(Z.B, Z.IMG, Z.CLASSES)
    v = Z._init(jres.ResNet([1, 1, 1, 1], num_classes=Z.CLASSES,
                            dtype=jnp.float32), Z.IMG, True)

    def jgrad(dtype):
        model = jres.ResNet([1, 1, 1, 1], num_classes=Z.CLASSES, dtype=dtype)
        vv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)

        def loss_fn(p):
            logits, _ = model.apply(
                {"params": p, "batch_stats": vv["batch_stats"]},
                jnp.asarray(x, dtype), train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy(
                logits, jax.nn.one_hot(y, Z.CLASSES)).mean()
        g = jax.jit(jax.grad(loss_fn))(vv["params"])
        return from_flax(Z._flat(g))

    g32 = jgrad(jnp.float32)
    with jax.enable_x64(True):
        g64 = jgrad(jnp.float64)
    m = resnet.ResNet([1, 1, 1, 1], Z.CLASSES, torch.float32, device="cpu")
    m.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    m.train()
    pre = {}

    def keep(mod, inputs, out):
        pre["o"] = out.detach()

    m.BottleneckBlock_3.BatchNorm_1.register_forward_hook(keep)
    torch.nn.functional.cross_entropy(
        m(Z.nchw(x)), torch.from_numpy(y).long()).backward()
    port = {k: p.grad for k, p in m.named_parameters()}

    def worst(g):
        rel = {k: float((g[k].double() - g64[k].double()).norm()
                        / g64[k].double().norm().clamp_min(1e-30))
               for k in port}
        k = max(rel, key=rel.get)
        return k, rel[k], float((g[k].double() - g64[k].double()).abs().max())

    for name, g in (("jax fp32", g32), ("port fp32", port)):
        k, rel, err = worst(g)
        print(f"resnet {name} vs jax fp64: worst leaf {k} rel L2 {rel:.3g}, "
              f"worst element {err:.3g}")
    key = "BottleneckBlock_3.BatchNorm_1.bias"
    d = (port[key].double() - g64[key].double()).abs()
    ch = int(d.argmax())
    rest = float(d[torch.arange(d.numel()) != ch].max())
    near = float(pre["o"][:, ch].abs().min())
    print(f"resnet {key}: channel {ch} off by {float(d[ch]):.3g} (the other "
          f"channels at most {rest:.3g}); its ReLU input nearest 0: "
          f"{near:.3g}")


def inception_drift(Z):
    import jax
    import jax.numpy as jnp
    import torch

    from horovod_tpu.models import inception as jinc
    from horovod_tpu_torch.models import inception
    from horovod_tpu_torch.models._flax import from_flax

    jm = jinc.InceptionV3(num_classes=Z.INC_CLASSES, dtype=jnp.float32,
                          dropout=0.0)
    v = Z._init(jm, Z.INC_IMG, False)
    x, _ = Z.batch(4, Z.INC_IMG, Z.INC_CLASSES, seed=4)
    _, mut = jm.apply(v, jnp.asarray(x), train=True,
                      mutable=["batch_stats", "intermediates"],
                      capture_intermediates=True)
    inter = mut["intermediates"]
    m = inception.InceptionV3(Z.INC_CLASSES, torch.float32, 0.0, device="cpu")
    m.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    m.train()
    acts = {}

    def keep(name):
        def hook(mod, inputs, out):
            acts[name] = out.detach()
        return hook

    for n, mod in m.named_children():
        mod.register_forward_hook(keep(n))
    with torch.no_grad():
        m(Z.nchw(x))
    for n, t in acts.items():
        j = np.asarray(inter[n]["__call__"][0])
        got = t.permute(0, 2, 3, 1).numpy() if t.dim() == 4 else t.numpy()
        print(f"inception {n}: max diff {np.abs(got - j).max():.3g} "
              f"(largest value {np.abs(j).max():.3g})")
    block = jinc.InceptionC(jnp.float32)
    xc = np.abs(np.random.RandomState(0).randn(4, 2, 2, 1280)) \
        .astype(np.float32)
    vc = jax.jit(functools.partial(block.init, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(xc))
    vc = Z._perturb(jax.tree_util.tree_map(np.asarray, dict(vc)))
    jy, _ = block.apply(vc, jnp.asarray(xc), train=True,
                        mutable=["batch_stats"])
    pb = inception.InceptionC(1280, torch.float32)
    pb.load_state_dict(from_flax(vc["params"], vc["batch_stats"]))
    pb.train()
    with torch.no_grad():
        py = pb(Z.nchw(xc)).permute(0, 2, 3, 1).numpy()
    print(f"inception InceptionC alone: max diff "
          f"{np.abs(py - np.asarray(jy)).max():.3g}")


def bf16_against_fp32():
    import torch

    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models._flax import init_state
    torch.manual_seed(0)
    for name, size in (("inception3", 299), ("resnet50", 224)):
        ref = init_state(get_model(name, dtype=torch.float32, device="cpu"),
                         0)
        low = get_model(name, dtype=torch.bfloat16, device="cpu")
        low.load_state_dict(ref.state_dict())
        x = torch.rand(4, 3, size, size)
        y = torch.randint(0, 1000, (4,))
        out = []
        for m in (ref, low):
            m.train()
            if hasattr(m, "dropout"):
                m.dropout = 0.0
            with torch.no_grad():
                logits = m(x).float()
            out.append((logits, float(
                torch.nn.functional.cross_entropy(logits, y))))
        (a, la), (b, lb) = out
        print(f"{name} bf16 vs fp32 on the CPU: logits "
              f"{float((a - b).abs().max() / a.abs().max()):.3g} of the "
              f"largest, loss {la:.6f} vs {lb:.6f}")


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import test_torch_port_zoo as Z
    resnet_gradients(Z)
    inception_drift(Z)
    bf16_against_fp32()
    return 0


if __name__ == "__main__":
    sys.exit(main())
