"""Training the recurrent families (rwkv6, mamba2, zamba2) in the PyTorch
port vs the JAX package, on the CPU, from the same weights.

* Every gradient of ``train_loss`` (remat on, JAX's default) equals
  ``jax.grad`` of JAX's ``train_loss`` at fp32 3e-4 (relative to each
  leaf's largest gradient), for the reduced configs and for the
  kernel-shaped reduced configs that ``chip_smoke.py`` trains on the card
  (head_dim 64; ssm head_dim and d_state 64).  On the CPU the scans
  differentiate through their chunked plain versions in both packages.
* ``Trainer(comm="single")`` losses equal JAX's at rtol 1e-5.
* ``Rwkv6ScanFn`` and ``Mamba2ScanFn``, the autograd Functions that join
  K3/K4 to K3-bwd/K4-bwd on the card, with the kernels' plain versions
  standing in for the kernels (a CUDA kernel has no CPU mode): the
  gradients of autograd through the plain forward, bitwise, in the
  inputs' dtypes, under ``torch.utils.checkpoint`` too, with the final
  state an output or not.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

BAR = 3e-4
KERNEL_SSM = dict(d_state=64, head_dim=64)
# name, family override, reduced() overrides (the kernel-shaped configs of
# tests/test_torch_recurrent.py)
CASES = {
    "rwkv6": ("rwkv6-1.6b", None, {}),
    "zamba2": ("zamba2-1.2b", None, {}),
    "mamba2": ("zamba2-1.2b", "mamba2", {}),
    "rwkv6_kernel_shaped": ("rwkv6-1.6b", None, dict(head_dim=64)),
    "zamba2_kernel_shaped": ("zamba2-1.2b", None,
                             dict(head_dim=64, ssm=KERNEL_SSM)),
}


def cfgs(name, family, over):
    jover, tover = dict(over), dict(over)
    if "ssm" in over:
        jover["ssm"] = dataclasses.replace(jconfigs.get_config(name).ssm,
                                           **over["ssm"])
        tover["ssm"] = dataclasses.replace(tconfigs.get_config(name).ssm,
                                           **over["ssm"])
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    if family:
        jcfg = dataclasses.replace(jcfg, family=family)
        tcfg = dataclasses.replace(tcfg, family=family)
    return jcfg.reduced(**jover), tcfg.reduced(**tover)


def batch(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


@pytest.mark.parametrize("case", list(CASES))
def test_every_gradient_matches_jax(case):
    jcfg, tcfg = cfgs(*CASES[case])
    jp = japi.get_model(jcfg).init(jax.random.key(0))
    tp = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    toks, labels = batch(jcfg, 3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: japi.get_model(jcfg).train_loss(
            p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            remat=True))(jp)
    for p in tp.parameters():
        p.requires_grad_(True)
    loss = tapi.get_model(tcfg).train_loss(
        tp, {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}, remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=BAR, atol=BAR)
    leaves = weights.jax_leaves(tcfg, tp)
    want, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    assert len(want) == len(leaves)
    for path, g in want:
        key = "/".join(p.key for p in path)
        got = weights.leaf_tensor(tcfg, key, [p.grad for p in leaves[key]])
        g = np.asarray(g, np.float64)
        err = float(np.abs(got.detach().double().numpy() - g).max())
        assert err <= BAR * float(np.abs(g).max()), (key, err)


OPT = dict(lr=1e-3, warmup_steps=0, total_steps=50)
TB, TS = 2, 16


@pytest.mark.parametrize("case", ["rwkv6", "zamba2"])
def test_trainer_losses_match_jax(case, tmp_path):
    jcfg, tcfg = cfgs(*CASES[case])
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), ckpt_every=0, batch=TB, seq_len=TS,
        opt=JAdamW(**OPT), comm="single"))
    init = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, jt.params),
                                   device="cpu")
    want = [m["loss"] for m in jt.train(3)]
    tt = Trainer(tcfg, TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), ckpt_every=0, batch=TB,
        seq_len=TS, opt=AdamWConfig(**OPT), comm="single"), device="cpu",
        init_params=init)
    got = [m["loss"] for m in tt.train(3)]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ----------------------------------------------------------------------------
# the autograd Functions, with the plain versions in the kernels' place
# ----------------------------------------------------------------------------

@pytest.fixture
def plain_kernels(monkeypatch):
    """The wrappers of K3/K4 and K3-bwd/K4-bwd replaced by their plain
    versions under the wrappers' contracts (fp32 du, dA, dD, ddt and
    states; contiguous dB, dC)."""
    def rwkv_bwd(r, k, v, w, u, dy, *, s0=None, ds_out=None,
                 need_ds0=True):
        g = ref.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
        return (*g[:4], g[4].float(), g[5].float() if need_ds0 else None)

    def mamba_bwd(x, dt, A, Bm, Cm, D, dy, *, h0=None, dh_out=None,
                  need_dh0=True):
        g = ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0,
                                dh_out=dh_out)
        return (g[0].contiguous(), g[1].float(), g[2].float(),
                g[3].contiguous(), g[4].contiguous(), g[5].float(),
                g[6].float() if need_dh0 else None)

    monkeypatch.setattr(rw, "rwkv6_scan",
                        lambda *a, s0=None, return_state=False:
                        ref.rwkv6_scan_chunked(*a, s0=s0,
                                               return_state=return_state))
    monkeypatch.setattr(rw, "rwkv6_scan_bwd", rwkv_bwd)
    monkeypatch.setattr(m2, "mamba2_scan",
                        lambda *a, h0=None, return_state=False:
                        ref.mamba2_scan_chunked(*a, h0=h0,
                                                return_state=return_state))
    monkeypatch.setattr(m2, "mamba2_scan_bwd", mamba_bwd)


def _loss(out, return_state):
    y = out[0] if return_state else out
    return y.float().square().sum() + (out[1].sum() if return_state else 0)


def _fn_and_autograd(fn_apply, plain, inputs, return_state, remat):
    """Gradients through the Function (under checkpoint if ``remat``) and
    through the plain forward, from the same inputs."""
    a = [t.clone().requires_grad_(True) for t in inputs]
    b = [t.clone().requires_grad_(True) for t in inputs]
    f = lambda *xs: _loss(fn_apply(*xs, return_state),  # noqa: E731
                          return_state)
    if remat:
        torch.utils.checkpoint.checkpoint(f, *a, use_reentrant=False) \
            .backward()
    else:
        f(*a).backward()
    _loss(plain(*b, return_state), return_state).backward()
    return a, b


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_function_gives_the_plain_gradients(plain_kernels, dtype,
                                                  return_state, remat):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(2, 20, 2, 64, generator=g).to(dtype)
               for _ in range(3))
    w = torch.rand(2, 20, 2, 64, generator=g).to(dtype)
    u, s0 = torch.randn(2, 64, generator=g), torch.randn(2, 2, 64, 64,
                                                         generator=g)
    a, b = _fn_and_autograd(
        rw.Rwkv6ScanFn.apply,
        lambda *xs: ref.rwkv6_scan_chunked(*xs[:5], s0=xs[5],
                                           return_state=xs[6]),
        (r, k, v, w, u, s0), return_state, remat)
    for x, y in zip(a, b):
        assert x.grad.dtype == x.dtype
        assert torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_function_gives_the_plain_gradients(plain_kernels, dtype,
                                                   return_state, remat):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 20, 2, 64, generator=g).to(dtype)
    dt, A = torch.rand(2, 20, 2, generator=g), -torch.rand(2, generator=g)
    Bm, Cm = (torch.randn(2, 20, 64, generator=g).to(dtype)
              for _ in range(2))
    D, h0 = torch.rand(2, generator=g), torch.randn(2, 2, 64, 64,
                                                    generator=g)
    a, b = _fn_and_autograd(
        m2.Mamba2ScanFn.apply,
        lambda *xs: ref.mamba2_scan_chunked(*xs[:6], h0=xs[6],
                                            return_state=xs[7]),
        (x, dt, A, Bm, Cm, D, h0), return_state, remat)
    for p, q in zip(a, b):
        assert p.grad.dtype == p.dtype
        assert torch.equal(p.grad, q.grad)


def test_cpu_scans_under_grad_take_the_plain_versions():
    """On the CPU ``ops`` differentiates the chunked plain versions: no
    Function, no kernel counter moves."""
    from repro_torch.kernels import ops
    counts = (rw.rwkv6_scan.launches, rw.rwkv6_scan_bwd.launches,
              m2.mamba2_scan.launches, m2.mamba2_scan_bwd.launches)
    r = torch.randn(1, 5, 1, 64, requires_grad=True)
    y = ops.rwkv6_scan(r, r, r, torch.rand(1, 5, 1, 64), torch.zeros(1, 64))
    assert y.grad_fn is not None and "Rwkv6" not in type(y.grad_fn).__name__
    y.sum().backward()
    x = torch.randn(1, 5, 1, 64, requires_grad=True)
    y = ops.mamba2_scan(x, torch.rand(1, 5, 1), -torch.rand(1),
                        torch.randn(1, 5, 64), torch.randn(1, 5, 64),
                        torch.ones(1))
    assert "Mamba2" not in type(y.grad_fn).__name__
    y.sum().backward()
    assert counts == (rw.rwkv6_scan.launches, rw.rwkv6_scan_bwd.launches,
                      m2.mamba2_scan.launches, m2.mamba2_scan_bwd.launches)
