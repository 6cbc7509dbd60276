"""The port's expert-parallel MoE dispatch (``moe.apply_moe_ep``) against
the JAX package's, on the CPU: a mirror of ``tests/ep_moe_check.py`` on 8
gloo ranks.

One module fixture runs ``tests/torch_dist_checks.py``'s "ep" mode once:
JAX's ``apply_moe_ep`` (its shard_map with two ``lax.all_to_all``) on 8
forced host devices in one subprocess, the port's 8 gloo ranks in 8 more,
from the same numpy inputs and weights (``ep_moe_check.py``'s MoE: 8
experts top-2 of width 32, d_model 64, fp32).  On the (2, 4) and (4, 2)
("data", "model") meshes both dispatch expert-parallel, at capacity factor
8 (nothing drops) and 0.5 (tokens drop by each rank's local capacity).
Outputs are held to the dense per-token reference and to JAX's at rtol /
atol 2e-4, aux to rtol 1e-3, the gradients of sum(y * ct) + aux with
respect to x and every MoE weight to ``jax.grad``'s at 1e-4; each of JAX's
fallback conditions gives the global dispatch, with no all-to-all.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as tdc  # noqa: E402

CASES = [f"{regime}/{a}x{b}" for regime in tdc.EP_REGIMES
         for a, b in tdc.EP_MESHES]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ep"))
    tdc.launch("ep", out, timeout=600)
    with np.load(os.path.join(out, "jax_ep.npz")) as z:
        ref = {k: z[k] for k in z.files}
    ranks, counts = [], []
    for r in range(8):
        with np.load(os.path.join(out, f"rank{r}_ep.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
        with open(os.path.join(out, f"rank{r}_ep.json")) as f:
            counts.append(json.load(f))
    return {"jax": ref, "ranks": ranks, "counts": counts}


def dense_reference(p: dict, x: np.ndarray, top_k: int) -> np.ndarray:
    """y_t = sum_k p_k FFN_{e_k}(x_t), every expert on every token in
    float64 (``ep_moe_check.dense_reference``)."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_e = np.argsort(-probs, -1, kind="stable")[:, :top_k]
    top_p = np.take_along_axis(probs, top_e, -1)
    top_p /= np.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    g = np.einsum("td,edf->tef", xt, p["w_gate"])
    u = np.einsum("td,edf->tef", xt, p["w_up"])
    every = np.einsum("tef,efd->ted", g / (1 + np.exp(-g)) * u, p["w_down"])
    sel = np.take_along_axis(every, top_e[:, :, None], 1)
    return (sel * top_p[:, :, None]).sum(1).reshape(x.shape)


@pytest.mark.parametrize("case", CASES)
def test_ep_outputs_match_jax(run, case):
    ref = run["jax"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r[f"{case}/y"], ref[f"{case}/y"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r[f"{case}/aux"], ref[f"{case}/aux"],
                                   rtol=1e-3)


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in tdc.EP_MESHES])
def test_ep_with_ample_capacity_equals_the_dense_reference(run, mesh):
    """ep_moe_check.py's claim: nothing drops at capacity factor 8, so the
    EP output is the dense per-token one, and its aux the global
    dispatch's."""
    ref = run["jax"]
    p = {k: ref[f"p8/{k}"] for k in tdc.EP_GRADS}
    want = dense_reference(p, tdc.ep_inputs()["x"], top_k=2)
    for r in run["ranks"]:
        np.testing.assert_allclose(r[f"ample/{mesh}/y"], want, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r[f"ample/{mesh}/aux"],
                                   ref["global/ample/aux"], rtol=1e-3)


@pytest.mark.parametrize("case", CASES)
def test_ep_gradients_match_jax_grad(run, case):
    """d(sum(y * ct) + aux) / d(x, router, w_gate, w_up, w_down): the
    ranks' shares summed (the router's over every rank, each expert's over
    the ranks that hold it) equal ``jax.grad`` of JAX's EP function, the
    aux term's router gradient through the mean over the mesh too."""
    ref = run["jax"]
    for r in run["ranks"]:
        for g in ("dx",) + tuple(f"d_{k}" for k in tdc.EP_GRADS):
            np.testing.assert_allclose(r[f"{case}/{g}"], ref[f"{case}/{g}"],
                                       rtol=1e-4, atol=1e-4, err_msg=g)


def test_ep_drops_by_its_local_capacity_not_the_global_one(run):
    """At capacity factor 0.5 each rank's block sizes its own buffers, so
    EP drops other tokens than the global dispatch: the port's output is
    JAX's EP output (held above), and far from the global one."""
    for mesh in tdc.EP_MESHES:
        y = run["ranks"][0][f"drop/{mesh[0]}x{mesh[1]}/y"]
        assert np.abs(y - run["jax"]["global/drop/y"]).max() > 1e-2


@pytest.mark.parametrize("case", list(tdc.EP_FALLBACKS))
def test_ep_falls_back_to_the_global_dispatch_as_jax_does(run, case):
    """No runtime mesh, a "model" axis of 1, experts, sequence or batch
    that do not divide (JAX's ``moe.py:163-164``): JAX's ``apply_moe_ep``
    runs the global ``apply_moe``, and so does the port's, with no
    all-to-all."""
    ref = run["jax"]
    np.testing.assert_allclose(ref[f"fallback/{case}/y"],
                               ref[f"fallback/{case}/global"], rtol=1e-6,
                               atol=1e-6)
    for r, c in zip(run["ranks"], run["counts"]):
        np.testing.assert_allclose(r[f"fallback/{case}/y"],
                                   ref[f"fallback/{case}/y"], rtol=2e-4,
                                   atol=2e-4)
        assert not any(k.startswith("all_to_all")
                       for k in c[f"fallback/{case}"]), c[f"fallback/{case}"]


@pytest.mark.parametrize("case", CASES)
def test_ep_runs_two_all_to_alls_each_way(run, case):
    """Dispatch and return in the forward and their adjoints in the
    backward; the router statistics' two all-reduces (me, ce), and me's
    adjoint."""
    for c in run["counts"]:
        n = c[case]
        assert n["all_to_all/moe"] == 2 and n["all_to_all/moe/bwd"] == 2
        assert n["all_reduce/moe"] == 2 and n["all_reduce/moe/bwd"] == 1


@pytest.mark.parametrize("impl", ["ep_a2a", "global"])
def test_layers_pick_the_dispatch_as_jax_does(monkeypatch, impl):
    """Training layers and the prefill without ``moe_dropless`` take
    ``apply_moe_ep`` when the config says ``ep_a2a`` (JAX's
    ``transformer.py:64-66``, ``:250-256``); the dropless prefill and the
    decode step always the global ``apply_moe``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api, moe, transformer

    cfg = dataclasses.replace(configs.get_reduced("olmoe-1b-7b"),
                              moe_impl=impl)
    model = api.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    calls, depth = [], [0]
    for name in ("apply_moe_ep", "apply_moe_global", "apply_moe"):
        real = getattr(moe, name)

        def spy(*a, real=real, name=name, **kw):
            if not depth[0]:            # the layer's own call, not the
                calls.append((name, kw.get("dropless", False)))  # fallback's
            depth[0] += 1
            try:
                return real(*a, **kw)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(moe, name, spy)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int64))
    layers = cfg.n_layers

    def run(fn):
        calls.clear()
        with torch.no_grad():
            fn()
        return list(calls)

    train = run(lambda: transformer.train_loss(
        cfg, params, {"tokens": toks, "labels": toks}, remat=False))
    want = "apply_moe_ep" if impl == "ep_a2a" else "apply_moe_global"
    assert [c[0] for c in train] == [want] * layers
    pre = run(lambda: transformer.prefill(cfg, params, {"tokens": toks}))
    want = "apply_moe_ep" if impl == "ep_a2a" else "apply_moe"
    assert [c[0] for c in pre] == [want] * layers
    assert run(lambda: transformer.prefill(
        cfg, params, {"tokens": toks}, moe_dropless=True)) == \
        [("apply_moe", True)] * layers
    _, cache = transformer.prefill(cfg, params, {"tokens": toks},
                                   max_len=9)
    assert run(lambda: transformer.decode_step(
        cfg, params, toks[:, :1], cache, 8)) == [("apply_moe", False)] * \
        layers
