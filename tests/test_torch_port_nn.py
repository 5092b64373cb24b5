"""Port dense blocks (MLP, BatchNorm with the padding mask, stacked banks,
domain_select, eval folding) against the JAX package's ``ops``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.ops import nn as jnn  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.folding import (  # noqa: E402
    fold_bn_linear_eval as j_fold_bn_linear, fold_stacked_mlp_eval as j_fold)
from scenario_wise_rec_tpu.ops.select import domain_select as j_select  # noqa: E402
from scenario_wise_rec_tpu_torch.core import config as port_config  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.ops import nn as pnn  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels.folding import (  # noqa: E402
    fold_bn_linear_eval as p_fold_bn_linear, fold_stacked_mlp_eval as p_fold)
from scenario_wise_rec_tpu_torch.ops.select import domain_select as p_select  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # matmul sums taken in another order than XLA's
IN, B, N = 10, 24, 3


def _gen():
    return port_config.make_generator(torch.device("cpu"), 0)


def _noisy_state(state, r):
    """Non-trivial running stats (mean ~ N(0, .3), var in [0.5, 1.5])."""
    def f(path, a):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(r.normal(0, 0.3, a.shape).astype(np.float32))
        return jnp.asarray(r.uniform(0.5, 1.5, a.shape).astype(np.float32))
    return jax.tree_util.tree_map_with_path(f, state)


def _mlp_pair(members, dims=(8, 4), output_layer=True, act="relu", seed=0):
    r = np.random.default_rng(seed)
    jm = jnn.MLP(IN, dims=list(dims), output_layer=output_layer, activation=act)
    if members is None:
        params, state = jm.init(jax.random.PRNGKey(seed))
    else:
        params, state = jnn.stacked_mlp_init(jm, jax.random.PRNGKey(seed), members)
    state = _noisy_state(state, r)
    pm = pnn.MLP(IN, dims=list(dims), output_layer=output_layer, activation=act,
                 members=members, generator=_gen())
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_jax_params(pm, np_tree(params), np_tree(state))
    return jm, params, state, pm


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _w(seed=2):
    w = np.ones(B, np.float32)
    w[-7:] = 0.0  # ragged tail padding
    return w


@pytest.mark.parametrize("act", ["relu", "dice", "prelu", "leakyrelu"])
@pytest.mark.parametrize("output_layer", [True, False])
def test_mlp_eval_matches_jax(act, output_layer):
    jm, params, state, pm = _mlp_pair(None, output_layer=output_layer, act=act)
    x = _x((B, IN))
    want, _ = jm.apply(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pm(torch.tensor(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_mlp_train_batchnorm_matches_jax(masked):
    jm, params, state, pm = _mlp_pair(None)
    x = _x((B, IN))
    w = _w() if masked else None
    want, new_state = jm.apply(params, state, jnp.asarray(x), train=True,
                               rng=jax.random.PRNGKey(0),
                               w=None if w is None else jnp.asarray(w))
    with torch.no_grad():
        got = pm(torch.tensor(x), train=True,
                 w=None if w is None else torch.tensor(w))
    keep = slice(None) if w is None else w > 0
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               rtol=RTOL, atol=ATOL)
    for i, s in enumerate(new_state["layers"]):
        bn = pm.layers[i].bn
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(s["mean"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(s["var"]),
                                   rtol=RTOL, atol=ATOL)


def test_masked_batch_stats_ignore_padded_rows():
    x = _x((B, IN))
    w = _w()
    mean, var, n = pnn.batch_stats(torch.tensor(x), torch.tensor(w))
    jmean, jvar, jn = jnn.batch_stats(jnp.asarray(x), jnp.asarray(w))
    assert float(n) == float(jn) == B - 7
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), x[:B - 7].mean(0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("per_member_x", [False, True])
@pytest.mark.parametrize("act", ["relu", "dice", "softmax"])
def test_stacked_mlp_matches_jax(train, per_member_x, act):
    jm, params, state, pm = _mlp_pair(N, act=act, output_layer=act != "softmax")
    x = _x((N, B, IN) if per_member_x else (B, IN))
    w = _w()
    want, new_state = jnn.stacked_mlp_apply(
        jm, params, state, jnp.asarray(x), train=train,
        rng=jax.random.PRNGKey(0) if train else None,
        per_member_x=per_member_x, w=jnp.asarray(w))
    with torch.no_grad():
        got = pm(torch.tensor(x), train=train, w=torch.tensor(w),
                 per_member_x=per_member_x)
    assert got.shape == want.shape
    keep = w > 0
    np.testing.assert_allclose(got.numpy()[:, keep], np.asarray(want)[:, keep],
                               rtol=RTOL, atol=ATOL)
    for i, s in enumerate(new_state["layers"]):
        np.testing.assert_allclose(pm.layers[i].bn.mean.numpy(),
                                   np.asarray(s["mean"]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pm.layers[i].bn.var.numpy(),
                                   np.asarray(s["var"]), rtol=RTOL, atol=ATOL)


def test_per_member_x_needs_member_axis():
    _, _, _, pm = _mlp_pair(N)
    with pytest.raises(ValueError):
        pm(torch.tensor(_x((B, IN))), per_member_x=True)


@pytest.mark.parametrize("trailing", [False, True])
def test_domain_select_matches_jax(trailing):
    r = np.random.default_rng(5)
    ys = r.normal(size=(4, B) + ((1,) if trailing else ())).astype(np.float32)
    did = r.integers(-3, 8, B)
    want = np.asarray(j_select(jnp.asarray(ys), jnp.asarray(did)))
    got = p_select(torch.tensor(ys), torch.tensor(did)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("members", [None, N])
def test_fold_stacked_mlp_eval_matches_jax(members):
    jm, params, state, pm = _mlp_pair(members)
    j_stages, j_out = j_fold(params, state)
    p_stages, p_out = p_fold(pm)
    assert len(p_stages) == len(j_stages)
    for (pw, pb), (jw, jb) in zip(p_stages, j_stages):
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p_out[0].numpy(), np.asarray(j_out[0]))
    # the folded chain reproduces the eval forward
    x = _x((B, IN))
    h = torch.tensor(x)
    for w_, b_ in p_stages:
        h = torch.relu(h @ w_ + b_.unsqueeze(-2))
    h = h @ p_out[0] + p_out[1].unsqueeze(-2)
    with torch.no_grad():
        np.testing.assert_allclose(h.numpy(), pm(torch.tensor(x)).numpy(),
                                   rtol=RTOL, atol=1e-5)
    _, _, _, headless = _mlp_pair(members, output_layer=False)
    assert p_fold(headless)[1] is None


def test_fold_bn_linear_eval_matches_jax():
    r = np.random.default_rng(7)
    bn = pnn.BatchNorm(IN, lead=(N,))
    lin = pnn.Linear(IN, 6, _gen(), lead=(N,))
    with torch.no_grad():
        for t in (bn.gamma, bn.beta, bn.mean):
            t.copy_(torch.tensor(r.normal(size=t.shape).astype(np.float32)))
        bn.var.copy_(torch.tensor(r.uniform(0.5, 2, bn.var.shape).astype(np.float32)))
    a = lambda t: jnp.asarray(t.detach().numpy())
    jw, jb = j_fold_bn_linear(
        {"gamma": a(bn.gamma), "beta": a(bn.beta)},
        {"mean": a(bn.mean), "var": a(bn.var)}, {"w": a(lin.w), "b": a(lin.b)})
    pw, pb = p_fold_bn_linear(bn, lin)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=RTOL, atol=1e-6)
