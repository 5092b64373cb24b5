"""Port AdaptDHM, the plain version of its fused kernel and the weight
carry-over against the JAX package (its Pallas kernel in interpret mode),
weights and centers carried across. Inputs are made with numpy from a seed
and fed to both. Its train steps are in ``test_torch_port_train_hamur.py``,
its registry and ``build_model`` checks in ``test_torch_port_hamur.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.adaptdhm_infer import (  # noqa: E402
    adaptdhm_fused_infer as j_adaptdhm)
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import adaptdhm_infer as pk  # noqa: E402

# the JAX package's own fused-kernel tolerance: sums in another order
RTOL, ATOL = 1e-5, 1e-6
V, C = 40, 3
CPU = torch.device("cpu")


def _kwargs(m, fcn_dims=(16, 8), cluster_num=C):
    feats = ([m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8) for i in range(4)]
             + [m.SparseFeature("domain_indicator", vocab_size=3, embed_dim=8)])
    return dict(features=feats, fcn_dims=list(fcn_dims), cluster_num=cluster_num, beta=0.9)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(seed=0, **kw):
    """The JAX model, its tables from N(0, 0.5) (at their N(0, 1e-4) init
    every row's logits against the unit centers lie within 1e-3 of each
    other), and the port model holding the same weights and centers."""
    jm = jmodels.AdaptDHM(**_kwargs(jf, **kw))
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed + 100)
    params = {**params, "embedding": jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.normal(0, 0.5, a.shape).astype(np.float32)),
        params["embedding"])}
    pm = pmodels.AdaptDHM(**_kwargs(pf, **kw), device="cpu",
                          generator=make_generator(CPU, seed))
    load_jax_params(pm, _np(params), _np(state))
    return jm, params, state, pm


def _batch(b, seed=0):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b) for i in range(4)}
    x["domain_indicator"] = r.integers(0, 3, b)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{"rtol": RTOL, "atol": ATOL, **kw})


def _no_near_ties(pm, xt, gap=1e-5):
    """The routing of every row is clear of rounding (else the two
    frameworks may route it differently; the chip check counts such rows)."""
    with torch.no_grad():
        emb = pm.embedding(xt, pm.features, squeeze_dim=True)
        assert bool((pk.adaptdhm_route_margin(emb, pm.center) > gap).all())


def test_l2norm_and_center_init_match_jax():
    jm, params, state, pm = _models()
    c = pm.center.numpy()
    np.testing.assert_allclose(np.linalg.norm(c, axis=1), 1.0, rtol=1e-6)
    _close(c, state["center"], rtol=0, atol=0)  # carried
    fresh = pmodels.AdaptDHM(**_kwargs(pf), device="cpu").center.numpy()
    np.testing.assert_allclose(np.linalg.norm(fresh, axis=1), 1.0, rtol=1e-6)
    from scenario_wise_rec_tpu.models.adaptdhm import _l2norm
    from scenario_wise_rec_tpu_torch.models.adaptdhm import l2norm
    v = np.array([[3.0, 4.0], [0.0, 0.0], [1e-13, 0.0]], np.float32)
    _close(l2norm(torch.tensor(v)), _l2norm(jnp.asarray(v)), rtol=0, atol=0)


@pytest.mark.parametrize("clusters", [1, 3, 5])
def test_eval_apply_matches_jax(clusters):
    jm, params, state, pm = _models(cluster_num=clusters)
    xj, xt = _batch(45, seed=3)
    _no_near_ties(pm, xt)
    want, new_state = jm.apply(params, state, xj, train=False, rng=None)
    center = pm.center.clone()
    with torch.no_grad():
        got = pm.apply(xt, train=False)
    _close(got, want)
    assert torch.equal(pm.center, center)  # eval moves no center


@pytest.mark.parametrize("n_pad", [0, 9])
def test_train_apply_refines_centers_like_jax(n_pad):
    """A train-mode forward: 3 masked EMA refinements of the centers, the
    route by the refined centers, the output of the real rows."""
    jm, params, state, pm = _models()
    xj, xt = _batch(40, seed=4)
    w = np.ones(40, np.float32)
    w[40 - n_pad:] = 0.0
    want, new_state = jm.apply(params, state, xj, train=True, rng=jax.random.PRNGKey(0),
                               w=jnp.asarray(w))
    with torch.no_grad():
        got = pm.apply(xt, train=True, w=torch.tensor(w))
    _no_near_ties(pm, xt)
    keep = w > 0
    _close(got.numpy()[keep], np.asarray(want)[keep])
    _close(pm.center.numpy(), new_state["center"])
    assert not np.allclose(pm.center.numpy(), state["center"])
    np.testing.assert_allclose(np.linalg.norm(pm.center.numpy(), axis=1), 1.0, rtol=1e-6)


def test_padded_rows_do_not_move_the_centers():
    _, _, _, pm = _models()
    _, xt = _batch(30, seed=5)
    _, pad = _batch(10, seed=6)
    xp = {k: torch.cat([xt[k], pad[k]]) for k in xt}
    w = torch.cat([torch.ones(30), torch.zeros(10)])
    c0 = pm.center.clone()
    with torch.no_grad():
        pm.apply(xt, train=True)
        alone = pm.center.clone()
        pm.center.copy_(c0)
        pm.apply(xp, train=True, w=w)
    _close(pm.center, alone)


def test_fused_eval_matches_jax():
    """The port's fused eval (the kernel's plain version on the CPU) against
    the JAX fused eval (Pallas, interpret mode), the JAX op-by-op eval and
    the port's op-by-op eval, after a train step has moved the centers."""
    jm, params, state, pm = _models()
    xj, xt = _batch(40, seed=7)
    _, state = jm.apply(params, state, xj, train=True, rng=jax.random.PRNGKey(1))
    load_jax_params(pm, _np(params), _np(state))
    xj, xt = _batch(43, seed=8)
    _no_near_ties(pm, xt)
    want_fused = jm.apply_fused_eval(params, state, xj)
    want, _ = jm.apply(params, state, xj, train=False, rng=None)
    with torch.no_grad():
        got = pm.apply_fused_eval(xt, w=torch.ones(43))
        plain = pm.apply(xt, train=False)
        folded = pm.fold_eval()
        assert torch.equal(pm.apply_fused_eval(xt, folded=folded), got)
    assert got.shape == (43,)
    for other in (want_fused, want, plain):
        _close(got, other)


def _stages(r, C, dims):
    return [((i ** -0.5) * r.normal(size=(C, i, o))).astype(np.float32)
            for i, o in zip(dims[:-1], dims[1:])]


def _skewed(r, B, C):
    """90 % of the rows in cluster C - 1, the rest spread over the others."""
    rid = np.where(r.random(B) < 0.9, C - 1, r.integers(0, C, B))
    assert (rid == C - 1).mean() >= 0.9
    return rid


def _int64_wide(r, B, C):
    """int64 ids far outside [0, C), ± 2^32 offsets among them: each is taken
    modulo 2^32 as int32, then clipped, as JAX's ``astype(int32)`` and the
    card take them."""
    wide = np.array([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, -2**31 - 7, 2**40,
                     -3], np.int64)
    return np.where(r.random(B) < 0.5, wide[r.integers(0, len(wide), B)],
                    r.integers(0, C, B)).astype(np.int64)


@pytest.mark.parametrize("cfg", [
    # (B, F, C, hidden dims, router ids: drawn from (lo, hi) or made by a
    #  function, block_rows of the JAX kernel)
    (37, 24, 3, [16, 8], (-2, 6), 16),   # ragged; ids -2..5, clipped
    (20, 10, 2, [], (0, 2), 8),          # one stage: width 1 straight away
    (33, 17, 4, [9, 5, 3], (0, 4), 8),
    (16, 12, 3, [6], (2, 3), 8),         # clusters 0 and 1 absent
    (60, 24, 3, [16, 8], _skewed, 16),   # skewed: 90 % of the rows in one cluster
    (45, 20, 3, [12, 6], _int64_wide, 16),  # int64 ids with ± 2^32 offsets: wrap, then clip
    (50, 18, 5, [10, 4], (0, 5), 16),    # 5 clusters
    (40, 48, 3, [64, 64], (0, 3), 8),    # KuaiRand's ladder, [64, 64]
])
def test_kernel_ref_matches_jax_kernel(cfg):
    B, F, Cn, dims, ids, rows = cfg
    r = np.random.default_rng(B)
    emb = r.normal(size=(B, F)).astype(np.float32)
    stages = _stages(r, Cn, [F] + dims + [1])
    rid = r.integers(*ids, B) if isinstance(ids, tuple) else ids(r, B, Cn)
    want = j_adaptdhm(jnp.asarray(emb), jnp.asarray(rid), [jnp.asarray(w) for w in stages],
                      block_rows=rows, interpret=True)
    before = pk.adaptdhm_fused_infer.launches
    got = pk.adaptdhm_fused_infer(torch.tensor(emb), torch.tensor(rid),
                                  [torch.tensor(w) for w in stages])
    assert pk.adaptdhm_fused_infer.launches == before  # plain on the CPU
    assert got.shape == (B,)
    _close(got, want)


@pytest.mark.parametrize("rows", [8, 24, 72])
def test_tile_rule_raises_on_the_cpu(rows):
    """The card's tile rule (a multiple of 16 from 16 to 64, or None) holds
    on the CPU too, where the plain version runs: a call that would raise on
    the card raises here, and every tile the rule takes gives the plain
    version's output."""
    r = np.random.default_rng(7)
    emb = torch.tensor(r.normal(size=(21, 18)).astype(np.float32))
    rid = torch.tensor(r.integers(-1, 4, 21))
    st = [torch.tensor(w) for w in _stages(r, 3, [18, 12, 8, 1])]
    with pytest.raises(ValueError, match="block_rows"):
        pk.adaptdhm_fused_infer(emb, rid, st, block_rows=rows)
    want = pk.adaptdhm_fused_infer_ref(emb, rid, st)
    for ok in (16, 32, 48, 64, None):
        torch.testing.assert_close(pk.adaptdhm_fused_infer(emb, rid, st, block_rows=ok), want,
                                   rtol=0, atol=0)


def test_route_margin():
    emb = torch.tensor([[1.0, 0.0], [0.5, 0.5], [0.0, 2.0]])
    center = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    np.testing.assert_allclose(pk.adaptdhm_route_margin(emb, center).numpy(), [1.0, 0.0, 2.0])
    assert torch.isinf(pk.adaptdhm_route_margin(emb, center[:1])).all()


def test_wrapper_checks_shapes():
    r = np.random.default_rng(0)
    emb, rid = torch.randn(4, 6), torch.zeros(4, dtype=torch.long)
    st = [torch.tensor(w) for w in _stages(r, 2, [6, 5, 1])]
    assert pk.adaptdhm_fused_infer(emb, rid, st).shape == (4,)
    with pytest.raises(ValueError, match="width 1"):
        pk.adaptdhm_fused_infer(emb, rid, st[:1])
    with pytest.raises(ValueError, match="follow"):
        pk.adaptdhm_fused_infer(emb, rid, [st[0], torch.randn(3, 5, 1)])
    with pytest.raises(ValueError):
        pk.adaptdhm_fused_infer(emb, rid[:3], st)
    with pytest.raises(ValueError, match="integer"):
        pk.adaptdhm_fused_infer(emb, rid.float(), st)


def test_load_jax_params_raises_on_missing_or_leftover():
    _, params, state, pm = _models()
    p, s = _np(params), _np(state)
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, p, {})
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, {**p, "b": p["b"][:-1]}, s)
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(pm, p, {**s, "extra": np.zeros(2, np.float32)})
