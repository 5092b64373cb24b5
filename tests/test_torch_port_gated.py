"""Port SAR-Net, EPNet, PPNet and AdaSparse, ``GateNU`` and ``Pruner``, the
weight carry-over, the registry and ``build_model`` against the JAX package
(its Pallas kernels in interpret mode), weights carried across. Inputs are
made with numpy from a seed and fed to both. The kernels' plain versions
against the JAX kernels are in ``test_torch_port_gated_kernels.py``, the
train steps in ``test_torch_port_train_gated.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu import configs as jconfigs  # noqa: E402
from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops import nn as jnn  # noqa: E402
from scenario_wise_rec_tpu.train.loss import bce_loss as j_bce  # noqa: E402
from scenario_wise_rec_tpu_torch import configs as pconfigs  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import jax_state_dict, load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.ops import nn as pnn  # noqa: E402
from scenario_wise_rec_tpu_torch.train.loss import bce_loss as p_bce  # noqa: E402

# the JAX package's own fused-kernel tolerance: sums in another order
RTOL, ATOL = 1e-5, 1e-6
V, D = 40, 3
CPU = torch.device("cpu")


def _features(m):
    """sparse, dense, scenario and id features, as the scenario and ppnet
    loaders give them (the scenario feature is the domain indicator)."""
    return ([m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8) for i in range(4)],
            [m.DenseFeature(f"d{i}") for i in range(2)],
            [m.SparseFeature("domain_indicator", vocab_size=D, embed_dim=8)],
            [m.SparseFeature("uid", vocab_size=V, embed_dim=8)])


def _kwargs(name, m):
    sparse, dense, sce, ids = _features(m)
    if name == "sarnet":
        return dict(features=sparse + dense, domain_num=D, domain_shared_expert_num=4,
                    domain_specific_expert_num=2)
    if name == "epnet":
        return dict(sce_features=sce, agn_features=sparse + dense, fcn_dims=[16, 8])
    if name == "ppnet":
        return dict(id_features=ids, agn_features=sparse + dense + sce, domain_num=D,
                    fcn_dims=[16, 12, 8])
    form = name.split("_")[1].capitalize()
    return dict(sce_features=sce, agn_features=sparse, form=form,
                mlp_params={"dims": [16, 8], "dropout": 0.0, "activation": "relu"})


MODELS = ["sarnet", "epnet", "ppnet", "adasparse_binarization", "adasparse_scaling",
          "adasparse_fusion"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(name, seed=0):
    """The JAX model with random BatchNorm running stats (and AdaSparse's
    alpha drawn from U(0.5, 1.5)), and the port model holding the same.

    The embedding tables are redrawn from N(0, 0.5): at their initial scale
    (1e-4) a train-mode BatchNorm after the first layer divides differences
    of ~1e-4 between rows by sqrt(eps), and the two frameworks' rounding of
    the products then shows at 3e-5 in the output."""
    reg = name.split("_")[0]
    jm = jmodels.get_model(reg)(**_kwargs(name, jf))
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(r.normal(0, 0.5, a.shape).astype(np.float32))
                      if "embedding" in p[0].key else a), params)
    state = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            (r.normal(0, 0.2, a.shape) if p[-1].key == "mean"
             else r.uniform(0.5, 1.5, a.shape)).astype(np.float32)), state)
    pm = pmodels.get_model(reg)(**_kwargs(name, pf), device="cpu",
                                generator=make_generator(CPU, seed))
    load_jax_params(pm, _np(params), _np(state))
    return jm, params, state, pm


def _batch(b, seed=0, oob_domains=False):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b) for i in range(4)}
    x.update({f"d{i}": r.normal(size=b).astype(np.float32) for i in range(2)})
    x["uid"] = r.integers(0, V, b)
    x["domain_indicator"] = r.integers(-2, D + 3, b) if oob_domains else r.integers(0, D, b)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{"rtol": RTOL, "atol": ATOL, **kw})


# -- GateNU and Pruner --------------------------------------------------------------

@pytest.mark.parametrize("members", [None, 3])
def test_gatenu_matches_jax(members):
    r = np.random.default_rng(1)
    jg = jnn.GateNU(12, 7, hidden_dim=5, gemma=1.5)
    keys = jax.random.split(jax.random.PRNGKey(0), members or 1)
    params = jax.vmap(jg.init)(keys) if members else jg.init(keys[0])
    pg = pnn.GateNU(12, 7, hidden_dim=5, gemma=1.5, members=members,
                    generator=make_generator(CPU, 0))
    load_jax_params(pg, _np(params))
    x = r.normal(size=(9, 12)).astype(np.float32)
    want = (jax.vmap(lambda p: jg.apply(p, jnp.asarray(x)))(params) if members
            else jg.apply(params, jnp.asarray(x)))
    got = pg(torch.tensor(x))
    assert got.shape == ((members,) if members else ()) + (9, 7)
    _close(got.detach(), want)


@pytest.mark.parametrize("form", ["Binarization", "Scaling", "Fusion"])
def test_pruner_matches_jax_and_sign_is_zero_at_zero(form):
    r = np.random.default_rng(2)
    jp = jnn.Pruner(6, 10, form=form, epsilon=0.3, beta=2.0)
    params = jp.init(jax.random.PRNGKey(1))
    pp = pnn.Pruner(6, 10, form=form, epsilon=0.3, beta=2.0,
                    generator=make_generator(CPU, 0))
    load_jax_params(pp, _np(params))
    sce = r.normal(size=(20, 6)).astype(np.float32)
    h = r.normal(size=(20, 10)).astype(np.float32)
    want = jp.apply(params, jnp.asarray(sce), jnp.asarray(h), jnp.float32(1.7))
    got = pp(torch.tensor(sce), torch.tensor(h), torch.tensor(1.7))
    _close(got.detach(), want)
    assert set(np.unique(np.sign(np.asarray(want)))) <= {-1.0, 0.0, 1.0}
    # zero weights put sigmoid(v) at 0.5: a threshold there gives sign(0) = 0
    eps = 0.5 if form == "Binarization" else 1.0
    jz = jnn.Pruner(6, 10, form=form, epsilon=eps, beta=2.0)
    pz = pnn.Pruner(6, 10, form=form, epsilon=eps, beta=2.0,
                    generator=make_generator(CPU, 0))
    with torch.no_grad():
        pz.w.zero_()
    want = jz.apply({"w": jnp.zeros((16, 10))}, jnp.asarray(sce), jnp.asarray(h), 1.0)
    got = pz(torch.tensor(sce), torch.tensor(h), torch.tensor(1.0))
    assert not np.asarray(want).any() and not got.detach().numpy().any()


# -- the models -----------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_eval_apply_matches_jax(name):
    jm, params, state, pm = _models(name)
    xj, xt = _batch(45, seed=3, oob_domains=True)
    want, _ = jm.apply(params, state, xj, train=False, rng=None)
    alpha = {k: v.clone() for k, v in pm.named_buffers()}
    with torch.no_grad():
        _close(pm.apply(xt, train=False), want)
    for k, v in pm.named_buffers():  # eval moves no buffer, AdaSparse's alpha neither
        assert torch.equal(v, alpha[k]), k


@pytest.mark.parametrize("name", MODELS)
def test_train_apply_running_stats_and_alpha_match_jax(name):
    jm, params, state, pm = _models(name)
    xj, xt = _batch(40, seed=4)
    w = np.ones(40, np.float32)
    w[-9:] = 0.0
    want, new_state = jm.apply(params, state, xj, train=True, rng=jax.random.PRNGKey(0),
                               w=jnp.asarray(w))
    with torch.no_grad():
        got = pm.apply(xt, train=True, w=torch.tensor(w))
    keep = w > 0
    _close(got.numpy()[keep], np.asarray(want)[keep])
    stats = jax_state_dict(_np(params), _np(new_state))
    stats = {k: v for k, v in stats.items() if k.endswith((".mean", ".var", "alpha"))}
    sd = pm.state_dict()
    assert sorted(stats) == sorted(k for k in sd if k.endswith((".mean", ".var", "alpha")))
    for k, v in stats.items():
        _close(sd[k].numpy(), v, err_msg=k)
    if "alpha" in sd:  # advanced by delta_alpha from the carried value
        _close(sd["alpha"].numpy(), np.asarray(state["alpha"]) + 1e-4)


def test_sarnet_rows_path_equals_plain_path():
    """SAR-Net's sorted train step reads pre-gathered packed rows."""
    _, _, _, pm = _models("sarnet")
    _, xt = _batch(24, seed=5)
    col = pm.embedding
    rows = col.packed.detach()[col.touched_ids(xt)]
    with torch.no_grad():
        for train in (False, True):
            a = pm.apply(xt, train=train, rows=rows)
            b = pm.apply(xt, train=train)
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", MODELS)
def test_fused_eval_matches_jax(name):
    """A ragged batch of 37 rows: the port's fused eval (the kernels' plain
    versions on the CPU) against the JAX fused eval (Pallas, interpret
    mode), the JAX op-by-op eval and the port's op-by-op eval."""
    jm, params, state, pm = _models(name)
    xj, xt = _batch(37, seed=6, oob_domains=True)
    want_fused = jm.apply_fused_eval(params, state, xj)
    want, _ = jm.apply(params, state, xj, train=False, rng=None)
    with torch.no_grad():
        got = pm.apply_fused_eval(xt)
        plain = pm.apply(xt, train=False)
    assert got.shape == (37,)
    _close(got, want_fused)
    _close(got, want)
    _close(got, plain)


def test_fold_cache_follows_weights_and_alpha():
    """A fold taken before a change of running stats (or of AdaSparse's
    alpha) is stale; a fresh one is not."""
    for name in ("sarnet", "ppnet", "adasparse_fusion"):
        _, _, _, pm = _models(name)
        _, xt = _batch(16, seed=8)
        with torch.no_grad():
            folded = pm.fold_eval()
            for k, v in pm.named_buffers():
                if k.endswith(".mean"):
                    v.add_(0.5)
                if k == "alpha":
                    v.mul_(3.0)
            stale = pm.apply_fused_eval(xt, folded=folded)
            fresh = pm.apply_fused_eval(xt)
            want = pm.apply(xt)
        _close(fresh, want)
        assert np.abs(stale.numpy() - want.numpy()).max() > 1e-4, name


def test_epnet_gradients_follow_the_detach():
    """EPNet detaches the agnostic embedding in the gate input: the scenario
    table learns only through the gate, the agnostic table only through the
    head. Both tables' gradients match the JAX package's, and the agnostic
    table's equals the gradient with the gate held constant."""
    jm, params, state, pm = _models("epnet")
    xj, xt = _batch(32, seed=9)
    y = (np.arange(32) % 2).astype(np.float32)

    def jloss(p):
        return j_bce(jm.apply(p, state, xj, train=True, rng=jax.random.PRNGKey(1))[0],
                     jnp.asarray(y))

    jg = jax.grad(jloss)(params)
    p_bce(pm.apply(xt, train=True), torch.tensor(y)).backward()
    g_sce = pm.sce_embedding.packed.grad
    g_agn = pm.agn_embedding.packed.grad
    _close(g_sce, jg["sce_embedding"]["packed"], atol=1e-7)
    _close(g_agn, jg["agn_embedding"]["packed"], atol=1e-7)
    assert g_sce.abs().sum() > 0

    table = pm.agn_embedding.packed
    table.grad = None
    sce, agn = pm._embed(xt)
    gate = pm.gatenu(torch.cat([sce, agn], dim=1)).detach()  # constant
    p_bce(torch.sigmoid(pm.mlp(agn * gate))[:, 0], torch.tensor(y)).backward()
    _close(g_agn, table.grad, atol=1e-9)


# -- carrying weights across ------------------------------------------------------------

@pytest.mark.parametrize("name", ["sarnet", "epnet", "ppnet", "adasparse_fusion"])
def test_load_jax_params_raises_on_missing_or_leftover(name):
    _, params, state, pm = _models(name)
    p, s = _np(params), _np(state)
    if name == "adasparse_fusion":  # the scalar state leaf
        s = {k: v for k, v in s.items() if k != "alpha"}
    elif name == "sarnet":
        p = {k: v for k, v in p.items() if k != "dom_b"}
    elif name == "epnet":
        p = {**p, "gatenu": {"l1": p["gatenu"]["l1"]}}
    else:
        p = {**p, "towers": {**p["towers"], "gates": p["towers"]["gates"][:-1]}}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, p, s)
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(pm, {**_np(params), "extra": np.zeros(3, np.float32)}, _np(state))


# -- the registry and build_model -------------------------------------------------------

def _ladder_data(m):
    sparse = [m.SparseFeature(f"s{i}", vocab_size=12, embed_dim=8) for i in range(3)]
    return {"dense_feas": [m.DenseFeature("d0")], "sparse_feas": sparse,
            "scenario_feas": [m.SparseFeature("domain_indicator", vocab_size=3, embed_dim=8)],
            "id_feas": [m.SparseFeature("uid", vocab_size=12, embed_dim=8)],
            "domain_num": 3}


@pytest.mark.parametrize("dataset", ["ali_ccp", "movielens", "kuairand", "amazon", "douban",
                                     "mind"])
@pytest.mark.parametrize("model", ["sarnet", "epnet", "ppnet", "adasparse"])
def test_build_model_matches_jax_tree(dataset, model):
    """The port's parameter and buffer names and shapes equal the JAX tree's
    (params and state, shapes by ``jax.eval_shape``)."""
    jm = jconfigs.build_model(dataset, model, _ladder_data(jf))
    pm = pconfigs.build_model(dataset, model, _ladder_data(pf), device="cpu")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: v.shape for k, v in jax_state_dict(*zeros).items()}
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want
    assert type(pm).__name__ == type(jm).__name__


def test_registry_aliases():
    for name, cls in (("sarnet", pmodels.Sarnet), ("SARNet", pmodels.Sarnet),
                      ("EPNet", pmodels.EPNet), ("ppnet", pmodels.PPNet),
                      ("AdaSparse", pmodels.AdaSparse), ("ada-sparse", pmodels.AdaSparse)):
        assert pmodels.get_model(name) is cls
        assert jmodels.get_model(name).__name__ == cls.__name__
    assert set(pmodels.MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)
    m = pconfigs.build_model("ali_ccp", "adasparse", _ladder_data(pf), device="cpu")
    assert (m.mlp_dims, m.dropout_p, m.pruners[0].form) == ([256, 128, 64, 32, 16, 8], 0.2,
                                                           "Fusion")
    assert float(m.alpha) == 1.0 and m.delta_alpha == 1e-4
