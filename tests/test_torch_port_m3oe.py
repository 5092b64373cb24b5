"""Port M3oE, the plain version of its fused kernel, the weight carry-over
and ``build_model`` against the JAX package (its Pallas kernel in
interpret mode), weights carried across, at ``D`` = 3 and at ``D`` = 1
(the balance mix's own branch). Inputs are made with numpy from a seed and
fed to both. The train steps are in
``test_torch_port_train_m2m_m3oe.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu import configs as jconfigs  # noqa: E402
from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas import m3oe_infer as jk  # noqa: E402
from scenario_wise_rec_tpu_torch import configs as pconfigs  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import jax_state_dict, load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import m3oe_infer as pk  # noqa: E402

# Per-row math against XLA's: sums in another order, and each LayerNorm
# divides by a row's std; the JAX package's own fused-kernel tolerance for
# M3oE (tests/test_pallas_kernels.py).
RTOL, ATOL = 1e-5, 1e-6
V = 32
CPU = torch.device("cpu")


def _kwargs(m, D=3):
    feats = ([m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8) for i in range(4)]
             + [m.DenseFeature("d0")])
    return dict(features=feats, domain_num=D, fcn_dims=[32, 16, 16, 8], expert_num=2,
                exp_d=0.2, exp_t=0.2, bal_d=0.5, bal_t=0.5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize(params, seed):
    """Embedding tables from N(0, 0.5), the LayerNorms' gammas and betas,
    the slot and gate biases and the mixing scalars random too."""
    r = np.random.default_rng(seed)

    def leaf(p, a):
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        if path.startswith("embedding"):
            v = r.normal(0, 0.5, a.shape)
        elif path.endswith("gamma"):
            v = r.uniform(0.5, 1.5, a.shape)
        elif path.endswith("beta") or path in ("slot_b", "shared_b"):
            v = 0.1 * r.normal(size=a.shape)
        elif path.startswith("w_"):
            v = r.normal(size=a.shape)
        else:
            return a
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, params)


def _models(D=3, seed=0):
    jm = jmodels.M3oE(**_kwargs(jf, D))
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    params = randomize(params, seed + 100)
    pm = pmodels.M3oE(**_kwargs(pf, D), device="cpu", generator=make_generator(CPU, seed))
    load_jax_params(pm, _np(params), _np(state))
    return jm, params, state, pm


def _batch(b, D=3, seed=0, oob_domains=False):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b) for i in range(4)}
    x["d0"] = r.normal(size=b).astype(np.float32)
    x["domain_indicator"] = r.integers(-2, D + 3, b) if oob_domains else r.integers(0, D, b)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{"rtol": RTOL, "atol": ATOL, **kw})


@pytest.mark.parametrize("D", [3, 1])
@pytest.mark.parametrize("train", [False, True])
def test_apply_matches_jax(D, train):
    """Eval and train mode (the same math: no batch statistics, no
    dropout), out-of-range domain ids clipped."""
    jm, params, state, pm = _models(D)
    xj, xt = _batch(39, D, seed=3, oob_domains=True)
    want, new_state = jm.apply(params, state, xj, train=train, rng=jax.random.PRNGKey(0))
    assert new_state == {}
    with torch.no_grad():
        got = pm.apply(xt, train=train)
    assert got.shape == (39,)
    _close(got, want)


@pytest.mark.parametrize("D", [3, 1])
def test_fused_eval_matches_jax_and_apply(D):
    """The port's fused eval (the kernel's plain version on the CPU)
    against the JAX fused eval (Pallas, interpret mode), the JAX op-by-op
    eval and the port's op-by-op eval."""
    jm, params, state, pm = _models(D, seed=1)
    xj, xt = _batch(39, D, seed=6, oob_domains=True)
    want_fused = jm.apply_fused_eval(params, state, xj)
    want, _ = jm.apply(params, state, xj, train=False, rng=None)
    before = pk.m3oe_fused_infer.launches
    with torch.no_grad():
        got = pm.apply_fused_eval(xt)
        plain = pm.apply(xt, train=False)
    assert pk.m3oe_fused_infer.launches == before  # the plain version on the CPU
    for other in (want_fused, want, plain):
        _close(got, other)


def test_fold_eval_operands_match_jax():
    """``fold_eval`` builds the stacked operands of the JAX package's
    ``apply_fused_eval``: the star slots, the stacked members, the towers
    and the two sigmoids."""
    _, params, _, pm = _models(seed=2)
    star, skip, star_mlp, gates, experts, dom_experts, towers, w_exp, w_bal = pm.fold_eval()
    _close(star[0], params["slot_w"] * params["shared_w"][None], rtol=0, atol=0)
    _close(star[1], params["slot_b"] + params["shared_b"][None], rtol=0, atol=0)
    _close(experts[0][0], jnp.stack([e[0]["lin"]["w"] for e in params["experts"]]), rtol=0,
           atol=0)
    _close(dom_experts[0][2], jnp.stack([e[0]["ln"]["gamma"] for e in params["domain_experts"]]),
           rtol=0, atol=0)
    _close(skip[0][3], params["skip"][0]["ln"]["beta"], rtol=0, atol=0)
    _close(gates[0], jnp.stack([g["w"] for g in params["gates"]]), rtol=0, atol=0)
    _close(towers[2], jnp.stack([t["ln"]["gamma"] for t in params["towers"]]), rtol=0, atol=0)
    _close(w_bal, jax.nn.sigmoid(params["w_bal_d"]))
    _close(w_exp, jax.nn.sigmoid(params["w_exp_d"]))
    assert len(star_mlp) == 1 and experts[0][0].shape == (2, 16, 8)


# -- the kernel's plain version against the JAX kernel --------------------------------------

def _mlp_n(r, lead, dims):
    return [(((i ** -0.5) * r.normal(size=lead + (i, o))).astype(np.float32),
             (0.1 * r.normal(size=lead + (o,))).astype(np.float32),
             r.uniform(0.5, 1.5, lead + (o,)).astype(np.float32),
             (0.1 * r.normal(size=lead + (o,))).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def _ref_against_jax_kernel(cfg, ids=None):
    """The plain version against the JAX kernel (interpret mode) on numpy
    inputs; ``ids(r, B, D)`` makes the domain ids (default: -2 .. D + 2)."""
    B, s0, s1, s2, hid, h, E, D, w_exp, w_bal = cfg
    r = np.random.default_rng(B)
    emb = r.normal(size=(B, s0)).astype(np.float32)
    did = r.integers(-2, D + 3, B) if ids is None else ids(r, B, D)
    star = ((s0 ** -0.5 * r.normal(size=(D, s0, s1))).astype(np.float32),
            (0.1 * r.normal(size=(D, s1))).astype(np.float32))
    skip, star_mlp = _mlp_n(r, (), [s0, s2]), _mlp_n(r, (), [s1, s2])
    experts, dom = _mlp_n(r, (E,), [s2] + hid + [h]), _mlp_n(r, (D,), [s2] + hid + [h])
    gates = ((s2 ** -0.5 * r.normal(size=(D, s2, E))).astype(np.float32),
             r.normal(size=(D, E)).astype(np.float32))
    l1 = _mlp_n(r, (D,), [h, h])[0]
    towers = l1 + ((h ** -0.5 * r.normal(size=(D, h, 1))).astype(np.float32),
                   (0.1 * r.normal(size=(D, 1))).astype(np.float32))
    scal = (np.array([w_exp], np.float32), np.array([w_bal], np.float32))
    j = lambda t: tuple(jnp.asarray(a) for a in t)
    t = lambda x: tuple(torch.tensor(a) for a in x)
    want = jk.m3oe_fused_infer(jnp.asarray(emb), jnp.asarray(did), j(star), [j(l) for l in skip],
                               [j(l) for l in star_mlp], j(gates), [j(l) for l in experts],
                               [j(l) for l in dom], j(towers), *j(scal), block_rows=16,
                               interpret=True)
    args = (torch.tensor(emb), torch.tensor(did), t(star), [t(l) for l in skip],
            [t(l) for l in star_mlp], t(gates), [t(l) for l in experts], [t(l) for l in dom],
            t(towers), *t(scal))
    got = pk.m3oe_fused_infer_ref(*args)
    assert got.shape == (B,)
    _close(got, want)
    before = pk.m3oe_fused_infer.launches
    np.testing.assert_array_equal(pk.m3oe_fused_infer(*args).numpy(), got.numpy())
    assert pk.m3oe_fused_infer.launches == before
    return args


@pytest.mark.parametrize("cfg", [
    # (B, s0, s1, s2, fcn hidden dims, h, E, D, w_exp, w_bal)
    (39, 33, 32, 16, [], 8, 2, 3, 0.55, 0.62),   # the JAX test's widths
    (21, 20, 12, 10, [7], 6, 3, 2, 0.3, 0.9),    # deeper experts, widths not multiples of 4
    (17, 12, 8, 8, [], 4, 2, 1, 0.7, 0.4),       # one domain: the balance mix's own branch
])
def test_fused_infer_ref_matches_jax_kernel(cfg):
    _ref_against_jax_kernel(cfg)


def _skewed(r, B, D):
    """90 % of the rows in domain D - 1, the rest spread over the others."""
    did = np.where(r.random(B) < 0.9, D - 1, r.integers(0, D, B))
    assert (did == D - 1).mean() >= 0.9
    return did


def _int64_wide(r, B, D):
    """int64 ids far outside [0, D): each is taken modulo 2^32 as int32, then
    clipped, as JAX's ``astype(int32)`` and the card take them."""
    wide = np.array([2**32 + 1, 2**31, 2**33 + 2, -2**32 + 2, -2**31 - 7, 2**40], np.int64)
    return np.where(r.random(B) < 0.5, wide[r.integers(0, len(wide), B)],
                    r.integers(0, D, B)).astype(np.int64)


@pytest.mark.parametrize("ids", [_skewed, _int64_wide])
@pytest.mark.parametrize("cfg", [
    (64, 33, 32, 16, [], 8, 2, 3, 0.55, 0.62),
    (40, 20, 12, 10, [7], 6, 3, 4, 0.3, 0.9),
])
def test_fused_infer_ref_matches_jax_kernel_on_ids(cfg, ids):
    args = _ref_against_jax_kernel(cfg, ids)
    assert args[1].dtype == torch.int64


@pytest.mark.parametrize("rows", [8, 12, 24, 80, 0, -16, 16.0])
def test_fused_infer_tile_rule_raises_on_the_cpu(rows):
    """The card's tile rule (a multiple of 16 up to 64, or None) holds on the
    CPU too, where the plain version runs: a call that would raise on the
    card raises here."""
    _, _, _, pm = _models(seed=4)
    _, xt = _batch(6)
    emb = pm.embedding(xt, pm.features, squeeze_dim=True).detach()
    did = xt["domain_indicator"]
    folded = pm.fold_eval()
    with pytest.raises(ValueError, match="block_rows"):
        pk.m3oe_fused_infer(emb, did, *folded, block_rows=rows)
    want = pk.m3oe_fused_infer_ref(emb, did, *folded)
    for ok in (16, 32, 48, 64, None):
        torch.testing.assert_close(pk.m3oe_fused_infer(emb, did, *folded, block_rows=ok), want,
                                   rtol=0, atol=0)


def test_fused_infer_checks_shapes():
    _, _, _, pm = _models(seed=3)
    _, xt = _batch(6)
    emb = pm.embedding(xt, pm.features, squeeze_dim=True).detach()
    did = xt["domain_indicator"]
    folded = list(pm.fold_eval())
    assert pk.m3oe_fused_infer(emb, did, *folded).shape == (6,)
    bad = folded.copy()
    bad[3] = (folded[3][0][:, :, :1], folded[3][1][:, :1])  # one gate column for 2 experts
    with pytest.raises(ValueError, match="gates"):
        pk.m3oe_fused_infer(emb, did, *bad)
    bad = folded.copy()
    bad[1] = [folded[1][0][:3]]
    with pytest.raises(ValueError, match="skip"):
        pk.m3oe_fused_infer(emb, did, *bad)
    with pytest.raises(ValueError, match="domain_id"):
        pk.m3oe_fused_infer(emb, did[:5], *folded)


# -- carrying weights across and build_model -------------------------------------------------

def test_load_jax_params_raises_on_missing_or_leftover():
    _, params, state, pm = _models()
    p = _np(params)
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, {**p, "experts": p["experts"][:1]}, {})
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, {k: v for k, v in p.items() if k != "w_bal_t"}, {})
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(pm, {**p, "towers": p["towers"] + [p["towers"][0]]}, {})


def _ladder_data(m):
    sparse = [m.SparseFeature(f"s{i}", vocab_size=12, embed_dim=8) for i in range(3)]
    return {"dense_feas": [m.DenseFeature("d0")], "sparse_feas": sparse,
            "scenario_feas": [m.SparseFeature("domain_indicator", vocab_size=3, embed_dim=8)],
            "domain_num": 3}


@pytest.mark.parametrize("dataset", ["ali_ccp", "movielens", "kuairand", "amazon"])
def test_build_model_matches_jax_tree(dataset):
    """The port's parameter names and shapes equal the JAX tree's (shapes by
    ``jax.eval_shape``); M3oE has no state."""
    jm = jconfigs.build_model(dataset, "m3oe", _ladder_data(jf))
    pm = pconfigs.build_model(dataset, "m3oe", _ladder_data(pf), device="cpu")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: v.shape for k, v in jax_state_dict(*zeros).items()}
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want
    assert type(pm).__name__ == type(jm).__name__ and not list(pm.buffers())


def test_build_model_ali_ccp_widths():
    """At Ali-CCP width (23 sparse features of 16 and 8 dense): input 376,
    star [376, 512, 256], fcn [256, 64], 4 experts, 3 domains."""
    sparse = [pf.SparseFeature(f"s{i}", vocab_size=5, embed_dim=16) for i in range(23)]
    data = {"dense_feas": [pf.DenseFeature(f"d{i}") for i in range(8)], "sparse_feas": sparse,
            "domain_num": 3}
    m = pconfigs.build_model("ali_ccp", "m3oe", data, device="cpu")
    assert isinstance(m, pmodels.M3oE) and m.input_dim == 376
    assert m.star_dim == [376, 512, 256] and m.fcn_dim == [256, 64] and m.expert_num == 4
    assert tuple(m.slot_w.shape) == (3, 376, 512) and len(m.domain_experts) == 3
    assert tuple(m.towers[0].l1.w.shape) == (64, 64) and tuple(m.gates[0].w.shape) == (256, 4)
