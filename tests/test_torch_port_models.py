"""Port SharedBottom, STAR and PLE, the plain versions of their fused
kernels, the weight carry-over, the model registry and ``build_model``
against the JAX package (its Pallas kernels in interpret mode), weights
carried across. Inputs are made with numpy from a seed and fed to both."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu import configs as jconfigs  # noqa: E402
from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas import ple_infer as jple  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.star_infer import star_fused_infer as j_star  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.tower_infer import (  # noqa: E402
    trunk_towers_fused_infer as j_tower)
from scenario_wise_rec_tpu_torch import configs as pconfigs  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import (  # noqa: E402
    jax_state_dict, load_jax_params)
from scenario_wise_rec_tpu_torch.ops.kernels import ple_infer as pk_ple  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import star_infer as pk_star  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import tower_infer as pk_tower  # noqa: E402

# the JAX package's own fused-kernel tolerance: sums in another order
RTOL, ATOL = 1e-5, 1e-6
V, D = 48, 3

# name -> (registry name, constructor arguments), narrow
MODELS = {
    "sharedbottom": ("sharedbottom", dict(bottom_params={"dims": [24]},
                                          tower_params={"dims": [16, 8]})),
    "star": ("star", dict(fcn_dims=[16, 8], aux_dims=[8])),
    "ple_1_level": ("ple", dict(n_level=1, n_expert_specific=2, n_expert_shared=1,
                                expert_params={"dims": [16, 8]},
                                tower_params={"dims": [4]})),
    "ple_2_levels": ("ple", dict(n_level=2, n_expert_specific=2, n_expert_shared=2,
                                 expert_params={"dims": [12, 8]},
                                 tower_params={"dims": [4]})),
}


def _feats(m):
    return ([m.DenseFeature("d0"), m.DenseFeature("d1")]
            + [m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8) for i in range(4)])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(name, seed=0):
    """The JAX model with random BatchNorm running stats, and the port model
    holding the same weights."""
    reg, kw = MODELS[name]
    jm = jmodels.get_model(reg)(_feats(jf), D, **kw)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed + 100)
    state = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            (r.normal(0, 0.2, a.shape) if p[-1].key == "mean"
             else r.uniform(0.5, 1.5, a.shape)).astype(np.float32)), state)
    pm = pmodels.get_model(reg)(_feats(pf), D, device="cpu",
                                generator=make_generator(torch.device("cpu"), seed), **kw)
    load_jax_params(pm, _np(params), _np(state))
    return jm, params, state, pm


def _batch(b, seed=0, oob_domains=False):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b) for i in range(4)}
    x.update({f"d{i}": r.normal(size=b).astype(np.float32) for i in range(2)})
    x["domain_indicator"] = r.integers(-2, D + 3, b) if oob_domains \
        else r.integers(0, D, b)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# -- the models -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_eval_apply_matches_jax(name):
    jm, params, state, pm = _models(name)
    xj, xt = _batch(45, seed=3, oob_domains=True)
    want, _ = jm.apply(params, state, xj, train=False, rng=None)
    with torch.no_grad():
        _close(pm.apply(xt, train=False), want)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_apply_and_running_stats_match_jax(name):
    jm, params, state, pm = _models(name)
    xj, xt = _batch(40, seed=4)
    w = np.ones(40, np.float32)
    w[-9:] = 0.0
    want, new_state = jm.apply(params, state, xj, train=True,
                               rng=jax.random.PRNGKey(0), w=jnp.asarray(w))
    with torch.no_grad():
        got = pm.apply(xt, train=True, w=torch.tensor(w))
    keep = w > 0
    _close(got.numpy()[keep], np.asarray(want)[keep])
    stats = {k: v for k, v in jax_state_dict(
        _np(params), _np(new_state), getattr(pm, "jax_state_map", ())).items()
        if k.endswith((".mean", ".var"))}
    sd = pm.state_dict()
    assert stats and sorted(stats) == sorted(k for k in sd if k.endswith((".mean", ".var")))
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_rows_path_equals_plain_path(name):
    """The sorted train step's forward reads pre-gathered packed rows."""
    _, _, _, pm = _models(name)
    _, xt = _batch(24, seed=5)
    col = pm.embedding
    rows = col.packed.detach()[col.touched_ids(xt)]
    with torch.no_grad():
        for train in (False, True):
            a = pm.apply(xt, train=train, rows=rows)
            b = pm.apply(xt, train=train)
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_eval_matches_jax(name):
    """A ragged batch (37 rows: 2 tiles of 16 and 5) with its tail masked:
    the port's fused eval (the kernels' plain versions on the CPU) against
    the JAX fused eval (Pallas, interpret mode) and the JAX op-by-op eval."""
    jm, params, state, pm = _models(name)
    xj, xt = _batch(37, seed=6, oob_domains=True)
    w = np.ones(37, np.float32)
    w[-6:] = 0.0
    want_fused = jm.apply_fused_eval(params, state, xj, w=jnp.asarray(w))
    want, _ = jm.apply(params, state, xj, train=False, rng=None, w=jnp.asarray(w))
    with torch.no_grad():
        got = pm.apply_fused_eval(xt, w=torch.tensor(w))
        plain = pm.apply(xt, train=False, w=torch.tensor(w))
    assert got.shape == (37,)
    _close(got, want_fused)
    _close(got, want)
    _close(got, plain)


def test_star_fused_eval_masks_padding():
    """STAR's domain norm reads the batch's statistics at eval too: a batch
    padded from 13 to 32 rows with ``w`` gives, on its real rows, what the
    unpadded batch gives (port and JAX alike)."""
    jm, params, state, pm = _models("star")
    xj, xt = _batch(13, seed=7)
    want, _ = jm.apply(params, state, xj, train=False, rng=None)
    pad = lambda x: {k: torch.cat([v, v[:1].expand(19, *v.shape[1:])]) for k, v in x.items()}
    w = torch.cat([torch.ones(13), torch.zeros(19)])
    with torch.no_grad():
        got = pm.apply_fused_eval(pad(xt), w=w)[:13]
        unmasked = pm.apply_fused_eval(pad(xt))[:13]
        plain = pm.apply(pad(xt), train=False, w=w)[:13]
    _close(got, want)
    _close(plain, want)
    assert np.abs(unmasked.numpy() - np.asarray(want)).max() > 1e-4  # the mask matters


def test_fold_cache_follows_weights():
    """A fold taken before a weight change is stale; a fresh one is not."""
    for name in ("sharedbottom", "star", "ple_2_levels"):
        _, _, _, pm = _models(name)
        _, xt = _batch(16, seed=8)
        with torch.no_grad():
            folded = pm.fold_eval()
            for k, v in pm.named_buffers():
                if k.endswith(".mean"):
                    v.add_(0.5)
            stale = pm.apply_fused_eval(xt, folded=folded)
            fresh = pm.apply_fused_eval(xt)
            want = pm.apply(xt)
        _close(fresh, want)
        assert np.abs(stale.numpy() - want.numpy()).max() > 1e-4, name


# -- the kernels' plain versions against the JAX kernels --------------------------

def _affines(r, lead, dims):
    """Stages (W [*lead, in, out], b [*lead, out]) scaled like a Linear's
    init, between the widths ``dims``."""
    out = []
    for i, o in zip(dims[:-1], dims[1:]):
        out.append((((i ** -0.5) * r.normal(size=lead + (i, o))).astype(np.float32),
                    (0.1 * r.normal(size=lead + (o,))).astype(np.float32)))
    return out


def _j(stages):
    return [tuple(jnp.asarray(a) for a in s) for s in stages]


def _t(stages):
    return [tuple(torch.tensor(a) for a in s) for s in stages]


@pytest.mark.parametrize("cfg", [
    # (B, F, D, trunk dims, tower dims, head, block_rows)
    (37, 42, 3, [24], [16, 8], True, 16),     # ragged: 37 = 2*16 + 5
    (20, 30, 2, [16, 12], [], True, 8),       # no tower stage: head on the trunk
    (33, 18, 4, [10], [6, 1], False, 16),     # no head: the last stage has width 1
    (16, 12, 1, [], [5], True, 8),            # no trunk stage
])
def test_tower_ref_matches_jax_kernel(cfg):
    B, F, Dn, trunk, towers, head, block_rows = cfg
    r = np.random.default_rng(B)
    tr = _affines(r, (), [F] + trunk)
    w_in = trunk[-1] if trunk else F
    tw = _affines(r, (Dn,), [w_in] + towers)
    out = _affines(r, (Dn,), [towers[-1] if towers else w_in, 1])[0] if head else None
    emb = r.normal(size=(B, F)).astype(np.float32)
    did = r.integers(-2, Dn + 4, B)  # out-of-range ids are clipped
    want = j_tower(jnp.asarray(emb), jnp.asarray(did), _j(tr), _j(tw),
                   None if out is None else _j([out])[0], block_rows=block_rows,
                   interpret=True)
    before = pk_tower.trunk_towers_fused_infer.launches
    got = pk_tower.trunk_towers_fused_infer(
        torch.tensor(emb), torch.tensor(did), _t(tr), _t(tw),
        None if out is None else _t([out])[0])
    assert pk_tower.trunk_towers_fused_infer.launches == before  # plain on the CPU
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("cfg", [
    # (B, F, D, fcn dims, aux dims, block_rows)
    (37, 42, 3, [16, 8], [8], 16),
    (19, 20, 2, [6], [], 8),                  # aux head on the raw row
    (24, 33, 4, [12, 10, 6], [7, 5], 8),
])
def test_star_ref_matches_jax_kernel(cfg):
    B, F, Dn, fcn, aux, block_rows = cfg
    r = np.random.default_rng(B + 1)
    emb = r.normal(size=(B, F)).astype(np.float32)
    mean = emb.mean(0)
    rstd = (1.0 / np.sqrt(emb.var(0) + 1e-6)).astype(np.float32)
    g = r.uniform(0.5, 1.5, (Dn, F)).astype(np.float32)
    b = (0.1 * r.normal(size=(Dn, F))).astype(np.float32)
    fs = _affines(r, (Dn,), [F] + fcn + [1])
    ast = _affines(r, (), [F] + aux)
    ao = _affines(r, (), [aux[-1] if aux else F, 1])[0]
    did = r.integers(-2, Dn + 4, B)
    vec = [mean, rstd, g, b]
    want = j_star(jnp.asarray(emb), jnp.asarray(did), *map(jnp.asarray, vec), _j(fs),
                  _j(ast), _j([ao])[0], block_rows=block_rows, interpret=True)
    got = pk_star.star_fused_infer(torch.tensor(emb), torch.tensor(did),
                                   *map(torch.tensor, vec), _t(fs), _t(ast), _t([ao])[0])
    assert got.shape == (B,)
    _close(got, want)


def _ple_levels(r, F, Dn, S, n_sh, levels, gate_hidden=()):
    """Random folded levels; ``levels`` lists each level's expert dims and
    ``gate_hidden`` adds gate stages before the softmax output."""
    out, width = [], F
    for li, dims in enumerate(levels):
        last = li == len(levels) - 1
        E, n_all = S + n_sh, Dn * S + n_sh
        spec = _affines(r, (Dn, S), [width] + dims)
        shared = _affines(r, (n_sh,), [width] + dims)
        gates = _affines(r, (Dn,), [width] + list(gate_hidden) + [E])
        gs = None if last else _affines(r, (), [width] + list(gate_hidden) + [n_all])
        out.append((spec, shared, gates, gs))
        width = dims[-1]
    return out, width


@pytest.mark.parametrize("cfg", [
    # (B, F, D, S, n_sh, levels' expert dims, tower dims, gate hidden, block_rows)
    (37, 42, 3, 2, 1, [[16, 8]], [4], (), 16),              # one level
    (29, 30, 3, 2, 2, [[12, 8], [6]], [4], (), 8),          # two levels
    (21, 24, 2, 1, 1, [[8], [8], [5]], [], (6,), 16),       # three levels, 2-stage gates
])
def test_ple_ref_matches_jax_kernel(cfg):
    B, F, Dn, S, n_sh, levels, towers, gate_hidden, block_rows = cfg
    r = np.random.default_rng(B + 2)
    lv, width = _ple_levels(r, F, Dn, S, n_sh, levels, gate_hidden)
    tw = _affines(r, (Dn,), [width] + towers)
    out = _affines(r, (Dn,), [towers[-1] if towers else width, 1])[0]
    emb = r.normal(size=(B, F)).astype(np.float32)
    did = r.integers(-2, Dn + 4, B)
    want = jple.ple_fused_infer(
        jnp.asarray(emb), jnp.asarray(did),
        [jple.LevelSpec(_j(a), _j(b), _j(c), None if d is None else _j(d))
         for a, b, c, d in lv], _j(tw), _j([out])[0], block_rows=block_rows,
        interpret=True)
    got = pk_ple.ple_fused_infer(
        torch.tensor(emb), torch.tensor(did),
        [pk_ple.LevelSpec(_t(a), _t(b), _t(c), None if d is None else _t(d))
         for a, b, c, d in lv], _t(tw), _t([out])[0])
    assert got.shape == (B,)
    _close(got, want)


def test_wrappers_check_shapes():
    r = np.random.default_rng(0)
    emb, did = torch.randn(4, 10), torch.zeros(4, dtype=torch.long)
    tr, tw = _t(_affines(r, (), [10, 6])), _t(_affines(r, (2,), [6, 3]))
    out = _t(_affines(r, (2,), [3, 1]))[0]
    with pytest.raises(ValueError):
        pk_tower.trunk_towers_fused_infer(torch.randn(4, 11), did, tr, tw, out)
    with pytest.raises(ValueError):
        pk_tower.trunk_towers_fused_infer(emb, torch.zeros(4), tr, tw, out)
    with pytest.raises(ValueError, match="width 1"):
        pk_tower.trunk_towers_fused_infer(emb, did, tr, tw, None)
    g, b = torch.ones(2, 10), torch.zeros(2, 10)
    fs = _t(_affines(r, (2,), [10, 4, 1]))
    ast, ao = _t(_affines(r, (), [10, 3])), _t(_affines(r, (), [3, 1]))[0]
    with pytest.raises(ValueError):
        pk_star.star_fused_infer(emb, did, torch.zeros(9), torch.ones(10), g, b, fs, ast, ao)
    with pytest.raises(ValueError, match="width 1"):
        pk_star.star_fused_infer(emb, did, torch.zeros(10), torch.ones(10), g, b, fs[:1],
                                 ast, ao)
    lv, width = _ple_levels(r, 10, 2, 2, 1, [[6], [4]])
    levels = [pk_ple.LevelSpec(_t(a), _t(b_), _t(c), None if d is None else _t(d))
              for a, b_, c, d in lv]
    head = _t(_affines(r, (2,), [width, 1]))[0]
    assert pk_ple.ple_fused_infer(emb, did, levels, [], head).shape == (4,)
    with pytest.raises(ValueError, match="shared gate"):
        pk_ple.ple_fused_infer(emb, did, levels[:1] + [pk_ple.LevelSpec(
            levels[1].spec_stages, levels[1].shared_stages, levels[1].gate_stages,
            levels[0].gate_shared_stages)], [], head)
    with pytest.raises(ValueError):
        pk_ple.ple_fused_infer(emb, did, levels[1:], [], head)  # widths do not chain


# -- carrying weights across ------------------------------------------------------

@pytest.mark.parametrize("name", ["sharedbottom", "star", "ple_2_levels"])
def test_load_jax_params_raises_on_missing_or_leftover(name):
    _, params, state, pm = _models(name)
    p, s = _np(params), _np(state)
    if name == "star":  # the leaf that lives elsewhere in the module
        s = {**s, "bn": s["bn"][:-1]}
    else:
        key = "bottom" if name == "sharedbottom" else "towers"
        p = {**p, key: {**p[key], "out": None} if key == "towers" else
             {**p[key], "layers": p[key]["layers"][:-1]}}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, p, s)
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(pm, {**_np(params), "extra": np.zeros(3, np.float32)}, _np(state))
    bad = jax.tree_util.tree_map(lambda a: a, _np(state))
    with pytest.raises((KeyError, ValueError)):
        load_jax_params(pm, _np(params), {**bad, "stray": {"layers": [
            {"mean": np.zeros(2, np.float32), "var": np.ones(2, np.float32)}]}})


# -- the registry and build_model ---------------------------------------------------

def _ladder_data(m):
    sparse = [m.SparseFeature(f"s{i}", vocab_size=12, embed_dim=8) for i in range(3)]
    return {"dense_feas": [m.DenseFeature("d0")], "sparse_feas": sparse,
            "scenario_feas": [m.SparseFeature("sce", vocab_size=3, embed_dim=8)],
            "id_feas": [m.SparseFeature("uid", vocab_size=12, embed_dim=8)],
            "domain_num": 3}


@pytest.mark.parametrize("dataset", ["ali_ccp", "movielens", "kuairand", "amazon",
                                     "douban", "mind"])
@pytest.mark.parametrize("model", ["mmoe", "sharedbottom", "sharebottom", "ple", "star"])
def test_build_model_matches_jax_tree(dataset, model):
    """The port's parameter and buffer names and shapes equal the JAX tree's
    (params and state, shapes by ``jax.eval_shape``)."""
    jm = jconfigs.build_model(dataset, model, _ladder_data(jf))
    pm = pconfigs.build_model(dataset, model, _ladder_data(pf), device="cpu")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: v.shape for k, v in jax_state_dict(
        *zeros, getattr(pm, "jax_state_map", ())).items()}
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want
    assert type(pm).__name__ == type(jm).__name__


def test_registry_aliases_and_unported_names():
    for name in ("SharedBottom", "sharebottom", "Sharedbottom"):
        assert pmodels.get_model(name) is pmodels.SharedBottom
    assert pmodels.get_model("PLE") is pmodels.PLE and pmodels.get_model("Star") is pmodels.Star
    assert set(pmodels.MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)
    for name in list(jmodels.MODEL_REGISTRY) + ["M2M", "M3oE", "Hamur_Small", "HamurLarge"]:
        assert pmodels.get_model(name).__name__ == jmodels.get_model(name).__name__, name
    m = pconfigs.build_model("ali_ccp", "m3oe", _ladder_data(pf), device="cpu")
    assert isinstance(m, pmodels.M3oE) and m.fcn_dim == [256, 64]
    with pytest.raises(KeyError):
        pmodels.get_model("no_such_model")
    with pytest.raises(KeyError):
        pconfigs.build_model("no_such_dataset", "mmoe", _ladder_data(pf), device="cpu")
    m = pconfigs.build_model("AliCCP", "star", _ladder_data(pf), device="cpu")
    assert isinstance(m, pmodels.Star) and m.fcn_dim == [25, 256, 128, 64, 32, 16, 8, 1]


def test_register_ladder_passes_model_arguments():
    seen = {}

    def ladder(model_name, d, **kw):
        seen.update(kw)
        return pmodels.get_model(model_name)(d["dense_feas"] + d["sparse_feas"],
                                             d["domain_num"], fcn_dims=[4], aux_dims=[2],
                                             **kw)

    pconfigs.register_ladder("toy", ladder)
    gen = make_generator(torch.device("cpu"), 3)
    m = pconfigs.build_model("toy", "star", _ladder_data(pf), device="cpu", generator=gen)
    assert seen == {"device": "cpu", "generator": gen} and isinstance(m, pmodels.Star)
