"""Port ``layernorm``, the ``Transformer`` and M2M, the plain version of
M2M's fused kernel, the weight carry-over, the registry and ``build_model``
against the JAX package (its Pallas kernel in interpret mode), weights
carried across. Inputs are made with numpy from a seed and fed to both.
The train steps are in ``test_torch_port_train_m2m_m3oe.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu import configs as jconfigs  # noqa: E402
from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops import nn as jnn  # noqa: E402
from scenario_wise_rec_tpu.ops import transformer as jtr  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas import m2m_infer as jk  # noqa: E402
from scenario_wise_rec_tpu_torch import configs as pconfigs  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import jax_state_dict, load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.ops import nn as pnn  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import m2m_infer as pk  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.transformer import Transformer  # noqa: E402

# Per-row math against XLA's: sums in another order, a few ulp of O(1)
# values (the JAX package's fused-kernel tolerance).
RTOL, ATOL = 1e-5, 1e-6
# The transformer's outputs: each of its 13 LayerNorms divides by a row's
# std, which carries the sums' rounding of the 40-wide rows it normalises.
TR_RTOL, TR_ATOL = 1e-5, 1e-5
# A padded batch against the unpadded one: the JAX package's own M2M
# tolerance (tests/test_masked_batch_stats.py): the transformer's LayerNorm
# chain amplifies the masked softmax's other summation order.
PAD_RTOL, PAD_ATOL = 1e-3, 5e-4
V, D, E = 32, 3, 8
CPU = torch.device("cpu")


def _feats(m):
    dom = [m.SparseFeature("domain_indicator", vocab_size=D, embed_dim=8)]
    return [m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8) for i in range(4)] + dom, dom


def _kwargs(m, dropout=None):
    feats, dom = _feats(m)
    kw = dict(features=feats, domain_feature=dom, domain_num=D, num_experts=4,
              expert_output_size=E)
    if dropout is not None:
        kw["transformer_dims"] = {"num_encoder_layers": 2, "num_decoder_layers": 2,
                                  "dim_feedforward": 16, "dropout": dropout}
    return kw


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize(params, state, seed):
    """Embedding tables from N(0, 0.5), the LayerNorms' gammas and betas and
    every BatchNorm's running stats random, so that nothing is left at its
    identity."""
    r = np.random.default_rng(seed)

    def leaf(p, a):
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        if path.startswith("embedding"):
            return jnp.asarray(r.normal(0, 0.5, a.shape).astype(np.float32))
        if path.endswith("gamma"):
            return jnp.asarray(r.uniform(0.5, 1.5, a.shape).astype(np.float32))
        if path.endswith("beta") or path.endswith("in_b") or path.endswith("out_b"):
            return jnp.asarray((0.1 * r.normal(size=a.shape)).astype(np.float32))
        return a

    params = jax.tree_util.tree_map_with_path(leaf, params)
    state = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray((r.normal(0, 0.2, a.shape) if str(p[-1].key) == "mean"
                                  else r.uniform(0.5, 1.5, a.shape)).astype(np.float32)),
        state)
    return params, state


def _models(seed=0, dropout=None):
    jm = jmodels.M2M(**_kwargs(jf, dropout))
    params, state = randomize(*jax.jit(jm.init)(jax.random.PRNGKey(seed)), seed + 100)
    pm = pmodels.M2M(**_kwargs(pf, dropout), device="cpu", generator=make_generator(CPU, seed))
    load_jax_params(pm, _np(params), _np(state))
    return jm, params, state, pm


def _batch(b, seed=0):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b) for i in range(4)}
    x["domain_indicator"] = r.integers(0, D, b)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def _mask(b, n_pad):
    w = np.ones(b, np.float32)
    w[b - n_pad:] = 0.0
    return w


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{"rtol": RTOL, "atol": ATOL, **kw})


# -- layernorm and the transformer -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 40), (3, 5, 16), (1, 94)])
def test_layernorm_matches_jax(shape):
    r = np.random.default_rng(len(shape))
    x = (3.0 * r.normal(size=shape) + 1.0).astype(np.float32)
    g = r.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = r.normal(size=shape[-1]).astype(np.float32)
    want = jnn.layernorm_apply({"gamma": jnp.asarray(g), "beta": jnp.asarray(b)},
                               jnp.asarray(x))
    got = pnn.layernorm(torch.tensor(x), torch.tensor(g), torch.tensor(b))
    _close(got, want)
    ln = pnn.LayerNorm(shape[-1])
    assert torch.equal(ln.gamma, torch.ones(shape[-1])) and torch.equal(ln.beta, torch.zeros(shape[-1]))
    with torch.no_grad():
        ln.gamma.copy_(torch.tensor(g))
        ln.beta.copy_(torch.tensor(b))
    assert torch.equal(ln(torch.tensor(x)), got)


def _transformers(d_model=40, seed=0, **kw):
    jt = jtr.Transformer(d_model, nhead=4, **kw)
    params = jt.init(jax.random.PRNGKey(seed))
    params, _ = randomize(params, {}, seed)
    pt = Transformer(d_model, nhead=4, generator=make_generator(CPU, seed), **kw)
    load_jax_params(pt, _np(params))
    return jt, params, pt


@pytest.mark.parametrize("n_pad", [0, 6])
@pytest.mark.parametrize("layers", [(2, 2), (1, 3)])
def test_transformer_matches_jax(n_pad, layers):
    """Eval forward over a 29-row sequence, with and without a key mask that
    pads its last rows; the real rows compared."""
    jt, params, pt = _transformers(num_encoder_layers=layers[0], num_decoder_layers=layers[1])
    r = np.random.default_rng(n_pad)
    src = r.normal(size=(29, 40)).astype(np.float32)
    tgt = r.normal(size=(29, 40)).astype(np.float32)
    w = _mask(29, n_pad) if n_pad else None
    want = jt.apply(params, jnp.asarray(src), jnp.asarray(tgt), train=False,
                    w=None if w is None else jnp.asarray(w))
    with torch.no_grad():
        got = pt(torch.tensor(src), torch.tensor(tgt), w=None if w is None else torch.tensor(w))
    keep = slice(0, 29 - n_pad)
    _close(got[keep], np.asarray(want)[keep], rtol=TR_RTOL, atol=TR_ATOL)
    if n_pad:  # the mask matters: the same rows without it differ
        with torch.no_grad():
            unmasked = pt(torch.tensor(src), torch.tensor(tgt))
        assert (unmasked[keep] - got[keep]).abs().max() > 1e-3


def test_transformer_padded_rows_do_not_reach_real_rows():
    """Padded rows (weight 0) change no real row: the real rows of a padded
    sequence against the same rows alone, at the JAX package's padded
    tolerance."""
    _, _, pt = _transformers(seed=3)
    r = np.random.default_rng(5)
    x = torch.tensor(r.normal(size=(20, 40)).astype(np.float32))
    pad = torch.tensor(r.normal(size=(9, 40)).astype(np.float32))
    with torch.no_grad():
        alone = pt(x, x)
        padded = pt(torch.cat([x, pad]), torch.cat([x, pad]), w=torch.tensor(_mask(29, 9)))
    _close(padded[:20], alone, rtol=PAD_RTOL, atol=PAD_ATOL)


def test_transformer_dropout_draws_from_the_generator():
    """Train mode with dropout 0.1: the same generator state gives the same
    output, another gives another; dropout 0 in train mode equals eval."""
    _, _, pt = _transformers(seed=1)
    x = torch.randn(12, 40, generator=make_generator(CPU, 2))
    with torch.no_grad():
        a = pt(x, x, train=True, generator=make_generator(CPU, 7))
        b = pt(x, x, train=True, generator=make_generator(CPU, 7))
        c = pt(x, x, train=True, generator=make_generator(CPU, 8))
        ev = pt(x, x)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ev)
    with pytest.raises(ValueError, match="Generator"):
        pt(x, x, train=True)
    _, _, p0 = _transformers(seed=1, dropout=0.0)
    with torch.no_grad():
        assert torch.equal(p0(x, x, train=True), p0(x, x))


# -- the model ---------------------------------------------------------------------------------

def test_eval_apply_matches_jax():
    jm, params, state, pm = _models()
    xj, xt = _batch(45, seed=3)
    w = _mask(45, 6)
    want, _ = jm.apply(params, state, xj, train=False, rng=None, w=jnp.asarray(w))
    bufs = {k: v.clone() for k, v in pm.named_buffers()}
    with torch.no_grad():
        got = pm.apply(xt, train=False, w=torch.tensor(w))
    _close(got.numpy()[w > 0], np.asarray(want)[w > 0])
    for k, v in pm.named_buffers():  # eval moves no running stat
        assert torch.equal(v, bufs[k]), k


def test_train_apply_and_running_stats_match_jax():
    """A ragged train-mode batch with the transformer's dropout at 0: the
    outputs of the real rows and every BatchNorm's running stats (the
    padded rows masked out of the statistics)."""
    jm, params, state, pm = _models(dropout=0.0)
    xj, xt = _batch(40, seed=4)
    w = _mask(40, 9)
    want, new_state = jm.apply(params, state, xj, train=True, rng=jax.random.PRNGKey(0),
                               w=jnp.asarray(w))
    with torch.no_grad():
        got = pm.apply(xt, train=True, w=torch.tensor(w))
    _close(got.numpy()[w > 0], np.asarray(want)[w > 0])
    stats = {k: v for k, v in jax_state_dict(_np(params), _np(new_state)).items()
             if k.endswith((".mean", ".var"))}
    sd = pm.state_dict()
    assert sorted(stats) == sorted(k for k in sd if k.endswith((".mean", ".var")))
    for k, v in stats.items():
        _close(sd[k].numpy(), v, err_msg=k)


def test_fused_eval_matches_jax_and_apply():
    """A ragged batch of 33 rows, the last 5 padded: the port's fused eval
    (the kernel's plain version on the CPU) against the JAX fused eval
    (Pallas, interpret mode), the JAX op-by-op eval and the port's op-by-op
    eval, on the real rows."""
    jm, params, state, pm = _models()
    xj, xt = _batch(33, seed=6)
    w = _mask(33, 5)
    want_fused = jm.apply_fused_eval(params, state, xj, w=jnp.asarray(w))
    want, _ = jm.apply(params, state, xj, train=False, rng=None, w=jnp.asarray(w))
    before = pk.m2m_fused_infer.launches
    with torch.no_grad():
        got = pm.apply_fused_eval(xt, w=torch.tensor(w))
        plain = pm.apply(xt, train=False, w=torch.tensor(w))
    assert pk.m2m_fused_infer.launches == before  # the plain version on the CPU
    assert got.shape == (33,)
    keep = w > 0
    for other in (want_fused, want, plain):
        _close(got.numpy()[keep], np.asarray(other)[keep])


@pytest.mark.parametrize("fused", [False, True])
def test_padded_matches_unpadded(fused):
    """Weight-0 rows reach no real row (the transformer's key mask, the
    BatchNorm statistics are running ones at eval): the padded batch's real
    rows against the same rows alone; without the mask they differ."""
    _, _, _, pm = _models(seed=2)
    _, xt = _batch(30, seed=7)
    _, pad = _batch(12, seed=8)
    xp = {k: torch.cat([xt[k], pad[k]]) for k in xt}
    w = torch.tensor(_mask(42, 12))
    run = pm.apply_fused_eval if fused else (lambda x, w=None: pm.apply(x, train=False, w=w))
    with torch.no_grad():
        alone = run(xt)
        padded = run(xp, w=w)
        unmasked = run(xp)
    _close(padded[:30], alone, rtol=PAD_RTOL, atol=PAD_ATOL)
    assert np.abs(unmasked[:30].numpy() - alone.numpy()).max() > 1e-3


# -- the kernel's plain version against the JAX kernel --------------------------------------

def _affines(r, lead, dims):
    return [(((i ** -0.5) * r.normal(size=lead + (i, o))).astype(np.float32),
             (0.1 * r.normal(size=lead + (o,))).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("cfg", [
    # (B, F, Fd, nE, E, expert hidden dims, hyper hidden dims, output dims)
    (33, 40, 8, 4, 8, [], [], [64, 32]),    # M2M's shape at narrow widths
    (21, 12, 5, 3, 4, [6], [7], [5]),       # deeper chains, widths not multiples of 4
    (9, 16, 4, 1, 16, [], [], []),          # one expert, no output MLP
    (37, 376, 16, 4, 16, [], [], [64, 32]),  # Ali-CCP's exact widths, a ragged B
])
def test_fused_infer_ref_matches_jax_kernel(cfg):
    B, F, Fd, nE, E_, ex_h, hy_h, out_dims = cfg
    r = np.random.default_rng(B)
    t_out = r.normal(size=(B, F)).astype(np.float32)
    dom = r.normal(size=(B, Fd)).astype(np.float32)
    ex = _affines(r, (nE,), [F] + ex_h + [E_])
    hyper = [_affines(r, (), [i] + hy_h + [o]) for i, o in
             ((Fd, E_), (Fd, E_), (E_, 4 * E_ * E_), (E_, 2 * E_), (E_, E_ * E_), (E_, E_))]
    v = r.normal(size=(2 * E_, 1)).astype(np.float32)
    out = _affines(r, (), [E_] + out_dims)
    head = _affines(r, (), [out_dims[-1] if out_dims else E_, 1])[0]
    j = lambda st: [tuple(jnp.asarray(a) for a in s) for s in st]
    t = lambda st: [tuple(torch.tensor(a) for a in s) for s in st]
    want = jk.m2m_fused_infer(jnp.asarray(t_out), jnp.asarray(dom), j(ex), *map(j, hyper),
                              jnp.asarray(v), j(out), j([head])[0], E=E_, block_rows=16,
                              interpret=True)
    args = (torch.tensor(t_out), torch.tensor(dom), t(ex), *map(t, hyper), torch.tensor(v),
            t(out), t([head])[0])
    got = pk.m2m_fused_infer_ref(*args, E=E_)
    assert got.shape == (B,)
    _close(got, want)
    before = pk.m2m_fused_infer.launches
    np.testing.assert_array_equal(pk.m2m_fused_infer(*args, E=E_).numpy(), got.numpy())
    assert pk.m2m_fused_infer.launches == before


def _plain_args(B, F, Fd, nE, E_, out_dims, seed=0):
    r = np.random.default_rng(seed)
    t = lambda st: [tuple(torch.tensor(a) for a in s) for s in st]
    hyper = [t(_affines(r, (), [i, o])) for i, o in
             ((Fd, E_), (Fd, E_), (E_, 4 * E_ * E_), (E_, 2 * E_), (E_, E_ * E_), (E_, E_))]
    return (torch.tensor(r.normal(size=(B, F)).astype(np.float32)),
            torch.tensor(r.normal(size=(B, Fd)).astype(np.float32)),
            t(_affines(r, (nE,), [F, E_])), *hyper,
            torch.tensor(r.normal(size=(2 * E_, 1)).astype(np.float32)),
            t(_affines(r, (), [E_] + out_dims)), t(_affines(r, (), [out_dims[-1], 1]))[0])


@pytest.mark.parametrize("rows", [16, 32, 48, 64, None])
def test_fused_infer_tile_rule_runs_the_plain_version(rows):
    """Every block_rows of the kernel's tile rule (a multiple of 16 up to 64,
    or None) runs the plain version on the CPU, bit for bit, and launches
    nothing."""
    args = _plain_args(21, 30, 6, 4, 4, [8])
    want = pk.m2m_fused_infer_ref(*args, E=4)
    before = pk.m2m_fused_infer.launches
    got = pk.m2m_fused_infer(*args, E=4, block_rows=rows)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert pk.m2m_fused_infer.launches == before


@pytest.mark.parametrize("rows", [8, 12, 24, 80, 0, 16.0])
def test_fused_infer_tile_rule_is_checked_before_the_cpu_branch(rows):
    """A block_rows off the rule raises on the CPU as it would on the card,
    though the CPU runs no kernel."""
    args = _plain_args(5, 12, 4, 2, 4, [8])
    with pytest.raises(ValueError, match="block_rows"):
        pk.m2m_fused_infer(*args, E=4, block_rows=rows)


def test_fused_infer_checks_shapes():
    r = np.random.default_rng(0)
    t = lambda st: [tuple(torch.tensor(a) for a in s) for s in st]
    ex = t(_affines(r, (4,), [12, 4]))
    hyper = [t(_affines(r, (), [i, o])) for i, o in
             ((5, 4), (5, 4), (4, 64), (4, 8), (4, 16), (4, 4))]
    v, head = torch.ones(8, 1), t(_affines(r, (), [4, 1]))[0]
    x, dom = torch.randn(6, 12), torch.randn(6, 5)
    assert pk.m2m_fused_infer(x, dom, ex, *hyper, v, [], head, E=4).shape == (6,)
    with pytest.raises(ValueError, match="vw"):
        pk.m2m_fused_infer(x, dom, ex, hyper[0], hyper[1], hyper[2][:0] + hyper[3],
                           *hyper[3:], v, [], head, E=4)
    with pytest.raises(ValueError, match="v must be"):
        pk.m2m_fused_infer(x, dom, ex, *hyper, torch.ones(4, 1), [], head, E=4)
    with pytest.raises(ValueError, match="dom_emb"):
        pk.m2m_fused_infer(x, dom[:5], ex, *hyper, v, [], head, E=4)


# -- carrying weights across, the registry and build_model ----------------------------------

def test_load_jax_params_raises_on_missing_or_leftover():
    _, params, state, pm = _models()
    p, s = _np(params), _np(state)
    tr = p["transformer"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, {**p, "transformer": {**tr, "dec": tr["dec"][:1]}}, s)
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, p, {k: v for k, v in s.items() if k != "vw"})
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(pm, {**p, "w": np.ones(3)}, s)


def _ladder_data(m):
    """Widths that make every ladder's M2M input a multiple of its 4 heads."""
    sparse = [m.SparseFeature(f"s{i}", vocab_size=12, embed_dim=8) for i in range(3)]
    return {"dense_feas": [m.DenseFeature(f"d{i}") for i in range(4)], "sparse_feas": sparse,
            "scenario_feas": [m.SparseFeature("domain_indicator", vocab_size=3, embed_dim=8)],
            "domain_num": 3}


@pytest.mark.parametrize("dataset", ["ali_ccp", "movielens", "kuairand"])
def test_build_model_matches_jax_tree(dataset):
    """The port's parameter and buffer names and shapes equal the JAX tree's
    (params and state, shapes by ``jax.eval_shape``)."""
    jm = jconfigs.build_model(dataset, "m2m", _ladder_data(jf))
    pm = pconfigs.build_model(dataset, "m2m", _ladder_data(pf), device="cpu")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: v.shape for k, v in jax_state_dict(*zeros).items()}
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want
    assert type(pm).__name__ == type(jm).__name__


def test_build_model_ali_ccp_widths():
    """At Ali-CCP width (the scenario loader's 22 sparse features and the
    domain feature, 16 wide, and 8 dense): d_model 376 in 4 heads of 94."""
    sparse = [pf.SparseFeature(f"s{i}", vocab_size=5, embed_dim=16) for i in range(22)]
    data = {"dense_feas": [pf.DenseFeature(f"d{i}") for i in range(8)], "sparse_feas": sparse,
            "scenario_feas": [pf.SparseFeature("domain_indicator", vocab_size=3, embed_dim=16)],
            "domain_num": 3}
    m = pconfigs.build_model("ali_ccp", "m2m", data, device="cpu")
    assert isinstance(m, pmodels.M2M) and m.input_dim == 376 and m.E == 16
    tr = m.transformer
    assert tr.nhead == 4 and tr.d_model // tr.nhead == 94 and (len(tr.enc), len(tr.dec)) == (2, 2)
    assert tuple(tr.enc[0].attn.in_w.shape) == (3 * 376, 376) and tr.d_ff == 16
    assert tuple(m.experts.layers[0].lin.w.shape) == (4, 376, 16)
    assert tuple(m.vw.layers[0].lin.w.shape) == (16, 1024)
    assert [tuple(l.lin.w.shape) for l in m.out.layers] == [(16, 64), (64, 32)]


def test_registry_resolves_every_jax_name():
    """Every name of the JAX registry resolves to the port's class of the
    same name, in any casing; an unknown name raises KeyError."""
    for name in jmodels.MODEL_REGISTRY:
        for n in (name, name.upper(), name.capitalize()):
            assert pmodels.get_model(n).__name__ == jmodels.get_model(n).__name__, n
    assert set(pmodels.MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)
    assert pmodels.get_model("M2M") is pmodels.M2M and pmodels.get_model("m3oe") is pmodels.M3oE
    with pytest.raises(KeyError):
        pmodels.get_model("no_such_model")
