"""Port HamurLarge, HamurSmall and MlpNLayer, ``domain_norm`` and the
D-fold BatchNorm update, the plain versions of the HAMUR segment kernel,
the weight carry-over, the registry and ``build_model`` against the JAX
package (its Pallas kernels in interpret mode), weights carried across.
Inputs are made with numpy from a seed and fed to both. The train steps are
in ``test_torch_port_train_hamur.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu import configs as jconfigs  # noqa: E402
from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops import nn as jnn  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas import hamur_infer as jhamur  # noqa: E402
from scenario_wise_rec_tpu_torch import configs as pconfigs  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import jax_state_dict, load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.ops import nn as pnn  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import hamur_infer as pk  # noqa: E402

# The JAX package's own HAMUR tolerance (tests/test_pallas_kernels.py): the
# adapter norms divide by the batch's rstd twice in a row, which amplifies
# the rounding of sums taken in another order.
RTOL, ATOL = 1e-4, 1e-5
# One segment alone, with no norm between: the fused-kernel tolerance of the
# other models.
SEG_RTOL, SEG_ATOL = 1e-5, 1e-6
# A padded batch against the unpadded one: the JAX package's own
# (tests/test_masked_batch_stats.py), for the same amplification.
PAD_RTOL, PAD_ATOL = 1e-3, 5e-4
V, D = 40, 3
CPU = torch.device("cpu")
VARIANTS = {"small": "HamurSmall", "large": "HamurLarge", "mlpn": "MlpNLayer"}


def _kwargs(variant, m):
    feats = ([m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8) for i in range(4)]
             + [m.DenseFeature("d0")])
    if variant == "small":
        return dict(features=feats, domain_num=D, fcn_dims=[16, 8], hyper_dims=[8], k=4)
    if variant == "large":
        return dict(features=feats, domain_num=D, fcn_dims=[32, 32, 16, 16, 16, 16, 8],
                    hyper_dims=[8], k=4)
    return dict(features=feats, domain_num=D, fcn_dims=[16, 8])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _path(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


def randomize(params, state, seed):
    """Embedding tables from N(0, 0.5), the adapters' u/v from 0.1 N(0, 1)
    (the JAX package's tests do the same: at their all-ones init the
    adapter's sigmoid saturates and the norm divides near-zero variances),
    their biases, gammas and betas and every BatchNorm's running stats
    random too."""
    r = np.random.default_rng(seed)

    def leaf(p, a):
        path, name = _path(p), _path(p[-1:])
        if path.startswith("embedding"):
            v = r.normal(0, 0.5, a.shape)
        elif path.startswith("adapters") and name[0] in "uv":
            v = 0.1 * r.normal(size=a.shape)
        elif path.startswith("adapters"):
            v = (r.uniform(0.5, 1.5, a.shape) if name == "gamma"
                 else 0.1 * r.normal(size=a.shape))
        else:
            return a
        return jnp.asarray(v.astype(np.float32))

    params = jax.tree_util.tree_map_with_path(leaf, params)
    state = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray((r.normal(0, 0.2, a.shape) if _path(p[-1:]) == "mean"
                                  else r.uniform(0.5, 1.5, a.shape)).astype(np.float32)),
        state)
    return params, state


def _models(variant, seed=0):
    """The JAX model (random adapters and running stats) and the port model
    holding the same weights."""
    jm = getattr(jmodels, VARIANTS[variant])(**_kwargs(variant, jf))
    params, state = randomize(*jax.jit(jm.init)(jax.random.PRNGKey(seed)), seed + 100)
    pm = getattr(pmodels, VARIANTS[variant])(**_kwargs(variant, pf), device="cpu",
                                             generator=make_generator(CPU, seed))
    load_jax_params(pm, _np(params), _np(state))
    return jm, params, state, pm


def _batch(b, seed=0, oob_domains=False):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b) for i in range(4)}
    x["d0"] = r.normal(size=b).astype(np.float32)
    x["domain_indicator"] = r.integers(-2, D + 3, b) if oob_domains else r.integers(0, D, b)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def _mask(b, n_pad):
    w = np.ones(b, np.float32)
    w[b - n_pad:] = 0.0
    return w


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{"rtol": RTOL, "atol": ATOL, **kw})


# -- domain_norm and the D-fold BatchNorm update -----------------------------------------

@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_domain_norm_matches_jax(unbiased, masked):
    r = np.random.default_rng(1)
    x = r.normal(size=(23, 6)).astype(np.float32)
    g, b = r.uniform(0.5, 1.5, 6).astype(np.float32), r.normal(size=6).astype(np.float32)
    w = _mask(23, 5) if masked else None
    want = jnn.domain_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), eps=1e-5,
                           unbiased=unbiased, w=None if w is None else jnp.asarray(w))
    got = pnn.domain_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b), eps=1e-5,
                          unbiased=unbiased, w=None if w is None else torch.tensor(w))
    _close(got, want, rtol=SEG_RTOL, atol=SEG_ATOL)
    # stacked [D, B, F]: each member normalised over its own rows
    xs = np.stack([x, 2 * x + 1])
    got = pnn.domain_norm(torch.tensor(xs), torch.tensor(g), torch.tensor(b), eps=1e-5,
                          unbiased=unbiased, w=None if w is None else torch.tensor(w))
    _close(got[0], want, rtol=SEG_RTOL, atol=SEG_ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_batchnorm_momentum_takes_n_updates_in_one(n):
    """One update of momentum ``1 - 0.9^n`` equals ``n`` sequential updates
    of momentum 0.1 on the same batch (HAMUR's shared hyper-network)."""
    r = np.random.default_rng(n)
    x = torch.tensor(r.normal(1.0, 2.0, (30, 7)).astype(np.float32))
    w = torch.tensor(_mask(30, 4))
    one = pnn.BatchNorm(7)
    seq = pnn.BatchNorm(7)
    with torch.no_grad():
        for bn in (one, seq):
            bn.mean.copy_(torch.tensor(r.normal(size=7).astype(np.float32)) if bn is one
                          else one.mean)
            bn.var.copy_(torch.full((7,), 0.7))
        y_one = one(x, train=True, w=w, momentum=1 - 0.9 ** n)
        for _ in range(n):
            y_seq = seq(x, train=True, w=w)
    np.testing.assert_array_equal(y_one.numpy(), y_seq.numpy())
    np.testing.assert_allclose(one.mean.numpy(), seq.mean.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(one.var.numpy(), seq.var.numpy(), rtol=1e-6, atol=1e-7)


# -- the models ----------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_apply_matches_jax(variant):
    jm, params, state, pm = _models(variant)
    xj, xt = _batch(45, seed=3, oob_domains=True)
    w = _mask(45, 6)
    want, _ = jm.apply(params, state, xj, train=False, rng=None, w=jnp.asarray(w))
    bufs = {k: v.clone() for k, v in pm.named_buffers()}
    with torch.no_grad():
        got = pm.apply(xt, train=False, w=torch.tensor(w))
    _close(got.numpy()[w > 0], np.asarray(want)[w > 0])
    for k, v in pm.named_buffers():  # eval moves no running stat
        assert torch.equal(v, bufs[k]), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_apply_and_running_stats_match_jax(variant):
    """A ragged train-mode batch: the outputs of the real rows, every block
    BatchNorm's running stats and the hyper-network's D-fold update (MlpN's
    hyper-network does not run and keeps its stats)."""
    jm, params, state, pm = _models(variant)
    xj, xt = _batch(40, seed=4)
    w = _mask(40, 9)
    want, new_state = jm.apply(params, state, xj, train=True, rng=jax.random.PRNGKey(0),
                               w=jnp.asarray(w))
    with torch.no_grad():
        got = pm.apply(xt, train=True, w=torch.tensor(w))
    _close(got.numpy()[w > 0], np.asarray(want)[w > 0])
    stats = jax_state_dict(_np(params), _np(new_state), pm.jax_state_map)
    stats = {k: v for k, v in stats.items() if k.endswith((".mean", ".var"))}
    sd = pm.state_dict()
    assert sorted(stats) == sorted(k for k in sd if k.endswith((".mean", ".var")))
    for k, v in stats.items():
        _close(sd[k].numpy(), v, rtol=SEG_RTOL, atol=SEG_ATOL, err_msg=k)
    moved = [k for k in stats if k.startswith("hyper")
             and not np.array_equal(stats[k], np.asarray(jax_state_dict(
                 _np(params), _np(state), pm.jax_state_map)[k]))]
    assert bool(moved) == (variant != "mlpn")


@pytest.mark.parametrize("variant", ["small", "large"])
def test_fused_eval_matches_jax(variant):
    """A ragged batch of 37 rows, the last 5 padded and out-of-range domain
    ids: the port's fused eval (the segments' plain versions on the CPU)
    against the JAX fused eval (Pallas, interpret mode), the JAX op-by-op
    eval and the port's op-by-op eval, on the real rows."""
    jm, params, state, pm = _models(variant)
    xj, xt = _batch(37, seed=6, oob_domains=True)
    w = _mask(37, 5)
    want_fused = jm.apply_fused_eval(params, state, xj, w=jnp.asarray(w))
    want, _ = jm.apply(params, state, xj, train=False, rng=None, w=jnp.asarray(w))
    with torch.no_grad():
        got = pm.apply_fused_eval(xt, w=torch.tensor(w))
        plain = pm.apply(xt, train=False, w=torch.tensor(w))
    assert got.shape == (37,)
    keep = w > 0
    for other in (want_fused, want, plain):
        _close(got.numpy()[keep], np.asarray(other)[keep])


@pytest.mark.parametrize("variant", ["small", "large"])
def test_padded_fused_eval_matches_unpadded(variant):
    """Weight-0 rows do not move the adapter norms' statistics: the padded
    batch's real rows against the same rows alone."""
    _, _, _, pm = _models(variant)
    _, xt = _batch(30, seed=7)
    _, pad = _batch(12, seed=8)
    xp = {k: torch.cat([xt[k], pad[k]]) for k in xt}
    w = torch.tensor(_mask(42, 12))
    with torch.no_grad():
        alone = pm.apply_fused_eval(xt)
        padded = pm.apply_fused_eval(xp, w=w)
        unmasked = pm.apply_fused_eval(xp)
    _close(padded[:30], alone, rtol=PAD_RTOL, atol=PAD_ATOL)
    assert np.abs(unmasked[:30].numpy() - alone.numpy()).max() > 1e-3


def test_mlpn_has_no_fused_eval_and_no_embedding_attribute():
    """MlpN keeps the JAX tree's keys (its embedding collection included)
    while the trainer sees no ``embedding`` and no ``apply_fused_eval``."""
    _, params, state, pm = _models("mlpn")
    assert pm.embedding is None and not hasattr(pm, "apply_fused_eval")
    assert "embedding.packed" in pm.state_dict()
    assert any(n == "embedding.packed" for n, _ in pm.named_parameters())
    assert not hasattr(pmodels.MlpNLayer, "fold_eval")
    assert isinstance(pmodels.HamurSmall(**_kwargs("small", pf), device="cpu").embedding,
                      torch.nn.Module)


# -- the kernel's plain versions against the JAX kernel -------------------------------------

def _affines(r, lead, dims):
    return [(((i ** -0.5) * r.normal(size=lead + (i, o))).astype(np.float32),
             (0.1 * r.normal(size=lead + (o,))).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def _adapter(r, w, k, mid):
    a = {"u_down": (w, k), "v_down": (k, mid), "b_down": (mid,), "u_up": (mid, k),
         "v_up": (k, w), "b_up": (w,)}
    a = {n: (0.3 * r.normal(size=s)).astype(np.float32) for n, s in a.items()}
    a["gamma"] = r.uniform(0.5, 1.5, w).astype(np.float32)
    a["beta"] = (0.1 * r.normal(size=w)).astype(np.float32)
    return a


def _j(stages):
    return [tuple(jnp.asarray(a) for a in s) for s in stages]


def _t(stages):
    return [tuple(torch.tensor(a) for a in s) for s in stages]


@pytest.mark.parametrize("cfg", [
    # (B, F, D, first's block dims, middle's block dims, k, mid, block_rows)
    (37, 20, 3, [12, 8], [5], 5, 6, 16),
    (16, 9, 2, [6], [], 3, 4, 8),        # a middle without blocks: the adapter on its input
    (21, 14, 4, [7], [5, 3], 6, 5, 8),
])
def test_segment_refs_match_jax_segments(cfg):
    """Each form of the segment alone, from the same inputs: first, middle
    (the previous norm's affine and the residual) and final; the JAX
    kernel's flat ``[B, D·F]`` layout against the port's ``[B, D, F]``."""
    B, F, Dn, dims, dims2, k, mid, rows = cfg
    r = np.random.default_rng(B)
    emb = r.normal(size=(B, F)).astype(np.float32)
    hyper = (0.4 * r.normal(size=(B, k, k))).astype(np.float32)
    did = r.integers(-2, Dn + 3, B)
    run_j = lambda x, st, hy, a, dn, tp, fin, first: jhamur._segment(
        jnp.asarray(x), _j(st), None if hy is None else jnp.asarray(hy),
        None if a is None else {n: jnp.asarray(v) for n, v in a.items()},
        None if dn is None else tuple(jnp.asarray(v) for v in dn),
        None if tp is None else jnp.asarray(tp), None if fin is None else _j([fin])[0],
        None if fin is None else jnp.asarray(did), rows, True, first)

    st1 = _affines(r, (Dn,), [F] + dims)
    w1 = dims[-1]
    a1 = _adapter(r, w1, k, mid)
    jt, jh = run_j(emb, st1, hyper, a1, None, None, None, True)
    pt, ph = pk.hamur_segment_ref(torch.tensor(emb), _t(st1), hyper=torch.tensor(hyper),
                                  adapter={n: torch.tensor(v) for n, v in a1.items()})
    assert pt.shape == ph.shape == (B, Dn, w1)
    _close(pt.reshape(B, -1), jt, rtol=SEG_RTOL, atol=SEG_ATOL)
    _close(ph.reshape(B, -1), jh, rtol=SEG_RTOL, atol=SEG_ATOL)

    # the port's norm affine (t - mean) * scale + shift; the JAX kernel's
    # t * scale + (shift - mean * scale)
    mean = (0.2 * r.normal(size=(Dn, w1))).astype(np.float32)
    scale = r.uniform(0.5, 1.5, (Dn, w1)).astype(np.float32)
    shift = (0.1 * r.normal(size=(Dn, w1))).astype(np.float32)
    dn_j = (scale, shift - mean * scale)
    dn_t = tuple(torch.tensor(a) for a in (mean, scale, shift))
    st2 = _affines(r, (Dn,), [w1] + dims2)
    a2 = _adapter(r, dims2[-1] if dims2 else w1, k, mid)
    jt2, jh2 = run_j(np.asarray(jh), st2, hyper, a2, dn_j, np.asarray(jt), None, False)
    pt2, ph2 = pk.hamur_segment_ref(ph, _t(st2), hyper=torch.tensor(hyper),
                                    adapter={n: torch.tensor(v) for n, v in a2.items()},
                                    dn_affine=dn_t, t_pre=pt)
    _close(pt2.reshape(B, -1), jt2, rtol=SEG_RTOL, atol=SEG_ATOL)
    _close(ph2.reshape(B, -1), jh2, rtol=SEG_RTOL, atol=SEG_ATOL)

    for blocks in ([], [4]):  # the final form with and without blocks
        st3 = _affines(r, (Dn,), [w1] + blocks)
        fin = _affines(r, (Dn,), [blocks[-1] if blocks else w1, 1])[0]
        want = run_j(np.asarray(jh), st3, None, None, dn_j, np.asarray(jt), fin, False)
        got = pk.hamur_segment_ref(ph, _t(st3), dn_affine=dn_t, t_pre=pt, final=_t([fin])[0],
                                   domain_id=torch.tensor(did))
        assert got.shape == (B,)
        _close(got, want, rtol=SEG_RTOL, atol=SEG_ATOL)


@pytest.mark.parametrize("cfg", [
    # (B, F, D, segments' block dims, k, padded rows, block_rows)
    (45, 24, 3, [[16, 12], [8], []], 4, 7, 16),   # HamurLarge's three forms
    (33, 20, 2, [[16, 8], []], 5, 0, 8),           # HamurSmall's two
    (18, 12, 3, [[6], [], [4]], 3, 3, 8),          # a middle segment without blocks
])
def test_fused_infer_ref_matches_jax_kernel(cfg):
    """The whole chain (hyper-network, segments, masked norm statistics
    between them) against the JAX ``hamur_fused_infer`` in interpret mode."""
    B, F, Dn, seg_dims, k, n_pad, rows = cfg
    r = np.random.default_rng(B + 1)
    emb = r.normal(size=(B, F)).astype(np.float32)
    did = r.integers(-2, Dn + 3, B)
    hyper = _affines(r, (), [F, 8, k * k])
    segments, adapters, width = [], [], F
    for j, dims in enumerate(seg_dims):
        segments.append(_affines(r, (Dn,), [width] + dims))
        width = dims[-1] if dims else width
        if j < len(seg_dims) - 1:
            adapters.append(_adapter(r, width, k, 6))
    final = _affines(r, (Dn,), [width, 1])[0]
    w = _mask(B, n_pad)
    want = jhamur.hamur_fused_infer(
        jnp.asarray(emb), jnp.asarray(did), _j(hyper), k, [_j(s) for s in segments],
        [{n: jnp.asarray(v) for n, v in a.items()} for a in adapters], _j([final])[0],
        block_rows=rows, interpret=True, w=jnp.asarray(w))
    before = pk.hamur_segment.launches
    args = (torch.tensor(emb), torch.tensor(did), _t(hyper), k, [_t(s) for s in segments],
            [{n: torch.tensor(v) for n, v in a.items()} for a in adapters], _t([final])[0])
    got = pk.hamur_fused_infer(*args, w=torch.tensor(w))
    assert pk.hamur_segment.launches == before  # plain on the CPU
    assert got.shape == (B,)
    _close(got.numpy()[w > 0], np.asarray(want)[w > 0])
    _close(pk.hamur_fused_infer_ref(*args, w=torch.tensor(w)), got, rtol=0, atol=0)


def test_segment_wrapper_checks_shapes():
    r = np.random.default_rng(0)
    emb, hy = torch.randn(4, 6), torch.randn(4, 3, 3)
    st = _t(_affines(r, (2,), [6, 5]))
    a = {n: torch.tensor(v) for n, v in _adapter(r, 5, 3, 4).items()}
    t, h = pk.hamur_segment(emb, st, hyper=hy, adapter=a)
    assert t.shape == h.shape == (4, 2, 5)
    with pytest.raises(ValueError, match="hyper"):
        pk.hamur_segment(emb, st, hyper=hy[:, :2], adapter=a)
    with pytest.raises(ValueError, match="u_down"):
        pk.hamur_segment(emb, st, hyper=hy, adapter={**a, "u_down": torch.randn(4, 3)})
    with pytest.raises(ValueError, match="not both"):
        pk.hamur_segment(emb, st, hyper=hy, adapter=a,
                         final=_t(_affines(r, (2,), [5, 1]))[0])
    with pytest.raises(ValueError, match="t_pre"):
        pk.hamur_segment(h, [], hyper=hy, adapter=a)
    with pytest.raises(ValueError, match="domain_id"):
        pk.hamur_segment(emb, st, final=_t(_affines(r, (2,), [5, 1]))[0])
    with pytest.raises(ValueError, match="segments"):
        pk.hamur_fused_infer(emb, torch.zeros(4), [], 3, [st], [a],
                             _t(_affines(r, (2,), [5, 1]))[0])


def _segment_args(r):
    emb, hy = torch.randn(5, 6), torch.randn(5, 3, 3)
    st = _t(_affines(r, (2,), [6, 5]))
    return emb, st, dict(hyper=hy, adapter={n: torch.tensor(v) for n, v in
                                             _adapter(r, 5, 3, 4).items()})


@pytest.mark.parametrize("block_rows", [0, 8, 12, 24, 80, 16.0])
def test_segment_wrapper_rejects_block_rows_off_the_tile_rule(block_rows):
    """The kernel's tile rule (a multiple of 16 up to 64, or None) holds on
    the CPU too, where the plain version runs."""
    emb, st, kw = _segment_args(np.random.default_rng(0))
    with pytest.raises(ValueError, match="block_rows"):
        pk.hamur_segment(emb, st, block_rows=block_rows, **kw)


@pytest.mark.parametrize("block_rows", [16, 32, 48, 64, None])
def test_segment_wrapper_takes_every_tile_of_the_rule(block_rows):
    emb, st, kw = _segment_args(np.random.default_rng(1))
    for got, want in zip(pk.hamur_segment(emb, st, block_rows=block_rows, **kw),
                         pk.hamur_segment_ref(emb, st, **kw)):
        assert torch.equal(got, want)


# -- carrying weights across, the registry and build_model ----------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_load_jax_params_raises_on_missing_or_leftover(variant):
    _, params, state, pm = _models(variant)
    p, s = _np(params), _np(state)
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, p, {**s, "hyper": s["hyper"][:-1]})
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, {k: v for k, v in p.items() if k != "final"}, s)
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(pm, {**p, "adapters": p["adapters"] + [{"gamma": np.ones(3)}]}, s)


def _ladder_data(m):
    sparse = [m.SparseFeature(f"s{i}", vocab_size=12, embed_dim=8) for i in range(3)]
    return {"dense_feas": [m.DenseFeature("d0")], "sparse_feas": sparse,
            "scenario_feas": [m.SparseFeature("domain_indicator", vocab_size=3, embed_dim=8)],
            "domain_num": 3}


@pytest.mark.parametrize("dataset", ["ali_ccp", "movielens", "kuairand", "amazon", "douban",
                                     "mind"])
@pytest.mark.parametrize("model", ["hamur", "adaptdhm"])
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


def test_mlpn_matches_jax_tree():
    jm = jmodels.MlpNLayer(**_kwargs("mlpn", jf))
    pm = pmodels.MlpNLayer(**_kwargs("mlpn", pf), device="cpu")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: v.shape for k, v in jax_state_dict(*zeros, pm.jax_state_map).items()}
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want


def test_registry_aliases_and_ladders():
    for name, cls in (("hamur", pmodels.HamurLarge), ("HamurLarge", pmodels.HamurLarge),
                      ("Hamur_Small", pmodels.HamurSmall), ("hamursmall", pmodels.HamurSmall),
                      ("MlpN", pmodels.MlpNLayer), ("AdaptDHM", pmodels.AdaptDHM)):
        assert pmodels.get_model(name) is cls
        assert jmodels.get_model(name).__name__ == cls.__name__
    assert set(pmodels.MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)
    for name in jmodels.MODEL_REGISTRY:
        assert pmodels.get_model(name).__name__ == jmodels.get_model(name).__name__, name
    with pytest.raises(KeyError):
        pmodels.get_model("hamur_medium")
    m = pconfigs.build_model("ali_ccp", "hamur", _ladder_data(pf), device="cpu")
    assert isinstance(m, pmodels.HamurLarge) and m.k == 65 and m.adapter_after == (6, 7)
    assert m.fcn_dim[1:] == [256, 128, 64, 64, 32, 16, 8] and m.hyper_dims == [64, 65 * 65]
    m = pconfigs.build_model("movielens", "hamur", _ladder_data(pf), device="cpu")
    assert isinstance(m, pmodels.HamurSmall) and m.k == 35 and m.fcn_dim[1:] == [256, 128]
    m = pconfigs.build_model("ali_ccp", "adaptdhm", _ladder_data(pf), device="cpu")
    assert m.cluster_num == 3 and m.fcn_dims[1:] == [256, 128, 64, 32, 16, 8, 1]
