"""The plain versions of the SAR-Net, EPNet, PPNet and AdaSparse fused
kernels (``ops/kernels/{sarnet,gated}_infer.py``, what the CPU runs)
against the JAX package's Pallas kernels in interpret mode, and the
wrappers' shape checks. Inputs are made with numpy from a seed and fed to
both."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.ops.pallas import gated_infer as jgated  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.sarnet_infer import sarnet_fused_infer as j_sarnet  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import gated_infer as pk_gated  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import sarnet_infer as pk_sarnet  # noqa: E402

# the JAX package's own fused-kernel tolerance: sums in another order
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{"rtol": RTOL, "atol": ATOL, **kw})


def _affines(r, lead, dims):
    """Stages (W [*lead, in, out], b [*lead, out]) scaled like a Linear's
    init, between the widths ``dims``."""
    return [(((i ** -0.5) * r.normal(size=lead + (i, o))).astype(np.float32),
             (0.1 * r.normal(size=lead + (o,))).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def _j(stages):
    return [tuple(jnp.asarray(a) for a in s) for s in stages]


def _t(stages):
    return [tuple(torch.tensor(a) for a in s) for s in stages]


def _sarnet_ids(r, B, D, ids):
    """``[B]`` domain ids: ``None`` uniform over -2 .. D + 3 (out-of-range ids
    are clipped); ``"skewed"`` all in domain 0 but 3 in domain D - 1, none in
    the domains between; ``"wide"`` int64 ids far outside [0, D), ± 2^32
    offsets among them, each taken modulo 2^32 as int32, then clipped."""
    if ids is None:
        return r.integers(-2, D + 4, B)
    if ids == "skewed":
        did = np.zeros(B, np.int64)
        did[r.choice(B, 3, replace=False)] = D - 1
        return did
    wide = np.array([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, -2**31 - 7, 2**40,
                     -3], np.int64)
    return np.where(r.random(B) < 0.5, wide[r.integers(0, len(wide), B)],
                    r.integers(0, D, B)).astype(np.int64)


def _sarnet_weights(r, F, Dn, n_sh, n_sp, H, final):
    """(dom_w, dom_b, shared, specific, gate, final stages, head) as numpy."""
    return (r.uniform(-1, 1, (Dn, F)).astype(np.float32),
            r.uniform(0, 1, (Dn, F)).astype(np.float32),
            _affines(r, (n_sh,), [F, H])[0], _affines(r, (Dn, n_sp), [F, H])[0],
            _affines(r, (), [F, n_sh + n_sp])[0], _affines(r, (), [H] + final),
            _affines(r, (), [final[-1] if final else H, 1])[0])


def _sarnet_torch(w):
    return (torch.tensor(w[0]), torch.tensor(w[1]), *_t(w[2:5]), _t(w[5]), _t([w[6]])[0])


@pytest.mark.parametrize("cfg", [
    # (B, F, D, n_sh, n_sp, expert width, final dims, block_rows, ids)
    (37, 42, 3, 4, 2, 16, [32, 32], 16, None),   # ragged: 37 = 2 * 16 + 5
    (20, 30, 2, 2, 1, 6, [5], 8, None),
    (16, 12, 4, 3, 3, 10, [], 8, None),          # head straight on the mixture
    (64, 40, 3, 8, 2, 16, [32, 32], 16, "skewed"),  # domain 0 nearly all, domain 1 none
    (50, 40, 3, 4, 2, 16, [32, 32], 16, "wide"),    # int64 ids, ± 2^32 offsets
    (45, 36, 5, 3, 2, 8, [16, 8], 16, None),     # 5 domains
    (24, 796, 5, 8, 2, 16, [32, 32], 16, None),  # KuaiRand's widths: 796 sparse columns
])
def test_sarnet_ref_matches_jax_kernel(cfg):
    B, F, Dn, n_sh, n_sp, H, final, block_rows, ids = cfg
    r = np.random.default_rng(B)
    emb = r.normal(size=(B, F)).astype(np.float32)
    w = _sarnet_weights(r, F, Dn, n_sh, n_sp, H, final)
    did = _sarnet_ids(r, B, Dn, ids)
    want = j_sarnet(jnp.asarray(emb), jnp.asarray(did), jnp.asarray(w[0]), jnp.asarray(w[1]),
                    *_j(w[2:5]), _j(w[5]), _j([w[6]])[0], block_rows=block_rows,
                    interpret=True)
    before = pk_sarnet.sarnet_fused_infer.launches
    got = pk_sarnet.sarnet_fused_infer(torch.tensor(emb), torch.tensor(did), *_sarnet_torch(w))
    assert pk_sarnet.sarnet_fused_infer.launches == before  # plain on the CPU
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("rows,ok", [(None, True), (16, True), (32, True), (48, True),
                                     (64, True), (8, False), (24, False), (72, False)])
def test_sarnet_wrapper_keeps_the_tile_rule_on_the_cpu(rows, ok):
    """``block_rows`` is checked before the CPU branch, as on the card: a
    multiple of 16 up to 64, or None. An accepted value runs the plain
    version unchanged, the launch counter unmoved."""
    r = np.random.default_rng(7)
    args = (torch.tensor(r.normal(size=(9, 20)).astype(np.float32)),
            torch.tensor(r.integers(0, 3, 9)),
            *_sarnet_torch(_sarnet_weights(r, 20, 3, 2, 1, 8, [4])))
    before = pk_sarnet.sarnet_fused_infer.launches
    if not ok:
        with pytest.raises(ValueError, match="block_rows"):
            pk_sarnet.sarnet_fused_infer(*args, block_rows=rows)
        return
    got = pk_sarnet.sarnet_fused_infer(*args, block_rows=rows)
    assert pk_sarnet.sarnet_fused_infer.launches == before  # plain on the CPU
    assert torch.equal(got, pk_sarnet.sarnet_fused_infer_ref(*args))


@pytest.mark.parametrize("cfg", [
    # (B, S, A, gate hidden, block_rows[, a row with a NaN])
    (37, 8, 30, 30, 16), (20, 5, 11, 7, 8), (9, 16, 4, 20, 8),
    (41, 7, 24, 40, 16),       # H != A, S odd
    (33, 16, 13, 13, 16, 17),  # A off 8; a NaN in row 17 stays there
])
def test_epnet_ref_matches_jax_kernel(cfg):
    B, S, A, H, block_rows, *nan_row = cfg
    r = np.random.default_rng(B + 1)
    sce = r.normal(size=(B, S)).astype(np.float32)
    agn = r.normal(size=(B, A)).astype(np.float32)
    for row in nan_row:
        agn[row, A // 2] = np.nan
    l1, l2 = _affines(r, (), [S + A, H]), _affines(r, (), [H, A])
    head = _affines(r, (), [A, 1])[0]
    want = jgated.epnet_fused_infer(jnp.asarray(sce), jnp.asarray(agn), *_j(l1 + l2),
                                    _j([head])[0], gemma=1.5, block_rows=block_rows,
                                    interpret=True)
    got = pk_gated.epnet_fused_infer(torch.tensor(sce), torch.tensor(agn), *_t(l1 + l2),
                                     _t([head])[0], gemma=1.5)
    assert got.shape == (B,)
    _close(got, want)
    assert np.isnan(got.numpy()).nonzero()[0].tolist() == nan_row  # no row but its own


@pytest.mark.parametrize("rows,ok", [(None, True), (16, True), (32, True), (48, True),
                                     (64, True), (8, False), (40, False), (80, False)])
def test_epnet_wrapper_keeps_the_tile_rule_on_the_cpu(rows, ok):
    """``block_rows`` is checked before the CPU branch, as on the card: a
    multiple of 16 up to 64, or None. An accepted value runs the plain
    version unchanged."""
    r = np.random.default_rng(6)
    args = (torch.tensor(r.normal(size=(9, 5)).astype(np.float32)),
            torch.tensor(r.normal(size=(9, 11)).astype(np.float32)),
            *_t(_affines(r, (), [16, 7]) + _affines(r, (), [7, 11]) + _affines(r, (), [11, 1])))
    if not ok:
        with pytest.raises(ValueError, match="block_rows"):
            pk_gated.epnet_fused_infer(*args, block_rows=rows)
        return
    before = pk_gated.epnet_fused_infer.launches
    got = pk_gated.epnet_fused_infer(*args, block_rows=rows)
    assert pk_gated.epnet_fused_infer.launches == before  # plain on the CPU
    assert torch.equal(got, pk_gated.epnet_fused_infer_ref(*args))


@pytest.mark.parametrize("cfg", [
    # (B, G, D, layer dims, gate hidden dims (None: the layer's), block_rows)
    (37, 24, 3, [16, 12, 8], None, 16),
    (21, 10, 2, [6], [9], 8),
    (16, 14, 4, [], None, 8),             # no layer: the final stage on g
])
def test_ppnet_ref_matches_jax_kernel(cfg):
    B, G, Dn, dims, hidden, block_rows = cfg
    r = np.random.default_rng(B + 2)
    g = r.normal(size=(B, G)).astype(np.float32)
    lay = _affines(r, (Dn,), [G] + dims)
    hidden = hidden or dims
    g1 = [_affines(r, (Dn,), [G, h])[0] for h in hidden]
    g2 = [_affines(r, (Dn,), [h, o])[0] for h, o in zip(hidden, dims)]
    final = _affines(r, (Dn,), [dims[-1] if dims else G, 1])[0]
    did = r.integers(-2, Dn + 4, B)
    want = jgated.ppnet_fused_infer(jnp.asarray(g), jnp.asarray(did), _j(lay), _j(g1),
                                    _j(g2), _j([final])[0], gemma=2.0,
                                    block_rows=block_rows, interpret=True)
    got = pk_gated.ppnet_fused_infer(torch.tensor(g), torch.tensor(did), _t(lay), _t(g1),
                                     _t(g2), _t([final])[0], gemma=2.0)
    assert got.shape == (B,)
    _close(got, want)


def _ppnet_inputs(r, B, G, Dn, dims):
    g = r.normal(size=(B, G)).astype(np.float32)
    lay = _affines(r, (Dn,), [G] + dims)
    g1 = [_affines(r, (Dn,), [G, h])[0] for h in dims]
    g2 = [_affines(r, (Dn,), [h, h])[0] for h in dims]
    final = _affines(r, (Dn,), [dims[-1] if dims else G, 1])[0]
    return g, lay, g1, g2, final


@pytest.mark.parametrize("counts", [
    # rows of each domain, shuffled; the JAX kernel's tiles are 16 rows
    (0, 50, 0),       # every row in one domain
    (20, 0, 30),      # one domain absent
    (33, 32, 1),      # counts astride the 16-row tiles
    (37,),            # one domain
])
def test_ppnet_ref_matches_jax_kernel_on_skewed_domains(counts):
    """The plain version against the JAX kernel where the card kernel's
    partition by domain is tested hardest: each domain's rows fill whole
    tiles, one more, one fewer, or none."""
    r = np.random.default_rng(sum(counts) + len(counts))
    Dn = len(counts)
    did = r.permutation(np.repeat(np.arange(Dn), counts))
    g, lay, g1, g2, final = _ppnet_inputs(r, len(did), 20, Dn, [12, 8])
    want = jgated.ppnet_fused_infer(jnp.asarray(g), jnp.asarray(did), _j(lay), _j(g1),
                                    _j(g2), _j([final])[0], gemma=2.0, block_rows=16,
                                    interpret=True)
    got = pk_gated.ppnet_fused_infer(torch.tensor(g), torch.tensor(did), _t(lay), _t(g1),
                                     _t(g2), _t([final])[0], gemma=2.0)
    assert got.shape == (len(did),)
    _close(got, want)


@pytest.mark.parametrize("rows,ok", [(None, True), (16, True), (32, True), (48, True),
                                     (64, True), (8, False), (24, False), (80, False),
                                     (0, False)])
def test_ppnet_wrapper_keeps_the_tile_rule_on_the_cpu(rows, ok):
    """``block_rows`` is checked before the CPU branch, as on the card: a
    multiple of 16 up to 64, or None. An accepted value runs the plain
    version unchanged."""
    r = np.random.default_rng(3)
    g, lay, g1, g2, final = _ppnet_inputs(r, 9, 10, 2, [6])
    args = (torch.tensor(g), torch.tensor(r.integers(0, 2, 9)), _t(lay), _t(g1), _t(g2),
            _t([final])[0])
    if not ok:
        with pytest.raises(ValueError, match="block_rows"):
            pk_gated.ppnet_fused_infer(*args, block_rows=rows)
        return
    before = pk_gated.ppnet_fused_infer.launches
    got = pk_gated.ppnet_fused_infer(*args, block_rows=rows)
    assert pk_gated.ppnet_fused_infer.launches == before  # plain on the CPU
    assert torch.equal(got, pk_gated.ppnet_fused_infer_ref(*args))


def _adasparse_args(r, S, A, dims, alpha):
    pw = [(alpha * (S + h) ** -0.5 * r.normal(size=(S + h, h))).astype(np.float32)
          for h in [A] + dims]
    lay = _affines(r, (), [S + A] + dims)
    final = _affines(r, (), [dims[-1] if dims else S + A, 1])[0]
    return pw, lay, final


@pytest.mark.parametrize("form", ["Binarization", "Scaling", "Fusion"])
@pytest.mark.parametrize("cfg", [(37, 8, 24, [16, 8], 1.6, 16), (13, 5, 9, [], 1.0, 8),
                                 (20, 4, 12, [7], 0.7, 8)])
def test_adasparse_ref_matches_jax_kernel(form, cfg):
    B, S, A, dims, alpha, block_rows = cfg
    r = np.random.default_rng(B + 3)
    sce = r.normal(size=(B, S)).astype(np.float32)
    agn = r.normal(size=(B, A)).astype(np.float32)
    pw, lay, final = _adasparse_args(r, S, A, dims, alpha)
    want = jgated.adasparse_fused_infer(
        jnp.asarray(sce), jnp.asarray(agn), [jnp.asarray(p) for p in pw], _j(lay),
        _j([final])[0], form=form, epsilon=0.05, beta=2.0, block_rows=block_rows,
        interpret=True)
    args = (torch.tensor(sce), torch.tensor(agn), [torch.tensor(p) for p in pw], _t(lay),
            _t([final])[0])
    got = pk_gated.adasparse_fused_infer(*args, form=form, epsilon=0.05, beta=2.0)
    assert got.shape == (B,)
    margin = pk_gated.adasparse_threshold_margin(*args, form=form, epsilon=0.05, beta=2.0)
    assert margin.shape == (B,) and bool((margin > 1e-5).all())  # no row at the threshold
    _close(got, want)


@pytest.mark.parametrize("rows,ok", [(None, True), (16, True), (32, True), (48, True),
                                     (64, True), (8, False), (24, False), (80, False),
                                     (0, False), (16.0, False)])
def test_adasparse_wrapper_keeps_the_tile_rule_on_the_cpu(rows, ok):
    """``block_rows`` is checked before the CPU branch, as on the card: a
    multiple of 16 up to 64, or None. An accepted value runs the plain
    version unchanged."""
    r = np.random.default_rng(4)
    pw, lay, final = _adasparse_args(r, 5, 9, [6], 1.0)
    args = (torch.tensor(r.normal(size=(9, 5)).astype(np.float32)),
            torch.tensor(r.normal(size=(9, 9)).astype(np.float32)),
            [torch.tensor(p) for p in pw], _t(lay), _t([final])[0])
    if not ok:
        with pytest.raises(ValueError, match="block_rows"):
            pk_gated.adasparse_fused_infer(*args, block_rows=rows)
        return
    before = pk_gated.adasparse_fused_infer.launches
    got = pk_gated.adasparse_fused_infer(*args, block_rows=rows)
    assert pk_gated.adasparse_fused_infer.launches == before  # plain on the CPU
    assert torch.equal(got, pk_gated.adasparse_fused_infer_ref(*args))


@pytest.mark.parametrize("form", ["Binarization", "Scaling", "Fusion"])
def test_adasparse_ref_sign_is_zero_at_the_threshold(form):
    """Zero pruner weights put every pruner input at sigmoid(0) = 0.5; with
    epsilon there (x beta for Scaling and Fusion) every factor is sign(0) =
    0, in the plain version and the JAX kernel alike."""
    r = np.random.default_rng(5)
    sce = r.normal(size=(11, 4)).astype(np.float32)
    agn = r.normal(size=(11, 6)).astype(np.float32)
    pw = [np.zeros((4 + h, h), np.float32) for h in (6, 5)]
    lay, final = _affines(r, (), [10, 5]), _affines(r, (), [5, 1])[0]
    eps = 0.5 if form == "Binarization" else 1.0
    want = jgated.adasparse_fused_infer(
        jnp.asarray(sce), jnp.asarray(agn), [jnp.asarray(p) for p in pw], _j(lay),
        _j([final])[0], form=form, epsilon=eps, beta=2.0, interpret=True)
    args = (torch.tensor(sce), torch.tensor(agn), [torch.tensor(p) for p in pw], _t(lay),
            _t([final])[0])
    got = pk_gated.adasparse_fused_infer(*args, form=form, epsilon=eps, beta=2.0)
    # every hidden unit is pruned to 0, so the logit is the head's bias
    _close(got, want)
    _close(got, torch.sigmoid(torch.tensor(final[1])).expand(11))
    assert not pk_gated.adasparse_threshold_margin(*args, form=form, epsilon=eps,
                                                   beta=2.0).any()


def test_wrappers_check_shapes():
    r = np.random.default_rng(0)
    sce, agn = torch.randn(4, 3), torch.randn(4, 5)
    l1, l2 = _t(_affines(r, (), [8, 6])), _t(_affines(r, (), [6, 5]))
    head = _t(_affines(r, (), [5, 1]))[0]
    assert pk_gated.epnet_fused_infer(sce, agn, l1[0], l2[0], head).shape == (4,)
    with pytest.raises(ValueError, match="agnostic width"):
        pk_gated.epnet_fused_infer(sce, agn, l1[0], _t(_affines(r, (), [6, 4]))[0], head)
    with pytest.raises(ValueError):
        pk_gated.epnet_fused_infer(sce[:3], agn, l1[0], l2[0], head)
    did = torch.zeros(4, dtype=torch.long)
    lay = _t(_affines(r, (2,), [8, 6]))
    g1, g2 = _t(_affines(r, (2,), [8, 4])), _t(_affines(r, (2,), [4, 6]))
    fin = _t(_affines(r, (2,), [6, 1]))[0]
    g = torch.randn(4, 8)
    assert pk_gated.ppnet_fused_infer(g, did, lay, g1, g2, fin).shape == (4,)
    with pytest.raises(ValueError, match="gate 0"):
        pk_gated.ppnet_fused_infer(g, did, lay, g1, _t(_affines(r, (2,), [4, 5])), fin)
    with pytest.raises(ValueError, match="one gate"):
        pk_gated.ppnet_fused_infer(g, did, lay, g1, [], fin)
    pw = [torch.randn(8, 5), torch.randn(3 + 6, 6)]
    lay = _t(_affines(r, (), [8, 6]))
    fin = _t(_affines(r, (), [6, 1]))[0]
    assert pk_gated.adasparse_fused_infer(sce, agn, pw, lay, fin).shape == (4,)
    with pytest.raises(ValueError, match="form"):
        pk_gated.adasparse_fused_infer(sce, agn, pw, lay, fin, form="Hard")
    with pytest.raises(ValueError, match="pruner 1"):
        pk_gated.adasparse_fused_infer(sce, agn, [pw[0], torch.randn(8, 6)], lay, fin)
    emb = torch.randn(4, 10)
    sarnet = (torch.ones(2, 10), torch.zeros(2, 10), _t(_affines(r, (3,), [10, 4]))[0],
              _t(_affines(r, (2, 2), [10, 4]))[0], _t(_affines(r, (), [10, 5]))[0], [],
              _t(_affines(r, (), [4, 1]))[0])
    assert pk_sarnet.sarnet_fused_infer(emb, did, *sarnet).shape == (4,)
    with pytest.raises(ValueError, match="gate"):
        pk_sarnet.sarnet_fused_infer(emb, did, *sarnet[:4], _t(_affines(r, (), [10, 4]))[0],
                                     *sarnet[5:])
