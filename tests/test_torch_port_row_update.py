"""The port's lazy and dense embedding updates against the JAX package: the
plain versions of ``occurrence_segsum``, ``scatter_rows`` and
``fused_dense_adam_apply`` (against the JAX Pallas kernels in interpret mode
and their JAX plain references), the optimizer functions of
``train/optim.py`` (winner, occurrence, dense, sorted, each with frozen
spans) and the freeze helpers. Inputs are made with numpy from a seed and
fed to both packages."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops.embedding import (  # noqa: E402
    EmbeddingCollection as JCollection)
from scenario_wise_rec_tpu.ops.pallas import fused_adam as jfa  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas import row_update as jru  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.sorted_adam import unpack_rows  # noqa: E402
from scenario_wise_rec_tpu.train import freeze as jfreeze  # noqa: E402
from scenario_wise_rec_tpu.train import optim as joptim  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.core.init import pretrained  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.embedding import (  # noqa: E402
    EmbeddingCollection as PCollection)
from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as pfa  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import row_update as pru  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels.sorted_adam import adam_hparams  # noqa: E402
from scenario_wise_rec_tpu_torch.train import freeze as pfreeze  # noqa: E402
from scenario_wise_rec_tpu_torch.train import optim as poptim  # noqa: E402

# A segment sum of n f32 terms in two orders (XLA's dot or scatter-add, the
# port's index_add_) differs by at most ~(n - 1) ulp of the sum's terms.
SUM_RTOL, SUM_ATOL = 1e-6, 1e-6
# One f32 Adam step computed by two frameworks: the same chain of elementwise
# ops, but the bias corrections' powers (XLA's and numpy's) and the scalar
# constants may round in the last ulp, and the duplicate sums in another
# order. Adam divides by sqrt(nu), so after three steps an element whose
# gradient is near eps carries a few 1e-6 of relative noise; the JAX
# package's own kernel-vs-reference checks use 1e-5 (tests/test_fused_adam.py).
STEP_RTOL, STEP_ATOL = 1e-5, 1e-7
KW = dict(lr=1e-2, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8)
D = 8


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def _close(got, want, what="", rtol=STEP_RTOL, atol=STEP_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _duplicates_equal_exactly(ids, out):
    """Every occurrence of an id in a row carries bit-identical sums."""
    for f in range(ids.shape[0]):
        for v in np.unique(ids[f]):
            rows = out[f][ids[f] == v]
            assert (rows == rows[:1]).all(), (f, v)


# -- occurrence_segsum ------------------------------------------------------

@pytest.mark.parametrize("f,n,d,vocab,tile", [
    (3, 64, 16, 10, 16),   # many duplicates per row
    (2, 37, 8, 5, 16),     # ragged N: the JAX kernel pads to its tile
    (1, 50, 3, 40, 8),     # D not a multiple of 4, mostly unique ids
    (4, 1, 4, 3, 256),     # one occurrence per row
])
def test_occurrence_segsum_matches_jax(f, n, d, vocab, tile):
    r = np.random.default_rng(f * 100 + n)
    ids = r.integers(0, vocab, (f, n)).astype(np.int32)
    g = r.normal(size=(f, n, d)).astype(np.float32)
    got = pru.occurrence_segsum(_t(ids), _t(g), tile=tile).numpy()
    kernel = jru.occurrence_segsum(jnp.asarray(ids), jnp.asarray(g), tile=tile,
                                   interpret=True)
    _close(got, kernel, "vs the Pallas kernel", SUM_RTOL, SUM_ATOL)
    _close(got, jru.occurrence_segsum_ref(jnp.asarray(ids), jnp.asarray(g)),
           "vs the JAX reference", SUM_RTOL, SUM_ATOL)
    _duplicates_equal_exactly(ids, got)


def test_occurrence_segsum_exact_sums_and_rows_independent():
    ids = np.array([[3, 1, 3, 3, 2, 1], [3, 3, 0, 1, 1, 1]], np.int32)
    g = np.arange(2 * 6 * 4, dtype=np.float32).reshape(2, 6, 4)
    out = pru.occurrence_segsum_ref(_t(ids), _t(g)).numpy()
    _duplicates_equal_exactly(ids, out)
    np.testing.assert_array_equal(out[0, 0], g[0, [0, 2, 3]].sum(0))
    np.testing.assert_array_equal(out[1, 0], g[1, [0, 1]].sum(0))  # row 0's 3s not mixed in
    np.testing.assert_array_equal(out[1, 5], g[1, [3, 4, 5]].sum(0))
    # one row over disjoint id spans equals the rows apart (the optimizer's
    # one-launch form)
    flat = pru.occurrence_segsum(_t(ids + np.array([[0], [10]], np.int32)).reshape(1, -1),
                                 _t(g).reshape(1, 12, 4)).numpy()
    np.testing.assert_array_equal(flat.reshape(2, 6, 4), out)
    assert pru.occurrence_segsum(_t(ids[:, :0]), _t(g[:, :0])).shape == (2, 0, 4)
    with pytest.raises(ValueError):
        pru.occurrence_segsum(_t(ids), _t(g), tile=0)
    with pytest.raises(ValueError):
        pru.occurrence_segsum(_t(ids), _t(g[:, :5]))


def _owner_layout(layout):
    """``(ids int32 [K], segments)``: each owner's ids in its own span of
    the packed table (as ``touched_ids`` clips them), with duplicates."""
    sizes = {"unequal": (("A", 30), ("B", 50), ("C", 30), ("D", 7)),
             # alias segments of one owner, not contiguous, duplicates across them
             "alias": (("A", 10), ("B", 20), ("A", 15), ("C", 25), ("A", 5)),
             # an owner longer than the card's shared-memory route takes
             "long": (("A", pru.ROW_LIMIT + 3), ("B", 40), ("A", 9))}[layout]
    r = np.random.default_rng(len(layout))
    span = {o: i * 1000 for i, o in enumerate(dict.fromkeys(o for o, _ in sizes))}
    ids, segments, at = [], [], 0
    for owner, size in sizes:
        ids.append(span[owner] + r.integers(0, 12 if owner == "A" else 900, size))
        segments.append((owner, at, size))
        at += size
    return np.concatenate(ids).astype(np.int32), tuple(segments)


@pytest.mark.parametrize("layout,use_pallas", [
    ("unequal", False), ("unequal", True), ("alias", False), ("alias", True),
    ("long", True),  # the XLA form would build a [16387, 16387] mask
], ids=lambda v: {False: "jax_xla", True: "jax_pallas"}.get(v, v))
def test_grouped_occurrence_segsum_matches_jax(layout, use_pallas):
    """The trainer's batching (owners merged, stacked by length, one call a
    length) against the JAX function on the same numpy inputs: unequal
    owner lengths, non-contiguous alias segments, and an owner longer than
    ROW_LIMIT; every duplicate's sum bit-identical."""
    ids, segments = _owner_layout(layout)
    g = np.random.default_rng(7).normal(size=(ids.shape[0], D)).astype(np.float32)
    want = joptim._grouped_occurrence_segsum(jnp.asarray(g), jnp.asarray(ids), segments,
                                            use_pallas)
    got = poptim._grouped_occurrence_segsum(_t(g), _t(ids).long(), segments).numpy()
    # runs here reach ~1400 occurrences: two f32 sums of a run's n terms in
    # other orders lie within n ulp of the run's sum of |g| (the spans are
    # disjoint, so the runs are those of the whole layout)
    _, inv, count = np.unique(ids, return_inverse=True, return_counts=True)
    abs_sum = np.zeros((count.shape[0], D), np.float64)
    np.add.at(abs_sum, inv, np.abs(g))
    tol = count[inv, None] * 2.0 ** -23 * abs_sum[inv]
    assert np.all(np.abs(got - np.asarray(want)) <= tol + SUM_ATOL), layout
    _duplicates_equal_exactly(ids[None], got[None])


def test_grouped_occurrence_segsum_layout():
    """The JAX package's batching: one call per distinct owner length, in
    order of first appearance; the ids' own order stays a view (no gather)."""
    _, segments = _owner_layout("alias")
    order, back, shapes = poptim._owner_rows(segments, torch.device("cpu"))
    assert shapes == ((1, 30), (1, 20), (1, 25))
    assert order[:12].tolist() == list(range(10)) + [30, 31]  # A's pieces merged first
    assert sorted(order.tolist()) == list(range(75))
    assert order[back].tolist() == list(range(75))  # back is the inverse
    ali = tuple((f"f{f}", f * 4096, 4096) for f in range(23))
    assert poptim._owner_rows(ali, torch.device("cpu")) == (None, None, ((23, 4096),))
    with pytest.raises(ValueError):
        poptim._grouped_occurrence_segsum(torch.zeros(5, D), torch.zeros(5, dtype=torch.long),
                                          (("A", 0, 4),))


# -- scatter_rows -------------------------------------------------------------

def _scatter_case(trailing, k, negative, dtype=np.int32):
    """dst [50, *trailing], k ids with duplicates and ids >= V; with
    ``negative`` also -1, -V, -V-1 and the wrapped twin of a positive id.
    Every row is a function of the id it lands on (later duplicates, a
    negative id's wrapped twin included, copy the first row)."""
    r = np.random.default_rng(k)
    v = 50
    dst = r.normal(size=(v,) + trailing).astype(np.float32)
    ids = r.integers(0, v, k).astype(dtype)
    ids[5] = ids[7]
    ids[3], ids[9] = v, v + 4
    if negative:
        ids[11], ids[13], ids[15] = -1, -v, -v - 1
        ids[17] = ids[19] - v  # the wrapped twin of ids[19]
    rows = r.normal(size=(k,) + trailing).astype(np.float32)
    first = {}
    for i, t in enumerate(ids):
        lands = int(t) + v if t < 0 else int(t)
        rows[i] = rows[first.setdefault(lands, i)]
    return dst, ids, rows


@pytest.mark.parametrize("trailing,k,chunk", [((16,), 40, 32), ((2, 8), 40, 32),
                                              ((48,), 53, 16)])
def test_scatter_rows_matches_jax(trailing, k, chunk):
    """Ids >= V dropped, duplicates carrying identical rows, K across
    several of the JAX kernel's chunks: exact equality with the Pallas
    kernel (interpret mode) and the XLA form."""
    dst, ids, rows = _scatter_case(trailing, k, negative=False)
    want = jru.scatter_rows(jnp.asarray(dst), jnp.asarray(ids), jnp.asarray(rows),
                            nslots=4, chunk=chunk, interpret=True)
    pd = _t(dst)
    assert pru.scatter_rows(pd, _t(ids), _t(rows), nslots=4, chunk=chunk) is pd  # in place
    np.testing.assert_array_equal(pd.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        pd.numpy(), np.asarray(jru.scatter_rows(jnp.asarray(dst), jnp.asarray(ids),
                                                jnp.asarray(rows), force_xla=True)))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("trailing,k", [((16,), 40), ((2, 8), 40), ((48,), 53)])
def test_scatter_rows_negative_ids_match_jax_xla(trailing, k, dtype):
    """Ids -1, -V and -V-1 and the wrapped twin of a positive id: a negative
    id wraps once and what is still outside [0, V) drops, exactly as the JAX
    function's XLA form (what the JAX package runs off the TPU)."""
    dst, ids, rows = _scatter_case(trailing, k, negative=True, dtype=dtype)
    want = jru.scatter_rows(jnp.asarray(dst), jnp.asarray(ids), jnp.asarray(rows),
                            force_xla=True)
    pd = _t(dst)
    assert pru.scatter_rows(pd, _t(ids), _t(rows)) is pd
    np.testing.assert_array_equal(pd.numpy(), np.asarray(want))
    assert not np.array_equal(pd.numpy()[[0, 49]], dst[[0, 49]])  # -V and -1 landed


def test_scatter_rows_wraps_negative_ids_and_checks_dials():
    dst = torch.zeros(6, 3)
    pru.scatter_rows(dst, torch.tensor([-1, 2, 7, -6]), torch.ones(4, 3))
    np.testing.assert_array_equal(dst.sum(1).numpy(), [3, 0, 3, 0, 0, 3])
    dst = torch.zeros(6, 3)
    pru.scatter_rows(dst, torch.tensor([-7, 6, -13]), torch.ones(3, 3))  # -V-1, V: dropped
    assert not dst.any()
    for kw in (dict(nslots=0), dict(chunk=-1), dict(force_xla=1)):
        with pytest.raises(ValueError):
            pru.scatter_rows(dst, torch.tensor([1]), torch.ones(1, 3), **kw)
    with pytest.raises(ValueError):
        pru.scatter_rows(dst, torch.tensor([1]), torch.ones(1, 4))
    assert pru.scatter_rows.launches == pru.occurrence_segsum.launches == 0  # CPU


# -- fused_dense_adam_apply ---------------------------------------------------

def _segment_sorts(ids, sizes, bounds=None):
    """Each segment's ids sorted (stable), their original positions and, for
    the JAX kernel, ``starts`` at ``bounds``."""
    sid, pos, starts, off = [], [], [], 0
    for s in sizes:
        seg = ids[off:off + s]
        order = np.argsort(seg, kind="stable")
        if bounds is not None:
            starts.append(np.searchsorted(seg[order], bounds).astype(np.int32) + off)
        sid.append(seg[order])
        pos.append(order + off)
        off += s
    cat = lambda parts: np.concatenate(parts).astype(np.int32)
    return cat(sid), cat(pos), (cat(starts) if starts else None)


@pytest.mark.parametrize("sizes", [[12, 12, 20], [44], [0, 30, 1]])
def test_fused_dense_adam_apply_matches_jax(sizes):
    """Three steps; V = 100 is not a multiple of the JAX tile (16); an
    in-segment and a cross-segment duplicate; several segments."""
    r = np.random.default_rng(sum(sizes) + len(sizes))
    V, block_rows = 100, 16
    k = sum(sizes)
    ids = r.integers(0, V, k).astype(np.int32)
    if k > 13:
        ids[1], ids[13] = ids[5], ids[2]
    bounds = np.arange(-(-V // block_rows) + 1, dtype=np.int32) * block_rows
    sid, pos, starts = _segment_sorts(ids, sizes, bounds)
    table = r.normal(size=(V, D)).astype(np.float32)
    mu = (0.01 * r.normal(size=(V, D))).astype(np.float32)
    nu = (0.01 * np.abs(r.normal(size=(V, D)))).astype(np.float32)
    jk = [jnp.asarray(a) for a in (table, mu, nu)]
    jr = list(jk)
    p = [_t(a) for a in (table, mu, nu)]
    for t in (1, 2, 3):
        hp = adam_hparams(t, 1e-2, 1e-4, 0.9, 0.999, 1e-8)
        g = r.normal(size=(k, D)).astype(np.float32)
        jhp = jnp.asarray(hp, jnp.float32)
        jk = jfa.fused_dense_adam_apply(*jk, jnp.asarray(g), jnp.asarray(sid),
                                        jnp.asarray(pos), jnp.asarray(starts), jhp,
                                        block_rows=block_rows, interpret=True)
        jr = jfa.fused_dense_adam_ref(*jr, jnp.asarray(g), jnp.asarray(ids), jhp)
        out = pfa.fused_dense_adam_apply(*p, _t(g), _t(sid), _t(pos), sizes, hp)
        assert all(a is b for a, b in zip(out, p))  # in place
        for name, got, a, b in zip(("table", "mu", "nu"), p, jk, jr):
            _close(got, a, f"{name} t={t} vs the Pallas kernel")
            _close(got, b, f"{name} t={t} vs the JAX reference")
    assert np.all(p[0].numpy() != table)  # every row decays, touched or not


def test_fused_dense_adam_apply_checks_its_segments():
    t = [torch.zeros(10, D) for _ in range(3)]
    hp = adam_hparams(1, 1e-3, 0.0, 0.9, 0.999, 1e-8)
    ids = torch.tensor([1, 3], dtype=torch.int32)
    pos = torch.tensor([0, 1], dtype=torch.int32)
    for sizes in ([1], [3, -1], [1, 2]):
        with pytest.raises(ValueError, match="segment"):
            pfa.fused_dense_adam_apply(*t, torch.ones(2, D), ids, pos, sizes, hp)
    with pytest.raises(ValueError):
        pfa.fused_dense_adam_apply(*t, torch.ones(2, D), ids, pos[:1], [2], hp)
    with pytest.raises(ValueError):
        pfa.fused_dense_adam_apply(*t, torch.ones(2, D), ids, pos, [2], hp, block_rows=0)
    pfa.fused_dense_adam_apply(*t, torch.ones(0, D), ids[:0], pos[:0], [], hp)  # K = 0
    assert pfa.fused_dense_adam_apply.launches == 0


# -- the optimizer functions ----------------------------------------------------

def _owners():
    """Ids of two owners: A spans rows [0, 25) with two alias segments and a
    duplicate across them, B spans [25, 40)."""
    r = np.random.default_rng(4)
    a1, a2 = r.integers(0, 25, 10), r.integers(0, 25, 10)
    a2[0] = a1[3]
    a1[7] = a1[2]
    b = r.integers(0, 15, 6) + 25
    ids = np.concatenate([a1, a2, b]).astype(np.int32)
    return ids, (("A", 0, 10), ("A", 10, 10), ("B", 20, 6)), 40


FROZEN = ((25, 15),)  # owner B frozen


def _table(v, seed=5):
    return np.random.default_rng(seed).normal(size=(v, D)).astype(np.float32)


def _grads(step, k):
    return np.random.default_rng(100 + step).normal(size=(k, D)).astype(np.float32)


@pytest.mark.parametrize("frozen", [(), FROZEN], ids=["trainable", "frozen"])
def test_winner_update_matches_jax(frozen):
    ids, _, v = _owners()
    table = _table(v)
    jt, js = jnp.asarray(table), joptim.sparse_adam_init(jnp.asarray(table))
    pt = _t(table)
    ps = poptim.sparse_adam_init(pt)
    for step in range(3):
        g = _grads(step, ids.shape[0])
        jt, js = joptim.sparse_adam_rowgrads_update(jt, js, jnp.asarray(g), jnp.asarray(ids),
                                                    frozen_spans=frozen, **KW)
        out = poptim.sparse_adam_rowgrads_update(pt, ps, _t(g), _t(ids),
                                                 frozen_spans=frozen, **KW)
        assert out[0] is pt and out[1] is ps  # in place
    assert ps["step"] == int(js["step"]) == 3
    for got, want, what in ((pt, jt, "table"), (ps["mu"], js["mu"], "mu"),
                            (ps["nu"], js["nu"], "nu")):
        _close(got, want, what)
    if frozen:
        np.testing.assert_array_equal(pt.numpy()[25:], table[25:])
        assert not ps["mu"][25:].any()
    untouched = np.setdiff1d(np.arange(v), ids)
    np.testing.assert_array_equal(pt.numpy()[untouched], table[untouched])  # lazy


def test_winner_update_with_no_ids_and_dense_gradient_form():
    v = 12
    table = _table(v)
    pt, ps = _t(table), poptim.sparse_adam_init(_t(table))
    poptim.sparse_adam_rowgrads_update(pt, ps, torch.zeros(0, D), torch.zeros(0, dtype=torch.long))
    assert ps["step"] == 1 and torch.equal(pt, _t(table))
    # sparse_adam_rows_update: a dense [V, D] gradient, ids with duplicates
    ids = np.array([3, 1, 3, 7, 1, 0], np.int32)
    jt, js = jnp.asarray(table), joptim.sparse_adam_init(jnp.asarray(table))
    pt, ps = _t(table), poptim.sparse_adam_init(_t(table))
    for step in range(3):
        g = _grads(step, v)
        jt, js = joptim.sparse_adam_rows_update(jt, js, jnp.asarray(g), jnp.asarray(ids), **KW)
        poptim.sparse_adam_rows_update(pt, ps, _t(g), _t(ids), **KW)
    for got, want in ((pt, jt), (ps["mu"], js["mu"]), (ps["nu"], js["nu"])):
        _close(got, want)


@pytest.mark.parametrize("frozen", [(), FROZEN], ids=["trainable", "frozen"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["jax_xla", "jax_pallas"])
def test_occurrence_update_matches_jax(frozen, use_pallas):
    """The combined store over three steps, alias segments of one owner with
    a duplicate across them; JAX's segment sum by its XLA formulation or its
    Pallas kernel in interpret mode."""
    ids, segments, v = _owners()
    table = _table(v)
    js = joptim.sparse_adam_occurrence_init(jnp.asarray(table))
    ps = poptim.sparse_adam_occurrence_init(_t(table))
    for step in range(3):
        g = _grads(step, ids.shape[0])
        js = joptim.sparse_adam_occurrence_update(
            js, jnp.asarray(g), jnp.asarray(ids), segments, js["comb"][ids],
            use_pallas=use_pallas, frozen_spans=frozen, **KW)
        pids = _t(ids).long()
        assert poptim.sparse_adam_occurrence_update(
            ps, _t(g), pids, segments, ps["comb"][pids], frozen_spans=frozen, **KW) is ps
    assert ps["step"] == int(js["step"]) == 3
    _close(ps["comb"], js["comb"], "comb")
    if frozen:
        np.testing.assert_array_equal(ps["comb"].numpy()[25:, :D], table[25:])
        assert not ps["comb"][25:, D:].any()


def test_occurrence_update_equals_winner_update():
    """The two lazy forms inside the port, with no JAX in between."""
    ids, segments, v = _owners()
    table = _table(v)
    pt, pw = _t(table), poptim.sparse_adam_init(_t(table))
    po = poptim.sparse_adam_occurrence_init(_t(table))
    pids = _t(ids).long()
    for step in range(3):
        g = _t(_grads(step, ids.shape[0]))
        poptim.sparse_adam_rowgrads_update(pt, pw, g, pids, **KW)
        poptim.sparse_adam_occurrence_update(po, g, pids, segments, po["comb"][pids], **KW)
    _close(po["comb"][:, :D], pt)
    _close(po["comb"][:, D:2 * D], pw["mu"])
    _close(po["comb"][:, 2 * D:], pw["nu"])


@pytest.mark.parametrize("frozen", [(), FROZEN], ids=["trainable", "frozen"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["jax_xla", "jax_pallas"])
def test_fused_dense_adam_update_matches_jax(frozen, use_pallas):
    ids, segments, v = _owners()
    table = _table(v)
    jt = jnp.asarray(table)
    js = {"mu": jnp.zeros((v, D)), "nu": jnp.zeros((v, D)), "step": jnp.zeros((), jnp.int32)}
    pt = _t(table)
    ps = poptim.sparse_adam_init(pt)
    for step in range(3):
        g = _grads(step, ids.shape[0])
        jt, js = joptim.fused_dense_adam_update(jt, js, jnp.asarray(g), jnp.asarray(ids),
                                                segments, use_pallas=use_pallas,
                                                block_rows=16, frozen_spans=frozen, **KW)
        out = poptim.fused_dense_adam_update(pt, ps, _t(g), _t(ids).long(), segments,
                                             frozen_spans=frozen, **KW)
        assert out[0] is pt and out[1] is ps
    assert ps["step"] == int(js["step"]) == 3
    for got, want, what in ((pt, jt, "table"), (ps["mu"], js["mu"], "mu"),
                            (ps["nu"], js["nu"], "nu")):
        _close(got, want, what)
    if frozen:
        np.testing.assert_array_equal(pt.numpy()[25:], table[25:])
        assert not ps["nu"][25:].any()


def test_sorted_update_with_frozen_spans_matches_jax():
    ids, segments, v = _owners()
    table = _table(v)
    js = joptim.sorted_dense_adam_init(jnp.asarray(table), block_rows=64)
    pt = _t(table)
    ps = poptim.sorted_dense_adam_init(pt)
    for step in range(3):
        g = _grads(step, ids.shape[0])
        js = joptim.sorted_dense_adam_update(js, jnp.asarray(g), jnp.asarray(ids), segments,
                                             {"A": 0, "B": 25}, D, block_rows=64,
                                             use_pallas=False, frozen_spans=FROZEN, **KW)
        poptim.sorted_dense_adam_update(pt, ps, _t(g), _t(ids).long(), frozen_spans=FROZEN,
                                        **KW)
    for got, want in ((pt, js["table"]), (ps["mu"], js["mu"]), (ps["nu"], js["nu"])):
        _close(got, unpack_rows(want, v, D))
    np.testing.assert_array_equal(pt.numpy()[25:], table[25:])
    assert np.all(pt.numpy()[:25] != table[:25])  # dense: every trainable row moved


def test_segment_sorted_ids():
    ids, segments, _ = _owners()
    sid, pos, sizes = poptim.segment_sorted_ids(_t(ids).long(), segments)
    assert sizes == [10, 10, 6] and sid.dtype == pos.dtype == torch.int32
    want_sid, want_pos, _ = _segment_sorts(ids, sizes)
    np.testing.assert_array_equal(sid.numpy(), want_sid)
    np.testing.assert_array_equal(pos.numpy(), want_pos)  # stable: duplicates in order
    with pytest.raises(ValueError):
        poptim.segment_sorted_ids(_t(ids), (("A", 0, 10), ("B", 11, 16)))
    with pytest.raises(ValueError):
        poptim.segment_sorted_ids(_t(ids), (("A", 0, 10),))


# -- frozen tables ------------------------------------------------------------

def test_frozen_spans_and_masks_match_jax():
    w = np.zeros((20, D), np.float32)
    feats = lambda m, init: [m.SparseFeature("s0", vocab_size=30, embed_dim=D),
                             m.SparseFeature("s1", vocab_size=20, embed_dim=D,
                                             initializer=init(w)),
                             m.SparseFeature("s2", vocab_size=30, embed_dim=D),
                             m.SparseFeature("sl", vocab_size=12, embed_dim=4,
                                             initializer=init(np.zeros((12, 4)))),
                             m.DenseFeature("d0")]
    from scenario_wise_rec_tpu.core.init import pretrained as jpretrained

    jc = JCollection(feats(jf, jpretrained))
    pc = PCollection(feats(pf, pretrained), make_generator(torch.device("cpu"), 0))
    assert pc.frozen_spans == jc.frozen_spans == ((30, 20),)
    assert pc.frozen_loose == jc.frozen_loose == ("sl",)
    unfrozen = PCollection(feats(pf, lambda a: pretrained(a, freeze=False)),
                           make_generator(torch.device("cpu"), 0))
    assert unfrozen.frozen_spans == () and unfrozen.frozen_loose == ()
    spans = ((3, 4), (10, 2))
    ids = np.array([-1, 0, 3, 6, 7, 9, 10, 11, 12, 80])
    np.testing.assert_array_equal(pfreeze.frozen_ids_mask(_t(ids), spans).numpy(),
                                  np.asarray(jfreeze.frozen_ids_mask(jnp.asarray(ids), spans)))
    np.testing.assert_array_equal(pfreeze.frozen_rows_mask(15, spans).numpy(),
                                  np.asarray(jfreeze.frozen_rows_mask(15, spans)))
    a, b = torch.arange(30.0).reshape(15, 2), torch.ones(15)
    with pfreeze.rows_kept([a, b], spans):
        a.mul_(-1)
        b.zero_()
    np.testing.assert_array_equal(a[3:7].numpy(), np.arange(6.0, 14.0).reshape(4, 2))
    assert (a[:3] <= 0).all() and b[10:12].tolist() == [1.0, 1.0] and b[12] == 0
    pfreeze.zero_rows([b], ((0, 11),))
    assert b.tolist() == [0.0] * 11 + [1.0] + [0.0] * 3
