"""The port's sorted embedding update against the JAX package: the id sort
(``owner_sorted_grads``), the plain version of the sorted dense-Adam kernel
(against the JAX Pallas kernel in interpret mode and against the JAX plain
``fused_dense_adam_ref``), the host ``hp`` vector and the update wrapper.
Inputs are made with numpy from a seed and fed to both packages."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops.embedding import (  # noqa: E402
    EmbeddingCollection as JCollection)
from scenario_wise_rec_tpu.ops.pallas import sorted_adam as jsa  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.fused_adam import fused_dense_adam_ref  # noqa: E402
from scenario_wise_rec_tpu.train import optim as joptim  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.embedding import (  # noqa: E402
    EmbeddingCollection as PCollection)
from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as psa  # noqa: E402
from scenario_wise_rec_tpu_torch.train import optim as poptim  # noqa: E402

# The JAX kernel sums duplicate gradients with a bf16 hi/lo split ("split"
# precision, as tests/test_sorted_adam.py:116 runs it): ~2^-18 relative
# residual; the JAX package's own kernel-vs-reference tolerance.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# The JAX plain reference computes the same chain of f32 ops; only the order
# of XLA's and torch's scatter-add may differ.
REF_RTOL, REF_ATOL = 1e-6, 1e-7
D = 8


def _feats(m):
    return ([m.SparseFeature(f"s{i}", vocab_size=30, embed_dim=D) for i in range(3)]
            + [m.SparseFeature("alias", vocab_size=30, embed_dim=D, shared_with="s0")]
            + [m.SequenceFeature("seq", vocab_size=30, embed_dim=D, pooling="mean",
                                 shared_with="s1")]
            + [m.DenseFeature("d0")])


def _batch(r, b=16, hi=30):
    x = {f"s{i}": r.integers(0, hi, b) for i in range(3)}
    x["alias"] = r.integers(-3, hi + 4, b)  # out of range: clipped to the owner's span
    x["seq"] = r.integers(0, hi, (b, 4))
    x["s2"][1] = x["s2"][5]  # in-segment duplicate
    x["d0"] = r.normal(size=b).astype(np.float32)
    return x


def _collections():
    pc = PCollection(_feats(pf), make_generator(torch.device("cpu"), 0))
    return JCollection(_feats(jf)), pc


@pytest.mark.parametrize("reorder", ["gather", "payload"])
def test_owner_sorted_grads_equal_jax_bit_for_bit(reorder):
    r = np.random.default_rng(0)
    jc, pc = _collections()
    x = _batch(r)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    px = {k: torch.as_tensor(v) for k, v in x.items()}
    ids_j = jc.touched_ids(jx)
    segs = jc.touched_owner_segments(jx)
    ids_p = pc.touched_ids(px)
    assert pc.touched_owner_segments(px) == segs
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_j))
    g = r.normal(size=(ids_p.shape[0], D)).astype(np.float32)
    sid_j, gs_j = jsa.owner_sorted_grads(ids_j, jnp.asarray(g), segs, jc.offsets,
                                         reorder=reorder)
    sid_p, gs_p = psa.owner_sorted_grads(ids_p, torch.as_tensor(g), segs, pc.offsets,
                                         reorder=reorder)
    assert sid_p.dtype == torch.int32
    np.testing.assert_array_equal(sid_p.numpy(), np.asarray(sid_j))
    np.testing.assert_array_equal(gs_p.numpy(), np.asarray(gs_j))


def test_adam_hparams_match_jax_hp():
    for t in (1, 2, 7, 1000):
        tf = jnp.float32(t)
        want = np.asarray(jnp.stack([
            jnp.float32(1e-3), jnp.float32(1e-5), jnp.float32(0.9),
            jnp.float32(0.999), 1.0 / (1.0 - jnp.float32(0.9) ** tf),
            1.0 / (1.0 - jnp.float32(0.999) ** tf), jnp.float32(1e-8)]))
        got = np.asarray(psa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8), np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def _state(r, V):
    table = r.normal(size=(V, D)).astype(np.float32)
    mu = (1e-3 * r.normal(size=(V, D))).astype(np.float32)
    nu = (1e-6 * r.random(size=(V, D))).astype(np.float32)
    return table, mu, nu


def _hp(t):
    return psa.adam_hparams(t, 1e-2, 1e-4, 0.9, 0.999, 1e-8)


@pytest.mark.parametrize("case", ["duplicates_empty_tiles_out_of_range", "one_hot_row"])
def test_plain_update_matches_jax_kernel_interpret(case):
    """Three steps; V = 100 is not a multiple of the 32-row tile, rows
    [70, 100) get no id (their tiles must still decay), and ids -1, -7, V,
    V+3 must add nothing."""
    r = np.random.default_rng(1)
    V, block_rows = 100, 32
    if case == "one_hot_row":
        ids = np.concatenate([np.full(300, 13), r.integers(0, 70, 40)])
    else:
        ids = np.concatenate([r.integers(0, 70, 500), [-1, -7, V, V + 3]])
    order = np.argsort(ids, kind="stable")
    sid = ids[order].astype(np.int32)
    table, mu, nu = _state(r, V)
    j = {k: jsa.pack_rows(jnp.asarray(a), block_rows)
         for k, a in zip(("table", "mu", "nu"), (table, mu, nu))}
    v2 = j["table"].shape[0] * (128 // D)
    p = [torch.as_tensor(a.copy()) for a in (table, mu, nu)]
    for t in (1, 2, 3):
        g = r.normal(size=(ids.shape[0], D)).astype(np.float32)[order]
        out = jsa.sorted_dense_adam_apply(
            j["table"], j["mu"], j["nu"], jnp.asarray(sid), jnp.asarray(g),
            jnp.asarray(_hp(t), jnp.float32), D, block_rows=block_rows,
            precision="split", interpret=True)
        j = dict(zip(("table", "mu", "nu"), out))
        res = psa.sorted_dense_adam_apply(*p, torch.as_tensor(sid), torch.as_tensor(g),
                                          _hp(t), block_rows=block_rows)
        assert all(a is b for a, b in zip(res, p))  # in place
        for name, got in zip(("table", "mu", "nu"), p):
            want = np.asarray(jsa.unpack_rows(j[name], v2, D))[:V]
            np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL, err_msg=f"{name} t={t}")
    # the rows no id touched moved too (dense decay)
    assert np.all(p[0].numpy()[70:] != table[70:])


@pytest.mark.parametrize("k", [0, 1, 257])
def test_plain_update_matches_jax_plain_reference(k):
    r = np.random.default_rng(2)
    V = 90
    ids = r.integers(0, V, k)
    order = np.argsort(ids, kind="stable")
    table, mu, nu = _state(r, V)
    j = [jnp.asarray(a) for a in (table, mu, nu)]
    p = [torch.as_tensor(a.copy()) for a in (table, mu, nu)]
    for t in (1, 2, 3):
        g = r.normal(size=(k, D)).astype(np.float32)
        j = fused_dense_adam_ref(*j, jnp.asarray(g), jnp.asarray(ids),
                                 jnp.asarray(_hp(t), jnp.float32))
        psa.sorted_dense_adam_apply(*p, torch.as_tensor(ids[order].astype(np.int32)),
                                    torch.as_tensor(g[order]), _hp(t))
        for name, got, want in zip(("table", "mu", "nu"), p, j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REF_RTOL,
                                       atol=REF_ATOL, err_msg=f"{name} t={t}")


def test_update_wrapper_matches_jax_update_over_steps():
    """``sorted_dense_adam_update`` (host step count, sort, plain version)
    against the JAX ``sorted_dense_adam_update`` (its XLA path) over three
    steps with aliases and a sequence feature."""
    r = np.random.default_rng(3)
    jc, pc = _collections()
    V = pc.packed_vocab
    table, _, _ = _state(r, V)
    js = joptim.sorted_dense_adam_init(jnp.asarray(table), block_rows=64)
    pt = torch.as_tensor(table.copy())
    ps = poptim.sorted_dense_adam_init(pt)
    kw = dict(lr=1e-2, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8)
    for _ in range(3):
        x = _batch(r)
        jx = {k: jnp.asarray(v) for k, v in x.items()}
        px = {k: torch.as_tensor(v) for k, v in x.items()}
        ids_j = jc.touched_ids(jx)
        g = r.normal(size=(ids_j.shape[0], D)).astype(np.float32)
        js = joptim.sorted_dense_adam_update(
            js, jnp.asarray(g), ids_j, jc.touched_owner_segments(jx), jc.offsets,
            D, block_rows=64, use_pallas=False, **kw)
        poptim.sorted_dense_adam_update(pt, ps, torch.as_tensor(g), pc.touched_ids(px),
                                        **kw)
    assert ps["step"] == int(js["step"]) == 3
    for got, want in ((pt, js["table"]), (ps["mu"], js["mu"]), (ps["nu"], js["nu"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(jsa.unpack_rows(want, V, D)),
                                   rtol=REF_RTOL, atol=REF_ATOL)


def test_dials_and_bad_input():
    table, mu, nu = (torch.zeros(10, D) for _ in range(3))
    ids = torch.tensor([1, 2], dtype=torch.int32)
    g = torch.ones(2, D)
    for precision in (None, "fast", "split", "highest"):
        psa.sorted_dense_adam_apply(table, mu, nu, ids, g, _hp(1), precision=precision,
                                    chunk_ids=256)
    with pytest.raises(ValueError):
        psa.sorted_dense_adam_apply(table, mu, nu, ids, g, _hp(1), precision="bf16")
    with pytest.raises(ValueError):
        psa.sorted_dense_adam_apply(table, mu, nu, ids, g, _hp(1), chunk_ids=100)
    with pytest.raises(ValueError):
        psa.sorted_dense_adam_apply(table, mu, nu, ids.long(), g, _hp(1))
    with pytest.raises(ValueError):
        psa.sorted_dense_adam_apply(table, mu, nu, ids, g[:1], _hp(1))
    with pytest.raises(ValueError):
        psa.sorted_dense_adam_apply(table, mu, nu, ids, g, _hp(1)[:6])
    with pytest.raises(ValueError):
        psa.owner_sorted_grads(ids, g, reorder="scatter")
    assert psa.sorted_dense_adam_apply.launches == 0  # the CPU never launches
