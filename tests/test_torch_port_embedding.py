"""Port EmbeddingCollection forward against the JAX package's, tables carried
across with ``interop.load_jax_params``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops.embedding import EmbeddingCollection as JEC  # noqa: E402
from scenario_wise_rec_tpu_torch.core import config as port_config  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.embedding import (  # noqa: E402
    EmbeddingCollection as PEC, clamp_rows)

B, L, V = 12, 5, 20


def _specs(m):
    """Dense listed FIRST; packed sparse (dim 8), a loose odd-width table,
    an alias, and sequence features of every pooling with padding_idx."""
    return [
        m.DenseFeature("d0"),
        m.SparseFeature("a", vocab_size=V, embed_dim=8),
        m.SparseFeature("b", vocab_size=V + 3, embed_dim=8),
        m.SparseFeature("odd", vocab_size=9, embed_dim=5),
        m.SparseFeature("a2", vocab_size=V, embed_dim=8, shared_with="a"),
        m.DenseFeature("d1"),
        m.SequenceFeature("qs", vocab_size=V, embed_dim=8, pooling="sum",
                          padding_idx=0),
        m.SequenceFeature("qm", vocab_size=V, embed_dim=8, pooling="mean",
                          padding_idx=0, shared_with="qs"),
        m.SequenceFeature("qc", vocab_size=V, embed_dim=8, pooling="concat",
                          padding_idx=0),
        m.SparseFeature("c", vocab_size=V, embed_dim=8),
    ]


def _pair(specs_fn=_specs, seed=0):
    jec = JEC(specs_fn(jf))
    params = jec.init(jax.random.PRNGKey(seed))
    pec = PEC(specs_fn(pf), port_config.make_generator(torch.device("cpu"), 0))
    load_jax_params(pec, jax.tree_util.tree_map(np.asarray, params))
    return jec, params, pec


def _batch(seed=0, oob=False):
    r = np.random.default_rng(seed)
    x = {n: r.integers(0, V, B) for n in ("a", "b", "a2", "c")}
    x["odd"] = r.integers(0, 9, B)
    for n in ("qs", "qm", "qc"):
        s = r.integers(0, V, (B, L))
        s[:, -2:] = 0  # padding
        x[n] = s
    x["qm"][0] = 0  # an all-padding row: mean divides by 0 + 1e-16
    x["d0"] = r.normal(size=B).astype(np.float32)
    x["d1"] = r.normal(size=B).astype(np.float32)
    if oob:
        # out-of-range and negative ids in a middle feature ("b"), the
        # loose table, an alias, a sequence, and the last feature ("c")
        x["b"][:6] = [V + 3, V + 10, -1, -2, -(V + 3) - 1, 10**6]
        x["odd"][:3] = [9, -1, -100]
        x["a2"][:2] = [V, -V]
        x["qs"][1, :3] = [V + 1, -1, 3 * V]
        x["c"][:4] = [V, -1, -5 * V * 10, 10**7]
    return x


def _both(x):
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def test_clamp_rule_matches_jax_indexing():
    ids = np.array([-1, 12, 3, -11, -30, 0, 9, 10], np.int32)
    want = np.asarray(jnp.arange(10)[jnp.asarray(ids)])
    got = clamp_rows(torch.as_tensor(ids).long(), 10).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:5], [9, 9, 3, 0, 0])


def test_packing_layout_matches_jax():
    jec, params, pec = _pair()
    assert pec.offsets == jec.offsets
    assert pec.packed_names == jec.packed_names
    assert pec.loose_names == jec.loose_names == ["odd"]
    assert pec.packed_vocab == jec.packed_vocab
    np.testing.assert_array_equal(pec.packed.detach().numpy(),
                                  np.asarray(params["packed"]))


@pytest.mark.parametrize("oob", [False, True])
def test_squeeze_output_matches_jax(oob):
    jec, params, pec = _pair()
    xj, xt = _both(_batch(1, oob))
    feats_j, feats_p = _specs(jf), _specs(pf)
    want = np.asarray(jec.apply(params, xj, feats_j, squeeze_dim=True))
    with torch.no_grad():
        got = pec(xt, feats_p, squeeze_dim=True).numpy()
    assert got.shape == want.shape == (B, 8 * 4 + 5 + 8 + 8 + 8 * L + 2)
    # gathers exact; the pooled sum/mean columns reduce in another order
    widths = [f.embed_dim * (L if getattr(f, "pooling", "") == "concat" else 1)
              for f in feats_p if not isinstance(f, pf.DenseFeature)]
    starts = np.cumsum([0] + widths)
    names = [f.name for f in feats_p if not isinstance(f, pf.DenseFeature)]
    for name, s, w in zip(names, starts, widths):
        if name in ("qs", "qm"):
            np.testing.assert_allclose(got[:, s:s + w], want[:, s:s + w],
                                       rtol=1e-6, atol=1e-12)
        else:
            np.testing.assert_array_equal(got[:, s:s + w], want[:, s:s + w])
    # dense columns come last even though d0 is listed first
    np.testing.assert_array_equal(got[:, -2:], want[:, -2:])
    np.testing.assert_array_equal(got[:, -2], _batch(1, oob)["d0"])


@pytest.mark.parametrize("oob", [False, True])
def test_stacked_output_matches_jax(oob):
    jec, params, pec = _pair()
    xj, xt = _both(_batch(2, oob))
    sel = lambda m: [f for f in _specs(m) if f.name in ("a", "b", "a2", "c", "qs")]
    want = np.asarray(jec.apply(params, xj, sel(jf), squeeze_dim=False))
    with torch.no_grad():
        got = pec(xt, sel(pf), squeeze_dim=False).numpy()
    assert got.shape == want.shape == (B, 5, 8)
    np.testing.assert_array_equal(got[:, :4], want[:, :4])
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-6, atol=1e-12)


def test_oob_id_in_middle_feature_reads_next_features_rows():
    jec, params, pec = _pair()
    x = _batch(3)
    x["b"][0] = V + 3 + 2  # past b's span: reads row 2 of the next owner
    _, xt = _both(x)
    feats = [f for f in _specs(pf) if f.name == "b"]
    with torch.no_grad():
        got = pec(xt, feats, squeeze_dim=True)[0].numpy()
    next_owner = pec.packed_names[pec.packed_names.index("b") + 1]
    row = pec.offsets[next_owner] + 2
    np.testing.assert_array_equal(got, np.asarray(params["packed"])[row])


@pytest.mark.parametrize("oob", [False, True])
def test_touched_ids_match_jax(oob):
    jec, params, pec = _pair()
    xj, xt = _both(_batch(4, oob))
    want = np.asarray(jec.touched_ids(xj))
    got = pec.touched_ids(xt).numpy()
    np.testing.assert_array_equal(got, want)
    sub_j = [f for f in _specs(jf) if f.name in ("c", "qs")]
    sub_p = [f for f in _specs(pf) if f.name in ("c", "qs")]
    np.testing.assert_array_equal(pec.touched_ids(xt, sub_p).numpy(),
                                  np.asarray(jec.touched_ids(xj, sub_j)))


def test_interop_rejects_mismatch():
    jec, params, pec = _pair()
    p = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError):
        load_jax_params(pec, {**p, "packed": p["packed"][:-1]})
    with pytest.raises(KeyError):
        load_jax_params(pec, {"packed": p["packed"]})
    with pytest.raises(KeyError):
        load_jax_params(pec, {**p, "extra": np.zeros(3, np.float32)})


def test_initial_tables_have_the_feature_distribution():
    pec = PEC(_specs(pf), port_config.make_generator(torch.device("cpu"), 0))
    t = pec.packed.detach().numpy()
    assert t.shape == (pec.packed_vocab, 8)
    assert abs(t.std() / 1e-4 - 1) < 0.1
    assert pec.tables["odd"].shape == (9, 5)
