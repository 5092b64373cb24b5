"""Port MMOE and the plain version of its fused kernel against the JAX
package (its Pallas kernel in interpret mode), weights carried across."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.mmoe_infer import (  # noqa: E402
    mmoe_fused_infer as j_fused)
from scenario_wise_rec_tpu_torch.core import config as port_config  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.models import MMOE as PMMOE  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import mmoe_infer as pk  # noqa: E402

# the JAX package's own fused-kernel tolerance: sums in another order
RTOL, ATOL = 1e-5, 1e-6
V, D = 64, 3


def _feats(m, n_sparse=5, n_dense=2):
    # dense listed first, as bench.py builds MMOE
    return ([m.DenseFeature(f"d{i}") for i in range(n_dense)]
            + [m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8)
               for i in range(n_sparse)])


def _models(expert_dims=(16, 8), tower_dims=(4,), n_expert=2, seed=0):
    kw = dict(n_expert=n_expert, expert_params={"dims": list(expert_dims)},
              tower_params={"dims": list(tower_dims)})
    jm = JMMOE(_feats(jf), D, **kw)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed + 100)
    state = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            (r.normal(0, 0.2, a.shape) if p[-1].key == "mean"
             else r.uniform(0.5, 1.5, a.shape)).astype(np.float32)), state)
    pm = PMMOE(_feats(pf), D, device="cpu",
               generator=port_config.make_generator(torch.device("cpu"), seed), **kw)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_jax_params(pm, np_tree(params), np_tree(state))
    return jm, params, state, pm


def _batch(b, seed=0, oob_domains=False):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b) for i in range(5)}
    x.update({f"d{i}": r.normal(size=b).astype(np.float32) for i in range(2)})
    x["domain_indicator"] = r.integers(-2, D + 3, b) if oob_domains \
        else r.integers(0, D, b)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def _random_stages(r, F, E, Dn, expert_dims, tower_dims):
    def n(*s, scale=1.0):
        return (scale * r.normal(size=s)).astype(np.float32)

    ex, w = [], F
    for o in expert_dims:
        ex.append((n(E, w, o, scale=w ** -0.5), n(E, o, scale=0.1)))
        w = o
    gate = (n(Dn, F, E, scale=F ** -0.5), n(Dn, E))
    tw, h = [], w
    for o in tower_dims:
        tw.append((n(Dn, h, o, scale=h ** -0.5), n(Dn, o, scale=0.1)))
        h = o
    return ex, gate, tw, (n(Dn, h, 1, scale=h ** -0.5), n(Dn, 1))


@pytest.mark.parametrize("cfg", [
    # (B, F, E, D, expert dims, tower dims, block_rows)
    (37, 42, 2, 3, (16, 8), (4,), 16),      # ragged: 37 = 2*16 + 5
    (64, 30, 3, 2, (8,), (), 16),           # no tower stage: head on the mix
    (20, 24, 4, 4, (12, 10, 6), (5, 3), 8),
])
def test_fused_ref_matches_jax_kernel(cfg):
    B, F, E, Dn, ed, td, block_rows = cfg
    r = np.random.default_rng(B)
    ex, gate, tw, out = _random_stages(r, F, E, Dn, ed, td)
    emb = r.normal(size=(B, F)).astype(np.float32)
    did = r.integers(-2, Dn + 4, B)  # out-of-range ids are clipped
    j = lambda s: tuple(jnp.asarray(a) for a in s)
    want = np.asarray(j_fused(jnp.asarray(emb), jnp.asarray(did), [j(s) for s in ex],
                              j(gate), [j(s) for s in tw], j(out),
                              block_rows=block_rows, interpret=True))
    t = lambda s: tuple(torch.tensor(a) for a in s)
    before = pk.mmoe_fused_infer.launches
    got = pk.mmoe_fused_infer(torch.tensor(emb), torch.tensor(did), [t(s) for s in ex],
                              t(gate), [t(s) for s in tw], t(out))
    assert pk.mmoe_fused_infer.launches == before  # the CPU runs the plain version
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fused_wrapper_checks_shapes():
    r = np.random.default_rng(0)
    ex, gate, tw, out = _random_stages(r, 10, 2, 2, (6,), (3,))
    t = lambda s: tuple(torch.tensor(a) for a in s)
    emb = torch.randn(4, 10)
    with pytest.raises(ValueError):
        pk.mmoe_fused_infer(torch.randn(4, 11), torch.zeros(4, dtype=torch.long),
                            [t(s) for s in ex], t(gate), [t(s) for s in tw], t(out))
    with pytest.raises(ValueError):
        pk.mmoe_fused_infer(emb, torch.zeros(4), [t(s) for s in ex], t(gate),
                            [t(s) for s in tw], t(out))
    with pytest.raises(ValueError):
        pk.mmoe_fused_infer(emb, torch.zeros(4, dtype=torch.long), [t(s) for s in ex],
                            t(gate), [], t(out))


@pytest.mark.parametrize("block_rows", [0, 8, 12, 24, 80, 1024, 16.0])
def test_fused_wrapper_rejects_block_rows_off_the_tile_rule(block_rows):
    """The kernel's tile rule (a multiple of 16 up to 64) holds on the CPU
    too, where the plain version runs."""
    r = np.random.default_rng(0)
    ex, gate, tw, out = _random_stages(r, 10, 2, 2, (6,), (3,))
    t = lambda s: tuple(torch.tensor(a) for a in s)
    with pytest.raises(ValueError, match="block_rows"):
        pk.mmoe_fused_infer(torch.randn(4, 10), torch.zeros(4, dtype=torch.long),
                            [t(s) for s in ex], t(gate), [t(s) for s in tw], t(out),
                            block_rows=block_rows)


@pytest.mark.parametrize("block_rows", [16, 32, 48, 64, None])
def test_fused_wrapper_takes_every_tile_of_the_rule(block_rows):
    r = np.random.default_rng(block_rows or 0)
    ex, gate, tw, out = _random_stages(r, 10, 3, 2, (6,), (3,))
    t = lambda s: tuple(torch.tensor(a) for a in s)
    args = (torch.randn(5, 10), torch.tensor([0, 1, 1, -1, 7]), [t(s) for s in ex], t(gate),
            [t(s) for s in tw], t(out))
    assert torch.equal(pk.mmoe_fused_infer(*args, block_rows=block_rows),
                       pk.mmoe_fused_infer_ref(*args))


@pytest.mark.parametrize("oob_domains", [False, True])
@pytest.mark.parametrize("dims", [((16, 8), (4,)), ((24, 12, 6), (8, 4))])
def test_mmoe_apply_and_fused_eval_match_jax(oob_domains, dims):
    jm, params, state, pm = _models(*dims)
    xj, xt = _batch(45, seed=3, oob_domains=oob_domains)
    want, _ = jm.apply(params, state, xj, train=False, rng=None)
    want_fused = jm.apply_fused_eval(params, state, xj)
    with torch.no_grad():
        got = pm.apply(xt, train=False)
        got_fused = pm.apply_fused_eval(xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_fused.numpy(), np.asarray(want_fused),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_fused.numpy(), got.numpy(), rtol=RTOL, atol=ATOL)


def test_mmoe_train_forward_matches_jax():
    jm, params, state, pm = _models()
    xj, xt = _batch(40, seed=4)
    w = np.ones(40, np.float32)
    w[-9:] = 0.0
    want, new_state = jm.apply(params, state, xj, train=True,
                               rng=jax.random.PRNGKey(0), w=jnp.asarray(w))
    with torch.no_grad():
        got = pm.apply(xt, train=True, w=torch.tensor(w))
    keep = w > 0
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               rtol=RTOL, atol=ATOL)
    for bank in ("experts", "gates", "towers"):
        for i, s in enumerate(new_state[bank]["layers"]):
            bn = getattr(pm, bank).layers[i].bn
            np.testing.assert_allclose(bn.mean.numpy(), np.asarray(s["mean"]),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(bn.var.numpy(), np.asarray(s["var"]),
                                       rtol=RTOL, atol=ATOL)


def test_fold_cache_follows_weights():
    """A fold taken before a weight change is stale; a fresh one is not."""
    _, _, _, pm = _models()
    _, xt = _batch(16, seed=5)
    with torch.no_grad():
        folded = pm.fold_eval()
        pm.towers.layers[0].bn.mean.add_(0.5)
        stale = pm.apply_fused_eval(xt, folded=folded)
        fresh = pm.apply_fused_eval(xt)
        want = pm.apply(xt)
    np.testing.assert_allclose(fresh.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert np.abs(stale.numpy() - want.numpy()).max() > 1e-4


def test_base_template_matches_jax():
    from scenario_wise_rec_tpu.models.base import Base as JBase
    from scenario_wise_rec_tpu_torch.models import Base as PBase

    jm = JBase(_feats(jf), D)
    params, _ = jm.init(jax.random.PRNGKey(2))
    pm = PBase(_feats(pf), D, device="cpu",
               generator=port_config.make_generator(torch.device("cpu"), 0))
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, params))
    xj, xt = _batch(30, seed=6, oob_domains=True)
    want, _ = jm.apply(params, {}, xj)
    np.testing.assert_array_equal(pm.apply(xt).detach().numpy(), np.asarray(want))


def test_mmoe_state_dict_layout():
    _, _, _, pm = _models()
    keys = set(pm.state_dict())
    assert "embedding.packed" in keys
    assert "experts.layers.1.lin.w" in keys and "towers.out.b" in keys
    assert "gates.layers.0.bn.var" in keys and "gates.out.w" not in keys
    assert pm.experts.layers[0].lin.w.shape == (2, 2 + 5 * 8, 16)
    assert pm.towers.layers[0].lin.w.shape == (D, 8, 4)
