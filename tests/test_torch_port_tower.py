"""The plain version of SharedBottom's fused kernel against the JAX kernel
(Pallas in interpret mode) on skewed domains, on int64 ids far outside
``[0, D)``, without a head, a trunk or a tower stage and at a ragged B; the
card's tile rule and shape limits on the CPU. Inputs are made with numpy
from a seed and fed to both. The model, its fused eval and the first cases
of the plain version are in ``test_torch_port_models.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.ops.pallas import tower_infer as jk  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import tower_infer as pk  # noqa: E402

# the JAX package's own fused-kernel tolerance: sums in another order
RTOL, ATOL = 1e-5, 1e-6


def _affines(r, lead, dims):
    return [(((i ** -0.5) * r.normal(size=lead + (i, o))).astype(np.float32),
             (0.1 * r.normal(size=lead + (o,))).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def _weights(r, F, D, trunk, towers, head):
    """Random folded trunk, towers and head (None without one)."""
    tr = _affines(r, (), [F] + trunk)
    w_in = trunk[-1] if trunk else F
    tw = _affines(r, (D,), [w_in] + towers)
    out = _affines(r, (D,), [towers[-1] if towers else w_in, 1])[0] if head else None
    return tr, tw, out


def _as(stages, f):
    return [tuple(f(a) for a in s) for s in stages]


def _torch_args(weights):
    tr, tw, out = weights
    t = lambda s: _as(s, torch.tensor)
    return t(tr), t(tw), None if out is None else t([out])[0]


def _skewed(r, B, D):
    """90 % of the rows in domain D - 1, the rest spread over the others."""
    did = np.where(r.random(B) < 0.9, D - 1, r.integers(0, D, B))
    assert (did == D - 1).mean() >= 0.9
    return did


def _int64_wide(r, B, D):
    """int64 ids far outside [0, D), ± 2^32 offsets among them: each is taken
    modulo 2^32 as int32, then clipped, as JAX's ``astype(int32)`` and the
    card take them."""
    wide = np.array([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, -2**31 - 7, 2**40,
                     -3], np.int64)
    return np.where(r.random(B) < 0.5, wide[r.integers(0, len(wide), B)],
                    r.integers(0, D, B)).astype(np.int64)


def _in_range(r, B, D):
    return r.integers(0, D, B)


@pytest.mark.parametrize("ids", [_skewed, _int64_wide])
@pytest.mark.parametrize("cfg", [
    # (B, F, D, trunk dims, tower dims, head)
    (64, 40, 3, [32], [24, 16, 8], True),    # Ali-CCP's ladder, narrowed
    (45, 30, 4, [16, 12], [6, 1], False),    # no head: the last tower stage 1 wide
    (37, 26, 3, [], [9, 5], True),           # no trunk stage
    (50, 20, 2, [10], [], True),             # no tower stage: the head on the trunk
    (41, 18, 5, [], [], True),               # the head alone, on the embedding
])
def test_tower_ref_matches_jax_kernel_on_ids(cfg, ids):
    B, F, D, trunk, towers, head = cfg
    r = np.random.default_rng(B + len(trunk) + len(towers))
    weights = _weights(r, F, D, trunk, towers, head)
    emb = r.normal(size=(B, F)).astype(np.float32)
    did = ids(r, B, D)
    tr, tw, out = weights
    j = lambda s: _as(s, jnp.asarray)
    want = jk.trunk_towers_fused_infer(
        jnp.asarray(emb), jnp.asarray(did), j(tr), j(tw),
        None if out is None else j([out])[0], block_rows=16, interpret=True)
    args = (torch.tensor(emb), torch.tensor(did), *_torch_args(weights))
    got = pk.trunk_towers_fused_infer_ref(*args)
    assert got.shape == (B,) and args[1].dtype == torch.int64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    before = pk.trunk_towers_fused_infer.launches
    np.testing.assert_array_equal(pk.trunk_towers_fused_infer(*args).numpy(), got.numpy())
    assert pk.trunk_towers_fused_infer.launches == before  # the plain version on the CPU


@pytest.mark.parametrize("B", [1, 15, 17, 33, 100])
def test_tower_ref_matches_jax_kernel_at_ragged_b(B):
    """B not a multiple of the JAX kernel's tile (16) nor of the card's:
    the padded rows change no real row."""
    r = np.random.default_rng(1000 + B)
    weights = _weights(r, 24, 3, [16], [8, 4], True)
    emb = r.normal(size=(B, 24)).astype(np.float32)
    did = _in_range(r, B, 3)
    tr, tw, out = weights
    j = lambda s: _as(s, jnp.asarray)
    want = jk.trunk_towers_fused_infer(jnp.asarray(emb), jnp.asarray(did), j(tr), j(tw),
                                       j([out])[0], block_rows=16, interpret=True)
    got = pk.trunk_towers_fused_infer(torch.tensor(emb), torch.tensor(did),
                                      *_torch_args(weights))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows", [8, 12, 24, 72, 80, 0, -16, 16.0])
def test_tower_tile_rule_raises_on_the_cpu(rows):
    """The card's tile rule (a multiple of 16 up to 64, or None) holds on the
    CPU too, where the plain version runs: a call that would raise on the
    card raises here."""
    r = np.random.default_rng(5)
    args = (torch.tensor(r.normal(size=(21, 18)).astype(np.float32)),
            torch.tensor(r.integers(-1, 4, 21)),
            *_torch_args(_weights(r, 18, 3, [12], [8, 4], True)))
    with pytest.raises(ValueError, match="block_rows"):
        pk.trunk_towers_fused_infer(*args, block_rows=rows)
    want = pk.trunk_towers_fused_infer_ref(*args)
    for ok in (16, 32, 48, 64, None):
        torch.testing.assert_close(pk.trunk_towers_fused_infer(*args, block_rows=ok), want,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n_stages, D, ok", [
    (9, 3, True),        # a deep ladder: [5] x 8 and the head
    (96, 256, True),     # the limits themselves
    (97, 3, False),      # one stage past them
    (2, 257, False),     # one domain past them
])
def test_tower_card_limits(n_stages, D, ok):
    """The limits the wrapper's docstring names, held before a launch: at
    most MAX_STAGES stages (trunk, towers and head) and MAX_DOMAINS
    domains."""
    if ok:
        pk.check_card_limits(n_stages, D)
    else:
        with pytest.raises(ValueError, match="at most"):
            pk.check_card_limits(n_stages, D)


def test_tower_shapes_the_wrapper_refuses():
    """Without a head the last stage must be 1 wide; a tower stage or a head
    is needed; a stage that does not follow its input's width raises."""
    r = np.random.default_rng(9)
    tr, tw, out = _torch_args(_weights(r, 12, 2, [7], [5] * 8, True))
    emb, did = torch.randn(6, 12), torch.zeros(6, dtype=torch.long)
    assert pk.trunk_towers_fused_infer(emb, did, tr, tw, out).shape == (6,)
    with pytest.raises(ValueError, match="width 1"):
        pk.trunk_towers_fused_infer(emb, did, tr, tw, None)
    with pytest.raises(ValueError, match="tower stage or a head"):
        pk.trunk_towers_fused_infer(emb, did, tr, [], None)
    with pytest.raises(ValueError, match="does not follow"):
        pk.trunk_towers_fused_infer(emb, did, tr, tw[1:], out)
