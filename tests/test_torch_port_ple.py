"""The plain version of PLE's fused kernel against the JAX kernel (Pallas in
interpret mode) on skewed domains and on int64 ids far outside ``[0, D)``,
at 1, 2 and 3 levels; the card's tile rule and schedule limits on the CPU.
Inputs are made with numpy from a seed and fed to both. The models, their
fused eval and the other cases of the plain version are in
``test_torch_port_models.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.ops.pallas import ple_infer as jk  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import ple_infer as pk  # noqa: E402

# the JAX package's own fused-kernel tolerance: sums in another order
RTOL, ATOL = 1e-5, 1e-6
ALI = [256, 128, 64, 32, 16, 8]  # Ali-CCP's expert ladder


def _affines(r, lead, dims):
    return [(((i ** -0.5) * r.normal(size=lead + (i, o))).astype(np.float32),
             (0.1 * r.normal(size=lead + (o,))).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def _weights(r, F, D, S, n_sh, levels, towers, gate_hidden=()):
    """Random folded levels (each ``(spec, shared, gates, shared gate)``), the
    towers and the head; ``levels`` lists each level's expert dims."""
    out, width = [], F
    for li, dims in enumerate(levels):
        last = li == len(levels) - 1
        out.append((_affines(r, (D, S), [width] + dims), _affines(r, (n_sh,), [width] + dims),
                    _affines(r, (D,), [width, *gate_hidden, S + n_sh]),
                    None if last else _affines(r, (), [width, *gate_hidden, D * S + n_sh])))
        width = dims[-1]
    tw = _affines(r, (D,), [width] + towers)
    return out, tw, _affines(r, (D,), [towers[-1] if towers else width, 1])[0]


def _as(stages, f):
    return [tuple(f(a) for a in s) for s in stages]


def _torch_args(weights):
    lv, tw, head = weights
    t = lambda s: _as(s, torch.tensor)
    return ([pk.LevelSpec(t(a), t(b), t(c), None if d is None else t(d)) for a, b, c, d in lv],
            t(tw), t([head])[0])


def _skewed(r, B, D):
    """90 % of the rows in domain D - 1, the rest spread over the others."""
    did = np.where(r.random(B) < 0.9, D - 1, r.integers(0, D, B))
    assert (did == D - 1).mean() >= 0.9
    return did


def _int64_wide(r, B, D):
    """int64 ids far outside [0, D): each is taken modulo 2^32 as int32, then
    clipped, as JAX's ``astype(int32)`` and the card take them."""
    wide = np.array([2**32 + 1, 2**31, 2**33 + 2, -2**32 + 2, -2**31 - 7, 2**40, -3],
                    np.int64)
    return np.where(r.random(B) < 0.5, wide[r.integers(0, len(wide), B)],
                    r.integers(0, D, B)).astype(np.int64)


@pytest.mark.parametrize("ids", [_skewed, _int64_wide])
@pytest.mark.parametrize("cfg", [
    # (B, F, D, S, n_sh, levels' expert dims, tower dims, gate hidden)
    (64, 40, 3, 2, 1, [[24, 16, 8]], [8], ()),          # one level, Ali-CCP's S and n_sh
    (45, 30, 3, 2, 2, [[12, 8], [6]], [4], ()),         # two levels
    (37, 26, 4, 1, 2, [[8], [9], [5]], [], (6,)),       # three levels, 2-stage gates
])
def test_fused_infer_ref_matches_jax_kernel_on_ids(cfg, ids):
    B, F, D, S, n_sh, levels, towers, gate_hidden = cfg
    r = np.random.default_rng(B + len(levels))
    weights = _weights(r, F, D, S, n_sh, levels, towers, gate_hidden)
    emb = r.normal(size=(B, F)).astype(np.float32)
    did = ids(r, B, D)
    lv, tw, head = weights
    j = lambda s: _as(s, jnp.asarray)
    want = jk.ple_fused_infer(
        jnp.asarray(emb), jnp.asarray(did),
        [jk.LevelSpec(j(a), j(b), j(c), None if d is None else j(d)) for a, b, c, d in lv],
        j(tw), j([head])[0], block_rows=16, interpret=True)
    args = (torch.tensor(emb), torch.tensor(did), *_torch_args(weights))
    got = pk.ple_fused_infer_ref(*args)
    assert got.shape == (B,) and args[1].dtype == torch.int64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    before = pk.ple_fused_infer.launches
    np.testing.assert_array_equal(pk.ple_fused_infer(*args).numpy(), got.numpy())
    assert pk.ple_fused_infer.launches == before  # the plain version on the CPU


@pytest.mark.parametrize("rows", [8, 12, 24, 80, 0, -16, 16.0])
def test_fused_infer_tile_rule_raises_on_the_cpu(rows):
    """The card's tile rule (a multiple of 16 up to 64, or None) holds on the
    CPU too, where the plain version runs: a call that would raise on the
    card raises here."""
    r = np.random.default_rng(5)
    args = (torch.tensor(r.normal(size=(21, 18)).astype(np.float32)),
            torch.tensor(r.integers(-1, 4, 21)),
            *_torch_args(_weights(r, 18, 3, 2, 1, [[8, 4], [4]], [4])))
    with pytest.raises(ValueError, match="block_rows"):
        pk.ple_fused_infer(*args, block_rows=rows)
    want = pk.ple_fused_infer_ref(*args)
    for ok in (16, 32, 48, 64, None):
        torch.testing.assert_close(pk.ple_fused_infer(*args, block_rows=ok), want,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n_level, products, mixes", [
    (1, 20, 3),     # a row's own 2 specific experts of 6 stages, the shared one, its gate, the tower
    (2, 66, 19),    # level 0: 36 specific + 6 shared + 3 gates + the shared gate
    (4, 158, 51),   # the wrapper's MAX_LEVELS
])
def test_schedule_size_at_ali_ccp(n_level, products, mixes):
    """The kernel's schedule at Ali-CCP's widths (3 domains, 2 specific and 1
    shared expert [256, ..., 8], tower [16]) fits a launch's step list."""
    r = np.random.default_rng(n_level)
    levels, tw, _ = _torch_args(_weights(r, 8, 3, 2, 1, [ALI] * n_level, [16]))
    assert pk._schedule_size(levels, 3, 2, 1, len(tw)) == (products, mixes)
    assert products <= pk.MAX_PRODUCTS and mixes <= pk.MAX_MIXES
