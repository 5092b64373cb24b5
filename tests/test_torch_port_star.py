"""The plain version of STAR's fused kernel against the JAX kernel (Pallas in
interpret mode) on skewed domains, on int64 ids far outside ``[0, D)``, at 5
domains, on KuaiRand's ladder at a small F, without aux stages, with one FCN
stage and at a ragged B; the card's tile rule and shape limits on the CPU.
Inputs are made with numpy from a seed and fed to both. The model, its fused
eval and the first cases of the plain version are in
``test_torch_port_models.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.ops.pallas import star_infer as jk  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import star_infer as pk  # noqa: E402

# the JAX package's own fused-kernel tolerance: sums in another order
RTOL, ATOL = 1e-5, 1e-6


def _affines(r, lead, dims):
    return [(((i ** -0.5) * r.normal(size=lead + (i, o))).astype(np.float32),
             (0.1 * r.normal(size=lead + (o,))).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def _inputs(r, B, F, D, fcn, aux):
    """emb, then the kernel's arguments after the ids: the batch's mean and
    rstd, each domain's norm affine, the FCN (ending at width 1), the aux
    stages and the aux head; all numpy."""
    emb = r.normal(size=(B, F)).astype(np.float32)
    mean = emb.mean(0)
    rstd = (1.0 / np.sqrt(emb.var(0) + 1e-6)).astype(np.float32)
    g = r.uniform(0.5, 1.5, (D, F)).astype(np.float32)
    b = (0.1 * r.normal(size=(D, F))).astype(np.float32)
    return emb, (mean, rstd, g, b, _affines(r, (D,), [F] + fcn + [1]),
                 _affines(r, (), [F] + aux), _affines(r, (), [aux[-1] if aux else F, 1])[0])


def _as(args, f):
    """The kernel's arguments with every array passed through ``f``."""
    mean, rstd, g, b, fcn, aux, head = args
    stages = lambda s: [tuple(f(a) for a in st) for st in s]
    return (f(mean), f(rstd), f(g), f(b), stages(fcn), stages(aux),
            tuple(f(a) for a in head))


def _skewed(r, B, D):
    """90 % of the rows (rounded up) in domain D - 1, the rest spread over
    all domains, shuffled."""
    hot = -(-9 * B // 10)
    return r.permutation(np.concatenate([np.full(hot, D - 1), r.integers(0, D, B - hot)]))


def _int64_wide(r, B, D):
    """int64 ids far outside [0, D), ± 2^32 offsets among them: each is taken
    modulo 2^32 as int32, then clipped, as JAX's ``astype(int32)`` and the
    card take them."""
    wide = np.array([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, -2**31 - 7, 2**40,
                     -3], np.int64)
    return np.where(r.random(B) < 0.5, wide[r.integers(0, len(wide), B)],
                    r.integers(0, D, B)).astype(np.int64)


def _check(emb, did, args):
    want = jk.star_fused_infer(jnp.asarray(emb), jnp.asarray(did), *_as(args, jnp.asarray),
                               block_rows=16, interpret=True)
    targs = (torch.tensor(emb), torch.tensor(did), *_as(args, torch.tensor))
    got = pk.star_fused_infer_ref(*targs)
    assert got.shape == (emb.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    before = pk.star_fused_infer.launches
    np.testing.assert_array_equal(pk.star_fused_infer(*targs).numpy(), got.numpy())
    assert pk.star_fused_infer.launches == before  # the plain version on the CPU
    return targs


@pytest.mark.parametrize("ids", [_skewed, _int64_wide])
@pytest.mark.parametrize("cfg", [
    # (B, F, D, fcn dims, aux dims)
    (64, 40, 3, [24, 16, 8], [8]),      # Ali-CCP's ladder, narrowed
    (50, 36, 5, [16, 8], [8]),          # 5 domains
    (48, 24, 5, [128, 64, 32], [32]),   # KuaiRand's ladder at a small F
    (37, 26, 3, [9, 5], []),            # no aux stage: the aux head on the raw row
    (41, 18, 4, [], [6]),               # one FCN stage, F -> 1
    (45, 41, 3, [7, 33, 9, 3], [7]),    # widths not multiples of 8
])
def test_star_ref_matches_jax_kernel_on_ids(cfg, ids):
    B, F, D, fcn, aux = cfg
    r = np.random.default_rng(B + len(fcn) + len(aux))
    emb, args = _inputs(r, B, F, D, fcn, aux)
    did = ids(r, B, D)
    targs = _check(emb, did, args)
    assert targs[1].dtype == torch.int64


@pytest.mark.parametrize("B", [1, 15, 17, 33, 100])
def test_star_ref_matches_jax_kernel_at_ragged_b(B):
    """B not a multiple of the JAX kernel's tile (16) nor of the card's: the
    padded rows change no real row; domain 1 of 3 absent."""
    r = np.random.default_rng(2000 + B)
    emb, args = _inputs(r, B, 24, 3, [16, 8], [8])
    _check(emb, 2 * r.integers(0, 2, B), args)


@pytest.mark.parametrize("rows", [8, 12, 24, 40, 72, 80, 0, -16, 16.0])
def test_star_tile_rule_raises_on_the_cpu(rows):
    """The card's tile rule (a multiple of 16 up to 64, or None) holds on the
    CPU too, where the plain version runs: a call that would raise on the
    card raises here."""
    r = np.random.default_rng(7)
    emb, args = _inputs(r, 21, 18, 3, [12, 4], [5])
    targs = (torch.tensor(emb), torch.tensor(r.integers(-1, 4, 21)),
             *_as(args, torch.tensor))
    with pytest.raises(ValueError, match="block_rows"):
        pk.star_fused_infer(*targs, block_rows=rows)
    want = pk.star_fused_infer_ref(*targs)
    for ok in (16, 32, 48, 64, None):
        torch.testing.assert_close(pk.star_fused_infer(*targs, block_rows=ok), want,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n_stages, D, ok", [
    (9, 3, True),        # Ali-CCP's: the aux stage, its head and 7 FCN stages
    (96, 256, True),     # the limits themselves
    (97, 3, False),      # one stage past them
    (2, 257, False),     # one domain past them
])
def test_star_card_limits(n_stages, D, ok):
    """The limits the wrapper's docstring names, held before a launch and
    named by it: at most MAX_STAGES stages (the aux stages, the aux head and
    the FCN stages) and MAX_DOMAINS domains."""
    if ok:
        pk.check_card_limits(n_stages, D, "star_fused_infer")
    else:
        with pytest.raises(ValueError, match="star_fused_infer takes at most"):
            pk.check_card_limits(n_stages, D, "star_fused_infer")
