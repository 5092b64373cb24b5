"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit; without a card
each skips (decided inside the fixture, never at import). On a machine with
a card:

    python -m pytest tests/test_torch_port_cuda.py -q
"""

import copy
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenario_wise_rec_tpu_torch.ops.kernels import mmoe_infer as k  # noqa: E402

TOL = 1e-5  # f32 FMA order differs between the kernel and cuBLAS


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _stages(gen, F, E, D, expert_dims, tower_dims):
    def n(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    ex, w = [], F
    for o in expert_dims:
        ex.append((n(E, w, o, scale=w ** -0.5), n(E, o, scale=0.1)))
        w = o
    gate = (n(D, F, E, scale=F ** -0.5), n(D, E))
    tw, h = [], w
    for o in tower_dims:
        tw.append((n(D, h, o, scale=h ** -0.5), n(D, o, scale=0.1)))
        h = o
    return ex, gate, tw, (n(D, h, 1, scale=h ** -0.5), n(D, 1))


ALI = (376, 3, 3, (256, 128, 64, 32, 16, 8), (16,))


@pytest.mark.parametrize("cfg", [
    # (B, F, E, D, expert dims, tower dims, block_rows; None: the kernel's choice)
    (4096, *ALI, None),                      # Ali-CCP
    (4096, *ALI, 16),
    (4096, *ALI, 48),                        # 48- and 64-row tiles: a smaller ring
    (200, *ALI, 64),
    (333, 41, 2, 2, (7,), (3,), 16),         # widths not multiples of 4
    (130, 50, 16, 4, (33,), (40, 70), 48),   # most experts (2 a block); towers wider than a warp
    (64, 12, 2, 1, (8,) * 8, (4,) * 8, 32),  # deepest stacks
    (17, 9, 1, 3, (5,), (), 16),             # one expert, no tower stage
    (1, *ALI, 32),                           # one row
    (31, *ALI, 32),                          # one row below a tile
    (33, *ALI, 32),                          # one above: a last tile of one row
    (97, *ALI, 32),                          # a last tile of one row after three full ones
    (1000, *ALI, 32),                        # 32 tiles, the last of 8 rows
    (200, 41, 3, 2, (33, 17), (9,), 48),     # widths not multiples of the mma tile (8)
    (200, 377, 3, 3, (257, 129, 9), (16,), 16),  # ... and a layer past one 256-column pass
    (300, 64, 9, 2, (300, 20), (5,), 48),    # 9 experts; 300 columns in two passes
    (4096, 800, 5, 5, (32,), (16,), None),   # KuaiRand's MMOE: wide F, 5 domains and experts
    (500, 1000, 5, 5, (32,), (16,), None),   # a ring smaller than 3 full slots at 32 rows
    (100, 2000, 5, 5, (32,), (16,), None),   # 32 rows do not fit: 16
    (100, 3000, 2, 2, (8,), (4,), 16),
])
def test_mmoe_kernel_matches_plain(gen, cfg):
    B, F, E, D, ed, td, rows = cfg
    st = _stages(gen, F, E, D, ed, td)
    emb = torch.randn(B, F, generator=gen, device="cuda")
    did = torch.randint(-2, D + 3, (B,), generator=gen, device="cuda")
    before = k.mmoe_fused_infer.launches
    got = k.mmoe_fused_infer(emb, did, *st, block_rows=rows)
    torch.cuda.synchronize()
    assert k.mmoe_fused_infer.launches == before + 1
    want = k.mmoe_fused_infer_ref(emb, did, *st)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_mmoe_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of emb leaves every other row of the
    tile as the plain version computes it."""
    st = _stages(gen, *ALI[:3], *ALI[3:])
    emb = torch.randn(100, ALI[0], generator=gen, device="cuda")
    emb[50, 7] = float("nan")
    did = torch.randint(0, 3, (100,), generator=gen, device="cuda")
    got = k.mmoe_fused_infer(emb, did, *st, block_rows=32)
    want = k.mmoe_fused_infer_ref(emb, did, *st)
    assert bool(torch.isnan(got[50])) and bool(torch.isnan(want[50]))
    rest = torch.arange(100, device="cuda") != 50
    assert bool(torch.isfinite(got[rest]).all())
    assert (got[rest] - want[rest]).abs().max().item() <= TOL


def test_mmoe_kernel_layout_at_the_alicpp_shape(gen):
    """The kernel's shared memory: at the Ali-CCP shape a 16- or 32-row tile
    leaves room for the full ring of 3 slots of 9216 floats; 48- and 64-row
    tiles fit in an H100 block's 232,448 bytes with a smaller ring, and a
    tile too wide for even the smallest ring (8 rows of the widest weight
    slab a slot) reports more bytes than it is given."""
    lib = k._lib()
    F, E, D, ed, td = ALI
    budget = 232_448

    def smem(rows, F=F, ed=ed, td=td, budget=budget):
        return lib.mmoe_fused_infer_smem_bytes(rows, F, E, len(ed), k.ints([F, *ed]),
                                               len(td), k.ints([ed[-1], *td]), budget)

    # the ring's 6 barriers in 64 bytes; rows x (388 emb + 260 + 132
    # activations + 8 mixture + 3 gates) floats and their domain ids; the ring
    tile = {rows: 64 + 4 * rows * 791 + 4 * rows for rows in (16, 32, 48, 64)}
    assert smem(16) == tile[16] + 4 * 3 * 9216
    assert smem(32) == tile[32] + 4 * 3 * 9216 == 212_032
    for rows in (48, 64):  # the slots take what is left, in 16-byte steps
        slot = (budget - tile[rows]) // 4 // 3 // 4 * 4
        assert 8 * 264 <= slot < 9216 and smem(rows) == tile[rows] + 4 * 3 * slot <= budget
    assert smem(16, budget=0) == tile[16] + 4 * 3 * 8 * 264  # the smallest ring
    wide = smem(32, F=2000, ed=(32,), td=(16,))
    assert wide > budget and smem(16, F=2000, ed=(32,), td=(16,)) <= budget


def test_mmoe_kernel_wraps_int64_ids_as_int32(gen):
    """An int64 domain id is taken modulo 2^32 as an int32 before it is
    clipped, as the plain version (and the JAX reference's int32 ids) take
    it."""
    st = _stages(gen, 20, 2, 3, (8,), (4,))
    did = torch.tensor([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, 1, 7, -5],
                       device="cuda")
    emb = torch.randn(did.shape[0], 20, generator=gen, device="cuda")
    got = k.mmoe_fused_infer(emb, did, *st)
    assert torch.equal(got, k.mmoe_fused_infer(emb, did.to(torch.int32), *st))
    assert torch.equal(got, k.mmoe_fused_infer(
        emb, torch.tensor([1, 0, 0, 2, 2, 1, 2, 0], device="cuda"), *st))
    assert (got - k.mmoe_fused_infer_ref(emb, did, *st)).abs().max().item() <= TOL


def test_mmoe_kernel_int32_ids_and_empty_batch(gen):
    st = _stages(gen, 20, 2, 2, (8,), (4,))
    emb = torch.randn(50, 20, generator=gen, device="cuda")
    did = torch.randint(0, 2, (50,), generator=gen, device="cuda")
    a = k.mmoe_fused_infer(emb, did.to(torch.int32), *st)
    b = k.mmoe_fused_infer(emb, did, *st)
    assert torch.equal(a, b)
    assert k.mmoe_fused_infer(emb[:0], did[:0], *st).shape == (0,)


def test_mmoe_kernel_rejects_what_it_does_not_take(gen):
    st = _stages(gen, 20, 2, 2, (8,), (4,))
    emb = torch.randn(10, 20, generator=gen, device="cuda")
    did = torch.zeros(10, dtype=torch.long, device="cuda")
    for rows in (8, 12, 24, 80):  # not a multiple of 16 up to 64
        with pytest.raises(ValueError):
            k.mmoe_fused_infer(emb, did, *st, block_rows=rows)
    with pytest.raises(ValueError):
        k.mmoe_fused_infer(emb.double(), did, *st)
    with pytest.raises(ValueError):
        k.mmoe_fused_infer(emb.t().contiguous().t(), did, *st)
    with pytest.raises(ValueError):
        k.mmoe_fused_infer(emb, did.cpu(), *st)
    big = _stages(gen, 9000, 2, 2, (8,), (4,))  # the emb tile exceeds shared memory
    with pytest.raises(RuntimeError, match="shared memory"):
        k.mmoe_fused_infer(torch.randn(16, 9000, device="cuda"), did[:1].expand(16).contiguous(),
                           *big)
    wide = _stages(gen, 2000, 5, 5, (32,), (16,))  # fits in 16 rows, not in 32
    with pytest.raises(RuntimeError, match="shared memory"):
        k.mmoe_fused_infer(torch.randn(32, 2000, device="cuda"), did[:1].expand(32).contiguous(),
                           *wide, block_rows=32)


# -- sorted_dense_adam_apply ------------------------------------------------

from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa  # noqa: E402

# The kernel and its plain version round every elementwise step alike; they
# differ only in the order in which three or more duplicate gradients are
# summed (the plain version's index_add_ uses atomics, in a varying order).
# Two f32 sums of the same n terms differ by at most 2 (n-1) 2^-24 sum|g|.
# That keeps the moments well inside SA_ATOL + SA_RTOL |v|, but not always
# the table: where a row's G = sum g + wd w lies within that order error (or
# a few eps) of zero, Adam's first step lr G / (|G| + eps) moves by up to
# 2 lr on the order alone. _AdamOrderRule counts such elements and holds
# them to looser bounds; every other element keeps SA_ATOL + SA_RTOL |v|.
SA_RTOL, SA_ATOL = 1e-5, 1e-6


class _AdamOrderRule:
    """The counted excuse rule of the dense-Adam gates (the same rule as
    ``chip_smoke.py``'s ``AdamOrderRule``). An element of the table, mu or
    nu is excused from SA_ATOL + SA_RTOL |v| from the step on where its row
    took at least 3 duplicate gradients and |G| <= ORDER err + EPS eps (G =
    sum g + wd w; err = (n-1) 2^-24 sum|g|, the order error of one f32 sum of
    the n gradients). An excused element is still held: the table to
    LR_STEPS lr more per step since (a step moves an element by about lr at
    most, so two sides by 2 lr); mu and nu to the gap the order can open in
    their own scale: with dG the most the two sides' G can differ (2 err,
    plus wd x the table's own slack), mu' = b1 mu + (1-b1) G gives
    b1 slack + (1-b1) dG, and nu' = b2 nu + (1-b2) G^2 gives b2 slack +
    (1-b2) dG (2 |G|max + dG), |G|max = sum|g| + wd |w|. Excused elements
    are counted and may be at most SHARE of the table's elements."""

    ORDER, EPS, LR_STEPS, SHARE = 2.0, 4.0, 4.0, 1e-4

    def __init__(self, table):
        self.excused = torch.zeros(table.shape, dtype=torch.bool, device=table.device)
        self.slack = {w: torch.zeros_like(table) for w in ("table", "mu", "nu")}

    def step(self, before, ids, g, hp):
        """One step's gradients ``g`` at ``ids`` (any order; ids outside
        [0, V) add nothing) on the plain version's table ``before`` it."""
        lr, wd, b1, b2, _, _, eps = hp
        ids = ids.long()
        keep = (ids >= 0) & (ids < before.shape[0])
        rows, inv, n = torch.unique(ids[keep], return_inverse=True, return_counts=True)
        g64 = g[keep].double()
        s = torch.zeros(rows.numel(), g.shape[1], dtype=torch.float64,
                        device=g.device).index_add_(0, inv, g64)
        a = torch.zeros_like(s).index_add_(0, inv, g64.abs())
        err = (n[:, None] - 1).double() * 2.0 ** -24 * a
        G = s + wd * before[rows].double()
        near = (n[:, None] >= 3) & (G.abs() <= self.ORDER * err + self.EPS * eps)
        self.excused[rows] = self.excused[rows] | near
        sl = self.slack
        dG = wd * sl["table"]
        dG[rows] += (2 * err).float()
        gmax = wd * before.abs()
        gmax[rows] += a.float()
        sl["mu"] = b1 * sl["mu"] + (1 - b1) * dG
        sl["nu"] = b2 * sl["nu"] + (1 - b2) * dG * (2 * gmax + dG)
        sl["table"] = torch.where(self.excused, sl["table"] + self.LR_STEPS * lr, 0.0)

    def close(self, got, want, what):
        """``got`` against ``want`` (what: "table", "mu" or "nu")."""
        slack = torch.where(self.excused, self.slack[what], 0.0)
        return bool(((got - want).abs() <= SA_ATOL + SA_RTOL * want.abs() + slack).all())

    def count(self):
        n = int(self.excused.sum())
        assert n <= self.SHARE * self.excused.numel(), f"{n} excused elements"
        return n


def _sa_case(gen, V, D, ids):
    table = torch.randn(V, D, generator=gen, device="cuda")
    mu = 1e-3 * torch.randn(V, D, generator=gen, device="cuda")
    nu = 1e-6 * torch.rand(V, D, generator=gen, device="cuda")
    return table, mu, nu, ids.to("cuda")


def _zipf_ids(r, n, V):
    return np.minimum(r.zipf(1.3, n) - 1, V - 1)


def _run_steps(gen, V, D, ids, block_rows=sa.DEFAULT_BLOCK_ROWS, steps=3):
    table, mu, nu, ids = _sa_case(gen, V, D, ids)
    table0 = table.clone()
    ref = [t.clone() for t in (table, mu, nu)]
    rule = _AdamOrderRule(table)
    for t in range(1, steps + 1):
        g = 1e-3 * torch.randn(ids.shape[0], D, generator=gen, device="cuda")
        sid, gs = sa.owner_sorted_grads(ids, g)
        hp = sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
        before = sa.sorted_dense_adam_apply.launches
        sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp, block_rows=block_rows)
        torch.cuda.synchronize()
        assert sa.sorted_dense_adam_apply.launches == before + 1
        rule.step(ref[0], sid, gs, hp)
        sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
        for got, want, what in zip((table, mu, nu), ref, ("table", "mu", "nu")):
            assert bool(torch.isfinite(got).all())
            assert rule.close(got, want, what), (what, (got - want).abs().max().item())
    rule.count()
    return table0, table


def test_sorted_adam_hot_row(gen):
    r = np.random.default_rng(0)
    V, per = 23 * 5000, 4096
    parts = [np.full(per, 17)]  # one feature's 4096 ids all one row
    parts += [f * 5000 + _zipf_ids(r, per, 5000) for f in range(1, 23)]
    _run_steps(gen, V, 16, torch.as_tensor(np.concatenate(parts)))


@pytest.mark.parametrize("kernel", ["sorted", "fused"])
@pytest.mark.parametrize("fault", [None, "dropped_duplicate", "skipped_row"])
def test_adam_order_rule_catches_planted_faults(gen, kernel, fault):
    """The order rule excuses only elements whose sum lies within its order error
    of zero: one step of either dense-Adam kernel on the hot row with one of
    its 4096 duplicates left out of the kernel's input, or with one touched
    row's update undone, fails it; the step as it is passes."""
    from scenario_wise_rec_tpu_torch.train.optim import segment_sorted_ids

    r = np.random.default_rng(0)
    V, D, per = 23 * 5000, 16, 4096
    parts = [np.full(per, 17)] + [f * 5000 + _zipf_ids(r, per, 5000) for f in range(1, 23)]
    ids = torch.as_tensor(np.concatenate(parts)).cuda()
    table, mu, nu, _ = _sa_case(gen, V, D, ids)
    ref = [t.clone() for t in (table, mu, nu)]
    g = 1e-3 * torch.randn(ids.shape[0], D, generator=gen, device="cuda")
    hp = sa.adam_hparams(1, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    rule = _AdamOrderRule(table)
    rule.step(ref[0], ids, g, hp)
    kfa.fused_dense_adam_ref(*ref, g, ids, hp)  # the plain version, every gradient
    gk = g.clone()
    if fault == "dropped_duplicate":
        gk[0] = 0.0  # ids[0] is the hot row's
    saved = [t.clone() for t in (table, mu, nu)]
    if kernel == "sorted":
        sa.sorted_dense_adam_apply(table, mu, nu, *sa.owner_sorted_grads(ids, gk), hp)
    else:
        segs = [(f"s{f}", f * per, per) for f in range(23)]
        kfa.fused_dense_adam_apply(table, mu, nu, gk, *segment_sorted_ids(ids, segs), hp)
    if fault == "skipped_row":
        row = int(ids[per])  # a touched row of feature 1
        for t, before in zip((table, mu, nu), saved):
            t[row] = before[row]
    torch.cuda.synchronize()
    held = [rule.close(got, want, what)
            for got, want, what in zip((table, mu, nu), ref, ("table", "mu", "nu"))]
    rule.count()
    assert all(held) if fault is None else not all(held), held


@pytest.mark.parametrize("D,block_rows", [(16, 256), (8, 100), (3, 64), (16, 1024)])
def test_sorted_adam_empty_tiles_and_out_of_range_ids(gen, D, block_rows):
    V = 1000 * block_rows // 100 + 37  # not a multiple of the tile
    ids = torch.randint(0, V // 3, (600,), generator=gen, device="cuda")  # upper tiles empty
    ids = torch.cat([ids, torch.tensor([-1, -7, V, V + 3], device="cuda")])
    _run_steps(gen, V, D, ids, block_rows=block_rows)


def test_sorted_adam_no_ids_still_decays(gen):
    table0, table = _run_steps(gen, 5000, 16, torch.zeros(0, dtype=torch.long))
    assert bool((table != table0).any(dim=1).all())  # every row moved


def test_sorted_adam_precision_dials_agree_and_bad_input_raises(gen):
    V, D = 3000, 16
    ids = torch.randint(0, V, (500,), generator=gen, device="cuda")
    g = torch.randn(500, D, generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(ids, g)
    hp = sa.adam_hparams(1, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    base = _sa_case(gen, V, D, ids)[:3]
    outs = []
    for precision in (None, "fast", "split", "highest"):
        t = [x.clone() for x in base]
        sa.sorted_dense_adam_apply(*t, sid, gs, hp, precision=precision, chunk_ids=256)
        outs.append(t)
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    with pytest.raises(ValueError):
        sa.sorted_dense_adam_apply(*base, sid.long(), gs, hp)
    with pytest.raises(ValueError):
        sa.sorted_dense_adam_apply(*base, sid, gs.cpu(), hp)
    with pytest.raises(ValueError):
        sa.sorted_dense_adam_apply(*base, sid, gs, hp, block_rows=100_000)


def test_sorted_trainer_two_in_place_steps_on_a_live_parameter(gen):
    """Two back-to-back sorted train steps on the card: the kernel updates
    the live ``embedding.packed`` parameter in place while autograd holds
    only the gathered rows, so nothing trips; the result matches the CPU."""
    import copy

    from scenario_wise_rec_tpu_torch.core import DenseFeature, SparseFeature
    from scenario_wise_rec_tpu_torch.models import MMOE
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    feats = [DenseFeature("d0")] + [SparseFeature(f"s{i}", 60, embed_dim=8)
                                    for i in range(3)]
    cpu_model = MMOE(feats, 2, n_expert=2, expert_params={"dims": [16]},
                     tower_params={"dims": [4]}, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model)
    kw = dict(sparse_embedding_updates=True, sparse_update_impl="sorted")
    tc = CTRTrainer(cpu_model, device="cpu", **kw)
    tg = CTRTrainer(gpu_model, **kw)
    packed = gpu_model.embedding.packed
    before = packed.detach().clone()
    r = np.random.default_rng(0)
    launches = sa.sorted_dense_adam_apply.launches
    for _ in range(2):
        x = {f"s{i}": r.integers(0, 60, 64) for i in range(3)}
        x["d0"] = r.normal(size=64).astype(np.float32)
        x["domain_indicator"] = r.integers(0, 2, 64)
        y = (r.random(64) < 0.5).astype(np.float32)
        w = np.ones(64, np.float32)
        lc = float(tc._train_step(*tc._device_batch(x, y, w)))
        lg = float(tg._train_step(*tg._device_batch(x, y, w)))
        assert abs(lc - lg) <= 1e-5 * abs(lc)
    torch.cuda.synchronize()
    assert sa.sorted_dense_adam_apply.launches == launches + 2
    assert gpu_model.embedding.packed is packed  # updated in place
    assert bool((packed.detach() != before).any(dim=1).all())  # every row moved
    # as test_torch_port_train.py: Adam steps, BN-cancelled biases at 10 x lr
    for k, v in gpu_model.state_dict().items():
        want = cpu_model.state_dict()[k]
        atol = 1e-2 if k.endswith(("lin.b", "bn.mean")) and ".layers." in f".{k}" else 1e-6
        assert torch.allclose(v.cpu(), want, rtol=1e-4, atol=atol), k


# -- sorted_dense_adam_apply, bf16 storage -----------------------------------
#
# The bf16 form does the plain version's f32 chain on widened values and
# rounds each result to nearest even; the two differ only where the order of
# an f32 duplicate sum moves a value across a rounding boundary. Their f32
# values differ by at most _AdamOrderRule's slack (mu's and nu's for every
# element, the table's for its excused ones), and two f32 values s apart
# round at most s + one ulp apart. Each step starts both from one state (a
# flip persists and can compound across steps); every element must be within
# one ulp, or within its slack plus one ulp (a moment whose update cancels to
# far below its gradient's scale), and the elements that differ at all may
# be at most _AdamOrderRule.SHARE of each array.


def _bf16_ulps(got, want):
    """bf16 values between ``got`` and ``want``, elementwise (the bits in
    sign-magnitude order, so +0 and -0 are one value)."""
    def key(a):
        i = a.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(got) - key(want)).abs()


def _bf16_ulp(x):
    """The bf16 ulp at each element of bf16 ``x`` (the gap away from zero)."""
    mag = x.abs()
    return (mag.view(torch.int16) + 1).view(torch.bfloat16).float() - mag.float()


def _bf16_held(got, want, rule, what):
    ulps = _bf16_ulps(got, want)
    slack = rule.slack[what]
    if what == "table":
        slack = torch.where(rule.excused, slack, 0.0)
    gap = (got.float() - want.float()).abs()
    ok = (ulps <= 1) | (gap <= slack + _bf16_ulp(torch.maximum(got.abs(), want.abs())))
    n = int((ulps > 0).sum())
    return bool(ok.all()) and n <= _AdamOrderRule.SHARE * ulps.numel(), n


def _bf16_trio(gen, V, D, offset=None):
    """table, mu, nu in bf16 [V, D]; with ``offset`` each a view starting
    ``offset`` elements into a larger buffer (contiguous; 16-byte aligned
    only where 2 * offset is a multiple of 16)."""
    vals = (torch.randn(V, D, generator=gen, device="cuda"),
            1e-3 * torch.randn(V, D, generator=gen, device="cuda"),
            1e-6 * torch.rand(V, D, generator=gen, device="cuda"))
    out = []
    for v in vals:
        if offset is None:
            out.append(v.to(torch.bfloat16))
        else:
            buf = torch.zeros(V * D + offset, dtype=torch.bfloat16, device="cuda")
            t = buf[offset:].view(V, D)
            t.copy_(v)
            out.append(t)
    return out


def _run_bf16_steps(gen, V, D, ids, block_rows=None, steps=3, offset=None):
    table, mu, nu = _bf16_trio(gen, V, D, offset)
    table0 = table.clone()
    ids = ids.to("cuda")
    counted = 0
    for t in range(1, steps + 1):
        ref = [x.clone() for x in (table, mu, nu)]
        g = 1e-3 * torch.randn(ids.shape[0], D, generator=gen, device="cuda")
        sid, gs = sa.owner_sorted_grads(ids, g)
        hp = sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
        rule = _AdamOrderRule(ref[0].float())
        rule.step(ref[0].float(), sid, gs, hp)
        f32, bf16 = sa.sorted_dense_adam_apply.launches, sa.sorted_dense_adam_apply.launches_bf16
        sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp, block_rows=block_rows)
        torch.cuda.synchronize()
        assert sa.sorted_dense_adam_apply.launches_bf16 == bf16 + 1
        assert sa.sorted_dense_adam_apply.launches == f32  # the f32 form's count unmoved
        sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
        for got, want, what in zip((table, mu, nu), ref, ("table", "mu", "nu")):
            assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
            held, n = _bf16_held(got, want, rule, what)
            assert held, (what, t, n, int(_bf16_ulps(got, want).max()))
            counted += n
    return table0, table, counted


@pytest.mark.parametrize("V,D", [(5000, 16), (100_003, 16), (100_003, 8), (23 * 5000, 8)])
def test_sorted_adam_bf16_matches_plain(gen, V, D):
    ids = torch.randint(0, V // 3, (6000,), generator=gen, device="cuda")  # upper tiles empty
    ids = torch.cat([ids, torch.tensor([-1, -7, V, V + 3], device="cuda")])
    _run_bf16_steps(gen, V, D, ids)


@pytest.mark.parametrize("block_rows", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("D", [8, 16])
def test_sorted_adam_bf16_every_block_rows(gen, D, block_rows):
    V = 50_021
    ids = torch.randint(0, V, (8000,), generator=gen, device="cuda")
    _run_bf16_steps(gen, V, D, ids, block_rows=block_rows)


@pytest.mark.parametrize("D", [8, 16])
def test_sorted_adam_bf16_hot_row(gen, D):
    r = np.random.default_rng(0)
    V, per = 23 * 5000, 4096
    parts = [np.full(per, 17)] + [f * 5000 + _zipf_ids(r, per, 5000) for f in range(1, 23)]
    _run_bf16_steps(gen, V, D, torch.as_tensor(np.concatenate(parts)))


@pytest.mark.parametrize("fault", [None, "truncated", "missed_decay"])
def test_sorted_adam_bf16_rule_catches_planted_faults(gen, fault):
    """One step on the hot row and Zipf ids, from one state: the bf16 form as
    it is passes the rule; its f32 results truncated to bf16 instead of
    rounded (the f32 form on widened copies, then truncated), or one
    untouched row's decay left out, fail it."""
    r = np.random.default_rng(1)
    V, D, per = 23 * 5000, 16, 4096
    parts = [np.full(per, 17)] + [f * 5000 + _zipf_ids(r, per, 5000) for f in range(1, 23)]
    ids = torch.as_tensor(np.concatenate(parts)).cuda()
    table, mu, nu = _bf16_trio(gen, V, D)
    g = 1e-3 * torch.randn(ids.shape[0], D, generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(ids, g)
    hp = sa.adam_hparams(2, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    ref = [t.clone() for t in (table, mu, nu)]
    rule = _AdamOrderRule(table.float())
    rule.step(table.float(), sid, gs, hp)
    sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
    out = [t.clone() for t in (table, mu, nu)]
    if fault == "truncated":
        wide = [t.float() for t in out]
        sa.sorted_dense_adam_apply(*wide, sid, gs, hp)
        for t, w in zip(out, wide):
            t.copy_((w.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16))
    else:
        sa.sorted_dense_adam_apply(*out, sid, gs, hp)
    if fault == "missed_decay":
        hit = torch.zeros(V, dtype=torch.bool, device="cuda")
        hit[sid.long()] = True
        row = int((~hit).nonzero()[0])
        for t, before in zip(out, (table, mu, nu)):
            t[row] = before[row]
    torch.cuda.synchronize()
    held = [_bf16_held(o, w, rule, what)[0]
            for o, w, what in zip(out, ref, ("table", "mu", "nu"))]
    assert all(held) if fault is None else not all(held), held


def test_sorted_adam_bf16_no_ids_still_decays(gen):
    table0, table, _ = _run_bf16_steps(gen, 5000, 16, torch.zeros(0, dtype=torch.long))
    assert bool((table != table0).any())


@pytest.mark.parametrize("offset", [16, 8, 1, 3])
def test_sorted_adam_bf16_sliced_store(gen, offset):
    """A store that starts ``offset`` elements into its buffer: one row of 16
    (32 bytes) and 8 (16 bytes) keep the 16-byte path, 1 and 3 (2 and 6
    bytes) take the scalar one; both agree with the plain version."""
    ids = torch.randint(0, 20_000, (5000,), generator=gen, device="cuda")
    _run_bf16_steps(gen, 20_000, 16, ids, offset=offset)


def test_sorted_adam_bf16_bad_input_raises(gen):
    table, mu, nu = _bf16_trio(gen, 3000, 16)
    ids = torch.randint(0, 3000, (500,), generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(ids, torch.randn(500, 16, generator=gen, device="cuda"))
    hp = sa.adam_hparams(1, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    f32, bf16 = sa.sorted_dense_adam_apply.launches, sa.sorted_dense_adam_apply.launches_bf16
    with pytest.raises(ValueError):
        sa.sorted_dense_adam_apply(table, mu, nu.float(), sid, gs, hp)
    with pytest.raises(ValueError):
        sa.sorted_dense_adam_apply(table, mu, nu, sid, gs.bfloat16(), hp)
    with pytest.raises(ValueError):
        sa.sorted_dense_adam_apply(table.t(), mu.t(), nu.t(), sid, gs[:, :16], hp)
    with pytest.raises(ValueError):
        sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp, block_rows=100_000)
    assert (sa.sorted_dense_adam_apply.launches, sa.sorted_dense_adam_apply.launches_bf16) \
        == (f32, bf16)


# -- trunk_towers_fused_infer, star_fused_infer, ple_fused_infer --------------

from scenario_wise_rec_tpu_torch.ops.kernels import ple_infer as kp  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import star_infer as ks  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import tower_infer as kt  # noqa: E402


def _affines(gen, lead, dims):
    """Stages (W [*lead, in, out], b [*lead, out]) between the widths
    ``dims``, scaled like a Linear's init."""
    return [(torch.randn(*lead, i, o, generator=gen, device="cuda") * i ** -0.5,
             torch.randn(*lead, o, generator=gen, device="cuda") * 0.1)
            for i, o in zip(dims[:-1], dims[1:])]


def _launch_and_compare(gen, wrapper, ref, emb, did, *args, rows=16):
    before = wrapper.launches
    got = wrapper(emb, did, *args, block_rows=rows)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = ref(emb, did, *args)
    assert got.shape == (emb.shape[0],) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


ALI_TOWER = (376, 3, [512], [256, 128, 64, 32, 16, 8], True)
# KuaiRand's SharedBottom (trunk [128], towers [64, 32], 5 domains) at
# MMOE's KuaiRand F 800; Amazon's (trunk [128], towers [8], 3 domains) at
# its 3 sparse features of 16
KUAIRAND_TOWER = (800, 5, [128], [64, 32], True)
AMAZON_TOWER = (48, 3, [128], [8], True)


def _tower_args(gen, F, D, trunk, towers, head):
    tr = _affines(gen, (), [F] + trunk)
    w_in = trunk[-1] if trunk else F
    tw = _affines(gen, (D,), [w_in] + towers)
    out = _affines(gen, (D,), [towers[-1] if towers else w_in, 1])[0] if head else None
    return tr, tw, out


@pytest.mark.parametrize("cfg", [
    # (B, (F, D, trunk dims, tower dims, head), ids: drawn from (lo, hi) or
    #  counts of each domain, block_rows)
    (4096, ALI_TOWER, (-2, 6), 16),                          # Ali-CCP
    (4096, ALI_TOWER, (-2, 6), None),
    (333, (41, 2, [7], [3], True), (-2, 5), 16),            # widths not multiples of 4
    (130, (50, 5, [33, 20], [40, 70, 1], False), (-2, 8), 48),  # no head: width-1 last stage
    (64, (12, 1, [], [5] * 8, True), (-2, 4), 64),          # no trunk; deep towers; widest tile
    (17, (9, 3, [6], [], True), (-2, 6), 16),               # head on the trunk
    (41, (18, 5, [], [], True), (-2, 8), 32),               # the head alone, on the embedding
    (4096, ALI_TOWER, [3700, 300, 96], None),               # skewed: 90 % in domain 0
    (4096, ALI_TOWER, [96, 300, 3700], 48),
    (4096, ALI_TOWER, [0, 4096, 0], 32),                    # every row in one domain
    (66, ALI_TOWER, [33, 32, 1], 32),                       # counts astride 32-row tiles
    (100, ALI_TOWER, [33, 1, 66], 16),                      # and 16-row tiles
    (1, ALI_TOWER, (0, 3), None),
    (4095, ALI_TOWER, (0, 3), 32),
    (4096, KUAIRAND_TOWER, (0, 5), None),                   # KuaiRand's ladder
    (4096, KUAIRAND_TOWER, (0, 5), 48),
    (4096, AMAZON_TOWER, (0, 3), None),                     # Amazon's and Douban's
    (4096, AMAZON_TOWER, (0, 3), 64),
    (65_536, ALI_TOWER, (0, 3), None),                # the largest B the partition is held to
    (300, (70, 256, [33], [7], True), (-2, 260), 16),       # the most domains
    (200, (100, 3, [600, 300], [257, 8], False), (0, 3), 16),  # no head at width 8: its last stage 8 -> 1
])
def test_tower_kernel_matches_plain(gen, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version, one launch a call, none on STAR's counter."""
    B, (F, D, trunk, towers, head), ids, rows = cfg
    if not head and towers[-1] != 1:
        towers = towers + [1]
    tr, tw, out = _tower_args(gen, F, D, trunk, towers, head)
    emb = torch.randn(B, F, generator=gen, device="cuda")
    did = _m3oe_ids(gen, B, D, ids)
    before = kt.trunk_towers_fused_infer.launches
    star_before = ks.star_fused_infer.launches
    got = _unwritten_nan(kt.trunk_towers_fused_infer, emb, did, tr, tw, out, block_rows=rows)
    torch.cuda.synchronize()
    assert kt.trunk_towers_fused_infer.launches == before + 1
    assert ks.star_fused_infer.launches == star_before
    want = kt.trunk_towers_fused_infer_ref(emb, did, tr, tw, out)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("rows", [16, 32, 48, 64, None])
def test_tower_kernel_every_tile_at_ali_ccp(gen, rows):
    """At Ali-CCP's widths the tiles of 16, 32 or 48 rows fit beside the
    ring and match the plain version; 64 rows do not fit and raise, naming
    the shared memory."""
    tr, tw, out = _tower_args(gen, *ALI_TOWER)
    emb = torch.randn(4096, 376, generator=gen, device="cuda")
    did = torch.randint(0, 3, (4096,), generator=gen, device="cuda")
    if rows == 64:
        with pytest.raises(RuntimeError, match=f"shared memory.*block_rows={rows}"):
            kt.trunk_towers_fused_infer(emb, did, tr, tw, out, block_rows=rows)
        return
    got = _unwritten_nan(kt.trunk_towers_fused_infer, emb, did, tr, tw, out, block_rows=rows)
    want = kt.trunk_towers_fused_infer_ref(emb, did, tr, tw, out)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_tower_kernel_reads_int32_and_int64_ids_alike(gen):
    """int64 ids are read as they are (no cast launch: one launch a call),
    taken modulo 2^32 as int32 and clipped: the same outputs as the int32
    ids, bit for bit."""
    tr, tw, out = _tower_args(gen, *ALI_TOWER)
    emb = torch.randn(4096, 376, generator=gen, device="cuda")
    did = torch.randint(-2, 6, (4096,), generator=gen, device="cuda")
    got = kt.trunk_towers_fused_infer(emb, did.to(torch.int32), tr, tw, out)
    before = kt.trunk_towers_fused_infer.launches
    assert torch.equal(got, kt.trunk_towers_fused_infer(emb, did.to(torch.int64), tr, tw, out))
    assert torch.equal(got, kt.trunk_towers_fused_infer(emb, did + 2**32, tr, tw, out))
    assert kt.trunk_towers_fused_infer.launches == before + 2
    wrap = torch.tensor([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, 1, 7, -5],
                        device="cuda")
    e8 = emb[:8].contiguous()
    assert torch.equal(kt.trunk_towers_fused_infer(e8, wrap, tr, tw, out),
                       kt.trunk_towers_fused_infer(
                           e8, torch.tensor([1, 0, 0, 2, 2, 1, 2, 0], device="cuda"), tr, tw, out))
    assert (kt.trunk_towers_fused_infer(e8, wrap, tr, tw, out)
            - kt.trunk_towers_fused_infer_ref(e8, wrap, tr, tw, out)).abs().max().item() <= TOL


def test_tower_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of emb leaves every other row of its
    domain's tile as the plain version computes it."""
    tr, tw, out = _tower_args(gen, *ALI_TOWER)
    emb = torch.randn(100, 376, generator=gen, device="cuda")
    emb[50, 7] = float("nan")
    did = torch.zeros(100, dtype=torch.int32, device="cuda")
    got = kt.trunk_towers_fused_infer(emb, did, tr, tw, out, block_rows=32)
    want = kt.trunk_towers_fused_infer_ref(emb, did, tr, tw, out)
    assert bool(torch.isnan(got[50])) and bool(torch.isnan(want[50]))
    rest = torch.arange(100, device="cuda") != 50
    assert (got[rest] - want[rest]).abs().max().item() <= TOL


def _star_args(gen, B, F, D, fcn, aux):
    emb = torch.randn(B, F, generator=gen, device="cuda")
    var, mean = torch.var_mean(emb, dim=0, unbiased=False)
    g = 0.5 + torch.rand(D, F, generator=gen, device="cuda")
    b = 0.1 * torch.randn(D, F, generator=gen, device="cuda")
    return emb, (mean, torch.rsqrt(var + 1e-6), g, b, _affines(gen, (D,), [F] + fcn + [1]),
                 _affines(gen, (), [F] + aux),
                 _affines(gen, (), [aux[-1] if aux else F, 1])[0])


ALI_STAR = (376, 3, [256, 128, 64, 32, 16, 8], [16])
# KuaiRand's STAR (FCN [128, 64, 32], aux [32], 5 domains) at MMOE's
# KuaiRand F 800
KUAIRAND_STAR = (800, 5, [128, 64, 32], [32])


@pytest.mark.parametrize("cfg", [
    # (B, (F, D, fcn dims, aux dims), ids: drawn from (lo, hi) or counts of
    #  each domain, block_rows)
    (4096, ALI_STAR, (-2, 6), 16),                          # Ali-CCP
    (4096, ALI_STAR, (-2, 6), None),
    (333, (41, 2, [7], [3]), (-2, 5), 16),                  # widths not multiples of 8
    (130, (33, 6, [9, 3], [7]), (-2, 9), 48),               # and 6 domains
    (130, (50, 6, [33, 20, 9], []), (-2, 9), 64),           # aux head on the raw row
    (77, (20, 3, [], [4, 4]), (-2, 6), 32),                 # one FCN stage, F -> 1
    (1, (20, 3, [8], [4, 4]), (-2, 6), 64),
    (64, (12, 4, [5] * 8, [6]), (1, 3), 64),                # domains 0 and 3 absent
    (4096, ALI_STAR, [3700, 300, 96], None),                # skewed: 90 % in domain 0
    (4096, ALI_STAR, [96, 300, 3700], 48),
    (4096, ALI_STAR, [0, 4096, 0], 32),                     # every row in one domain
    (66, ALI_STAR, [33, 32, 1], 32),                        # counts astride 32-row tiles
    (100, ALI_STAR, [33, 1, 66], 16),                       # and 16-row tiles
    (1, ALI_STAR, (0, 3), None),
    (4095, ALI_STAR, (0, 3), 32),
    (4096, KUAIRAND_STAR, (0, 5), None),                    # KuaiRand's ladder
    (4096, KUAIRAND_STAR, (0, 5), 48),
    (65_536, ALI_STAR, (0, 3), None),                 # the largest B the partition is held to
    (300, (70, 256, [33], [9]), (-2, 260), 16),             # the most domains
])
def test_star_kernel_matches_plain(gen, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version, one launch a call on STAR's counter and none on
    SharedBottom's or AdaptDHM's, whose kernel it runs."""
    B, (F, D, fcn, aux), ids, rows = cfg
    emb, args = _star_args(gen, B, F, D, fcn, aux)
    did = _m3oe_ids(gen, B, D, ids)
    before = ks.star_fused_infer.launches
    others = kt.trunk_towers_fused_infer.launches, ka.adaptdhm_fused_infer.launches
    got = _unwritten_nan(ks.star_fused_infer, emb, did, *args, block_rows=rows)
    torch.cuda.synchronize()
    assert ks.star_fused_infer.launches == before + 1
    assert (kt.trunk_towers_fused_infer.launches, ka.adaptdhm_fused_infer.launches) == others
    want = ks.star_fused_infer_ref(emb, did, *args)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("ladder", [ALI_STAR, KUAIRAND_STAR])
@pytest.mark.parametrize("rows", [16, 32, 48, 64, None])
def test_star_kernel_every_tile(gen, ladder, rows):
    """At Ali-CCP's widths every tile of the rule fits beside the ring (the
    emb tile, the aux logit's and the first 256-wide tile take 684 floats a
    row) and matches the plain version; at KuaiRand's (972 floats a row at
    F 800) 64 rows do not fit and raise, naming the shared memory."""
    F, D, fcn, aux = ladder
    emb, args = _star_args(gen, 4096, F, D, fcn, aux)
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    if ladder is KUAIRAND_STAR and rows == 64:
        with pytest.raises(RuntimeError, match=f"shared memory.*block_rows={rows}"):
            ks.star_fused_infer(emb, did, *args, block_rows=rows)
        return
    got = _unwritten_nan(ks.star_fused_infer, emb, did, *args, block_rows=rows)
    want = ks.star_fused_infer_ref(emb, did, *args)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_star_kernel_reads_int32_and_int64_ids_alike(gen):
    """int64 ids are read as they are (no cast launch: one launch a call),
    taken modulo 2^32 as int32 and clipped: the same outputs as the int32
    ids, bit for bit."""
    emb, args = _star_args(gen, 4096, *ALI_STAR)
    did = torch.randint(-2, 6, (4096,), generator=gen, device="cuda")
    got = ks.star_fused_infer(emb, did.to(torch.int32), *args)
    before = ks.star_fused_infer.launches
    assert torch.equal(got, ks.star_fused_infer(emb, did.to(torch.int64), *args))
    assert torch.equal(got, ks.star_fused_infer(emb, did + 2**32, *args))
    assert ks.star_fused_infer.launches == before + 2
    wrap = torch.tensor([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, 1, 7, -5],
                        device="cuda")
    e8 = emb[:8].contiguous()
    assert torch.equal(ks.star_fused_infer(e8, wrap, *args),
                       ks.star_fused_infer(
                           e8, torch.tensor([1, 0, 0, 2, 2, 1, 2, 0], device="cuda"), *args))
    assert (ks.star_fused_infer(e8, wrap, *args)
            - ks.star_fused_infer_ref(e8, wrap, *args)).abs().max().item() <= TOL


def test_star_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of emb (the norm's statistics taken
    before it) leaves every other row of its domain's tile as the plain
    version computes it."""
    emb, args = _star_args(gen, 100, *ALI_STAR)
    emb[50, 7] = float("nan")
    did = torch.zeros(100, dtype=torch.int32, device="cuda")
    got = ks.star_fused_infer(emb, did, *args, block_rows=32)
    want = ks.star_fused_infer_ref(emb, did, *args)
    assert bool(torch.isnan(got[50])) and bool(torch.isnan(want[50]))
    rest = torch.arange(100, device="cuda") != 50
    assert (got[rest] - want[rest]).abs().max().item() <= TOL


def test_star_kernel_rejects_what_it_does_not_take(gen):
    emb, args = _star_args(gen, 10, 20, 2, [8], [4])
    did = torch.zeros(10, dtype=torch.long, device="cuda")
    for rows in (8, 12, 24, 40, 0, 72, 80):
        with pytest.raises(ValueError, match="block_rows"):
            ks.star_fused_infer(emb, did, *args, block_rows=rows)
    with pytest.raises(ValueError):
        ks.star_fused_infer(emb, did.float(), *args)
    with pytest.raises(ValueError):
        ks.star_fused_infer(emb, did.cpu(), *args)
    with pytest.raises(ValueError):
        ks.star_fused_infer(emb.double(), did, *args)
    with pytest.raises(ValueError, match="domains"):
        ks.star_fused_infer(emb, did, *_star_args(gen, 10, 20, 257, [8], [4])[1])
    with pytest.raises(ValueError, match="stages"):  # 97: the aux head and 96 FCN stages
        ks.star_fused_infer(emb, did, *_star_args(gen, 10, 20, 2, [8] * 95, [])[1])
    assert ks.star_fused_infer(emb[:0], did[:0], *args).shape == (0,)
    wide = _star_args(gen, 10, 3000, 2, [8], [4])  # 64 x 3000 emb rows exceed it
    with pytest.raises(RuntimeError, match="shared memory"):
        ks.star_fused_infer(wide[0], did, *wide[1], block_rows=64)


def _ple_args(gen, F, D, S, n_sh, levels, towers, gate_hidden=()):
    out, width = [], F
    for li, dims in enumerate(levels):
        last = li == len(levels) - 1
        gs = None if last else _affines(gen, (), [width, *gate_hidden, D * S + n_sh])
        out.append(kp.LevelSpec(_affines(gen, (D, S), [width] + dims),
                                _affines(gen, (n_sh,), [width] + dims),
                                _affines(gen, (D,), [width, *gate_hidden, S + n_sh]), gs))
        width = dims[-1]
    tw = _affines(gen, (D,), [width] + towers)
    return out, tw, _affines(gen, (D,), [towers[-1] if towers else width, 1])[0]


ALI_PLE_DIMS = [256, 128, 64, 32, 16, 8]
# (F, D, S, n_sh, levels' expert dims, tower dims, gate hidden)
ALI_PLE = (376, 3, 2, 1, [ALI_PLE_DIMS], [16], ())
ALI_PLE_2 = (376, 3, 2, 1, [ALI_PLE_DIMS] * 2, [16], ())
# KuaiRand's PLE ladder (1 level, experts [64, 32], tower [16], 5 domains) at
# MMOE's KuaiRand F 800
KUAIRAND_PLE = (800, 5, 2, 1, [[64, 32]], [16], ())


@pytest.mark.parametrize("cfg", [
    # (B, (F, D, S, n_sh, levels' expert dims, tower dims, gate hidden), ids:
    #  drawn from (lo, hi) or counts of each domain, block_rows)
    (4096, ALI_PLE, (-2, 6), 16),                                # Ali-CCP
    (1000, ALI_PLE_2, (-2, 6), 16),                              # 2 levels
    (333, (41, 2, 1, 2, [[7], [5], [3]], [], (6,)), (-2, 5), 16),  # 3 levels, 2-stage gates
    (130, (30, 4, 3, 1, [[9, 6], [10]], [4, 3], ()), (-2, 7), 48),
    (4096, ALI_PLE, [3700, 300, 96], None),                      # skewed: 90 % in domain 0
    (4096, ALI_PLE, [96, 300, 3700], 48),
    (4096, ALI_PLE_2, [3700, 300, 96], 32),
    (66, ALI_PLE, [33, 32, 1], 32),                              # counts astride 32-row tiles
    (100, ALI_PLE, [33, 1, 66], 16),                             # and 16-row tiles
    (66, ALI_PLE_2, [1, 33, 32], None),
    (1, ALI_PLE, (0, 3), None),
    (4095, ALI_PLE, (0, 3), 32),
    (4096, KUAIRAND_PLE, (0, 5), None),                          # KuaiRand's width
    (4096, KUAIRAND_PLE, (0, 5), 48),
    (65_536, ALI_PLE, (0, 3), None),                  # the largest B the partition is held to
    # products at most 8 wide and at least 64 deep split over the warps: a
    # relu stage before a level's mix, an expert's mixing stage at the last
    # level and before it (into every stream, 5 wide: a slab at stride 8)
    (500, (100, 3, 2, 1, [[8, 6], [8]], [4], ()), (-2, 6), 32),
    (300, (100, 3, 2, 2, [[8]], [4], (16,)), (0, 3), 16),
    (300, (100, 2, 1, 1, [[5], [7]], [], ()), (-1, 3), 48),
])
def test_ple_kernel_matches_plain(gen, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version, one launch a call."""
    B, (F, D, S, n_sh, levels, towers, gate_hidden), ids, rows = cfg
    args = _ple_args(gen, F, D, S, n_sh, levels, towers, gate_hidden)
    emb = torch.randn(B, F, generator=gen, device="cuda")
    did = _m3oe_ids(gen, B, D, ids)
    before = kp.ple_fused_infer.launches
    got = _unwritten_nan(kp.ple_fused_infer, emb, did, *args, block_rows=rows)
    torch.cuda.synchronize()
    assert kp.ple_fused_infer.launches == before + 1
    want = kp.ple_fused_infer_ref(emb, did, *args)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("rows", [16, 32, 48, 64, None])
@pytest.mark.parametrize("cfg", [ALI_PLE, ALI_PLE_2])
def test_ple_kernel_every_tile_at_ali_ccp(gen, cfg, rows):
    """At Ali-CCP's widths the tiles of 16, 32 or 48 rows (at 2 levels 16 or
    32) fit beside the ring and match the plain version; wider tiles do not
    fit and raise, naming the shared memory."""
    F, D, S, n_sh, levels, towers, gate_hidden = cfg
    args = _ple_args(gen, F, D, S, n_sh, levels, towers, gate_hidden)
    emb = torch.randn(4096, F, generator=gen, device="cuda")
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    if rows == 64 or (rows == 48 and len(levels) == 2):
        with pytest.raises(RuntimeError, match=f"shared memory.*block_rows={rows}"):
            kp.ple_fused_infer(emb, did, *args, block_rows=rows)
        return
    got = _unwritten_nan(kp.ple_fused_infer, emb, did, *args, block_rows=rows)
    want = kp.ple_fused_infer_ref(emb, did, *args)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_ple_kernel_reads_int32_and_int64_ids_alike(gen):
    """int64 ids are read as they are (no cast launch), taken modulo 2^32 as
    int32 and clipped: the same outputs as the int32 ids, bit for bit."""
    F, D, S, n_sh, levels, towers, gate_hidden = ALI_PLE
    args = _ple_args(gen, F, D, S, n_sh, levels, towers, gate_hidden)
    emb = torch.randn(4096, F, generator=gen, device="cuda")
    did = torch.randint(-2, D + 3, (4096,), generator=gen, device="cuda")
    got = kp.ple_fused_infer(emb, did.to(torch.int32), *args)
    assert torch.equal(got, kp.ple_fused_infer(emb, did.to(torch.int64), *args))
    assert torch.equal(got, kp.ple_fused_infer(emb, did + 2**32, *args))
    wrap = torch.tensor([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, 1, 7, -5],
                        device="cuda")
    e8 = emb[:8].contiguous()
    assert torch.equal(kp.ple_fused_infer(e8, wrap, *args), kp.ple_fused_infer(
        e8, torch.tensor([1, 0, 0, 2, 2, 1, 2, 0], device="cuda"), *args))
    assert (kp.ple_fused_infer(e8, wrap, *args)
            - kp.ple_fused_infer_ref(e8, wrap, *args)).abs().max().item() <= TOL


@pytest.mark.parametrize("cfg", [ALI_PLE, ALI_PLE_2])
def test_ple_kernel_keeps_a_nan_in_its_row(gen, cfg):
    """Rows never mix: a NaN in one row of emb leaves every other row of its
    domain's tile as the plain version computes it."""
    F, D, S, n_sh, levels, towers, gate_hidden = cfg
    args = _ple_args(gen, F, D, S, n_sh, levels, towers, gate_hidden)
    emb = torch.randn(100, F, generator=gen, device="cuda")
    emb[50, 7] = float("nan")
    did = torch.zeros(100, dtype=torch.int32, device="cuda")
    got = kp.ple_fused_infer(emb, did, *args, block_rows=32)
    want = kp.ple_fused_infer_ref(emb, did, *args)
    assert bool(torch.isnan(got[50])) and bool(torch.isnan(want[50]))
    rest = torch.arange(100, device="cuda") != 50
    assert (got[rest] - want[rest]).abs().max().item() <= TOL


def test_new_kernels_reject_what_they_do_not_take(gen):
    tr, tw = _affines(gen, (), [20, 8]), _affines(gen, (2,), [8, 4])
    out = _affines(gen, (2,), [4, 1])[0]
    emb = torch.randn(10, 20, generator=gen, device="cuda")
    did = torch.zeros(10, dtype=torch.long, device="cuda")
    for rows in (8, 12, 24, 0, 72, 80):
        with pytest.raises(ValueError, match="block_rows"):
            kt.trunk_towers_fused_infer(emb, did, tr, tw, out, block_rows=rows)
    with pytest.raises(ValueError):
        kt.trunk_towers_fused_infer(emb, did.float(), tr, tw, out)
    with pytest.raises(ValueError, match="stages"):  # 97 stages: 96 trunk stages and the head
        kt.trunk_towers_fused_infer(emb, did, _affines(gen, (), [20] + [8] * 96), [],
                                    _affines(gen, (2,), [8, 1])[0])
    with pytest.raises(ValueError, match="domains"):
        kt.trunk_towers_fused_infer(emb, did, tr, _affines(gen, (257,), [8, 4]),
                                    _affines(gen, (257,), [4, 1])[0])
    with pytest.raises(ValueError):
        kt.trunk_towers_fused_infer(emb.double(), did, tr, tw, out)
    with pytest.raises(ValueError):
        kt.trunk_towers_fused_infer(emb, did.cpu(), tr, tw, out)
    assert kt.trunk_towers_fused_infer(emb[:0], did[:0], tr, tw, out).shape == (0,)
    wide = _affines(gen, (), [20, 2000])  # two 64 x 2000 buffers exceed shared memory
    with pytest.raises(RuntimeError, match="shared memory"):
        kt.trunk_towers_fused_infer(emb, did, wide, _affines(gen, (2,), [2000, 1]), None,
                                    block_rows=64)
    levels, ptw, pout = _ple_args(gen, 20, 2, 2, 1, [[8]] * 5, [4])
    with pytest.raises(ValueError, match="levels"):
        kp.ple_fused_infer(emb, did, levels, ptw, pout)
    levels, ptw, pout = _ple_args(gen, 20, 2, 2, 1, [[8]], [4])
    for rows in (8, 24, 80, 0):
        with pytest.raises(ValueError, match="block_rows"):
            kp.ple_fused_infer(emb, did, levels, ptw, pout, block_rows=rows)
    with pytest.raises(ValueError):
        kp.ple_fused_infer(emb, did.float(), levels, ptw, pout)
    with pytest.raises(ValueError, match="products"):  # 2 levels of 100 domains: 307 products
        kp.ple_fused_infer(emb, did, *_ple_args(gen, 20, 100, 2, 1, [[8]] * 2, [4]))
    assert kp.ple_fused_infer(emb[:0], did[:0], levels, ptw, pout).shape == (0,)


# -- sarnet_fused_infer and the gated kernels ---------------------------------

from scenario_wise_rec_tpu_torch.ops.kernels import gated_infer as kg  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import sarnet_infer as ksn  # noqa: E402

# AdaSparse's pruners threshold sign(beta * sigmoid(v) - eps): a kernel and a
# plain version that differ in the last ulp of v can flip one factor. A row
# is held to TOL unless some pruner element of it lies within THRESHOLD_GAP
# of eps (by the plain version; a flip needs both within rounding of it), and
# such rows may be at most 0.01 % of the batch.
THRESHOLD_GAP, THRESHOLD_ROWS = 1e-5, 1e-4


def _sarnet_args(gen, B, F, D, n_sh, n_sp, H, final):
    emb = torch.randn(B, F, generator=gen, device="cuda")
    dom_w = 2 * torch.rand(D, F, generator=gen, device="cuda") - 1
    dom_b = torch.rand(D, F, generator=gen, device="cuda")
    return emb, (dom_w, dom_b, _affines(gen, (n_sh,), [F, H])[0],
                 _affines(gen, (D, n_sp), [F, H])[0], _affines(gen, (), [F, n_sh + n_sp])[0],
                 _affines(gen, (), [H] + final), _affines(gen, (), [final[-1] if final else H, 1])[0])


# SAR-Net at Ali-CCP (F 23 x 16, 3 domains, 8 shared + 2 own experts of
# width 16, final [32, 32]) and at KuaiRand's widths (its 796 sparse
# columns, 5 domains)
ALI_SARNET = (368, 3, 8, 2, 16, [32, 32])
KUAIRAND_SARNET = (796, 5, 8, 2, 16, [32, 32])


def _eval_counts():
    """Every fused eval kernel's launch counter."""
    from scenario_wise_rec_tpu_torch.ops import kernels

    return {n: getattr(kernels, n).launches for n in kernels.__all__
            if hasattr(getattr(kernels, n), "launches")}


@pytest.mark.parametrize("cfg", [
    # (B, (F, D, n_sh, n_sp, expert width, final dims), ids: drawn from (lo, hi)
    #  or counts of each domain, block_rows)
    (4096, ALI_SARNET, (-2, 6), 16),                       # Ali-CCP
    (333, (41, 2, 3, 1, 7, [5]), (-2, 5), 16),             # widths not multiples of 4
    (130, (50, 5, 2, 3, 16, []), (-2, 8), 48),             # head on the mixture
    (1, (20, 3, 1, 1, 4, [8, 4]), (-2, 6), 64),
    (4096, ALI_SARNET, (-2, 6), None),
    (4096, ALI_SARNET, [3700, 300, 96], None),             # skewed: 90 % in domain 0
    (4096, ALI_SARNET, [96, 0, 4000], 48),                 # domain 1 absent
    (4096, ALI_SARNET, [0, 4096, 0], 32),                  # every row in one domain
    (66, ALI_SARNET, [33, 32, 1], 32),                     # counts astride 32-row tiles
    (1, ALI_SARNET, (0, 3), None),
    (4095, ALI_SARNET, (0, 3), 32),
    (4096, KUAIRAND_SARNET, (0, 5), None),                 # KuaiRand's widths
    (65_536, ALI_SARNET, (0, 3), None),                    # the largest B the partition is held to
    (300, (30, 256, 2, 1, 8, [8]), (-2, 260), 16),         # the most domains
    (200, (24, 3, 14, 1, 16, [300, 8]), (-2, 5), 16),      # 256 columns; a stage past a chunk
])
def test_sarnet_kernel_matches_plain(gen, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version, one launch a call on SAR-Net's counter and none on
    any other kernel's."""
    B, (F, D, n_sh, n_sp, H, final), ids, rows = cfg
    emb, args = _sarnet_args(gen, B, F, D, n_sh, n_sp, H, final)
    did = _m3oe_ids(gen, B, D, ids)
    before = _eval_counts()
    got = _unwritten_nan(ksn.sarnet_fused_infer, emb, did, *args, block_rows=rows)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in _eval_counts().items() if c != before[n]}
    assert moved == {"sarnet_fused_infer": 1}
    want = ksn.sarnet_fused_infer_ref(emb, did, *args)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("ladder", [ALI_SARNET, KUAIRAND_SARNET])
@pytest.mark.parametrize("rows", [16, 32, 48, 64, None])
def test_sarnet_kernel_every_tile(gen, ladder, rows):
    """At Ali-CCP's widths every tile of the rule fits beside the ring (the
    emb tile and the experts' 176 columns take 584 floats a row) and matches
    the plain version; at KuaiRand's (1000 floats a row at F 796) 64 rows do
    not fit and raise, naming the shared memory."""
    F, D = ladder[:2]
    emb, args = _sarnet_args(gen, 4096, *ladder)
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    if ladder is KUAIRAND_SARNET and rows == 64:
        with pytest.raises(RuntimeError, match=f"shared memory.*block_rows={rows}"):
            ksn.sarnet_fused_infer(emb, did, *args, block_rows=rows)
        return
    got = _unwritten_nan(ksn.sarnet_fused_infer, emb, did, *args, block_rows=rows)
    want = ksn.sarnet_fused_infer_ref(emb, did, *args)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_sarnet_kernel_reads_int32_and_int64_ids_alike(gen):
    """int64 ids are read as they are (no cast launch: one launch a call),
    taken modulo 2^32 as int32 and clipped: the same outputs as the int32
    ids, bit for bit."""
    emb, args = _sarnet_args(gen, 4096, *ALI_SARNET)
    did = torch.randint(-2, 6, (4096,), generator=gen, device="cuda")
    got = ksn.sarnet_fused_infer(emb, did.to(torch.int32), *args)
    before = ksn.sarnet_fused_infer.launches
    assert torch.equal(got, ksn.sarnet_fused_infer(emb, did.to(torch.int64), *args))
    assert torch.equal(got, ksn.sarnet_fused_infer(emb, did + 2**32, *args))
    assert ksn.sarnet_fused_infer.launches == before + 2
    wrap = torch.tensor([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, 1, 7, -5],
                        device="cuda")
    e8 = emb[:8].contiguous()
    assert torch.equal(ksn.sarnet_fused_infer(e8, wrap, *args),
                       ksn.sarnet_fused_infer(
                           e8, torch.tensor([1, 0, 0, 2, 2, 1, 2, 0], device="cuda"), *args))
    assert (ksn.sarnet_fused_infer(e8, wrap, *args)
            - ksn.sarnet_fused_infer_ref(e8, wrap, *args)).abs().max().item() <= TOL


def test_sarnet_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of emb leaves every other row of its
    domain's tile as the plain version computes it."""
    emb, args = _sarnet_args(gen, 100, *ALI_SARNET)
    emb[50, 7] = float("nan")
    did = torch.zeros(100, dtype=torch.int32, device="cuda")
    got = ksn.sarnet_fused_infer(emb, did, *args, block_rows=64)
    want = ksn.sarnet_fused_infer_ref(emb, did, *args)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want)) and nan.nonzero().flatten().tolist() == [50]
    assert (got[~nan] - want[~nan]).abs().max().item() <= TOL


def test_sarnet_kernel_rejects_what_it_does_not_take(gen):
    emb, args = _sarnet_args(gen, 10, 20, 2, 2, 1, 4, [4])
    did = torch.zeros(10, dtype=torch.long, device="cuda")
    before = ksn.sarnet_fused_infer.launches
    for rows in (8, 12, 24, 40, 0, 72, 80):
        with pytest.raises(ValueError, match="block_rows"):
            ksn.sarnet_fused_infer(emb, did, *args, block_rows=rows)
    with pytest.raises(ValueError):
        ksn.sarnet_fused_infer(emb, did.cpu(), *args)
    with pytest.raises(ValueError):
        ksn.sarnet_fused_infer(emb.double(), did, *args)
    with pytest.raises(ValueError, match="domains"):
        ksn.sarnet_fused_infer(emb, did, *_sarnet_args(gen, 10, 20, 257, 2, 1, 4, [4])[1])
    with pytest.raises(ValueError, match="columns"):  # 15 + 1 experts of 16 and the gate: 272
        ksn.sarnet_fused_infer(emb, did, *_sarnet_args(gen, 10, 20, 2, 15, 1, 16, [4])[1])
    with pytest.raises(ValueError, match="final stages"):
        ksn.sarnet_fused_infer(emb, did, *_sarnet_args(gen, 10, 20, 2, 2, 1, 4, [4] * 32)[1])
    assert ksn.sarnet_fused_infer.launches == before
    assert ksn.sarnet_fused_infer(emb[:0], did[:0], *args).shape == (0,)
    wide = _sarnet_args(gen, 10, 3000, 2, 2, 1, 4, [4])  # 64 x 3000 emb rows exceed it
    with pytest.raises(RuntimeError, match="shared memory"):
        ksn.sarnet_fused_infer(wide[0], did, *wide[1], block_rows=64)


ALI_EPNET = (16, 360, 360)  # S, A (22 x 16 + 8), gate hidden
# KuaiRand's EPNet: its scenario loader gives sce the scenario feature (16)
# and agn the sparse and dense features, MMOE's KuaiRand F 800; the gate's
# hidden width is its output's
KUAIRAND_EPNET = (16, 800, 800)


def _epnet_args(gen, B, S, A, H):
    sce = torch.randn(B, S, generator=gen, device="cuda")
    agn = torch.randn(B, A, generator=gen, device="cuda")
    return sce, agn, (*_affines(gen, (), [S + A, H]), *_affines(gen, (), [H, A]),
                      _affines(gen, (), [A, 1])[0])


@pytest.mark.parametrize("cfg", [
    # (B, S, A, gate hidden, block_rows; None: the kernel's choice)
    (4096, *ALI_EPNET, 16),                      # Ali-CCP
    (333, 5, 41, 7, 16),                         # widths not multiples of 4
    (130, 16, 100, 300, 48),
    *[(4096, *ALI_EPNET, rows) for rows in (32, 48, 64, None)],  # every tile fits
    (4096, *KUAIRAND_EPNET, None),               # the kernel's choice: 16
    (1, *ALI_EPNET, None),
    (4095, *ALI_EPNET, None),                    # a last tile of 31 rows
    (65_536, *ALI_EPNET, None),
    (100, 7, 13, 21, 32),                        # A off 8, S odd, H != A
    (64, 16, 300, 24, 64),                       # a gate 300 wide: two chunks, the second 44
])
def test_epnet_kernel_matches_plain(gen, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version, one launch a call on EPNet's counter and none on
    AdaSparse's, whose kernel it runs."""
    B, S, A, H, rows = cfg
    sce, agn, args = _epnet_args(gen, B, S, A, H)
    before, other = kg.epnet_fused_infer.launches, kg.adasparse_fused_infer.launches
    got = _unwritten_nan(kg.epnet_fused_infer, sce, agn, *args, gemma=1.5, block_rows=rows)
    torch.cuda.synchronize()
    assert kg.epnet_fused_infer.launches == before + 1
    assert kg.adasparse_fused_infer.launches == other
    want = kg.epnet_fused_infer_ref(sce, agn, *args, gemma=1.5)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_epnet_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of agn, another in one row of sce,
    leave every other row of their tiles as the plain version computes it."""
    sce, agn, args = _epnet_args(gen, 100, *ALI_EPNET)
    agn[50, 7] = float("nan")
    sce[70, 3] = float("nan")
    got = kg.epnet_fused_infer(sce, agn, *args, block_rows=64)
    want = kg.epnet_fused_infer_ref(sce, agn, *args)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want)) and nan.nonzero().flatten().tolist() == [50, 70]
    assert (got[~nan] - want[~nan]).abs().max().item() <= TOL


@pytest.mark.parametrize("rows", [32, 48, 64])
def test_epnet_kernel_tile_that_does_not_fit_raises(gen, rows):
    """At KuaiRand's widths the [sce ‖ agn] tile and the gate's hidden tile
    take 1640 floats a row: 32, 48 and 64 rows do not fit beside the
    smallest ring and raise, naming the shared memory; it never falls
    back."""
    sce, agn, args = _epnet_args(gen, 64, *KUAIRAND_EPNET)
    before = kg.epnet_fused_infer.launches
    with pytest.raises(RuntimeError, match=f"shared memory.*block_rows={rows}"):
        kg.epnet_fused_infer(sce, agn, *args, block_rows=rows)
    for bad in (8, 24, 40, 80, 0):
        with pytest.raises(ValueError, match="block_rows"):
            kg.epnet_fused_infer(sce, agn, *args, block_rows=bad)
    assert kg.epnet_fused_infer.launches == before
    assert kg.epnet_fused_infer(sce[:0], agn[:0], *args).shape == (0,)


def _ppnet_args(gen, G, D, dims, hidden=None):
    hidden = hidden or dims
    lay = _affines(gen, (D,), [G] + dims)
    g1 = [_affines(gen, (D,), [G, h])[0] for h in hidden]
    g2 = [_affines(gen, (D,), [h, o])[0] for h, o in zip(hidden, dims)]
    return lay, g1, g2, _affines(gen, (D,), [dims[-1] if dims else G, 1])[0]


ALI_PPNET = (376, 3, [256, 128, 64, 32, 16, 8])  # G, D, layer dims (gate hidden alike)
# KuaiRand's PPNet ladder: 5 domains, layers [128, 64, 32]; G = 832, MMOE's
# F 800 less user_id and video_id (16 each) moved to the ids (32) plus the
# scenario feature twice (the ppnet loader keeps domain_indicator sparse, 16,
# and as the scenario feature, 16)
KUAIRAND_PPNET = (832, 5, [128, 64, 32])


def _ppnet_ids(gen, B, D, counts=None):
    """``[B]`` ids: uniform over -2 .. D + 2 (clipped by the kernel), or the
    given count of each domain, shuffled."""
    if counts is None:
        return torch.randint(-2, D + 3, (B,), generator=gen, device="cuda")
    did = torch.cat([torch.full((c,), d, device="cuda") for d, c in enumerate(counts)])
    return did[torch.randperm(B, generator=gen, device="cuda")]


def _unwritten_nan(wrapper, g, did, *args, **kw):
    """The wrapper's output where the caching allocator hands it a block just
    freed full of NaN: a row the kernel leaves unwritten reads NaN."""
    torch.cuda.synchronize()
    nan = torch.full((g.shape[0],), float("nan"), device="cuda")
    del nan
    return wrapper(g, did, *args, **kw)


@pytest.mark.parametrize("cfg", [
    # (B, G, D, layer dims, gate hidden, block_rows, counts of each domain)
    (4096, *ALI_PPNET, None, None, None),               # Ali-CCP, the kernel's tile (32)
    (4096, *ALI_PPNET, None, 16, None),
    (4096, *ALI_PPNET, None, 32, None),
    (4096, *ALI_PPNET, None, 48, None),
    (4096, *ALI_PPNET, None, 64, None),                 # a 64-row tile beside the smallest ring
    (4096, *ALI_PPNET, None, None, [2000, 0, 2096]),    # domain 1 absent
    (4096, *ALI_PPNET, None, None, [0, 4096, 0]),       # every row in one domain
    (66, *ALI_PPNET, None, 16, [33, 32, 1]),            # counts astride 16-row tiles
    (100, *ALI_PPNET, None, 32, [33, 1, 66]),
    (4096, *KUAIRAND_PPNET, None, None, None),           # KuaiRand's width
    (4096, *KUAIRAND_PPNET, None, 48, None),
    (333, 41, 2, [7, 3], [9, 5], 16, None),             # widths off 8; gate hidden != layer
    (64, 12, 4, [], None, 32, None),                    # no layer: the final on g
    (200, 30, 1, [24, 8], None, 16, None),              # D = 1
    (300, 40, 3, [300, 20, 270], [30, 280, 7], 16, None),  # layers past one 256-column pass
    (64, 10, 2, [4] * 30, None, 16, None),              # the deepest tower
    (1, *ALI_PPNET, None, None, None),
    (65_536, *ALI_PPNET, None, None, None),             # the largest B the partition is held to
])
def test_ppnet_kernel_matches_plain(gen, cfg):
    B, G, D, dims, hidden, rows, counts = cfg
    g = torch.randn(B, G, generator=gen, device="cuda")
    did = _ppnet_ids(gen, B, D, counts)
    args = _ppnet_args(gen, G, D, dims, hidden)
    before = kg.ppnet_fused_infer.launches
    got = _unwritten_nan(kg.ppnet_fused_infer, g, did, *args, block_rows=rows)
    torch.cuda.synchronize()
    assert kg.ppnet_fused_infer.launches == before + 1
    want = kg.ppnet_fused_infer_ref(g, did, *args)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())  # every row written
    assert (got - want).abs().max().item() <= TOL


def test_ppnet_kernel_reads_int32_and_int64_ids_alike(gen):
    """int64 ids are read as they are (no cast launch), taken modulo 2^32 as
    int32 and clipped: the same outputs as the int32 ids, bit for bit."""
    G, D, dims = ALI_PPNET
    args = _ppnet_args(gen, G, D, dims)
    g = torch.randn(4096, G, generator=gen, device="cuda")
    did = _ppnet_ids(gen, 4096, D)
    got = kg.ppnet_fused_infer(g, did.to(torch.int32), *args)
    assert torch.equal(got, kg.ppnet_fused_infer(g, did.to(torch.int64), *args))
    wrap = torch.tensor([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, 1, 7, -5],
                        device="cuda")
    g8 = g[:8].contiguous()
    assert torch.equal(kg.ppnet_fused_infer(g8, wrap, *args), kg.ppnet_fused_infer(
        g8, torch.tensor([1, 0, 0, 2, 2, 1, 2, 0], device="cuda"), *args))
    assert (kg.ppnet_fused_infer(g8, wrap, *args)
            - kg.ppnet_fused_infer_ref(g8, wrap, *args)).abs().max().item() <= TOL


def test_ppnet_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of g leaves every other row of its
    domain's tile as the plain version computes it."""
    G, D, dims = ALI_PPNET
    args = _ppnet_args(gen, G, D, dims)
    g = torch.randn(100, G, generator=gen, device="cuda")
    g[50, 7] = float("nan")
    did = torch.zeros(100, dtype=torch.int32, device="cuda")
    got = kg.ppnet_fused_infer(g, did, *args, block_rows=64)
    want = kg.ppnet_fused_infer_ref(g, did, *args)
    assert bool(torch.isnan(got[50])) and bool(torch.isnan(want[50]))
    rest = torch.arange(100, device="cuda") != 50
    assert (got[rest] - want[rest]).abs().max().item() <= TOL


def test_ppnet_kernel_rejects_what_it_does_not_take(gen):
    G, D, dims = KUAIRAND_PPNET
    g = torch.randn(64, G, generator=gen, device="cuda")
    did = torch.zeros(64, dtype=torch.int32, device="cuda")
    args = _ppnet_args(gen, G, D, dims)
    with pytest.raises(RuntimeError, match="shared memory"):  # 64 rows of G 832 do not fit
        kg.ppnet_fused_infer(g, did, *args, block_rows=64)
    for rows in (8, 24, 80, 0):
        with pytest.raises(ValueError, match="block_rows"):
            kg.ppnet_fused_infer(g, did, *args, block_rows=rows)
    with pytest.raises(ValueError, match="domains"):
        kg.ppnet_fused_infer(g[:, :20].contiguous(), did, *_ppnet_args(gen, 20, 257, [4]))
    assert kg.ppnet_fused_infer(g[:0], did[:0], *args).shape == (0,)


def _adasparse_args(gen, B, S, A, dims, alpha):
    """Pruner weights at 0.6 x a Linear's scale (times alpha, folded): the
    pruner inputs then have a std near 0.6, and eps = 1e-2 lies 7 of them
    below 0 (sigmoid(v) = 0.01 at v = -4.6), so that rows near the threshold
    stay rare at B = 4096. The negative factors are the work of
    test_adasparse_kernel_both_signs."""
    sce = torch.randn(B, S, generator=gen, device="cuda")
    agn = torch.randn(B, A, generator=gen, device="cuda")
    pw = [0.6 * alpha * (S + h) ** -0.5 * torch.randn(S + h, h, generator=gen, device="cuda")
          for h in [A] + dims]
    lay = _affines(gen, (), [S + A] + dims)
    return sce, agn, pw, lay, _affines(gen, (), [dims[-1] if dims else S + A, 1])[0]


def _adasparse_gap(got, want, margin):
    """(max |error| over the rows held to TOL, rows excused by the
    threshold rule)."""
    near = margin <= THRESHOLD_GAP
    err = (got - want).abs()[~near]
    return (err.max().item() if err.numel() else 0.0), int(near.sum())


ALI_ADASPARSE = (16, 352, [256, 128, 64, 32, 16, 8])  # S, A, layer dims
# KuaiRand's AdaSparse ladder ([128, 64, 32]): its scenario loader gives sce
# the scenario feature (16) and agn the sparse features only, MMOE's KuaiRand
# F 800 less its 4 dense columns
KUAIRAND_ADASPARSE = (16, 796, [128, 64, 32])
TILES = [16, 32, 48, 64, None]


@pytest.mark.parametrize("form", ["Binarization", "Scaling", "Fusion"])
@pytest.mark.parametrize("cfg", [
    # (B, S, A, layer dims, alpha, block_rows)
    *[(4096, *ALI_ADASPARSE, 1.37, rows) for rows in TILES],  # Ali-CCP, alpha folded
    *[(333, 5, 41, [7, 3], 1.0, rows) for rows in TILES],      # widths off 8
    *[(130, 16, 40, [], 0.8, rows) for rows in TILES],         # head on [sce ‖ agn]
    (1000, 16, 42, [16, 8], 1.0, None),
    (1, *ALI_ADASPARSE, 1.37, None),
    (4095, *ALI_ADASPARSE, 1.37, None),
    (65_536, *ALI_ADASPARSE, 1.37, None),
    (4096, *KUAIRAND_ADASPARSE, 1.0, None),                   # the kernel's choice: 16
    (4096, 16, 300, [300, 20], 1.0, 32),                       # a layer past one 256-column pass
])
def test_adasparse_kernel_matches_plain(gen, form, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version but for the rows the threshold rule excuses, one
    launch a call."""
    B, S, A, dims, alpha, rows = cfg
    args = _adasparse_args(gen, B, S, A, dims, alpha)
    kw = dict(form=form, epsilon=1e-2, beta=2.0)
    before = kg.adasparse_fused_infer.launches
    got = _unwritten_nan(kg.adasparse_fused_infer, *args, **kw, block_rows=rows)
    torch.cuda.synchronize()
    assert kg.adasparse_fused_infer.launches == before + 1
    want = kg.adasparse_fused_infer_ref(*args, **kw)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    err, near = _adasparse_gap(got, want, kg.adasparse_threshold_margin(*args, **kw))
    assert err <= TOL and near <= THRESHOLD_ROWS * B


def test_adasparse_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of agn leaves every other row of its
    tile as the plain version computes it."""
    sce, agn, pw, lay, fin = _adasparse_args(gen, 100, *ALI_ADASPARSE, 1.37)
    agn[50, 7] = float("nan")
    got = kg.adasparse_fused_infer(sce, agn, pw, lay, fin, block_rows=64)
    want = kg.adasparse_fused_infer_ref(sce, agn, pw, lay, fin)
    assert bool(torch.isnan(got[50])) and bool(torch.isnan(want[50]))
    rest = torch.arange(100, device="cuda") != 50
    margin = kg.adasparse_threshold_margin(sce, agn, pw, lay, fin)[rest]
    err, near = _adasparse_gap(got[rest], want[rest], margin)
    assert err <= TOL and near == 0


@pytest.mark.parametrize("rows", [48, 64])
def test_adasparse_kernel_tile_that_does_not_fit_raises(gen, rows):
    """At KuaiRand's widths the [sce ‖ agn] tile and pruner 0's output take
    1640 floats a row: 48 and 64 rows do not fit beside the smallest ring
    and raise, naming the shared memory; it never falls back."""
    args = _adasparse_args(gen, 64, *KUAIRAND_ADASPARSE, 1.0)
    with pytest.raises(RuntimeError, match=f"shared memory.*block_rows={rows}"):
        kg.adasparse_fused_infer(*args, block_rows=rows)
    for bad in (8, 24, 80, 0):
        with pytest.raises(ValueError, match="block_rows"):
            kg.adasparse_fused_infer(*args, block_rows=bad)


def _adasparse_both_signs(gen, B, S, A, dims):
    """Pruner inputs that are exact integers, -S/2 .. S/2, far from every
    threshold: sce of +-1, the pruners' sce rows +-0.5 and their other rows
    0. Every sum is exact in any order, and a few percent of the factors are
    negative (v <= -5 for Binarization, v <= -6 for Scaling and Fusion)."""
    sign = lambda *shape: torch.randint(0, 2, shape, generator=gen, device="cuda") * 2.0 - 1.0
    sce = sign(B, S)
    agn = torch.randn(B, A, generator=gen, device="cuda")
    pw = [torch.cat([0.5 * sign(S, h), torch.zeros(h, h, device="cuda")]) for h in [A] + dims]
    lay = _affines(gen, (), [S + A] + dims)
    return sce, agn, pw, lay, _affines(gen, (), [dims[-1] if dims else S + A, 1])[0]


@pytest.mark.parametrize("form", ["Binarization", "Scaling", "Fusion"])
def test_adasparse_kernel_both_signs(gen, form):
    args = _adasparse_both_signs(gen, 4096, 16, 352, [256, 128, 64, 32, 16, 8])
    kw = dict(form=form, epsilon=1e-2, beta=2.0)
    got = kg.adasparse_fused_infer(*args, **kw)
    want = kg.adasparse_fused_infer_ref(*args, **kw)
    assert (got - want).abs().max().item() <= TOL
    assert kg.adasparse_threshold_margin(*args, **kw).min().item() > 1e-3
    v0 = args[0] @ args[2][0][:16]
    assert bool((v0 <= (-5 if form == "Binarization" else -6)).any())  # negative factors


def test_adasparse_kernel_sign_is_zero_at_the_threshold(gen):
    """Zero pruner weights put every pruner input at exactly 0.5: with
    epsilon there every factor is sign(0) = 0, so the output is the head's
    bias through the sigmoid."""
    sce, agn, pw, lay, fin = _adasparse_args(gen, 50, 4, 12, [6], 1.0)
    pw = [torch.zeros_like(p) for p in pw]
    for form, eps in (("Binarization", 0.5), ("Scaling", 1.0), ("Fusion", 1.0)):
        got = kg.adasparse_fused_infer(sce, agn, pw, lay, fin, form=form, epsilon=eps, beta=2.0)
        assert torch.equal(got, torch.sigmoid(fin[1]).expand(50))


def test_gated_kernels_reject_what_they_do_not_take(gen):
    sce, agn, pw, lay, fin = _adasparse_args(gen, 10, 4, 12, [6], 1.0)
    with pytest.raises(ValueError):
        kg.adasparse_fused_infer(sce, agn, pw, lay, fin, block_rows=12)
    with pytest.raises(ValueError):
        kg.adasparse_fused_infer(sce.double(), agn, pw, lay, fin)
    with pytest.raises(ValueError):
        kg.adasparse_fused_infer(sce, agn.cpu(), pw, lay, fin)
    assert kg.adasparse_fused_infer(sce[:0], agn[:0], pw, lay, fin).shape == (0,)
    g = torch.randn(10, 20, generator=gen, device="cuda")
    did = torch.zeros(10, dtype=torch.long, device="cuda")
    with pytest.raises(ValueError, match="layers"):
        kg.ppnet_fused_infer(g, did, *_ppnet_args(gen, 20, 2, [4] * 31))
    emb, args = _sarnet_args(gen, 10, 20, 2, 2, 1, 4, [4])
    with pytest.raises(ValueError):
        ksn.sarnet_fused_infer(emb, did.float(), *args)
    wide = torch.randn(16, 9000, device="cuda")  # the tile exceeds shared memory
    with pytest.raises(RuntimeError, match="shared memory"):
        kg.epnet_fused_infer(wide[:, :8].contiguous(), wide, *_affines(gen, (), [9008, 8]),
                             *_affines(gen, (), [8, 9000]), _affines(gen, (), [9000, 1])[0])


# -- hamur_segment and adaptdhm_fused_infer -----------------------------------

from scenario_wise_rec_tpu_torch.ops.kernels import adaptdhm_infer as ka  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import hamur_infer as kh  # noqa: E402


def _hamur_adapter(gen, w, k, mid):
    shapes = {"u_down": (w, k), "v_down": (k, mid), "b_down": (mid,), "u_up": (mid, k),
              "v_up": (k, w), "b_up": (w,)}
    a = {n: 0.3 * torch.randn(*s, generator=gen, device="cuda") for n, s in shapes.items()}
    a["gamma"] = 0.5 + torch.rand(w, generator=gen, device="cuda")
    a["beta"] = 0.1 * torch.randn(w, generator=gen, device="cuda")
    return a


def _segment_gap(got, want):
    """max |got - want| over the scale of the plain output: the segments'
    outputs are not bounded by 1, the probabilities are."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("cfg", [
    # (B, F, D, first's blocks, middle's blocks, final's blocks, k, mid, block_rows;
    #  None: the kernel's choice)
    (4096, 376, 3, [256, 128, 64, 64, 32, 16], [8], [], 65, 32, 16),  # HamurLarge, Ali-CCP
    (4096, 376, 3, [256, 128, 64, 64, 32, 16], [8], [], 65, 32, None),
    # ragged, H[b] 16-byte aligned only for every 4th row (16,900 B a row)
    (4095, 376, 3, [256, 128, 64, 64, 32, 16], [8], [], 65, 32, 32),
    (4095, 376, 3, [256, 128], [], [], 35, 32, 16),  # HamurSmall's blocks, ragged; k 35
    (4096, 800, 5, [256, 128], [], [], 35, 32, None),  # HamurSmall at KuaiRand's width
    (333, 41, 2, [7], [], [5], 3, 5, 16),            # widths not multiples of 4
    (130, 30, 5, [6], [9, 6], [4, 4], 9, 7, 48),     # 5 domains; deeper middle and final
    (1, 20, 3, [8], [4], [], 4, 3, 64),
])
def test_hamur_segment_kernel_matches_plain(gen, cfg):
    """Each form of the segment alone, from the same inputs; domain ids
    -2..D+2, as int64 and as int32 in the final form."""
    B, F, D, d1, d2, d3, k, mid, rows = cfg
    emb = torch.randn(B, F, generator=gen, device="cuda")
    hyper = 0.4 * torch.randn(B, k, k, generator=gen, device="cuda")
    did = torch.randint(-2, D + 3, (B,), generator=gen, device="cuda")
    st1 = _affines(gen, (D,), [F] + d1)
    w1 = d1[-1] if d1 else F
    a1 = _hamur_adapter(gen, w1, k, mid)
    before = kh.hamur_segment.launches
    t, h = kh.hamur_segment(emb, st1, hyper=hyper, adapter=a1, block_rows=rows)
    torch.cuda.synchronize()
    assert kh.hamur_segment.launches == before + 1
    rt, rh = kh.hamur_segment_ref(emb, st1, hyper=hyper, adapter=a1)
    assert t.shape == h.shape == (B, D, w1) and bool(torch.isfinite(t).all())
    assert max(_segment_gap(t, rt), _segment_gap(h, rh)) <= TOL
    dn = (0.2 * torch.randn(D, w1, generator=gen, device="cuda"),   # mean, scale, shift
          0.5 + torch.rand(D, w1, generator=gen, device="cuda"),
          0.1 * torch.randn(D, w1, generator=gen, device="cuda"))
    st2 = _affines(gen, (D,), [w1] + d2)
    a2 = _hamur_adapter(gen, d2[-1] if d2 else w1, k, mid)
    t2, h2 = kh.hamur_segment(rh, st2, hyper=hyper, adapter=a2, dn_affine=dn, t_pre=rt,
                              block_rows=rows)
    torch.cuda.synchronize()
    rt2, rh2 = kh.hamur_segment_ref(rh, st2, hyper=hyper, adapter=a2, dn_affine=dn, t_pre=rt)
    assert max(_segment_gap(t2, rt2), _segment_gap(h2, rh2)) <= TOL
    st3 = _affines(gen, (D,), [w1] + d3)
    fin = _affines(gen, (D,), [d3[-1] if d3 else w1, 1])[0]
    for x, tp, dna in ((rh, rt, dn), (emb, None, None)):  # after an adapter; no adapter
        s3 = st3 if x.ndim == 3 else _affines(gen, (D,), [F] + d3)
        f3 = fin if x.ndim == 3 else _affines(gen, (D,), [d3[-1] if d3 else F, 1])[0]
        got = kh.hamur_segment(x, s3, dn_affine=dna, t_pre=tp, final=f3, domain_id=did,
                               block_rows=rows)
        torch.cuda.synchronize()
        want = kh.hamur_segment_ref(x, s3, dn_affine=dna, t_pre=tp, final=f3, domain_id=did)
        assert got.shape == (B,) and (got - want).abs().max().item() <= TOL
        assert torch.equal(got, kh.hamur_segment(x, s3, dn_affine=dna, t_pre=tp, final=f3,
                                                 domain_id=did.to(torch.int32),
                                                 block_rows=rows))


@pytest.mark.parametrize("cfg", [
    # (B, F, D, segments' block dims, k, padded rows, block_rows)
    (4096, 376, 3, [[256, 128, 64, 64, 32, 16], [8], []], 65, 0, 16),  # HamurLarge
    (4096, 376, 3, [[256, 128, 64, 64, 32, 16], [8], []], 65, 0, None),
    (1000, 376, 3, [[256, 128], []], 35, 217, 16),                     # HamurSmall, padded
    (4096, 800, 5, [[256, 128], []], 35, 0, None),       # HamurSmall at KuaiRand's width
    (45, 24, 2, [[16, 12], [], [4]], 4, 7, 16),
])
def test_hamur_fused_infer_matches_plain(gen, cfg):
    """The whole chain: one launch per segment; the probabilities within
    TOL of the plain chain (the norm statistics come from the same plain
    reduction on nearly equal inputs)."""
    B, F, D, seg_dims, k, n_pad, rows = cfg
    emb = torch.randn(B, F, generator=gen, device="cuda")
    did = torch.randint(-2, D + 3, (B,), generator=gen, device="cuda")
    hyper = _affines(gen, (), [F, 64, k * k])
    segments, adapters, width = [], [], F
    for j, dims in enumerate(seg_dims):
        segments.append(_affines(gen, (D,), [width] + dims))
        width = dims[-1] if dims else width
        if j < len(seg_dims) - 1:
            adapters.append(_hamur_adapter(gen, width, k, 32))
    final = _affines(gen, (D,), [width, 1])[0]
    w = torch.ones(B, device="cuda")
    w[B - n_pad:] = 0.0
    args = (emb, did, hyper, k, segments, adapters, final)
    before = kh.hamur_segment.launches
    got = kh.hamur_fused_infer(*args, w=w, block_rows=rows)
    torch.cuda.synchronize()
    assert kh.hamur_segment.launches == before + len(seg_dims)
    want = kh.hamur_fused_infer_ref(*args, w=w)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want)[w > 0].abs().max().item() <= TOL


def test_hamur_segment_rejects_what_it_does_not_take(gen):
    emb = torch.randn(10, 20, generator=gen, device="cuda")
    st = _affines(gen, (2,), [20, 8])
    hy = torch.randn(10, 4, 4, generator=gen, device="cuda")
    a = _hamur_adapter(gen, 8, 4, 3)
    for rows in (8, 12, 0, 72):
        with pytest.raises(ValueError):
            kh.hamur_segment(emb, st, hyper=hy, adapter=a, block_rows=rows)
    with pytest.raises(ValueError):
        kh.hamur_segment(emb, st, hyper=hy.cpu(), adapter=a)
    with pytest.raises(ValueError):
        kh.hamur_segment(emb.double(), st, hyper=hy, adapter=a)
    t, h = kh.hamur_segment(emb[:0], st, hyper=hy[:0], adapter=a)
    assert t.shape == h.shape == (0, 2, 8)
    wide = torch.randn(16, 9000, device="cuda")  # the tile exceeds shared memory
    with pytest.raises(RuntimeError, match="shared memory"):
        kh.hamur_segment(wide, _affines(gen, (2,), [9000, 8]), hyper=hy[:1].expand(16, 4, 4)
                         .contiguous(), adapter=a, block_rows=64)


def test_hamur_segment_kernel_reads_misaligned_hyper_rows(gen):
    """H starting 4 bytes past a 16-byte boundary (a view one row into a
    larger tensor) at k = 65 and at k = 35: every row's H is copied whole,
    its aligned middle in bulk and its ragged ends by 4-byte copies."""
    for k, B in ((65, 1001), (35, 517)):
        emb = torch.randn(B, 40, generator=gen, device="cuda")
        big = 0.4 * torch.randn(B + 1, k, k, generator=gen, device="cuda")
        hyper = big[1:]
        assert hyper.data_ptr() % 16 != 0 and hyper.is_contiguous()
        st = _affines(gen, (3,), [40, 24, 16])
        a = _hamur_adapter(gen, 16, k, 32)
        t, h = kh.hamur_segment(emb, st, hyper=hyper, adapter=a)
        torch.cuda.synchronize()
        rt, rh = kh.hamur_segment_ref(emb, st, hyper=hyper, adapter=a)
        assert max(_segment_gap(t, rt), _segment_gap(h, rh)) <= TOL


def test_hamur_segment_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix inside a launch: a NaN in one row of each form's input
    leaves every other row as the plain version computes it. (Across the
    chain the norm statistics mix rows, so it is held per form only.)"""
    B, F, D, k = 100, 376, 3, 65
    emb = torch.randn(B, F, generator=gen, device="cuda")
    emb[50, 7] = float("nan")
    hyper = 0.4 * torch.randn(B, k, k, generator=gen, device="cuda")
    st1 = _affines(gen, (D,), [F, 256, 128, 64, 64, 32, 16])
    a1 = _hamur_adapter(gen, 16, k, 32)
    rest = torch.arange(B, device="cuda") != 50

    def held(got, want):
        for g_, w_ in zip(got, want):
            assert bool(torch.isnan(g_[50]).any()) and bool(torch.isnan(w_[50]).any())
            assert bool(torch.isfinite(g_[rest]).all())
            assert _segment_gap(g_[rest], w_[rest]) <= TOL

    held(kh.hamur_segment(emb, st1, hyper=hyper, adapter=a1, block_rows=32),
         kh.hamur_segment_ref(emb, st1, hyper=hyper, adapter=a1))
    t = torch.randn(B, D, 16, generator=gen, device="cuda")
    h = torch.randn(B, D, 16, generator=gen, device="cuda")
    h[50, 1, 3] = float("nan")
    dn = (0.2 * torch.randn(D, 16, generator=gen, device="cuda"),
          0.5 + torch.rand(D, 16, generator=gen, device="cuda"),
          0.1 * torch.randn(D, 16, generator=gen, device="cuda"))
    st2 = _affines(gen, (D,), [16, 8])
    a2 = _hamur_adapter(gen, 8, k, 32)
    kw = dict(hyper=hyper, adapter=a2, dn_affine=dn, t_pre=t)
    held(kh.hamur_segment(h, st2, block_rows=32, **kw), kh.hamur_segment_ref(h, st2, **kw))
    did = torch.full((B,), 1, device="cuda")
    fin = _affines(gen, (D,), [16, 1])[0]
    kw = dict(dn_affine=dn, t_pre=t, final=fin, domain_id=did)
    held([kh.hamur_segment(h, [], **kw)], [kh.hamur_segment_ref(h, [], **kw)])


# AdaptDHM at Ali-CCP (scenario loader: F = 22 x 16 + 16, [256, ..., 8], 3
# clusters) and on KuaiRand's ladder ([64, 64], 3 clusters; 796 sparse
# columns and the scenario feature's 16)
ALI_DHM = (368, 3, [256, 128, 64, 32, 16, 8])
KUAIRAND_DHM = (812, 3, [64, 64])


def _adaptdhm_stages(gen, F, C, dims):
    return [w for w, _ in _affines(gen, (C,), [F] + dims + [1])]


@pytest.mark.parametrize("cfg", [
    # (B, (F, C, hidden dims), router ids: drawn from (lo, hi) or counts of
    #  each cluster, block_rows)
    (4096, ALI_DHM, (0, 3), 16),                        # Ali-CCP
    (4096, ALI_DHM, (0, 3), None),
    (4095, ALI_DHM, (-2, 8), 32),                       # ragged; ids -2..7, clipped
    (333, (41, 2, [7]), (0, 2), 16),                    # widths not multiples of 8
    (130, (50, 5, []), (0, 5), 48),                     # one stage: the head alone
    (64, (12, 4, [9, 5, 3]), (1, 3), 64),               # clusters 0 and 3 absent
    (4096, ALI_DHM, [3700, 300, 96], None),             # skewed: 90 % in cluster 0
    (4096, ALI_DHM, [96, 300, 3700], 48),
    (4096, ALI_DHM, [0, 4096, 0], 64),                  # every row in one cluster
    (66, ALI_DHM, [33, 32, 1], 32),                     # counts astride 32-row tiles
    (100, ALI_DHM, [33, 1, 66], 16),                    # and 16-row tiles
    (1, ALI_DHM, (0, 3), None),
    (65_536, ALI_DHM, (0, 3), None),            # the largest B the partition is held to
    (4096, KUAIRAND_DHM, (0, 3), None),                 # KuaiRand's ladder
    (4096, KUAIRAND_DHM, (0, 3), 48),
    (300, (70, 256, [33]), (-2, 260), 16),              # the most clusters
])
def test_adaptdhm_kernel_matches_plain(gen, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version, one launch a call on AdaptDHM's counter and none on
    SharedBottom's or STAR's, whose kernel it runs."""
    B, (F, C, dims), ids, rows = cfg
    stages = _adaptdhm_stages(gen, F, C, dims)
    emb = torch.randn(B, F, generator=gen, device="cuda")
    rid = _m3oe_ids(gen, B, C, ids)
    before = ka.adaptdhm_fused_infer.launches
    others = kt.trunk_towers_fused_infer.launches, ks.star_fused_infer.launches
    got = _unwritten_nan(ka.adaptdhm_fused_infer, emb, rid, stages, block_rows=rows)
    torch.cuda.synchronize()
    assert ka.adaptdhm_fused_infer.launches == before + 1
    assert (kt.trunk_towers_fused_infer.launches, ks.star_fused_infer.launches) == others
    want = ka.adaptdhm_fused_infer_ref(emb, rid, stages)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("ladder", [ALI_DHM, KUAIRAND_DHM])
@pytest.mark.parametrize("rows", [16, 32, 48, 64, None])
def test_adaptdhm_kernel_every_tile(gen, ladder, rows):
    """At Ali-CCP's widths every tile of the rule fits beside the ring (the
    emb tile and the first 256-wide tile take 648 floats a row) and matches
    the plain version; at KuaiRand's (the emb tile and the first 64-wide
    tile take 904 floats a row) 64 rows do not fit and raise, naming the
    shared memory."""
    F, C, dims = ladder
    stages = _adaptdhm_stages(gen, F, C, dims)
    emb = torch.randn(4096, F, generator=gen, device="cuda")
    rid = torch.argmax(torch.randn(4096, C, generator=gen, device="cuda"), dim=1)
    if ladder is KUAIRAND_DHM and rows == 64:
        with pytest.raises(RuntimeError, match=f"shared memory.*block_rows={rows}"):
            ka.adaptdhm_fused_infer(emb, rid, stages, block_rows=rows)
        return
    got = _unwritten_nan(ka.adaptdhm_fused_infer, emb, rid, stages, block_rows=rows)
    want = ka.adaptdhm_fused_infer_ref(emb, rid, stages)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_adaptdhm_kernel_reads_int32_and_int64_ids_alike(gen):
    """int64 router ids (argmax's) are read as they are (no cast launch: one
    launch a call), taken modulo 2^32 as int32 and clipped: the same outputs
    as the int32 ids, bit for bit."""
    stages = _adaptdhm_stages(gen, *ALI_DHM)
    emb = torch.randn(4096, 368, generator=gen, device="cuda")
    rid = torch.randint(-2, 6, (4096,), generator=gen, device="cuda")
    got = ka.adaptdhm_fused_infer(emb, rid.to(torch.int32), stages)
    before = ka.adaptdhm_fused_infer.launches
    assert torch.equal(got, ka.adaptdhm_fused_infer(emb, rid.to(torch.int64), stages))
    assert torch.equal(got, ka.adaptdhm_fused_infer(emb, rid + 2**32, stages))
    assert ka.adaptdhm_fused_infer.launches == before + 2
    wrap = torch.tensor([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, 1, 7, -5],
                        device="cuda")
    e8 = emb[:8].contiguous()
    assert torch.equal(ka.adaptdhm_fused_infer(e8, wrap, stages),
                       ka.adaptdhm_fused_infer(
                           e8, torch.tensor([1, 0, 0, 2, 2, 1, 2, 0], device="cuda"), stages))
    assert (ka.adaptdhm_fused_infer(e8, wrap, stages)
            - ka.adaptdhm_fused_infer_ref(e8, wrap, stages)).abs().max().item() <= TOL


def test_adaptdhm_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of emb leaves every other row of its
    cluster's tile as the plain version computes it."""
    stages = _adaptdhm_stages(gen, *ALI_DHM)
    emb = torch.randn(100, 368, generator=gen, device="cuda")
    emb[50, 7] = float("nan")
    rid = torch.zeros(100, dtype=torch.long, device="cuda")
    got = ka.adaptdhm_fused_infer(emb, rid, stages, block_rows=32)
    want = ka.adaptdhm_fused_infer_ref(emb, rid, stages)
    assert bool(torch.isnan(got[50])) and bool(torch.isnan(want[50]))
    rest = torch.arange(100, device="cuda") != 50
    assert (got[rest] - want[rest]).abs().max().item() <= TOL


def test_adaptdhm_kernel_rejects_what_it_does_not_take(gen):
    stages = [w for w, _ in _affines(gen, (2,), [20, 8, 1])]
    emb = torch.randn(10, 20, generator=gen, device="cuda")
    rid = torch.zeros(10, dtype=torch.long, device="cuda")
    for rows in (8, 12, 24, 0, 72):
        with pytest.raises(ValueError, match="block_rows"):
            ka.adaptdhm_fused_infer(emb, rid, stages, block_rows=rows)
    with pytest.raises(ValueError):
        ka.adaptdhm_fused_infer(emb, rid.cpu(), stages)
    with pytest.raises(ValueError):
        ka.adaptdhm_fused_infer(emb, rid, [stages[0].double(), stages[1]])
    with pytest.raises(ValueError, match="clusters"):
        ka.adaptdhm_fused_infer(emb, rid, [w for w, _ in _affines(gen, (257,), [20, 8, 1])])
    with pytest.raises(ValueError, match="stages"):
        ka.adaptdhm_fused_infer(emb, rid, [w for w, _ in _affines(gen, (2,), [20] + [8] * 96
                                                                   + [1])])
    assert ka.adaptdhm_fused_infer(emb[:0], rid[:0], stages).shape == (0,)
    wide = [w for w, _ in _affines(gen, (2,), [20, 3000, 1])]  # 64 x 3000 rows exceed it
    with pytest.raises(RuntimeError, match="shared memory"):
        ka.adaptdhm_fused_infer(emb, rid, wide, block_rows=64)


# -- m2m_fused_infer and m3oe_fused_infer -------------------------------------

from scenario_wise_rec_tpu_torch.ops.kernels import m2m_infer as km  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import m3oe_infer as k3  # noqa: E402


def _m2m_args(gen, F, Fd, E, nE, expert_dims, hyper_dims, out_dims):
    """``m2m_fused_infer``'s weights after its two inputs: hyper_dims are the
    hidden widths of every hyper-MLP, before its generated output."""
    hyper = lambda i, o: _affines(gen, (), [i] + hyper_dims + [o])
    return (_affines(gen, (nE,), [F] + expert_dims + [E]), hyper(Fd, E), hyper(Fd, E),
            hyper(E, 4 * E * E), hyper(E, 2 * E), hyper(E, E * E), hyper(E, E),
            torch.randn(2 * E, 1, generator=gen, device="cuda"),
            _affines(gen, (), [E] + out_dims), _affines(gen, (), [(out_dims or [E])[-1], 1])[0])


# M2M at Ali-CCP: F 376, Fd 16, E 16, 4 experts, no hidden expert or hyper
# stage, output MLP [64, 32]
ALI_M2M = (376, 16, 16, 4, [], [], [64, 32])


@pytest.mark.parametrize("cfg", [
    # (B, F, Fd, E, nE, expert hidden, hyper hidden, output MLP, block_rows;
    # None: the kernel's choice)
    *[(4096, *ALI_M2M, rows) for rows in (16, 32, 48, 64, None)],  # every tile fits
    *[(4095, *ALI_M2M, rows) for rows in (16, 32, 48, 64, None)],  # a partial last tile
    (1, *ALI_M2M, None),
    (65_536, *ALI_M2M, None),
    # E 5: widths off 8 (vw 100 wide, one chunk; tw 25), a product an expert,
    # hidden expert and hyper stages
    (333, 41, 7, 5, 3, [9], [6], [7], 16),
    (333, 41, 7, 5, 3, [9], [6], [7], 64),
    # the experts' first stage side by side (3 x 24), their second a product
    # an expert
    (200, 40, 8, 8, 3, [24], [12], [16], 32),
    (1, 20, 8, 8, 2, [], [], [], 64),               # no output MLP: the head on h
    (300, 20, 8, 8, 2, [], [], [], None),
    (50, 12, 4, 4, 1, [], [], [8], 16),             # one expert
    # E 32: vw 4096 wide (16 chunks), tw 1024 (both tensor copies), 2 experts
    # of 32 side by side
    (100, 64, 8, 32, 2, [], [], [16], None),
    (100, 30, 8, 4, 8, [], [], [8], 16),            # 8 experts of 4: a product each
    (100, 30, 8, 16, 8, [], [], [8], 48),           # 8 experts of 16: 128 columns, a product each
])
def test_m2m_kernel_matches_plain(gen, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version, one launch a call."""
    B, F, Fd, E, nE, ed, hd, od, rows = cfg
    t_out = torch.randn(B, F, generator=gen, device="cuda")
    dom = torch.randn(B, Fd, generator=gen, device="cuda")
    args = _m2m_args(gen, F, Fd, E, nE, ed, hd, od)
    before = km.m2m_fused_infer.launches
    got = _unwritten_nan(km.m2m_fused_infer, t_out, dom, *args, E=E, block_rows=rows)
    torch.cuda.synchronize()
    assert km.m2m_fused_infer.launches == before + 1
    want = km.m2m_fused_infer_ref(t_out, dom, *args, E=E)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_m2m_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of t_out, another in one row of
    dom_emb, leave every other row of their tiles as the plain version
    computes it."""
    t_out = torch.randn(100, 376, generator=gen, device="cuda")
    dom = torch.randn(100, 16, generator=gen, device="cuda")
    args = _m2m_args(gen, 376, 16, 16, 4, [], [], [64, 32])
    t_out[50, 7] = float("nan")
    dom[70, 3] = float("nan")
    got = km.m2m_fused_infer(t_out, dom, *args, E=16, block_rows=64)
    want = km.m2m_fused_infer_ref(t_out, dom, *args, E=16)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want)) and nan.nonzero().flatten().tolist() == [50, 70]
    assert (got[~nan] - want[~nan]).abs().max().item() <= TOL


def test_m2m_kernel_rejects_what_it_does_not_take(gen):
    t_out = torch.randn(10, 20, generator=gen, device="cuda")
    dom = torch.randn(10, 8, generator=gen, device="cuda")
    args = _m2m_args(gen, 20, 8, 4, 2, [], [], [8])
    before = km.m2m_fused_infer.launches
    for rows in (8, 12, 24, 80, 0):
        with pytest.raises(ValueError, match="block_rows"):
            km.m2m_fused_infer(t_out, dom, *args, E=4, block_rows=rows)
    with pytest.raises(ValueError):
        km.m2m_fused_infer(t_out, dom.cpu(), *args, E=4)
    with pytest.raises(ValueError):
        km.m2m_fused_infer(t_out.double(), dom, *args, E=4)
    with pytest.raises(ValueError):  # E does not match the generated widths
        km.m2m_fused_infer(t_out, dom, *args, E=5)
    with pytest.raises(ValueError, match="experts"):
        km.m2m_fused_infer(t_out, dom, *_m2m_args(gen, 20, 8, 4, 9, [], [], [8]), E=4)
    with pytest.raises(ValueError, match="products"):  # 8 experts of 5 stages: 40 + 7
        km.m2m_fused_infer(t_out, dom, *_m2m_args(gen, 20, 8, 4, 8, [8] * 4, [], [8]), E=4)
    assert km.m2m_fused_infer.launches == before
    assert km.m2m_fused_infer(t_out[:0], dom[:0], *args, E=4).shape == (0,)
    # at KuaiRand's widths (F 812) the t_out tile and those alive beside it
    # take 1012 floats a row: 64 rows do not fit beside the smallest ring
    wide = torch.randn(64, 812, generator=gen, device="cuda")
    with pytest.raises(RuntimeError, match="shared memory.*block_rows=64"):
        km.m2m_fused_infer(wide, torch.randn(64, 16, device="cuda"),
                           *_m2m_args(gen, 812, 16, 16, 4, [], [], [64, 32]), E=16,
                           block_rows=64)


def _ln_layers(gen, lead, dims):
    return [(w, b, 0.5 + torch.rand(*lead, w.shape[-1], generator=gen, device="cuda"),
             0.1 * torch.randn(*lead, w.shape[-1], generator=gen, device="cuda"))
            for w, b in _affines(gen, lead, dims)]


def _m3oe_args(gen, s0, s1, s2, D, E, fcn, skip_hidden=()):
    """``m3oe_fused_infer``'s weights after ``(emb, domain_id)``."""
    l1 = _ln_layers(gen, (D,), [fcn[-1], fcn[-1]])[0]
    return (_affines(gen, (D,), [s0, s1])[0], _ln_layers(gen, (), [s0, *skip_hidden, s2]),
            _ln_layers(gen, (), [s1, s2]), _affines(gen, (D,), [s2, E])[0],
            _ln_layers(gen, (E,), [s2] + fcn), _ln_layers(gen, (D,), [s2] + fcn),
            (*l1, *_affines(gen, (D,), [fcn[-1], 1])[0]),
            torch.rand(1, generator=gen, device="cuda"),
            torch.rand(1, generator=gen, device="cuda"))


ALI_M3OE = (376, 512, 256, 3, 4, [64], ())  # s0, s1, s2, D, E, expert widths, skip hidden
# KuaiRand's M3oE ladder (fcn_dims [128, 64, 64, 32], 5 domains) at MMOE's
# KuaiRand F 800
KUAIRAND_M3OE = (800, 128, 64, 5, 4, [32], ())


def _m3oe_ids(gen, B, D, ids):
    """``[B]`` ids: uniform over ``ids = (lo, hi)`` (clipped by the kernel),
    or ``ids`` rows of each domain (a list of counts), shuffled."""
    if isinstance(ids, tuple):
        return torch.randint(*ids, (B,), generator=gen, device="cuda")
    return _ppnet_ids(gen, B, D, ids)


@pytest.mark.parametrize("cfg", [
    # (B, (s0, s1, s2, D, E, expert widths, skip hidden), ids: drawn from (lo, hi)
    #  or counts of each domain, block_rows)
    (4096, ALI_M3OE, (0, 3), 16),                       # Ali-CCP
    (4095, ALI_M3OE, (-2, 6), 32),                      # ragged; ids -2..5, clipped
    (333, (41, 23, 13, 2, 3, [9, 5], (11,)), (0, 2), 48),  # two layers a chain
    (130, (30, 16, 12, 1, 2, [6], ()), (0, 1), 64),     # one domain: its own branch
    (1, (20, 8, 8, 4, 2, [4], ()), (3, 4), None),
    (4096, ALI_M3OE, [3700, 300, 96], None),            # skewed: 90 % in domain 0
    (4096, ALI_M3OE, [0, 4096, 0], 32),                 # every row in one domain
    (66, ALI_M3OE, [33, 32, 1], 32),                    # counts astride 32-row tiles
    (100, ALI_M3OE, [33, 1, 66], 16),                   # and 16-row tiles
    (4096, KUAIRAND_M3OE, (0, 5), None),                # KuaiRand's width
    (4096, KUAIRAND_M3OE, (0, 5), 48),
    (300, (40, 300, 270, 2, 2, [270, 20], (33,)), (0, 2), 16),  # widths past one 256-column pass
    (1000, (100, 64, 48, 5, 6, [64], ()), (0, 5), 32),  # 6 experts, 5 domains
    (65_536, ALI_M3OE, (0, 3), None),                   # the largest B the partition is held to
])
def test_m3oe_kernel_matches_plain(gen, cfg):
    """Every row written (the output starts out as NaN) and within TOL of
    the plain version, one launch a call."""
    B, (s0, s1, s2, D, E, fcn, skip_hidden), ids, rows = cfg
    emb = torch.randn(B, s0, generator=gen, device="cuda")
    did = _m3oe_ids(gen, B, D, ids)
    args = _m3oe_args(gen, s0, s1, s2, D, E, fcn, skip_hidden)
    before = k3.m3oe_fused_infer.launches
    got = _unwritten_nan(k3.m3oe_fused_infer, emb, did, *args, block_rows=rows)
    torch.cuda.synchronize()
    assert k3.m3oe_fused_infer.launches == before + 1
    want = k3.m3oe_fused_infer_ref(emb, did, *args)
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("rows", [16, 32, 48, 64, None])
def test_m3oe_kernel_every_tile_at_ali_ccp(gen, rows):
    """At Ali-CCP's widths the emb, skip and star tiles of 16 or 32 rows fit
    beside the ring and match the plain version; 48 and 64 rows do not fit
    and raise, naming the shared memory."""
    s0, s1, s2, D, E, fcn, skip_hidden = ALI_M3OE
    emb = torch.randn(4096, s0, generator=gen, device="cuda")
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    args = _m3oe_args(gen, s0, s1, s2, D, E, fcn, skip_hidden)
    if rows in (48, 64):
        with pytest.raises(RuntimeError, match=f"shared memory.*block_rows={rows}"):
            k3.m3oe_fused_infer(emb, did, *args, block_rows=rows)
        return
    got = _unwritten_nan(k3.m3oe_fused_infer, emb, did, *args, block_rows=rows)
    want = k3.m3oe_fused_infer_ref(emb, did, *args)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= TOL


def test_m3oe_kernel_reads_int32_and_int64_ids_alike(gen):
    """int64 ids are read as they are (no cast launch), taken modulo 2^32 as
    int32 and clipped: the same outputs as the int32 ids, bit for bit."""
    s0, s1, s2, D, E, fcn, skip_hidden = ALI_M3OE
    args = _m3oe_args(gen, s0, s1, s2, D, E, fcn, skip_hidden)
    emb = torch.randn(4096, s0, generator=gen, device="cuda")
    did = torch.randint(-2, D + 3, (4096,), generator=gen, device="cuda")
    got = k3.m3oe_fused_infer(emb, did.to(torch.int32), *args)
    assert torch.equal(got, k3.m3oe_fused_infer(emb, did.to(torch.int64), *args))
    wrap = torch.tensor([2**32 + 1, 2**32 - 1, 2**31, 2**33 + 2, -2**32 + 2, 1, 7, -5],
                        device="cuda")
    e8 = emb[:8].contiguous()
    assert torch.equal(k3.m3oe_fused_infer(e8, wrap, *args), k3.m3oe_fused_infer(
        e8, torch.tensor([1, 0, 0, 2, 2, 1, 2, 0], device="cuda"), *args))
    assert (k3.m3oe_fused_infer(e8, wrap, *args)
            - k3.m3oe_fused_infer_ref(e8, wrap, *args)).abs().max().item() <= TOL


def test_m3oe_kernel_keeps_a_nan_in_its_row(gen):
    """Rows never mix: a NaN in one row of emb leaves every other row of its
    domain's tile as the plain version computes it."""
    s0, s1, s2, D, E, fcn, skip_hidden = ALI_M3OE
    args = _m3oe_args(gen, s0, s1, s2, D, E, fcn, skip_hidden)
    emb = torch.randn(100, s0, generator=gen, device="cuda")
    emb[50, 7] = float("nan")
    did = torch.zeros(100, dtype=torch.int32, device="cuda")
    got = k3.m3oe_fused_infer(emb, did, *args, block_rows=32)
    want = k3.m3oe_fused_infer_ref(emb, did, *args)
    assert bool(torch.isnan(got[50])) and bool(torch.isnan(want[50]))
    rest = torch.arange(100, device="cuda") != 50
    assert (got[rest] - want[rest]).abs().max().item() <= TOL


def test_m3oe_kernel_rejects_what_it_does_not_take(gen):
    emb = torch.randn(10, 20, generator=gen, device="cuda")
    did = torch.zeros(10, dtype=torch.long, device="cuda")
    args = _m3oe_args(gen, 20, 16, 8, 2, 2, [4])
    for rows in (8, 12, 24, 80, 0):
        with pytest.raises(ValueError, match="block_rows"):
            k3.m3oe_fused_infer(emb, did, *args, block_rows=rows)
    with pytest.raises(ValueError):
        k3.m3oe_fused_infer(emb, did.cpu(), *args)
    with pytest.raises(ValueError):
        k3.m3oe_fused_infer(emb.double(), did, *args)
    with pytest.raises(ValueError):
        k3.m3oe_fused_infer(emb, did.float(), *args)
    with pytest.raises(ValueError, match="products"):  # 1 + 1 + 2 + 43 + 3 past 48
        k3.m3oe_fused_infer(emb, did, *_m3oe_args(gen, 20, 16, 8, 43, 2, [4]))
    assert k3.m3oe_fused_infer(emb[:0], did[:0], *args).shape == (0,)


# -- occurrence_segsum, scatter_rows, fused_dense_adam_apply --------------------

from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as kfa  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import row_update as kru  # noqa: E402


def _segsum_ids(gen, F, N, case, vocab=467_000):
    if case == "hot":  # row 0 all one id, the others Zipf
        r = np.random.default_rng(F * N)
        ids = np.minimum(r.zipf(1.2, (F, N)) - 1, vocab - 1)
        ids[0] = 17
        return torch.as_tensor(ids).cuda()
    if case == "threshold":  # row 0: runs of LONG_RUN and LONG_RUN + 1, scattered
        ids = torch.randint(0, vocab, (F, N), generator=gen, device="cuda")
        at = torch.randperm(N, generator=gen, device="cuda")
        ids[0, at[:kru.LONG_RUN]] = vocab + 1
        ids[0, at[kru.LONG_RUN:2 * kru.LONG_RUN + 1]] = vocab + 2
        return ids
    if case == "sentinels":  # negative ids and ids at and past any vocabulary
        ids = torch.randint(0, 50, (F, N), generator=gen, device="cuda")
        ids[:, ::7] = torch.tensor([-1, -7, vocab, vocab + 3, 2 ** 31 - 1, -2 ** 31],
                                   device="cuda").repeat(N)[:ids[:, ::7].shape[1]]
        return ids
    ids = torch.randint(0, vocab if case.startswith("uniform") else 7, (F, N), generator=gen,
                        device="cuda")
    return ids.to(torch.int32) if case.endswith("int32") else ids


def _assert_duplicates_bit_identical(ids, out):
    for f in range(ids.shape[0]):
        sid, perm = torch.sort(ids[f], stable=True)
        o, same = out[f][perm], sid[1:] == sid[:-1]
        assert torch.equal(o[1:][same], o[:-1][same])


@pytest.mark.parametrize("F,N,D,case", [
    (23, 4096, 16, "uniform"),   # Ali-CCP, one row a feature
    (1, 94208, 16, "uniform"),   # Ali-CCP in one launch, as the trainer calls it
    (3, 4097, 16, "hot"),        # a 4097-long run, ragged N
    (2, 1000, 3, "few"),         # D not a multiple of 4; 7 distinct ids a row
    (1, 70000, 12, "hot"),       # a 70000-long run
    (5, 1, 8, "uniform"),
    (23, 4096, 16, "uniform_int32"),  # int32 ids
    (3, 4096, 16, "sentinels"),  # ids < 0 and >= any V, compared as int32
    (4, 4096, 16, "threshold"),  # a run of LONG_RUN (lanes) and LONG_RUN + 1 (the block)
    (2, 16384, 16, "few"),       # rows at ROW_LIMIT: the shared-memory route
    (2, 16385, 16, "few"),       # one past it: the sorted route
    (2, 16384, 3, "hot"),        # at the limit with D = 3; a 16384-long run
])
def test_segsum_kernel_matches_plain(gen, F, N, D, case):
    ids = _segsum_ids(gen, F, N, case)
    g = torch.randn(F, N, D, generator=gen, device="cuda")
    before = kru.occurrence_segsum.launches
    got = kru.occurrence_segsum(ids, g)
    torch.cuda.synchronize()
    assert kru.occurrence_segsum.launches == before + 1
    want = kru.occurrence_segsum_ref(ids, g)
    # two f32 sums of a run's n terms in other orders: within n ulp of the
    # sum of |g| (the plain index_add_ uses atomics); a singleton is exact
    count = kru.occurrence_segsum_ref(ids, torch.ones_like(g[..., :1]))
    tol = count * 2.0 ** -23 * kru.occurrence_segsum_ref(ids, g.abs())
    assert bool(((got - want).abs() <= tol).all()), (got - want).abs().max().item()
    _assert_duplicates_bit_identical(ids, got)
    again = kru.occurrence_segsum(ids, g)
    assert torch.equal(again, got)  # the order of every sum is fixed by the data


@pytest.mark.parametrize("splits", [1, 2, 7, 23])
@pytest.mark.parametrize("case", ["uniform", "hot", "threshold"])
def test_segsum_splits_leave_the_sums_unchanged(gen, monkeypatch, splits, case):
    """Blocks per row only share out the runs: every count of blocks a row
    gives the default's bits."""
    ids = _segsum_ids(gen, 5, 4096, case)
    g = torch.randn(5, 4096, 16, generator=gen, device="cuda")
    want = kru.occurrence_segsum(ids, g)
    monkeypatch.setattr(kru, "_splits", lambda rows, device: splits)
    assert torch.equal(kru.occurrence_segsum(ids, g), want)


@pytest.mark.parametrize("segments", [
    tuple((f"f{f}", f * 4096, 4096) for f in range(23)),  # Ali-CCP: one [23, 4096] launch
    (("a", 0, 300), ("b", 300, 500), ("a", 800, 200), ("c", 1000, 500), ("d", 1500, 20000)),
])
def test_grouped_segsum_on_the_card(gen, segments):
    """The trainer's batching on the card: one launch per distinct owner
    length (alias segments of one owner merged, a 20000-long owner on the
    sorted route), equal to the plain version over the same layout."""
    from scenario_wise_rec_tpu_torch.train import optim

    K = sum(z for _, _, z in segments)
    ids = torch.empty(K, dtype=torch.long, device="cuda")
    spans = {o: i * 100_000 for i, o in enumerate(dict.fromkeys(o for o, _, _ in segments))}
    for owner, start, size in segments:
        ids[start:start + size] = spans[owner] + torch.randint(0, 3000, (size,), generator=gen,
                                                               device="cuda")
    g = torch.randn(K, 16, generator=gen, device="cuda")
    before = kru.occurrence_segsum.launches
    got = optim._grouped_occurrence_segsum(g, ids, segments)
    torch.cuda.synchronize()
    lengths = {}
    for owner, _, size in segments:
        lengths[owner] = lengths.get(owner, 0) + size
    assert kru.occurrence_segsum.launches - before == len(set(lengths.values()))
    want = kru.occurrence_segsum_ref(ids[None], g[None])[0]  # spans disjoint: one row
    count = kru.occurrence_segsum_ref(ids[None], torch.ones_like(g[None, :, :1]))[0]
    assert bool(((got - want).abs() <= count * 2.0 ** -23 *
                 kru.occurrence_segsum_ref(ids[None], g[None].abs())[0]).all())
    _assert_duplicates_bit_identical(ids[None], got[None])


def _wrapped(ids, V):
    """The row each id lands on: a negative id wraps once."""
    return torch.where(ids < 0, ids + V, ids)


@pytest.mark.parametrize("V,W,K", [(100_003, 48, 94_208), (5000, 5, 3000), (70, 16, 4000)])
def test_scatter_kernel_matches_plain(gen, V, W, K):
    ids = torch.randint(0, V, (K,), generator=gen, device="cuda")
    ids[:4] = torch.tensor([-1, V, V + 7, -V], device="cuda")  # -1, -V wrap; V, V+7 drop
    # duplicates carry identical rows: each row a function of the id it lands on
    rows = torch.randn(V + 8, W, generator=gen, device="cuda")[_wrapped(ids, V).clamp(0, V + 7)]
    dst = torch.randn(V, W, generator=gen, device="cuda")
    want = kru.scatter_rows_ref(dst.clone(), ids, rows)
    before = kru.scatter_rows.launches
    got = kru.scatter_rows(dst, ids.to(torch.int32), rows)
    torch.cuda.synchronize()
    assert got is dst and kru.scatter_rows.launches == before + 1
    assert torch.equal(got, want)
    kru.scatter_rows(dst, ids, rows)  # int64 ids
    assert torch.equal(dst, want)
    with pytest.raises(ValueError):
        kru.scatter_rows(dst.t(), ids, rows)
    with pytest.raises(ValueError):
        kru.scatter_rows(dst, ids.to(torch.int16), rows)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("V,W,K,offset", [
    (10_741_000, 48, 94_208, 0),  # the occurrence store: bulk copies
    (5000, 8, 3001, 0),           # a ragged last block of the bulk copies
    (70, 16, 4000, 1),            # rows 4 bytes off 16-byte alignment: the lanes
    (5000, 7, 3001, 0),           # W % 4 != 0: the lanes
    (3000, 896, 700, 0),          # the widest rows of the bulk copies (224 KB a block)
    (3000, 1024, 700, 0),         # wider: the lanes
])
def test_scatter_kernel_by_row_shape_matches_plain(gen, V, W, K, offset, dtype):
    """Each scatter kernel (bulk copies for 16-byte rows and pointers of at
    most 896 floats, lanes otherwise) exact against the plain version, with int64 and int32 ids
    and sentinels: -1 and -V wrap once, V and past it and -2^31 drop."""
    ids = torch.randint(0, V, (K,), generator=gen, device="cuda")
    ids[:6] = torch.tensor([-1, V, V + 7, -V, 2 ** 31 - 1, -2 ** 31], device="cuda")
    table = torch.randn(min(V, 100_000) + 8, W, generator=gen, device="cuda")
    buf = torch.empty(K * W + offset, device="cuda")
    rows = buf[offset:].view(K, W)
    # duplicates (a wrapped id and its twin too) carry identical rows
    rows.copy_(table[_wrapped(ids, V).remainder(table.shape[0])])
    dst = torch.randn(V, W, generator=gen, device="cuda")
    want = kru.scatter_rows_ref(dst.clone(), ids, rows)
    before = kru.scatter_rows.launches
    assert kru.scatter_rows(dst, ids.to(dtype), rows) is dst
    torch.cuda.synchronize()
    assert kru.scatter_rows.launches == before + 1
    assert torch.equal(dst, want)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("V,W", [(100_003, 48), (5000, 5), (3000, 1024)])
def test_scatter_kernels_wrap_negative_ids(gen, V, W, dtype):
    """The bulk copies (W = 48) and the lanes (W = 5, W = 1024) on ids -1,
    -V, -V-1 and negative twins of positive ids: a negative id wraps once
    and what is still outside [0, V) drops, equal to the plain version."""
    K = 4000
    ids = torch.randint(0, V, (K,), generator=gen, device="cuda")
    ids[:3] = torch.tensor([-1, -V, -V - 1], device="cuda")
    ids[3:200] = ids[200:397] - V  # wrapped twins of positive ids
    table = torch.randn(V, W, generator=gen, device="cuda")
    rows = table[_wrapped(ids, V).clamp(0, V - 1)]
    dst = torch.randn(V, W, generator=gen, device="cuda")
    want = kru.scatter_rows_ref(dst.clone(), ids, rows)
    assert torch.equal(want[[0, V - 1]], table[[0, V - 1]])  # -V and -1 landed
    before = kru.scatter_rows.launches
    assert kru.scatter_rows(dst, ids.to(dtype), rows) is dst
    torch.cuda.synchronize()
    assert kru.scatter_rows.launches == before + 1
    assert torch.equal(dst, want)


@pytest.mark.parametrize("V,D,sizes,case", [
    (50_003, 16, [4096, 4096, 4096, 100], "uniform"),
    (50_003, 16, [4096, 4096, 4096, 100], "hot"),
    (9_001, 3, [0, 2000, 17], "uniform"),
    (5_000, 16, [], "none"),
])
def test_fused_adam_kernel_matches_plain(gen, V, D, sizes, case):
    from scenario_wise_rec_tpu_torch.train.optim import segment_sorted_ids

    K = sum(sizes)
    ids = torch.randint(0, V // 3, (K,), generator=gen, device="cuda")  # upper tiles empty
    if case == "hot":
        ids[:4096] = 17
    if K > 4:
        ids[-4:] = torch.tensor([-1, V, V + 3, -7], device="cuda")
    segs = []
    for s in sizes:
        segs.append(("f", sum(z for _, _, z in segs), s))
    sid, pos, _ = segment_sorted_ids(ids, segs)
    table, mu, nu, _ = _sa_case(gen, V, D, ids)
    ref = [t.clone() for t in (table, mu, nu)]
    table0 = table.clone()
    rule = _AdamOrderRule(table)
    for t in (1, 2, 3):
        g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
        hp = sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
        before = kfa.fused_dense_adam_apply.launches
        kfa.fused_dense_adam_apply(table, mu, nu, g, sid, pos, sizes, hp)
        torch.cuda.synchronize()
        assert kfa.fused_dense_adam_apply.launches == before + 1
        rule.step(ref[0], ids, g, hp)
        kfa.fused_dense_adam_ref(*ref, g, ids, hp)
        for got, want, what in zip((table, mu, nu), ref, ("table", "mu", "nu")):
            assert bool(torch.isfinite(got).all())
            assert rule.close(got, want, what), (what, (got - want).abs().max().item())
    rule.count()
    assert bool((table != table0).any(dim=1).all())  # every row moved
    with pytest.raises(ValueError):
        kfa.fused_dense_adam_apply(table, mu, nu, g, sid, pos.long(), sizes, hp)


def _narrow_trainers(mode, frozen=False):
    from scenario_wise_rec_tpu_torch.core import DenseFeature, SparseFeature
    from scenario_wise_rec_tpu_torch.core.init import pretrained
    from scenario_wise_rec_tpu_torch.models import MMOE
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    r = np.random.default_rng(5)
    feats = [DenseFeature("d0")] + [SparseFeature(f"s{i}", 60, embed_dim=8) for i in range(3)]
    if frozen:
        feats += [SparseFeature("pre", 40, embed_dim=8,
                                initializer=pretrained(r.normal(size=(40, 8)))),
                  SparseFeature("loose", 10, embed_dim=4,
                                initializer=pretrained(r.normal(size=(10, 4))))]
    cpu_model = MMOE(feats, 2, n_expert=2, expert_params={"dims": [16]},
                     tower_params={"dims": [4]}, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model)
    kw = ({} if mode == "plain" else
          dict(sparse_embedding_updates=True, sparse_update_impl=mode))
    return CTRTrainer(cpu_model, device="cpu", **kw), CTRTrainer(gpu_model, **kw)


def _narrow_batch(r, n=64):
    x = {f"s{i}": r.integers(0, 60, n) for i in range(3)}
    x.update(pre=r.integers(0, 40, n), loose=r.integers(0, 10, n))
    x["s1"][:20] = 7  # duplicates
    x["d0"] = r.normal(size=n).astype(np.float32)
    x["domain_indicator"] = r.integers(0, 2, n)
    return x, (r.random(n) < 0.5).astype(np.float32), np.ones(n, np.float32)


LAUNCHES = {"occurrence": {"occurrence_segsum": 1, "scatter_rows": 1},
            "dense": {"fused_dense_adam_apply": 1}, "winner": {"scatter_rows": 3}}


@pytest.mark.parametrize("mode", ["occurrence", "dense", "winner"])
def test_trainer_modes_card_vs_cpu(gen, mode):
    """Two train steps of a narrow MMOE on the card and the CPU in each
    mode: the step's kernels launch as the mode says, and every parameter
    agrees (Adam steps to 1e-4, BN-cancelled biases at 10 x lr, as
    test_torch_port_train.py)."""
    tc, tg = _narrow_trainers(mode)
    r = np.random.default_rng(0)
    wrappers = {"occurrence_segsum": kru.occurrence_segsum, "scatter_rows": kru.scatter_rows,
                "fused_dense_adam_apply": kfa.fused_dense_adam_apply,
                "sorted_dense_adam_apply": sa.sorted_dense_adam_apply}
    before = {k: f.launches for k, f in wrappers.items()}
    for _ in range(2):
        batch = _narrow_batch(r)
        lc = float(tc._train_step(*tc._device_batch(*batch)))
        lg = float(tg._train_step(*tg._device_batch(*batch)))
        assert abs(lc - lg) <= 1e-5 * abs(lc)
    torch.cuda.synchronize()
    for k, f in wrappers.items():
        assert f.launches - before[k] == 2 * LAUNCHES[mode].get(k, 0), k
    for k, v in tg.model.state_dict().items():
        want = tc.model.state_dict()[k]
        atol = 1e-2 if k.endswith(("lin.b", "bn.mean")) and ".layers." in f".{k}" else 1e-6
        assert torch.allclose(v.cpu(), want, rtol=1e-4, atol=atol), k


@pytest.mark.parametrize("mode", ["plain", "occurrence", "dense", "winner", "sorted"])
def test_frozen_tables_on_the_card(gen, mode):
    _, tg = _narrow_trainers(mode, frozen=True)
    col = tg.model.embedding
    (off, n), = col.frozen_spans
    pre = col.packed.detach()[off:off + n].clone()
    loose = col.tables["loose"].detach().clone()
    r = np.random.default_rng(1)
    for _ in range(3):
        tg._train_step(*tg._device_batch(*_narrow_batch(r)))
    torch.cuda.synchronize()
    assert torch.equal(col.packed.detach()[off:off + n], pre)
    assert torch.equal(col.tables["loose"].detach(), loose)


# -- host batches, resident epochs and device metrics ------------------------------

def test_pinned_staging_equals_pageable_copy(gen):
    """50 prefetched batches staged in pinned memory and copied with
    ``non_blocking=True`` while the stream is held busy (so copies are in
    flight while the prefetch thread stages the next batches) equal the
    pageable copies of the same numpy batches."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset

    tg = _narrow_trainers("sorted")[1]
    r = np.random.default_rng(3)
    x, y, _ = _narrow_batch(r, n=50 * 64 - 7)
    loader = BatchIterable(ColumnarDataset(x, y), 64, shuffle=True, seed=1)
    staged = []
    for (bx, by, bw), host in tg._batches(loader):
        assert all(t.is_pinned() for t in list(host[0].values()) + [host[1], host[2]])
        torch.cuda._sleep(100_000)  # the copy queues behind this
        staged.append(((bx, by, bw), tg._device_batch(*host)))
    torch.cuda.synchronize()
    assert len(staged) == 50
    for (bx, by, bw), (xs, ys, ws) in staged:
        xp, yp, wp = tg._device_batch(bx, by, bw)
        assert sorted(xs) == sorted(xp)
        for key, v in xs.items():
            assert v.dtype == xp[key].dtype and torch.equal(v, xp[key]), key
        assert torch.equal(ys, yp) and torch.equal(ws, wp)


def test_resident_sorted_epoch_equals_host_epoch(gen):
    """A narrow sorted MMOE on the card: an epoch over a DeviceResidentLoader
    and one over the BatchIterable of the same rows and seed leave the same
    state, bit for bit, with one sorted launch a step."""
    from scenario_wise_rec_tpu_torch.data import (BatchIterable, ColumnarDataset,
                                                  DeviceResidentLoader)
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    _, host_t = _narrow_trainers("sorted")
    res_t = CTRTrainer(copy.deepcopy(host_t.model), sparse_embedding_updates=True,
                       sparse_update_impl="sorted")
    x, y, _ = _narrow_batch(np.random.default_rng(4), n=6 * 64 + 9)
    ds = ColumnarDataset(x, y)
    host_t.train_one_epoch(BatchIterable(ds, 64, shuffle=True, seed=2))
    loader = DeviceResidentLoader(ds, 64, seed=2)
    before = sa.sorted_dense_adam_apply.launches
    res_t.train_one_epoch(loader)
    res_t.barrier()
    assert sa.sorted_dense_adam_apply.launches - before == len(loader) == 7
    for k, v in host_t.model.state_dict().items():
        assert torch.equal(v, res_t.model.state_dict()[k]), k
    for k in ("mu", "nu"):
        assert torch.equal(host_t.emb_opt_state[k], res_t.emb_opt_state[k]), k


@pytest.mark.parametrize("case", ["random", "ties", "masked"])
def test_device_metrics_on_card_equal_cpu(gen, case):
    from scenario_wise_rec_tpu_torch.train import metrics

    r = np.random.default_rng(6)
    n = 100_003
    y = torch.from_numpy(r.integers(0, 2, n).astype(np.float32))
    p = torch.from_numpy(r.random(n).astype(np.float32))
    if case == "ties":
        p = torch.round(p * 100) / 100
    m = torch.from_numpy(r.integers(0, 2, n).astype(bool)) if case == "masked" else None
    for fn in (metrics.auc_score_device, metrics.log_loss_device):
        cpu = float(fn(y, p, m))
        card = float(fn(y.cuda(), p.cuda(), None if m is None else m.cuda()))
        assert abs(card - cpu) <= 1e-6, (fn.__name__, card, cpu)


# -- scan_steps > 1: the train step as a CUDA graph --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_adam_device_hp_form(gen, dtype):
    """The form that reads its Adam numbers from device memory: three steps,
    each from one state, equal the by-value form bit for bit and hold
    against the plain version under the order rule (f32) or the bf16 rule."""
    V, D = 100_003, 16
    ids = torch.randint(0, V // 3, (6000,), generator=gen, device="cuda")
    ids = torch.cat([ids, torch.tensor([-1, V + 3], device="cuda")])
    if dtype == torch.float32:
        trio = list(_sa_case(gen, V, D, ids)[:3])
    else:
        trio = _bf16_trio(gen, V, D)
    for t in range(1, 4):
        ref, byval = ([x.clone() for x in trio] for _ in range(2))
        g = 1e-3 * torch.randn(ids.shape[0], D, generator=gen, device="cuda")
        sid, gs = sa.owner_sorted_grads(ids, g)
        hp = sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
        rule = _AdamOrderRule(ref[0].float())
        rule.step(ref[0].float(), sid, gs, hp)
        sa.sorted_dense_adam_apply(*byval, sid, gs, hp)
        sa.sorted_dense_adam_apply(*trio, sid, gs, torch.tensor(hp, device="cuda"))
        sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
        torch.cuda.synchronize()
        for got, bv, want, what in zip(trio, byval, ref, ("table", "mu", "nu")):
            assert torch.equal(got, bv), (what, t)
            if dtype == torch.float32:
                assert rule.close(got, want, what), (what, t)
            else:
                assert _bf16_held(got, want, rule, what)[0], (what, t)
        rule.count()


GRAPH_MODES = {"sorted": dict(sparse_embedding_updates=True, sparse_update_impl="sorted"),
               "sorted_bf16": dict(sparse_embedding_updates=True, sparse_update_impl="sorted",
                                   sorted_dtype="bf16"),
               "plain": {}}


def _graph_model(dropout=0.0):
    from scenario_wise_rec_tpu_torch.core import DenseFeature, SparseFeature
    from scenario_wise_rec_tpu_torch.models import MMOE

    feats = [DenseFeature("d0")] + [SparseFeature(f"s{i}", 60, embed_dim=8) for i in range(3)]
    return MMOE(feats, 2, n_expert=2, expert_params={"dims": [16], "dropout": dropout},
                tower_params={"dims": [4]}, generator=torch.Generator(device="cuda").manual_seed(0))


def _graph_twins(model, kw, scan_steps=3, **extra):
    """An eager trainer (S = 1, its torch.optim.Adam made ``capturable`` as
    the graphed trainer's is) and a graphed one (``scan_steps``), one state."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    eager = CTRTrainer(model, **kw, **extra)
    for group in eager.optimizer.param_groups:
        group["capturable"] = True
    graphed = CTRTrainer(copy.deepcopy(model), scan_steps=scan_steps, **kw, **extra)
    assert graphed.graphed and not eager.graphed and graphed._capturable
    return eager, graphed


def _graph_data(seed=4, n=6 * 64 + 9):
    """Seven batches of 64 (the last padded) for the narrow models."""
    from scenario_wise_rec_tpu_torch.data import ColumnarDataset

    r = np.random.default_rng(seed)
    x, y, _ = _narrow_batch(r, n)
    x["uid"] = r.integers(0, 60, n)
    return ColumnarDataset(x, y)


def _graph_loader(ds, kind, seed=2):
    from scenario_wise_rec_tpu_torch.data import BatchIterable, DeviceResidentLoader

    return (BatchIterable(ds, 64, shuffle=True, seed=seed) if kind == "host"
            else DeviceResidentLoader(ds, 64, seed=seed))


def _trainer_tensors(t):
    out = {f"model/{k}": v for k, v in t.model.state_dict().items()}
    for name, p in t._dense_named:
        for k, v in t.optimizer.state[p].items():
            out[f"opt/{name}/{k}"] = v
    for k, v in (t.emb_opt_state or {}).items():
        out[f"emb/{k}"] = v if torch.is_tensor(v) else torch.tensor(v)
    return out


def _differing(a, b):
    """Elements that differ between two trainers' states, by tensor."""
    ta, tb = _trainer_tensors(a), _trainer_tensors(b)
    assert sorted(ta) == sorted(tb)
    return {k: int((ta[k].to(tb[k].device) != tb[k]).sum()) for k in ta}


def _step_gate(a, b):
    """The train-step gate of PERF.md §2 on the model's state: 1e-6 +
    1e-4 |v|, the BN-cancelled biases and running means within 10 x lr."""
    for k, v in a.model.state_dict().items():
        want = b.model.state_dict()[k]
        atol = 1e-2 if k.endswith(("lin.b", "bn.mean")) and ".layers." in f".{k}" else 1e-6
        assert torch.allclose(v.float(), want.float(), rtol=1e-4, atol=atol), k


def _epochs(t, loaders):
    for loader in loaders:
        t.train_one_epoch(loader)
    t.barrier()


@pytest.mark.parametrize("kind", ["host", "resident"])
@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_graphed_epochs_equal_eager_epochs(gen, mode, kind):
    """Two epochs of seven batches at S = 3 (two dispatches and a remainder
    of one an epoch) as a CUDA graph: 0 elements of any weight, BN
    statistic, moment or step differ from the eager S = 1 epochs with a
    capturable torch.optim.Adam; two warm-up steps, one capture and 12
    replays, the sorted kernel launched twice and captured once."""
    from scenario_wise_rec_tpu_torch.train import trainer as ptrainer

    eager, graphed = _graph_twins(_graph_model(), GRAPH_MODES[mode])
    ds = _graph_data()
    f32, bf16 = sa.sorted_dense_adam_apply.launches, sa.sorted_dense_adam_apply.launches_bf16
    cf32, cbf16 = sa.sorted_dense_adam_apply.captured, sa.sorted_dense_adam_apply.captured_bf16
    _epochs(graphed, [_graph_loader(ds, kind)] * 2)
    torch.cuda.synchronize()
    warm = ptrainer.WARMUP_STEPS
    assert (graphed.graph_captures, graphed.graph_replays) == (1, 14 - warm)
    launched = (sa.sorted_dense_adam_apply.launches - f32,
                sa.sorted_dense_adam_apply.launches_bf16 - bf16,
                sa.sorted_dense_adam_apply.captured - cf32,
                sa.sorted_dense_adam_apply.captured_bf16 - cbf16)
    assert launched == {"sorted": (warm, 0, 1, 0), "sorted_bf16": (0, warm, 0, 1),
                        "plain": (0, 0, 0, 0)}[mode]
    _epochs(eager, [_graph_loader(ds, kind)] * 2)
    diff = _differing(graphed, eager)
    assert not any(diff.values()), {k: v for k, v in diff.items() if v}
    if graphed.emb_opt_state is not None:
        assert graphed.emb_opt_state["step"] == 14


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_graphed_against_the_default_adam_holds_the_step_gate(gen, mode):
    """The eager default, torch.optim.Adam without ``capturable``, computes
    its bias corrections on the host in float64 and associates them
    otherwise, so its steps differ from the capturable ones in the last
    bits: over one dispatch of three steps from one state the graphed
    trainer's elements that differ are counted and the model's state holds
    the train-step gate of PERF.md §2."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    model = _graph_model()
    kw = GRAPH_MODES[mode]
    default = CTRTrainer(model, **kw)
    graphed = CTRTrainer(copy.deepcopy(model), scan_steps=3, **kw)
    assert default.optimizer.defaults["capturable"] is False and graphed._capturable
    ds = _graph_data(n=3 * 64)
    for t in (default, graphed):
        _epochs(t, [_graph_loader(ds, "host")])
    assert graphed.graph_replays == 1
    print(f"{mode}: graphed vs the default eager Adam over 3 steps, "
          f"{sum(_differing(graphed, default).values())} elements differ")
    _step_gate(graphed, default)


def test_graphed_dropout_draws_from_the_registered_generator(gen):
    """MMOE with dropout 0.2: the masks come from the trainer's generator,
    registered with the graph, so each replay draws the next masks as an
    eager step does: 0 elements differ from the eager epochs."""
    eager, graphed = _graph_twins(_graph_model(dropout=0.2), GRAPH_MODES["sorted"])
    ds = _graph_data()
    for t in (eager, graphed):
        _epochs(t, [_graph_loader(ds, "host")] * 2)
    diff = _differing(graphed, eager)
    assert not any(diff.values()), {k: v for k, v in diff.items() if v}
    assert graphed.generator.get_offset() == eager.generator.get_offset()


def test_graphed_replay_with_a_stale_hp_row_fails(gen, monkeypatch):
    """A planted fault: every step of a dispatch given its first step's Adam
    numbers (as if the replays did not advance the hp row) must not equal
    the eager epochs."""
    from scenario_wise_rec_tpu_torch.train import trainer as ptrainer

    right = ptrainer.adam_hparams_rows
    monkeypatch.setattr(ptrainer, "adam_hparams_rows",
                        lambda step0, n, *a: np.repeat(right(step0, 1, *a), n, axis=0))
    eager, graphed = _graph_twins(_graph_model(), GRAPH_MODES["sorted"])
    ds = _graph_data()
    for t in (eager, graphed):
        _epochs(t, [_graph_loader(ds, "host")])
    diff = _differing(graphed, eager)
    assert diff["model/embedding.packed"] > 0 and diff["emb/nu"] > 0, diff


def test_graphed_save_load_and_continue(gen, tmp_path):
    """Train graphed, save, load into a new graphed trainer and a new eager
    one, and continue both an epoch: 0 elements differ (the loaded step
    counts lie on the card for the capturable Adam); a load drops the
    captured step."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    kw = GRAPH_MODES["sorted"]
    model = _graph_model()
    _, first = _graph_twins(model, kw)
    ds = _graph_data()
    _epochs(first, [_graph_loader(ds, "resident")])
    path = first.save(str(tmp_path / "ckpt"))
    eager, graphed = _graph_twins(_graph_model(), kw)
    for t in (eager, graphed):
        t.load(path)
        assert t._plan is None
        assert all(st["step"].device.type == "cuda" for st in t.optimizer.state.values())
        _epochs(t, [_graph_loader(ds, "resident", seed=3)])
    first.load(path)
    assert first._plan is None
    _epochs(first, [_graph_loader(ds, "resident", seed=3)])
    for other in (eager, first):
        diff = _differing(graphed, other)
        assert not any(diff.values()), {k: v for k, v in diff.items() if v}
    assert isinstance(first, CTRTrainer) and first.graph_captures == 2


def test_graphed_step_lr_recaptures(gen, tmp_path):
    """``fit`` over three epochs with an epoch StepLR: each new lr drops the
    captured step (torch.optim's lr is baked into the graph), so three
    captures, and 0 elements differ from the eager fit."""
    from scenario_wise_rec_tpu_torch.train.optim import step_lr

    extra = dict(scheduler_fn=step_lr, scheduler_params={"step_size": 1, "gamma": 0.5},
                 n_epoch=3, model_path=str(tmp_path))
    eager, graphed = _graph_twins(_graph_model(), GRAPH_MODES["sorted"], **extra)
    ds = _graph_data()
    for t in (eager, graphed):
        t.fit(_graph_loader(ds, "resident"))
    assert graphed.graph_captures == 3
    diff = _differing(graphed, eager)
    assert not any(diff.values()), {k: v for k, v in diff.items() if v}


@pytest.mark.parametrize("mode", ["winner"])
def test_winner_at_scan_steps_3_is_graphed(gen, mode):
    """The winner mode at S = 3 captures its step as the other modes do
    (torch.optim.Adam made capturable), and a host epoch then a resident one
    with dropout 0.2 differ from the eager S = 1 epochs (a capturable Adam)
    in 0 elements: two captures (a plan a loader) and 10 replays, the
    update's step count at 14, the dropout generator's offset equal."""
    eager, graphed = _graph_twins(_graph_model(dropout=0.2), _mode_kw(mode))
    ds = _graph_data()
    for t in (eager, graphed):
        _epochs(t, [_graph_loader(ds, "host"), _graph_loader(ds, "resident")])
    assert graphed.graph_captures == 2 and graphed.graph_replays == 14 - 2 * 2
    assert graphed.emb_opt_state["step"] == eager.emb_opt_state["step"] == 14
    assert graphed.generator.get_offset() == eager.generator.get_offset()
    diff = _differing(graphed, eager)
    assert not any(diff.values()), {k: v for k, v in diff.items() if v}


# the updates whose step a dispatch captures, beside the sorted one and the
# plain step: each update kernel's launches a step
CAPTURED_MODES = {"occurrence": {"occurrence_segsum": 1, "scatter_rows": 1},
                  "dense": {"fused_dense_adam_apply": 1}, "winner": {"scatter_rows": 3}}


def _update_wrappers():
    return {"occurrence_segsum": kru.occurrence_segsum, "scatter_rows": kru.scatter_rows,
            "fused_dense_adam_apply": kfa.fused_dense_adam_apply}


def _mode_kw(mode):
    return dict(sparse_embedding_updates=True, sparse_update_impl=mode)


def test_fused_adam_device_hp_form(gen):
    """Row 14's form that reads its Adam numbers from device memory: three
    steps, each from one state, equal the by-value form bit for bit and hold
    against the plain version under the order rule; a launch counts in
    ``.launches``, one under capture in ``.captured``."""
    from scenario_wise_rec_tpu_torch.train.optim import segment_sorted_ids

    V, D, sizes = 100_003, 16, [4096, 4096, 100]
    ids = torch.randint(0, V // 3, (sum(sizes),), generator=gen, device="cuda")
    ids[:1000] = 17
    ids[-2:] = torch.tensor([-1, V + 3], device="cuda")
    segs = [("f", 0, 4096), ("g", 4096, 4096), ("h", 8192, 100)]
    sid, pos, _ = segment_sorted_ids(ids, segs)
    trio = list(_sa_case(gen, V, D, ids)[:3])
    for t in range(1, 4):
        ref, byval = ([x.clone() for x in trio] for _ in range(2))
        g = 1e-3 * torch.randn(ids.shape[0], D, generator=gen, device="cuda")
        hp = sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
        rule = _AdamOrderRule(ref[0])
        rule.step(ref[0], ids, g, hp)
        kfa.fused_dense_adam_ref(*ref, g, ids, hp)
        kfa.fused_dense_adam_apply(*byval, g, sid, pos, sizes, hp)
        before = kfa.fused_dense_adam_apply.launches
        kfa.fused_dense_adam_apply(*trio, g, sid, pos, sizes, torch.tensor(hp, device="cuda"))
        torch.cuda.synchronize()
        assert kfa.fused_dense_adam_apply.launches == before + 1
        for got, bv, want, what in zip(trio, byval, ref, ("table", "mu", "nu")):
            assert torch.equal(got, bv), (what, t)
            assert rule.close(got, want, what), (what, t)
        rule.count()
    hp_t = torch.tensor(hp, device="cuda")
    launches, captured = kfa.fused_dense_adam_apply.launches, kfa.fused_dense_adam_apply.captured
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        kfa.fused_dense_adam_apply(*trio, g, sid, pos, sizes, hp_t)
    torch.cuda.synchronize()
    assert (kfa.fused_dense_adam_apply.launches, kfa.fused_dense_adam_apply.captured) == (
        launches, captured + 1)
    want = [x.clone() for x in trio]
    kfa.fused_dense_adam_apply(*want, g, sid, pos, sizes, hp_t)
    graph.replay()
    torch.cuda.synchronize()
    for got, w in zip(trio, want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("kind", ["host", "resident"])
@pytest.mark.parametrize("mode", list(CAPTURED_MODES))
def test_captured_mode_epochs_equal_eager_epochs(gen, mode, kind):
    """The occurrence, dense and winner modes at S = 3 as a CUDA graph, MMOE
    with dropout 0.2: two epochs of seven batches (two dispatches and a
    remainder of one an epoch) differ from the eager S = 1 epochs (a
    capturable torch.optim.Adam) in 0 elements; two warm-up steps, one
    capture and 12 replays; each update kernel launched its launches a step
    twice eagerly and captured once, and the update's step count at 14."""
    from scenario_wise_rec_tpu_torch.train import trainer as ptrainer

    eager, graphed = _graph_twins(_graph_model(dropout=0.2), _mode_kw(mode))
    ds = _graph_data()
    wrappers = _update_wrappers()
    before = {k: (f.launches, f.captured) for k, f in wrappers.items()}
    _epochs(graphed, [_graph_loader(ds, kind)] * 2)
    torch.cuda.synchronize()
    warm = ptrainer.WARMUP_STEPS
    assert (graphed.graph_captures, graphed.graph_replays) == (1, 14 - warm)
    for k, f in wrappers.items():
        n = CAPTURED_MODES[mode].get(k, 0)
        assert (f.launches - before[k][0], f.captured - before[k][1]) == (warm * n, n), k
    _epochs(eager, [_graph_loader(ds, kind)] * 2)
    diff = _differing(graphed, eager)
    assert not any(diff.values()), {k: v for k, v in diff.items() if v}
    assert graphed.emb_opt_state["step"] == eager.emb_opt_state["step"] == 14
    assert graphed.generator.get_offset() == eager.generator.get_offset()
    if mode == "occurrence":  # the model's table stays the store's view
        assert (graphed.model.embedding.packed.data_ptr()
                == graphed.emb_opt_state["comb"].data_ptr())


@pytest.mark.parametrize("mode", list(CAPTURED_MODES))
def test_captured_mode_replay_with_a_stale_row_fails(gen, mode, monkeypatch):
    """A planted fault: every step of a dispatch given its first step's row
    of Adam numbers (as if the replays did not advance it) must not equal
    the eager epochs."""
    from scenario_wise_rec_tpu_torch.train import trainer as ptrainer

    name = {"occurrence": "occurrence_hparams_rows", "dense": "adam_hparams_rows",
            "winner": "occurrence_hparams_rows"}[mode]
    right = getattr(ptrainer, name)
    monkeypatch.setattr(ptrainer, name,
                        lambda step0, n, *a: np.repeat(right(step0, 1, *a), n, axis=0))
    eager, graphed = _graph_twins(_graph_model(), _mode_kw(mode))
    ds = _graph_data()
    for t in (eager, graphed):
        _epochs(t, [_graph_loader(ds, "host")])
    diff = _differing(graphed, eager)
    moments = "emb/comb" if mode == "occurrence" else "emb/nu"
    assert diff["model/embedding.packed"] > 0 and diff[moments] > 0, diff


@pytest.mark.parametrize("mode", list(CAPTURED_MODES))
def test_a_dispatch_step_does_not_sync(gen, mode):
    """One step of a dispatch, run eagerly on the plan's staged batches after
    an epoch has captured it, raises nothing under
    ``torch.cuda.set_sync_debug_mode("error")``: no host read, no blocking
    copy, no mask index; and its update kernels launch as the mode says."""
    _, graphed = _graph_twins(_graph_model(), _mode_kw(mode))
    _epochs(graphed, [_graph_loader(_graph_data(), "resident")])
    plan = graphed._plan
    plan.counter.zero_()
    wrappers = _update_wrappers()
    before = {k: f.launches for k, f in wrappers.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphed._plan_step(plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for k, f in wrappers.items():
        assert f.launches - before[k] == CAPTURED_MODES[mode].get(k, 0), k


@pytest.mark.parametrize("mode", list(CAPTURED_MODES))
def test_captured_mode_save_load_and_continue(gen, mode, tmp_path):
    """Train graphed, save, load into a new graphed trainer and a new eager
    one, and continue both an epoch: 0 elements differ; a load drops the
    captured step (in the occurrence mode the store the graph writes)."""
    kw = _mode_kw(mode)
    _, first = _graph_twins(_graph_model(), kw)
    ds = _graph_data()
    _epochs(first, [_graph_loader(ds, "resident")])
    path = first.save(str(tmp_path / "ckpt"))
    eager, graphed = _graph_twins(_graph_model(), kw)
    for t in (eager, graphed):
        t.load(path)
        assert t._plan is None
        _epochs(t, [_graph_loader(ds, "resident", seed=3)])
    first.load(path)
    assert first._plan is None
    _epochs(first, [_graph_loader(ds, "resident", seed=3)])
    for other in (eager, first):
        diff = _differing(graphed, other)
        assert not any(diff.values()), {k: v for k, v in diff.items() if v}
    assert first.graph_captures == 2


@pytest.mark.parametrize("mode", list(CAPTURED_MODES))
def test_captured_mode_step_lr_recaptures(gen, mode, tmp_path):
    """``fit`` over three epochs with an epoch StepLR: each new lr drops the
    captured step, so three captures, and 0 elements differ from the eager
    fit (the update's lr rides in its row)."""
    from scenario_wise_rec_tpu_torch.train.optim import step_lr

    extra = dict(scheduler_fn=step_lr, scheduler_params={"step_size": 1, "gamma": 0.5},
                 n_epoch=3, model_path=str(tmp_path))
    eager, graphed = _graph_twins(_graph_model(), _mode_kw(mode), **extra)
    ds = _graph_data()
    for t in (eager, graphed):
        t.fit(_graph_loader(ds, "resident"))
    assert graphed.graph_captures == 3
    diff = _differing(graphed, eager)
    assert not any(diff.values()), {k: v for k, v in diff.items() if v}


GRAPH_NARROW = {
    "mmoe": dict(n_expert=2, expert_params={"dims": [16, 8]}, tower_params={"dims": [4]}),
    "sharedbottom": dict(bottom_params={"dims": [16]}, tower_params={"dims": [8, 4]}),
    "star": dict(fcn_dims=[8, 4], aux_dims=[4]),
    "ple": dict(n_level=2, n_expert_specific=2, n_expert_shared=1,
                expert_params={"dims": [16, 8]}, tower_params={"dims": [4]}),
    "hamur": dict(fcn_dims=[16, 16, 12, 12, 8, 8, 6], hyper_dims=[8], k=4),
    "hamur_small": dict(fcn_dims=[16, 8], hyper_dims=[8], k=5),
    "mlpn": dict(fcn_dims=[16, 8]),
    "m3oe": dict(fcn_dims=[16, 8, 8, 4], expert_num=2, exp_d=1, exp_t=1, bal_d=1, bal_t=1),
}


def _narrow_registry_model(name):
    """A narrow ``name`` on the card (``chip_smoke.py``'s narrow widths;
    M2M's transformer and AdaSparse without dropout)."""
    from scenario_wise_rec_tpu_torch.core import DenseFeature, SparseFeature
    from scenario_wise_rec_tpu_torch.models import get_model

    g = torch.Generator(device="cuda").manual_seed(0)
    dense = [DenseFeature("d0")]
    sparse = [SparseFeature(f"s{i}", 60, embed_dim=8) for i in range(3)]
    sce = [SparseFeature("domain_indicator", 2, embed_dim=8)]
    ids = [SparseFeature("uid", 60, embed_dim=8)]
    if name in GRAPH_NARROW:
        return get_model(name)(dense + sparse, 2, generator=g, **GRAPH_NARROW[name])
    kw = {"sarnet": dict(features=dense + sparse, domain_num=2, domain_shared_expert_num=3,
                         domain_specific_expert_num=2),
          "epnet": dict(sce_features=sce, agn_features=sparse + dense, fcn_dims=[8]),
          "ppnet": dict(id_features=ids, agn_features=sparse + dense + sce, domain_num=2,
                        fcn_dims=[16, 8]),
          "adasparse": dict(sce_features=sce, agn_features=sparse,
                            mlp_params={"dims": [16, 8], "dropout": 0.0}),
          "adaptdhm": dict(features=sparse + sce, fcn_dims=[16, 8], cluster_num=3, beta=0.9),
          "m2m": dict(features=sparse + sce, domain_feature=sce, domain_num=2, num_experts=4,
                      expert_output_size=4,
                      transformer_dims={"num_encoder_layers": 2, "num_decoder_layers": 2,
                                        "dim_feedforward": 16, "dropout": 0.0})}[name]
    return get_model(name)(**kw, generator=g)


@pytest.mark.parametrize("name", ["mmoe", "sharedbottom", "star", "ple", "sarnet", "epnet",
                                  "ppnet", "adasparse", "hamur", "hamur_small", "mlpn",
                                  "adaptdhm", "m2m", "m3oe"])
def test_every_model_graphed_equals_eager(gen, name):
    """Every registry model, narrow, with ``sparse_embedding_updates=True``
    (the sorted update, or the plain step for a model without an
    ``embedding`` collection): a host epoch of seven batches at S = 3 as a
    CUDA graph, 0 elements different from the eager epoch."""
    eager, graphed = _graph_twins(_narrow_registry_model(name), GRAPH_MODES["sorted"])
    ds = _graph_data()
    for t in (eager, graphed):
        _epochs(t, [_graph_loader(ds, "host")])
    assert graphed.graph_captures == 1
    diff = _differing(graphed, eager)
    assert not any(diff.values()), {k: v for k, v in diff.items() if v}


# -- the row-sharded sorted update and the mesh (parallel/) on the card --------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e", [2, 3, 4])
def test_sorted_adam_sharded_matches_unsharded_and_plain(gen, dtype, e):
    """E shards of one table (V = 100,003, not a multiple of E: padded)
    stepped by ``sorted_dense_adam_apply_sharded``, hp by value and in
    device memory: bit for bit the unsharded kernel's step of the padded
    table (the shard's tiles are the table's), and held against the plain
    version shard by shard (the order rule; bf16 within one ulp). Ids on
    every boundary, duplicated, and a hot row; 2 launches a shard, counted
    in the sharded form's counter."""
    V, D, K = 100_003, 16, 23 * 512
    rows = -(-V // e)
    r = np.random.default_rng(e)
    ids = r.integers(0, V, K)
    bounds = [j * rows + o for j in range(1, e) for o in (-1, 0)]
    ids[:3 * len(bounds)] = np.repeat(bounds, 3)
    ids[-600:] = 77  # a hot row
    trio = list(_sa_case(gen, rows * e, D, torch.as_tensor(ids))[:3])
    if dtype == "bf16":
        trio = [t.to(torch.bfloat16) for t in trio]
    g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(torch.as_tensor(ids, device="cuda"), g)
    hp = sa.adam_hparams(4, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    whole = [t.clone() for t in trio]
    sa.sorted_dense_adam_apply(*whole, sid, gs, hp)
    plain = [t.clone() for t in trio]
    for j in range(e):
        sa.sorted_dense_adam_apply_sharded_ref(*(t[j * rows:(j + 1) * rows] for t in plain),
                                               sid, gs, hp, row0=j * rows)
    rule = _AdamOrderRule(trio[0].float())
    rule.step(trio[0].float(), sid, gs, hp)
    counter = "launches_sharded" + ("_bf16" if dtype == "bf16" else "")
    for h in (hp, torch.tensor(hp, device="cuda")):
        got = [t.clone() for t in trio]
        before = getattr(sa.sorted_dense_adam_apply, counter)
        for j in range(e):
            sa.sorted_dense_adam_apply_sharded(*(t[j * rows:(j + 1) * rows] for t in got),
                                               sid, gs, h, row0=j * rows)
        torch.cuda.synchronize()
        assert getattr(sa.sorted_dense_adam_apply, counter) == before + e
        for a, b, c, what in zip(got, whole, plain, ("table", "mu", "nu")):
            assert torch.equal(a, b), what
            held = (_bf16_held(a, c, rule, what)[0] if dtype == "bf16"
                    else rule.close(a, c, what))
            assert held, what
    rule.count()


def test_sorted_adam_sharded_rejects_a_bad_row0(gen):
    table, mu, nu, _ = _sa_case(gen, 100, 16, torch.zeros(1))
    sid, gs = sa.owner_sorted_grads(torch.zeros(4, dtype=torch.long, device="cuda"),
                                    torch.zeros(4, 16, device="cuda"))
    hp = sa.adam_hparams(1, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    for row0 in (-1, 2 ** 31 - 100):
        with pytest.raises(ValueError, match="row0"):
            sa.sorted_dense_adam_apply_sharded(table, mu, nu, sid, gs, hp, row0=row0)


def _mesh_fit_on_card(tmp_path, backend, shape):
    """``fit`` on a mesh of two ranks on the card over ``backend`` against
    the same ``fit`` in this process on the card (the rank worker of
    tests/test_torch_port_parallel.py; the kernels built here first), both
    at ``scan_steps=1``: a graphed one process would draw its dropout masks
    from the graph's generator state, not the eager steps' (the CPU test
    runs the mesh's uncaptured dispatches at ``scan_steps=2``)."""
    import _torch_port_parallel_worker as W
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    _build.build(["sorted_adam"])
    job = dict(kind="fit", seed=11, dropout=0.2, scan_steps=1, n_epoch=1, n=7 * W.B + 5,
               device="cuda")
    res = W.spawn(shape, {"fit": dict(job, dir=str(tmp_path / "mesh"))}, str(tmp_path),
                  backend=backend, timeout=300)
    one = W.run_fit(None, dict(job, dir=str(tmp_path / "one")))
    steps = one["step"]
    assert one["launches"] == (steps, 0)
    for r, out in enumerate(res):
        fit = out["fit"]
        assert fit["launches"] == (0, steps), (r, fit["launches"])
        assert fit["metrics"] == res[0]["fit"]["metrics"]
        if shape[0] == 1:
            # every rank sees the whole batch: one process's products and
            # reductions at its shapes, and the sharded lookup and update
            # are exact, so the two agree bit for bit
            assert fit["log"] == one["log"] and fit["metrics"] == one["metrics"]
            for k, v in one["state"].items():
                assert torch.equal(fit["state"][k], v), (r, k)
            continue
        for a, b in zip(fit["log"], one["log"]):
            assert a.split("loss")[0] == b.split("loss")[0]
            assert abs(float(a.split()[-1]) - float(b.split()[-1])) <= 1e-4 * abs(
                float(b.split()[-1])), (a, b)
        for k, v in one["state"].items():
            # the fit's 8 steps part by Adam's steps on noise-dominated
            # gradients: the port's CPU mesh gate's tolerances (weights
            # 2e-5, moments 1e-5, 1e-4 relative; BN-cancelled 2 lr a step)
            cancelled = re.search(r"layers\.\d+\.(lin\.b|bn\.mean)$", k)
            atol = 2e-3 * steps if cancelled else (2e-5 if k.startswith("model/") else 1e-5)
            np.testing.assert_allclose(fit["state"][k].float().numpy(), v.float().numpy(),
                                       rtol=1e-4, atol=atol, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_mesh_of_two_gloo_ranks_on_one_card(gen, tmp_path, shape):
    _mesh_fit_on_card(tmp_path, "gloo", shape)


def test_mesh_of_two_nccl_ranks(gen, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("nccl needs a card a rank: this machine has one card (the gloo "
                    "mesh of two ranks on it runs instead)")
    _mesh_fit_on_card(tmp_path, "nccl", (2, 1))


def test_a_failed_capture_raises(gen, monkeypatch):
    """A step that reads the host (here a loss read each step) cannot be
    captured: the graphed trainer raises after its warm-up steps and does
    not fall back to eager steps. (Last in the file: the failed capture is
    left behind on the graph's stream.)"""
    from scenario_wise_rec_tpu_torch.train import trainer as ptrainer

    _, graphed = _graph_twins(_graph_model(), GRAPH_MODES["sorted"])
    step = graphed._train_step

    def reading(*a, **kw):
        loss = step(*a, **kw)
        float(loss)
        return loss

    monkeypatch.setattr(graphed, "_train_step", reading)
    with pytest.raises(RuntimeError, match="capturing the train step"):
        _epochs(graphed, [_graph_loader(_graph_data(), "host")])
    assert graphed.graph_replays == 0 and graphed.graph_captures == 0
    assert ptrainer.WARMUP_STEPS >= 1
