"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit; without a card
each skips (decided inside the fixture, never at import). On a machine with
a card:

    python -m pytest tests/test_torch_port_cuda.py -q
"""

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


@pytest.mark.parametrize("cfg", [
    # (B, F, E, D, expert dims, tower dims, block_rows)
    (4096, 376, 3, 3, (256, 128, 64, 32, 16, 8), (16,), 16),  # Ali-CCP
    (333, 41, 2, 2, (7,), (3,), 8),          # widths not multiples of 4
    (130, 50, 16, 4, (33,), (40, 70), 24),   # most experts; towers wider than a warp
    (64, 12, 2, 1, (8,) * 8, (4,) * 8, 32),  # deepest stacks
    (17, 9, 1, 3, (5,), (), 16),             # one expert, no tower stage
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
    with pytest.raises(ValueError):
        k.mmoe_fused_infer(emb, did, *st, block_rows=12)
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


# -- sorted_dense_adam_apply ------------------------------------------------

from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa  # noqa: E402

# The kernel and its plain version round every elementwise step alike; they
# differ only in the order in which three or more duplicate gradients are
# summed (the plain version's index_add_ uses atomics, in a varying order).
# f32 sums of n terms in two orders differ by at most (n-1) * 2^-24 * sum|g|,
# which with gradients of 1e-3 and the hot row's 4096 duplicates stays well
# inside this bound on the moments and the table.
SA_RTOL, SA_ATOL = 1e-5, 1e-6


def _sa_close(got, want):
    return bool(((got - want).abs() <= SA_ATOL + SA_RTOL * want.abs()).all())


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
    for t in range(1, steps + 1):
        g = 1e-3 * torch.randn(ids.shape[0], D, generator=gen, device="cuda")
        sid, gs = sa.owner_sorted_grads(ids, g)
        hp = sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
        before = sa.sorted_dense_adam_apply.launches
        sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp, block_rows=block_rows)
        torch.cuda.synchronize()
        assert sa.sorted_dense_adam_apply.launches == before + 1
        sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
        for got, want in zip((table, mu, nu), ref):
            assert bool(torch.isfinite(got).all())
            assert _sa_close(got, want), (got - want).abs().max().item()
    return table0, table


def test_sorted_adam_hot_row(gen):
    r = np.random.default_rng(0)
    V, per = 23 * 5000, 4096
    parts = [np.full(per, 17)]  # one feature's 4096 ids all one row
    parts += [f * 5000 + _zipf_ids(r, per, 5000) for f in range(1, 23)]
    _run_steps(gen, V, 16, torch.as_tensor(np.concatenate(parts)))


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


@pytest.mark.parametrize("cfg", [
    # (B, F, D, trunk dims, tower dims, head, block_rows)
    (4096, 376, 3, [512], [256, 128, 64, 32, 16, 8], True, 16),  # Ali-CCP
    (333, 41, 2, [7], [3], True, 8),           # widths not multiples of 4
    (130, 50, 5, [33, 20], [40, 70, 1], False, 24),  # no head: width-1 last stage
    (64, 12, 1, [], [5] * 8, True, 64),        # no trunk; deep towers; widest tile
    (17, 9, 3, [6], [], True, 16),             # head on the trunk
])
def test_tower_kernel_matches_plain(gen, cfg):
    B, F, D, trunk, towers, head, rows = cfg
    tr = _affines(gen, (), [F] + trunk)
    w_in = trunk[-1] if trunk else F
    tw = _affines(gen, (D,), [w_in] + towers)
    out = _affines(gen, (D,), [towers[-1] if towers else w_in, 1])[0] if head else None
    emb = torch.randn(B, F, generator=gen, device="cuda")
    did = torch.randint(-2, D + 3, (B,), generator=gen, device="cuda")
    _launch_and_compare(gen, kt.trunk_towers_fused_infer, kt.trunk_towers_fused_infer_ref,
                        emb, did, tr, tw, out, rows=rows)


def _star_args(gen, B, F, D, fcn, aux):
    emb = torch.randn(B, F, generator=gen, device="cuda")
    var, mean = torch.var_mean(emb, dim=0, unbiased=False)
    g = 0.5 + torch.rand(D, F, generator=gen, device="cuda")
    b = 0.1 * torch.randn(D, F, generator=gen, device="cuda")
    return emb, (mean, torch.rsqrt(var + 1e-6), g, b, _affines(gen, (D,), [F] + fcn + [1]),
                 _affines(gen, (), [F] + aux),
                 _affines(gen, (), [aux[-1] if aux else F, 1])[0])


@pytest.mark.parametrize("cfg", [
    # (B, F, D, fcn dims, aux dims, block_rows)
    (4096, 376, 3, [256, 128, 64, 32, 16, 8], [16], 16),  # Ali-CCP
    (333, 41, 2, [7], [3], 8),
    (130, 50, 6, [33, 20, 9], [], 40),          # aux head on the raw row
    (1, 20, 3, [8], [4, 4], 64),
])
def test_star_kernel_matches_plain(gen, cfg):
    B, F, D, fcn, aux, rows = cfg
    emb, args = _star_args(gen, B, F, D, fcn, aux)
    did = torch.randint(-2, D + 3, (B,), generator=gen, device="cuda")
    _launch_and_compare(gen, ks.star_fused_infer, ks.star_fused_infer_ref, emb, did, *args,
                        rows=rows)


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


@pytest.mark.parametrize("cfg", [
    # (B, F, D, S, n_sh, levels' expert dims, tower dims, gate hidden, block_rows)
    (4096, 376, 3, 2, 1, [[256, 128, 64, 32, 16, 8]], [16], (), 16),  # Ali-CCP
    (1000, 376, 3, 2, 1, [[256, 128, 64, 32, 16, 8]] * 2, [16], (), 16),  # 2 levels
    (333, 41, 2, 1, 2, [[7], [5], [3]], [], (6,), 8),  # 3 levels, 2-stage gates
    (130, 30, 4, 3, 1, [[9, 6], [10]], [4, 3], (), 24),
])
def test_ple_kernel_matches_plain(gen, cfg):
    B, F, D, S, n_sh, levels, towers, gate_hidden, rows = cfg
    args = _ple_args(gen, F, D, S, n_sh, levels, towers, gate_hidden)
    emb = torch.randn(B, F, generator=gen, device="cuda")
    did = torch.randint(-2, D + 3, (B,), generator=gen, device="cuda")
    _launch_and_compare(gen, kp.ple_fused_infer, kp.ple_fused_infer_ref, emb, did, *args,
                        rows=rows)


def test_new_kernels_reject_what_they_do_not_take(gen):
    tr, tw = _affines(gen, (), [20, 8]), _affines(gen, (2,), [8, 4])
    out = _affines(gen, (2,), [4, 1])[0]
    emb = torch.randn(10, 20, generator=gen, device="cuda")
    did = torch.zeros(10, dtype=torch.long, device="cuda")
    for rows in (12, 0, 72):
        with pytest.raises(ValueError):
            kt.trunk_towers_fused_infer(emb, did, tr, tw, out, block_rows=rows)
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
