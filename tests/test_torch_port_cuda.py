"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit; without a card
each skips (decided inside the fixture, never at import). On a machine with
a card:

    python -m pytest tests/test_torch_port_cuda.py -q
"""

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
