"""Port core (features, activations, initialisers) against the JAX package."""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.core import activation as jax_activation  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.core import init as jinit  # noqa: E402
from scenario_wise_rec_tpu_torch.core import activation as port_activation  # noqa: E402
from scenario_wise_rec_tpu_torch.core import config as port_config  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core import init as pinit  # noqa: E402


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000, 20_000, 467_000, 10**7])
def test_auto_embedding_dim_matches_jax(n):
    assert pf.get_auto_embedding_dim(n) == jf.get_auto_embedding_dim(n)
    assert pf.get_auto_embedding_dim(n) == math.floor(6 * n ** 0.26)


def test_feature_specs_match_jax():
    for mod_p, mod_j in [(pf, jf)]:
        assert mod_p.DenseFeature("d").embed_dim == mod_j.DenseFeature("d").embed_dim == 1
    sp = pf.SparseFeature("s", vocab_size=500, shared_with="t", padding_idx=0)
    sj = jf.SparseFeature("s", vocab_size=500, shared_with="t", padding_idx=0)
    assert (sp.embed_dim, sp.shared_with, sp.padding_idx) == \
        (sj.embed_dim, sj.shared_with, sj.padding_idx)
    qp = pf.SequenceFeature("q", vocab_size=90, embed_dim=4, pooling="sum")
    assert (qp.embed_dim, qp.pooling) == (4, "sum")
    with pytest.raises(ValueError):
        pf.SequenceFeature("q", vocab_size=9, pooling="max")
    feats_p = [pf.DenseFeature("d"), sp, qp]
    feats_j = [jf.DenseFeature("d"), sj,
               jf.SequenceFeature("q", vocab_size=90, embed_dim=4, pooling="sum")]
    assert pf.sum_embed_dims(feats_p) == jf.sum_embed_dims(feats_j)


@pytest.mark.parametrize("name", ["sigmoid", "relu", "dice", "prelu", "softmax",
                                  "leakyrelu"])
def test_activation_matches_jax(name, np_rng):
    x = np_rng.normal(size=(16, 7)).astype(np.float32)
    ja = jax_activation(name)
    jp = ja.init(jax.random.PRNGKey(3))
    want = np.asarray(ja.apply(jp, jnp.asarray(x)))
    pa = port_activation(name.upper())
    gen = port_config.make_generator(torch.device("cpu"), 0)
    pp = pa.init(gen)
    assert set(pp) == set(jp)
    pp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    got = pa.apply(pp, torch.tensor(x)).numpy()
    # dice/softmax reduce over features in another order than XLA
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_activation_unknown_raises():
    with pytest.raises(NotImplementedError):
        port_activation("gelu")


def _jax_draw(init, shape, seed):
    return np.asarray(init(jax.random.PRNGKey(seed), shape))


def _port_draw(init, shape, seed):
    return init(port_config.make_generator(torch.device("cpu"), seed), shape).numpy()


_INITS = {
    "normal": (lambda m: m.random_normal(0.5, 2.0), None),
    "uniform": (lambda m: m.random_uniform(-1.0, 3.0), (-1.0, 3.0)),
    "xavier_normal": (lambda m: m.xavier_normal(1.5), None),
    "xavier_uniform": (lambda m: m.xavier_uniform(),
                       (-math.sqrt(6 / (96 + 64)), math.sqrt(6 / (96 + 64)))),
    "kaiming_uniform": (lambda m: m.kaiming_uniform_torch(0.5),
                        (-math.sqrt(2 / 1.25) * math.sqrt(3 / 96),
                         math.sqrt(2 / 1.25) * math.sqrt(3 / 96))),
}


@pytest.mark.parametrize("kind", sorted(_INITS))
def test_initializer_moments_and_bounds_match_jax(kind):
    make, bounds = _INITS[kind]
    shape = (64, 96)
    j = np.concatenate([_jax_draw(make(jinit), shape, s).ravel() for s in range(8)])
    p = np.concatenate([_port_draw(make(pinit), shape, s).ravel() for s in range(8)])
    assert p.dtype == np.float32 and p.shape == j.shape
    n = j.size
    sd = j.std()
    # same distribution: means within 5 standard errors, stds within 2%
    assert abs(p.mean() - j.mean()) < 5 * sd * math.sqrt(2.0 / n)
    assert abs(p.std() / sd - 1) < 0.02
    if bounds is not None:
        lo, hi = bounds
        for a in (j, p):
            assert a.min() >= lo - 1e-6 and a.max() <= hi + 1e-6
            assert a.min() < lo + 0.01 * (hi - lo) and a.max() > hi - 0.01 * (hi - lo)


def test_linear_params_match_jax_distribution():
    in_dim, out_dim = 50, 40
    bound = 1 / math.sqrt(in_dim)
    j = [jinit.linear_params(jax.random.PRNGKey(s), in_dim, out_dim) for s in range(20)]
    p = [pinit.linear_params(port_config.make_generator(torch.device("cpu"), s),
                             in_dim, out_dim) for s in range(20)]
    for key in ("w", "b"):
        jj = np.concatenate([np.asarray(t[key]).ravel() for t in j])
        pp = np.concatenate([t[key].numpy().ravel() for t in p])
        assert p[0][key].shape == tuple(j[0][key].shape)
        assert pp.min() >= -bound and pp.max() <= bound
        assert abs(pp.std() / jj.std() - 1) < 0.05
    stacked = pinit.linear_params(port_config.make_generator(torch.device("cpu"), 0),
                                  in_dim, out_dim, lead=(3,))
    assert stacked["w"].shape == (3, in_dim, out_dim) and stacked["b"].shape == (3, out_dim)


def test_pretrained_returns_weight_and_freeze_flag(np_rng):
    w = np_rng.normal(size=(5, 3)).astype(np.float32)
    init = pinit.pretrained(w, freeze=False)
    assert init.freeze is False and pinit.pretrained(w).freeze is True
    got = init(port_config.make_generator(torch.device("cpu"), 0), (5, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jinit.pretrained(w)(None, (5, 3))))
    with pytest.raises(AssertionError):
        init(port_config.make_generator(torch.device("cpu"), 0), (4, 3))


def test_parity_numerics_and_compute_dtype():
    import scenario_wise_rec_tpu_torch  # noqa: F401  (sets parity numerics)

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert port_config.get_compute_dtype() is None
    x = torch.randn(4, 8)
    w = torch.randn(8, 3)
    try:
        port_config.set_compute_dtype(torch.bfloat16)
        got = port_config.matmul(x, w)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, x @ w, rtol=3e-2, atol=3e-2)
    finally:
        port_config.set_compute_dtype(None)
    torch.testing.assert_close(port_config.einsum("bi,io->bo", x, w), x @ w)


# -- the bf16 compute mode against the JAX package's --------------------------------------

@pytest.fixture
def bf16_both():
    """Both packages' compute dtype at bf16 for one test, f32 again after it
    (the flag is global, and a worker runs a file's tests in one process)."""
    from scenario_wise_rec_tpu.core import config as jconfig

    jconfig.set_compute_dtype(jnp.bfloat16)
    port_config.set_compute_dtype(torch.bfloat16)
    try:
        yield
    finally:
        jconfig.set_compute_dtype(None)
        port_config.set_compute_dtype(None)


# f32 accumulation of bf16-rounded operands: each product is exact in f32,
# so the two packages differ only in the order of the f32 sums
BF16_RTOL, BF16_ATOL = 1e-5, 1e-6
# A model forward rounds every layer's input to bf16 again: an f32 sum that
# differs in its last bit between the two can round to the other bf16
# neighbour (a 2^-8 step of that one operand), which moves a probability by
# up to ~5e-5. So a forward holds BF16_ROWS of its rows to the tolerance
# above and every row to BF16_FLIP_ATOL. A product returned in bf16, the
# fault this closes, misses the first on every model (a 2^-9 error in every
# product moves most rows by 1e-5 to 1e-4).
BF16_ROWS, BF16_FLIP_ATOL = 0.9, 1e-4


def test_bf16_products_accumulate_in_f32(bf16_both, np_rng):
    """``matmul`` and ``einsum`` in bf16 mode return the f32 accumulation of
    the bf16-rounded operands, as the JAX package's do: at the
    ``[64, 376] @ [376, 256]`` shape of the fault they closed, a bf16 result
    was off by 4e-3 of its scale."""
    from scenario_wise_rec_tpu.core import config as jconfig

    x = np_rng.normal(size=(64, 376)).astype(np.float32)
    w = np_rng.normal(size=(376, 256)).astype(np.float32)
    s = np_rng.normal(size=(3, 64, 5)).astype(np.float32)
    want = np.asarray(jconfig.matmul(jnp.asarray(x), jnp.asarray(w)))
    got = port_config.matmul(torch.tensor(x), torch.tensor(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL, atol=BF16_ATOL * np.abs(want).max())
    exact = (torch.tensor(x).bfloat16().double() @ torch.tensor(w).bfloat16().double()).numpy()
    np.testing.assert_allclose(got.numpy(), exact, rtol=BF16_RTOL, atol=BF16_ATOL * np.abs(exact).max())
    want = np.asarray(jconfig.einsum("dbe,bi->dei", jnp.asarray(s), jnp.asarray(x)))
    got = port_config.einsum("dbe,bi->dei", torch.tensor(s), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL, atol=BF16_ATOL * np.abs(want).max())


def _bf16_models():
    """(name, JAX class, port class, kwargs for a features module) of the
    models whose forwards the bf16 mode reaches."""
    def feats(m):
        return ([m.SparseFeature(f"s{i}", vocab_size=40, embed_dim=8) for i in range(4)],
                [m.DenseFeature(f"d{i}") for i in range(2)],
                [m.SparseFeature("domain_indicator", vocab_size=3, embed_dim=8)])

    return {
        "mmoe": lambda m: dict(features=sum(feats(m)[:2], []), domain_num=3, n_expert=3,
                               expert_params={"dims": [16, 8]}, tower_params={"dims": [4]}),
        "ple": lambda m: dict(features=sum(feats(m)[:2], []), domain_num=3, n_level=2,
                              n_expert_specific=2, n_expert_shared=1,
                              expert_params={"dims": [16, 8]}, tower_params={"dims": [4]}),
        "sarnet": lambda m: dict(features=sum(feats(m)[:2], []), domain_num=3,
                                 domain_shared_expert_num=4, domain_specific_expert_num=2),
        "adasparse": lambda m: dict(sce_features=feats(m)[2], agn_features=feats(m)[0],
                                    form="Scaling",
                                    mlp_params={"dims": [16, 8], "dropout": 0.0}),
    }


@pytest.mark.parametrize("name", ["mmoe", "ple", "sarnet", "adasparse"])
def test_bf16_forward_matches_jax(bf16_both, name):
    """One eval forward of each model with both packages in bf16, weights
    carried across: the port's products are the JAX package's f32
    accumulations, and the five products the JAX package leaves in f32 (PLE's
    and SAR-Net's mixtures and selects, the AdaSparse pruner) are plain f32
    in the port too. A bf16 input rounded differently would move a
    probability by ~1e-3."""
    from scenario_wise_rec_tpu import models as jmodels
    from scenario_wise_rec_tpu_torch import models as pmodels
    from scenario_wise_rec_tpu_torch.interop import load_jax_params

    kw = _bf16_models()[name]
    jm = jmodels.get_model(name)(**kw(jf))
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    r = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(r.normal(0, 0.5, a.shape).astype(np.float32))
                      if "embedding" in str(p[0]) else a), params)
    pm = pmodels.get_model(name)(**kw(pf), device="cpu",
                                 generator=port_config.make_generator(torch.device("cpu"), 0))
    load_jax_params(pm, *jax.tree_util.tree_map(np.asarray, (params, state)))
    x = {f"s{i}": r.integers(0, 40, 37) for i in range(4)}
    x.update({f"d{i}": r.normal(size=37).astype(np.float32) for i in range(2)})
    x["domain_indicator"] = r.integers(0, 3, 37)
    want, _ = jm.apply(params, state, {k: jnp.asarray(v) for k, v in x.items()}, train=False)
    with torch.no_grad():
        got = pm.apply({k: torch.as_tensor(v) for k, v in x.items()}, train=False)
    gap = np.abs(got.numpy() - np.asarray(want))
    within = gap <= BF16_ATOL + BF16_RTOL * np.abs(np.asarray(want))
    assert within.mean() >= BF16_ROWS and gap.max() <= BF16_FLIP_ATOL, (within.mean(), gap.max())
