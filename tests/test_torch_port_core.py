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
