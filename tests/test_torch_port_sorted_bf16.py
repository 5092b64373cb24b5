"""The sorted embedding update with bf16 storage against the JAX package:
the plain bf16 version of ``sorted_dense_adam_apply`` against the JAX Pallas
kernel on bf16 tiles (interpret mode) and against the JAX XLA path, the bf16
run beside the f32 one, ``CTRTrainer(sorted_dtype="bf16")`` against the JAX
trainer from one carried state, its checkpoints, its early-stop restore and
frozen tables. Inputs are made with numpy from a seed and fed to both
packages.

The rule for bf16 results: both sides do the Adam math in f32 and round
each stored value to nearest even, so they differ only where the order of
an f32 sum (three or more duplicate gradients; torch's and XLA's matmuls in
the trainer) moves the f32 value across a rounding boundary. Such an
element is one bf16 ulp off, and the flip persists in later steps. Every
element must be within one ulp; the share of elements that differ at all is
printed and held to at most ``SHARE``."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.core.init import pretrained as jpretrained  # noqa: E402
from scenario_wise_rec_tpu.data import dataset as jds  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas import sorted_adam as jsa  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu.train import optim as joptim  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.core.init import pretrained  # noqa: E402
from scenario_wise_rec_tpu_torch.data import dataset as pds  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import (  # noqa: E402
    jax_state_dict, load_jax_trainer_state)
from scenario_wise_rec_tpu_torch.models import MMOE as PMMOE  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as psa  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.train import callback as pcallback  # noqa: E402
from scenario_wise_rec_tpu_torch.train import optim as poptim  # noqa: E402

from test_torch_port_train import (  # noqa: E402
    B, D, DOMAINS, KW, LOSS_RTOL, STEP_ATOL, STEP_RTOL, _atol, _np, _port_step)

SHARE = 1e-3  # at most 0.1 % of the elements may differ, each by one ulp
BF16 = dict(sparse_embedding_updates=True, sparse_update_impl="sorted", sorted_dtype="bf16")
# The trainers' vocab per feature: a store of 24,000 elements, so that 0.1 %
# is a count (24) that one step's rounding flips stay below; one flip in
# test_torch_port_train.py's 720-element store would be 0.14 %.
V = 1000


def _bits(a) -> torch.Tensor:
    """bf16 values (a torch tensor, or a JAX / ml_dtypes array) as int16 bits."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16)
    return torch.from_numpy(np.array(a, copy=True).view(np.int16))


def _ulps(got, want) -> torch.Tensor:
    """How many bf16 values lie between ``got`` and ``want``, elementwise
    (the bits in sign-magnitude order, so +0 and -0 are one value)."""
    def key(a):
        i = _bits(a).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(got) - key(want)).abs()


def _held(got, want, what, share=SHARE):
    """``(within one ulp everywhere, elements that differ)``, printed."""
    ulps = _ulps(got, want)
    n, total = int((ulps > 0).sum()), ulps.numel()
    print(f"{what}: {n} of {total} elements differ ({100 * n / total:.3f} %), "
          f"at most {int(ulps.max())} ulp")
    return bool(ulps.max() <= 1) and n <= share * total, n


def _assert_held(got, want, what):
    ok, n = _held(got, want, what)
    assert ok, f"{what}: {n} elements differ, or one by more than one ulp"


def _bf16_state(r, v, d):
    """Table, mu and nu rounded to bf16 (as float32 numpy), nu > 0."""
    as_bf16 = lambda a: torch.as_tensor(a).to(torch.bfloat16).float().numpy()
    return (as_bf16(r.normal(size=(v, d)).astype(np.float32)),
            as_bf16((1e-3 * r.normal(size=(v, d))).astype(np.float32)),
            as_bf16((1e-6 * r.random(size=(v, d))).astype(np.float32)))


def _hp(t):
    return psa.adam_hparams(t, 1e-2, 1e-4, 0.9, 0.999, 1e-8)


def _ids(r, case, v):
    if case == "hot_row":
        return np.concatenate([np.full(300, 13), r.integers(0, 70, 60)])
    return np.concatenate([r.integers(0, 70, 500), [-1, -7, v, v + 3]])


def _run_plain_vs_pallas(case, d, plain):
    """Three steps of ``plain`` (the port's plain bf16 version, or a faulty
    copy of it) beside the JAX kernel on packed bf16 tiles in interpret
    mode: V = 100 is not a multiple of the 32-row tile and rows [70, 100)
    get no id. Returns ``[(what, port, JAX)]`` of each step's three arrays."""
    r = np.random.default_rng(11)
    v, block_rows = 100, 32
    ids = _ids(r, case, v)
    order = np.argsort(ids, kind="stable")
    sid = ids[order].astype(np.int32)
    state = _bf16_state(r, v, d)
    j = [jsa.pack_rows(jnp.asarray(a), block_rows).astype(jnp.bfloat16) for a in state]
    v2 = j[0].shape[0] * (128 // d)
    p = [torch.as_tensor(a).to(torch.bfloat16) for a in state]
    out = []
    for t in (1, 2, 3):
        g = r.normal(size=(ids.shape[0], d)).astype(np.float32)[order]
        j = jsa.sorted_dense_adam_apply(*j, jnp.asarray(sid), jnp.asarray(g),
                                        jnp.asarray(_hp(t), jnp.float32), d,
                                        block_rows=block_rows, interpret=True)
        assert all(a.dtype == jnp.bfloat16 for a in j)
        plain(*p, torch.as_tensor(sid), torch.as_tensor(g), _hp(t))
        out += [(f"{name} t={t}", got.clone(), jsa.unpack_rows(want, v2, d)[:v])
                for name, got, want in zip(("table", "mu", "nu"), p, j)]
    return out


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("case", ["duplicates_empty_tiles_out_of_range", "hot_row"])
def test_plain_bf16_matches_jax_kernel_on_bf16_tiles(case, d):
    """The JAX kernel's default precision for bf16 tiles ("fast") sums in
    f32 on the CPU; it and the port's plain version differ only in the order
    of the duplicates' sums."""
    plain = lambda *a: psa.sorted_dense_adam_apply(*a)  # the wrapper: CPU -> plain
    steps = _run_plain_vs_pallas(case, d, plain)
    for what, got, want in steps:
        assert got.dtype == torch.bfloat16
        _assert_held(got, want, what)
    # every row decays, the untouched ones [70, 100) too
    assert not torch.equal(steps[-3][1][70:], steps[0][1][70:])
    assert psa.sorted_dense_adam_apply.launches_bf16 == 0  # the CPU never launches


def _truncating(table, mu, nu, sid, g, hp):
    """The plain version with one fault: f32 results truncated to bf16
    (rounded toward zero) instead of rounded to nearest even."""
    wide = [t.float() for t in (table, mu, nu)]
    psa.sorted_dense_adam_apply_ref(*wide, sid, g, hp)
    for t, w in zip((table, mu, nu), wide):
        t.copy_((w.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16))


def test_truncating_copy_fails_the_rule():
    steps = _run_plain_vs_pallas("duplicates_empty_tiles_out_of_range", 16, _truncating)
    held = [_held(got, want, what)[0] for what, got, want in steps]
    assert not all(held), "the one-ulp rule let truncation pass"


def test_update_wrapper_bf16_matches_jax_xla_path():
    """``sorted_dense_adam_init(dtype=bfloat16)`` + ``sorted_dense_adam_update``
    against the JAX ``sorted_dense_adam_init(dtype=jnp.bfloat16)`` +
    ``sorted_dense_adam_update(use_pallas=False)`` over three steps, with
    duplicates and a hot row; then the bf16 run beside the
    f32 run, which it tracks to bf16 resolution (as the JAX package's own
    test, tests/test_sorted_adam.py:296-307)."""
    r = np.random.default_rng(5)
    v, d, k = 120, 16, 96
    table = r.normal(size=(v, d)).astype(np.float32)
    js = joptim.sorted_dense_adam_init(jnp.asarray(table), block_rows=64, dtype=jnp.bfloat16)
    ps = poptim.sorted_dense_adam_init(torch.as_tensor(table), dtype=torch.bfloat16)
    p32 = torch.as_tensor(table.copy())
    s32 = poptim.sorted_dense_adam_init(p32)
    assert set(ps) == {"table", "mu", "nu", "step"} and ps["table"].dtype == torch.bfloat16
    assert torch.equal(_bits(ps["table"]), _bits(jsa.unpack_rows(js["table"], v, d)))
    kw = dict(lr=1e-2, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8)
    for _ in range(3):
        ids = np.concatenate([np.full(32, 7), r.integers(0, v, k - 32)]).astype(np.int32)
        g = r.normal(size=(k, d)).astype(np.float32)
        js = joptim.sorted_dense_adam_update(js, jnp.asarray(g), jnp.asarray(ids),
                                             (("s", 0, k),), {"s": 0}, d, block_rows=64,
                                             use_pallas=False, **kw)
        for table, state in ((ps["table"], ps), (p32, s32)):
            poptim.sorted_dense_adam_update(table, state, torch.as_tensor(g),
                                            torch.as_tensor(ids), **kw)
    assert ps["step"] == int(js["step"]) == 3
    for name in ("table", "mu", "nu"):
        _assert_held(ps[name], jsa.unpack_rows(js[name], v, d), f"{name} after 3 steps")
    np.testing.assert_allclose(ps["table"].float().numpy(), p32.numpy(), rtol=0.05, atol=0.02)


def test_bad_storage_raises():
    t, m, n = (torch.zeros(10, 8, dtype=torch.bfloat16) for _ in range(3))
    ids = torch.tensor([1, 2], dtype=torch.int32)
    g = torch.ones(2, 8)
    for trio in ((t, m, n.float()), (t.half(), m.half(), n.half())):
        with pytest.raises(ValueError, match="all float32 or all bfloat16"):
            psa.sorted_dense_adam_apply(*trio, ids, g, _hp(1))
    with pytest.raises(ValueError, match="g_sorted must be float32"):
        psa.sorted_dense_adam_apply(t, m, n, ids, g.bfloat16(), _hp(1))
    with pytest.raises(ValueError):
        poptim.sorted_dense_adam_init(torch.zeros(4, 8), dtype=torch.float16)
    for precision in (None, "fast", "split", "highest"):
        psa.sorted_dense_adam_apply(t, m, n, ids, g, _hp(1), precision=precision)


# -- the bf16 trainer ---------------------------------------------------------

def _feats(m):
    return ([m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=D) for i in range(3)]
            + [m.SparseFeature("alias", vocab_size=V, embed_dim=D, shared_with="s0")]
            + [m.SequenceFeature("seq", vocab_size=V, embed_dim=D, pooling="mean",
                                 shared_with="s1")]
            + [m.DenseFeature("d0")])


def _batch(seed, b=B, ragged=0):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b).astype(np.int32) for i in range(3)}
    x["alias"] = r.integers(0, V, b).astype(np.int32)
    x["seq"] = r.integers(0, V, (b, 4)).astype(np.int32)
    x["s1"][:4] = 7  # a row with duplicates (the seq feature shares s1's table)
    x["d0"] = r.normal(size=b).astype(np.float32)
    x["domain_indicator"] = r.integers(0, DOMAINS, b).astype(np.int32)
    w = np.ones(b, np.float32)
    w[b - ragged:] = 0.0
    return x, r.integers(0, 2, b).astype(np.float32), w


def _loader(n=7 * B + 5, seed=40):
    x, y, _ = _batch(seed, b=n)
    return pds.BatchIterable(pds.ColumnarDataset(x, y), B)


def _pair(seed=7, frozen=False):
    """A JAX bf16 sorted trainer and a port one holding the same state."""
    feats = (lambda m, init: _frozen_feats(m, init)) if frozen else (lambda m, init: _feats(m))
    jt = JTrainer(JMMOE(feats(jf, jpretrained), DOMAINS, **KW), seed=seed,
                  sorted_block_rows=64, **BF16)
    pm = PMMOE(feats(pf, pretrained), DOMAINS, device="cpu",
               generator=make_generator(torch.device("cpu"), 1), **KW)
    pt = PTrainer(pm, device="cpu", **BF16)
    _carry(jt, pt)
    return jt, pt


def _carry(jt, pt):
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))


def _jax_store(jt, pt):
    v = pt.model.embedding.packed_vocab
    return {k: jsa.unpack_rows(jt.opt_state["emb"][k], v, D) for k in ("table", "mu", "nu")}


def _jax_step(jt, batch):
    x, y, w = (jax.tree_util.tree_map(jnp.asarray, a) for a in batch)
    jt.params, jt.opt_state, jt.state, loss = jt._train_step(
        jt.params, jt.opt_state, jt.state, x, y, w, jax.random.PRNGKey(1))
    return float(loss)


def _assert_same_state(jt, pt):
    """The bf16 store under the one-ulp rule; every other parameter and BN
    running stat, and the torch.optim moments, as the f32 sorted trainer's
    test (test_torch_port_train.py)."""
    st = pt.emb_opt_state
    assert st["step"] == int(jt.opt_state["emb"]["step"])
    for name, want in _jax_store(jt, pt).items():
        _assert_held(st[name], want, f"store {name}")
    want = jax_state_dict(_np(jt._params_for_eval()), _np(jt.state))
    for k, v in pt.model.state_dict().items():
        if k != "embedding.packed":
            np.testing.assert_allclose(v.numpy(), want[k], rtol=STEP_RTOL, atol=_atol(k),
                                       err_msg=k)
    adam = [s for s in jt.opt_state["base"] if hasattr(s, "mu")][0]
    mu = jax_state_dict(_np(adam.mu))
    for name, p in pt._dense_named:
        np.testing.assert_allclose(pt.optimizer.state[p]["exp_avg"].numpy(), mu[name],
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=name)


def test_carried_state_is_bit_for_bit():
    jt, pt = _pair()
    st = pt.emb_opt_state
    assert st["table"].dtype == st["mu"].dtype == st["nu"].dtype == torch.bfloat16
    for name, want in _jax_store(jt, pt).items():
        assert torch.equal(_bits(st[name]), _bits(want)), name
    # the model's table is the store's, widened
    assert torch.equal(pt.model.embedding.packed.detach(), st["table"].float())


def test_train_steps_and_eval_match_jax_trainer():
    """Three steps, the port handed the JAX trainer's state before each (a
    flipped rounding persists and compounds: a one-step rule holds one
    step), the third batch ragged: the losses, the store and the rest of the
    state; then eval AUC and logloss after the last step, which read the
    model's table refreshed from the store."""
    jt, pt = _pair()
    for step in range(3):
        _carry(jt, pt)
        batch = _batch(30 + step, ragged=5 if step == 2 else 0)
        lj, lp = _jax_step(jt, batch), _port_step(pt, batch)
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL * (1 + 10 * step))
        _assert_same_state(jt, pt)
    x, y, _ = _batch(44, b=5 * B + 3)
    jl = jds.BatchIterable(jds.ColumnarDataset(x, y), B)
    pl = pds.BatchIterable(pds.ColumnarDataset(x, y), B)
    (ja, jll), (pa, pll) = jt.evaluate(jt.model, jl), pt.evaluate(pt.model, pl)
    assert abs(pa - ja) <= 1e-5 and abs(pll - jll) <= 1e-5 * abs(jll), ((pa, ja), (pll, jll))
    assert torch.equal(pt.model.embedding.packed.detach(), pt.emb_opt_state["table"].float())


def test_save_load_round_trip_and_other_storage_raises(tmp_path):
    _, a = _pair()
    for step in range(2):
        _port_step(a, _batch(50 + step))
    a.epoch_i, a.early_stopper.best_auc = 3, 0.625
    path = a.save(str(tmp_path / "ck"))
    saved = np.load(path)
    assert saved["opt/emb/mu"].dtype == np.uint16  # bf16 as its raw bits
    _, b = _pair(seed=8)  # other weights until the load
    meta = b.load(path)
    assert meta["sorted_dtype"] == "bf16" and b.epoch_i == 3 and b.emb_opt_state["step"] == 2
    for k in ("table", "mu", "nu"):
        assert torch.equal(_bits(a.emb_opt_state[k]), _bits(b.emb_opt_state[k])), k
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    batch = _batch(52)
    assert _port_step(a, batch) == _port_step(b, batch)
    f32 = PTrainer(copy.deepcopy(a.model), device="cpu", sparse_embedding_updates=True,
                   sparse_update_impl="sorted")
    with pytest.raises(ValueError, match="sorted_dtype='bf16'.*sorted_dtype='float32'"):
        f32.load(path)
    with pytest.raises(ValueError, match="sorted_dtype='float32'.*sorted_dtype='bf16'"):
        b.load(f32.save(str(tmp_path / "f32")))


@pytest.mark.parametrize("aucs,patience,stops", [
    ([0.6, 0.5, 0.55], 1, True),    # epoch 1 does not improve: stop, restore epoch 0
    ([0.6, 0.5, 0.55], 3, False),   # no stop: the last epoch's weights stay
])
def test_early_stop_restore_writes_the_store(tmp_path, aucs, patience, stops):
    _, pt = _pair()
    pt.n_epoch, pt.model_path = 3, str(tmp_path)
    pt.early_stopper = pcallback.EarlyStopper(patience)
    after_epoch, it = [], iter(aucs)
    train = pt.train_one_epoch

    def train_and_snapshot(loader):
        train(loader)
        after_epoch.append(pt.emb_opt_state["table"].clone())

    pt.train_one_epoch = train_and_snapshot
    pt.evaluate = lambda model, loader: (next(it), 0.5)  # reads no table
    path = pt.fit(_loader(), val_dataloader=_loader(seed=41))
    want = after_epoch[0] if stops else after_epoch[-1]
    assert len(after_epoch) == (2 if stops else 3)
    assert torch.equal(_bits(pt.emb_opt_state["table"]), _bits(want))
    assert not torch.equal(_bits(want), _bits(after_epoch[1]))
    np.testing.assert_array_equal(np.load(path)["model/embedding.packed"], want.float().numpy())


W_FROZEN = np.random.default_rng(99).normal(size=(20, D)).astype(np.float32)


def _frozen_feats(m, init):
    """A frozen pretrained packed span (s0) beside trainable tables."""
    return [m.SparseFeature("s0", vocab_size=20, embed_dim=D, initializer=init(W_FROZEN)),
            m.SparseFeature("s1", vocab_size=V, embed_dim=D),
            m.SparseFeature("s2", vocab_size=V, embed_dim=D),
            m.DenseFeature("d0")]


def _frozen_batch(seed, b=B):
    r = np.random.default_rng(seed)
    x = {"s0": r.integers(0, 20, b).astype(np.int32), "s1": r.integers(0, V, b).astype(np.int32),
         "s2": r.integers(0, V, b).astype(np.int32), "d0": r.normal(size=b).astype(np.float32),
         "domain_indicator": r.integers(0, DOMAINS, b).astype(np.int32)}
    return x, r.integers(0, 2, b).astype(np.float32), np.ones(b, np.float32)


def test_frozen_table_keeps_its_rows_and_moments():
    """Three steps beside the JAX trainer (its state handed over before
    each): the frozen span of the bf16 store keeps its rows bit for bit
    (W_FROZEN rounded to bf16) and zero moments; the trainable rows move as
    JAX's do."""
    jt, pt = _pair(frozen=True)
    st = pt.emb_opt_state
    assert pt.model.embedding.frozen_spans == ((0, 20),)
    init = st["table"].clone()
    for step in range(3):
        _carry(jt, pt)
        batch = _frozen_batch(80 + step)
        lj, lp = _jax_step(jt, batch), _port_step(pt, batch)
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL * (1 + 10 * step))
        _assert_same_state(jt, pt)
    frozen = torch.as_tensor(W_FROZEN).to(torch.bfloat16)
    assert torch.equal(_bits(st["table"][:20]), _bits(frozen))
    assert not st["mu"][:20].float().any() and not st["nu"][:20].float().any()
    assert st["mu"][20:].float().any()
    assert not torch.equal(_bits(st["table"][20:]), _bits(init[20:]))
