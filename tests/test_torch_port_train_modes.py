"""``CTRTrainer``'s embedding-update modes other than ``sorted``
(``occurrence``, ``dense``, ``winner``) and frozen ``Pretrained`` tables,
against the JAX trainer from one carried state; and, in the occurrence mode,
that every reader and writer of the weights sees the live combined store:
eval, ``predict``, ``save``, ``load`` and ``fit``'s early-stop snapshot and
restore. MMOE is narrow (vocab 30, D 8, experts [16], dropout 0); inputs are
made with numpy from a seed."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.core.init import pretrained as jpretrained  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.sorted_adam import unpack_rows  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.core.init import pretrained  # noqa: E402
from scenario_wise_rec_tpu_torch.data import dataset as pds  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import (  # noqa: E402
    jax_state_dict, load_jax_trainer_state)
from scenario_wise_rec_tpu_torch.models import MMOE as PMMOE  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.train import callback as pcallback  # noqa: E402

from test_torch_port_train import (  # noqa: E402
    B, D, DOMAINS, KW, LOSS_RTOL, STEP_ATOL, STEP_RTOL, V, _atol, _batch, _feats, _jax_step,
    _loader, _np, _port_step)

MODES = ["occurrence", "dense", "winner"]
ALL_MODES = ["plain"] + MODES + ["sorted"]
W_FROZEN = np.random.default_rng(99).normal(size=(20, D)).astype(np.float32)
W_LOOSE = np.random.default_rng(98).normal(size=(12, 4)).astype(np.float32)


def _frozen_feats(m, init):
    """A frozen packed span (s0) and a frozen loose table (sl, width 4)."""
    return [m.SparseFeature("s0", vocab_size=20, embed_dim=D, initializer=init(W_FROZEN)),
            m.SparseFeature("s1", vocab_size=V, embed_dim=D),
            m.SparseFeature("s2", vocab_size=V, embed_dim=D),
            m.SparseFeature("sl", vocab_size=12, embed_dim=4, initializer=init(W_LOOSE)),
            m.DenseFeature("d0")]


def _frozen_batch(seed, b=B):
    r = np.random.default_rng(seed)
    x = {"s0": r.integers(0, 20, b), "s1": r.integers(0, V, b), "s2": r.integers(0, V, b),
         "sl": r.integers(0, 12, b), "d0": r.normal(size=b).astype(np.float32),
         "domain_indicator": r.integers(0, DOMAINS, b)}
    x = {k: v.astype(np.float32 if k == "d0" else np.int32) for k, v in x.items()}
    return x, r.integers(0, 2, b).astype(np.float32), np.ones(b, np.float32)


def _kw(mode):
    if mode == "plain":
        return {}
    return dict(sparse_embedding_updates=True, sparse_update_impl=mode)


def _pair(mode, frozen=False, seed=7):
    """A JAX trainer and a port trainer holding the same weights and state."""
    jfeats = _frozen_feats(jf, jpretrained) if frozen else _feats(jf)
    pfeats = _frozen_feats(pf, pretrained) if frozen else _feats(pf)
    jkw = {**_kw(mode), **({"sorted_block_rows": 64} if mode == "sorted" else {})}
    jt = JTrainer(JMMOE(jfeats, DOMAINS, **KW), seed=seed, **jkw)
    pm = PMMOE(pfeats, DOMAINS, device="cpu",
               generator=make_generator(torch.device("cpu"), 1), **KW)
    pt = PTrainer(pm, device="cpu", **_kw(mode))
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    return jt, pt


def _emb_moments(jt, pt):
    """``[(name, port, JAX)]`` of the embedding update's moments."""
    if pt._emb_mode is None:
        return []
    emb, st = jt.opt_state["emb"], pt.emb_opt_state
    assert st["step"] == int(emb["step"])
    if pt._emb_mode == "occurrence":
        return [("comb moments", st["comb"][:, D:], np.asarray(emb["comb"])[:, D:])]
    v = pt.model.embedding.packed_vocab
    unpack = (lambda a: unpack_rows(a, v, D)) if "table" in emb else (lambda a: a)
    return [(k, st[k], np.asarray(unpack(emb[k]))) for k in ("mu", "nu")]


def _assert_same_state(jt, pt):
    """Every parameter, BN running stat and Adam moment of the two."""
    want = jax_state_dict(_np(jt._params_for_eval()), _np(jt.state))
    got = pt.model.state_dict()
    assert sorted(want) == sorted(got)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=STEP_RTOL, atol=_atol(k),
                                   err_msg=k)
    base = jt.opt_state["base"] if pt._emb_mode else jt.opt_state
    adam = [s for s in base if hasattr(s, "mu")][0]
    mu = jax_state_dict(_np(adam.mu))
    for name, p in pt._dense_named:
        np.testing.assert_allclose(pt.optimizer.state[p]["exp_avg"].numpy(), mu[name],
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=name)
    for name, got_m, want_m in _emb_moments(jt, pt):
        np.testing.assert_allclose(got_m.numpy(), want_m, rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=name)


# -- the three modes against the JAX trainer ----------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_train_steps_match_jax_trainer(mode):
    """Three steps from one carried state (the third batch ragged); the
    same tolerances as the sorted mode's test (test_torch_port_train.py)."""
    jt, pt = _pair(mode)
    for step in range(3):
        batch = _batch(10 + step, ragged=2 if step == 2 else 0)
        lj, lp = _jax_step(jt, batch), _port_step(pt, batch)
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL * (1 + 10 * step))
        _assert_same_state(jt, pt)


@pytest.mark.parametrize("mode", MODES)
def test_resume_from_carried_jax_training_state(mode):
    """k = 2 JAX steps, everything carried across, one more step each side."""
    jt, _ = _pair(mode)
    for step in range(2):
        _jax_step(jt, _batch(20 + step))
    _, pt = _pair(mode)
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    _assert_same_state(jt, pt)
    batch = _batch(22)
    np.testing.assert_allclose(_port_step(pt, batch), _jax_step(jt, batch), rtol=LOSS_RTOL)
    _assert_same_state(jt, pt)


def test_lazy_modes_agree_and_touch_only_the_batchs_rows():
    """occurrence and winner inside the port (both SparseAdam) after one
    step; rows no id touched keep their weights."""
    _, po = _pair("occurrence")
    pw = PTrainer(copy.deepcopy(po.model), device="cpu", **_kw("winner"))
    before = po.model.embedding.packed.detach().clone()
    batch = _batch(30)
    np.testing.assert_allclose(_port_step(po, batch), _port_step(pw, batch), rtol=LOSS_RTOL)
    for (k, a), b in zip(po.model.state_dict().items(), pw.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    touched = torch.unique(po.model.embedding.touched_ids(po._device_batch(*batch)[0]))
    moved = (po.model.embedding.packed.detach() != before).any(1)
    assert torch.equal(torch.nonzero(moved)[:, 0], touched)


# -- the occurrence mode's live weights ---------------------------------------

def _plain_copy(pt):
    """A plain trainer over a copy of the model with the comb's weights."""
    model = copy.deepcopy(pt.model)
    d = pt.model.embedding.packed_dim
    with torch.no_grad():
        model.embedding.packed.copy_(pt.emb_opt_state["comb"][:, :d])
    return PTrainer(model, device="cpu")


def test_occurrence_table_is_a_live_view_of_the_comb():
    _, pt = _pair("occurrence")
    col, comb = pt.model.embedding, pt.emb_opt_state["comb"]
    assert col.packed.data_ptr() == comb.data_ptr() and col.packed.stride() == (3 * D, 1)
    assert not any(p is col.packed for _, p in pt._dense_named)
    for step in range(2):
        _port_step(pt, _batch(40 + step))
    np.testing.assert_array_equal(col.packed.detach().numpy(), comb[:, :D].numpy())
    loader = _loader(seed=41)
    want = _plain_copy(pt)
    np.testing.assert_array_equal(pt.predict(pt.model, loader), want.predict(want.model, loader))
    np.testing.assert_array_equal(pt.evaluate_multi_domain_loss(pt.model, loader, DOMAINS)[2:],
                                  want.evaluate_multi_domain_loss(want.model, loader,
                                                                  DOMAINS)[2:])


def test_occurrence_save_load_round_trip(tmp_path):
    _, a = _pair("occurrence")
    for step in range(2):
        _port_step(a, _batch(50 + step))
    a.epoch_i = 3
    path = a.save(str(tmp_path / "ck"))
    arrays = np.load(path)
    np.testing.assert_array_equal(arrays["model/embedding.packed"],
                                  a.emb_opt_state["comb"][:, :D].numpy())
    _, b = _pair("occurrence", seed=8)  # other weights until the load
    meta = b.load(path)
    assert meta["sparse_update_impl"] == "occurrence" and b.emb_opt_state["step"] == 2
    assert torch.equal(a.emb_opt_state["comb"], b.emb_opt_state["comb"])
    assert b.model.embedding.packed.data_ptr() == b.emb_opt_state["comb"].data_ptr()
    batch = _batch(52)
    assert _port_step(a, batch) == _port_step(b, batch)
    assert torch.equal(a.emb_opt_state["comb"], b.emb_opt_state["comb"])
    for mode in ("dense", "winner"):
        with pytest.raises(ValueError, match="sparse_update_impl"):
            PTrainer(copy.deepcopy(a.model), device="cpu", **_kw(mode)).load(path)
    _, d = _pair("dense")
    for step in range(2):
        _port_step(d, _batch(60 + step))
    e = _pair("dense", seed=8)[1]
    e.load(d.save(str(tmp_path / "dense")))
    for k in ("mu", "nu"):
        assert torch.equal(d.emb_opt_state[k], e.emb_opt_state[k])
    assert torch.equal(d.model.embedding.packed, e.model.embedding.packed)


@pytest.mark.parametrize("aucs,patience,stops", [
    ([0.6, 0.5, 0.55], 1, True),    # epoch 1 does not improve: stop, restore epoch 0
    ([0.6, 0.5, 0.55], 3, False),   # no stop: the last epoch's weights stay
])
def test_occurrence_fit_restores_the_comb_on_early_stop(tmp_path, aucs, patience, stops):
    _, pt = _pair("occurrence")
    pt.n_epoch, pt.model_path = 3, str(tmp_path)
    pt.early_stopper = pcallback.EarlyStopper(patience)
    after_epoch, it = [], iter(aucs)
    train = pt.train_one_epoch

    def train_and_snapshot(loader):
        train(loader)
        after_epoch.append(pt.emb_opt_state["comb"][:, :D].clone())

    pt.train_one_epoch = train_and_snapshot
    pt.evaluate = lambda model, loader: (next(it), 0.5)
    path = pt.fit(_loader(), val_dataloader=_loader(seed=41))
    want = after_epoch[0] if stops else after_epoch[-1]
    assert len(after_epoch) == (2 if stops else 3)
    assert torch.equal(pt.emb_opt_state["comb"][:, :D], want)
    assert not torch.equal(want, after_epoch[1])
    np.testing.assert_array_equal(np.load(path)["model/embedding.packed"], want.numpy())


def test_occurrence_fit_trains_evaluates_and_saves(tmp_path):
    _, pt = _pair("occurrence")
    pt.n_epoch, pt.model_path = 2, str(tmp_path)
    path = pt.fit(_loader(shuffle=True), val_dataloader=_loader(seed=41))
    assert path.endswith(".npz") and pt.emb_opt_state["step"] == 2 * 8
    ll, auc, tll, tauc = pt.evaluate_multi_domain_loss(pt.model, _loader(seed=42), DOMAINS)
    assert all(np.isfinite(v) for v in ll + auc + [tll, tauc])
    want = _plain_copy(pt)
    assert (tll, tauc) == tuple(want.evaluate_multi_domain_loss(want.model, _loader(seed=42),
                                                                DOMAINS)[2:])


# -- frozen Pretrained tables -------------------------------------------------

@pytest.mark.parametrize("mode", ALL_MODES)
def test_frozen_tables_bit_identical_after_steps(mode):
    """3 steps: the frozen span and the frozen loose table keep their
    pretrained weights bit for bit and hold no moments; trainable rows
    moved."""
    _, pt = _pair(mode, frozen=True)
    col = pt.model.embedding
    assert col.frozen_spans == ((0, 20),) and col.frozen_loose == ("sl",)
    init = col.packed.detach().clone()
    for step in range(3):
        _port_step(pt, _frozen_batch(70 + step))
    packed = col.packed.detach()
    np.testing.assert_array_equal(packed[:20].numpy(), W_FROZEN)
    np.testing.assert_array_equal(col.tables["sl"].detach().numpy(), W_LOOSE)
    assert not col.tables["sl"].requires_grad
    assert not torch.equal(packed[20:], init[20:]), "trainable rows did not move"
    if mode == "plain":
        st = pt.optimizer.state[col.packed]
        moments = [st["exp_avg"], st["exp_avg_sq"]]
    elif mode == "occurrence":
        moments = [pt.emb_opt_state["comb"][:, D:]]
    else:
        moments = [pt.emb_opt_state["mu"], pt.emb_opt_state["nu"]]
    assert all(not m[:20].any() and m[20:].any() for m in moments)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_frozen_tables_match_jax_trainer(mode):
    """The JAX trainer with the same frozen tables, three steps from one
    carried state (the frozen loose table has no torch.optim state)."""
    jt, pt = _pair(mode, frozen=True)
    assert "embedding.tables.sl" not in dict(pt._dense_named)
    for step in range(3):
        batch = _frozen_batch(80 + step)
        jx = {k: jnp.asarray(v) for k, v in batch[0].items()}
        jt.params, jt.opt_state, jt.state, lj = jt._train_step(
            jt.params, jt.opt_state, jt.state, jx, jnp.asarray(batch[1]),
            jnp.asarray(batch[2]), jax.random.PRNGKey(1))
        np.testing.assert_allclose(_port_step(pt, batch), float(lj),
                                   rtol=LOSS_RTOL * (1 + 10 * step))
        _assert_same_state(jt, pt)


def test_frozen_table_survives_fit(tmp_path):
    x, y, _ = _frozen_batch(90, b=5 * B + 3)
    loader = pds.BatchIterable(pds.ColumnarDataset(x, y), B)
    _, pt = _pair("occurrence", frozen=True)
    pt.n_epoch, pt.model_path = 2, str(tmp_path)
    pt.fit(loader, val_dataloader=loader)
    np.testing.assert_array_equal(pt.model.embedding.packed.detach()[:20].numpy(), W_FROZEN)
    np.testing.assert_array_equal(pt.model.embedding.tables["sl"].detach().numpy(), W_LOOSE)
