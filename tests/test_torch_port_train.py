"""The port's training path against the JAX package: loss, optimizer,
rows-cache forward and its gradient, the sorted and the plain dense train
steps of ``CTRTrainer`` with weights carried across, resuming from carried
training state, ``scan_steps``, ``fit``'s early stopping and the port's own
checkpoints. Inputs are made with numpy from a seed and fed to both
packages; MMOE is narrow (vocab 30, D 8, experts [16], dropout 0)."""

import copy
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.sorted_adam import unpack_rows  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu.train import callback as jcallback  # noqa: E402
from scenario_wise_rec_tpu.train import loss as jloss  # noqa: E402
from scenario_wise_rec_tpu.train import optim as joptim  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.data import dataset as pds  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import (  # noqa: E402
    jax_state_dict, load_jax_trainer_state)
from scenario_wise_rec_tpu_torch.models import MMOE as PMMOE  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.embedding import EmbeddingCollection  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.train import callback as pcallback  # noqa: E402
from scenario_wise_rec_tpu_torch.train import loss as ploss  # noqa: E402
from scenario_wise_rec_tpu_torch.train import optim as poptim  # noqa: E402

V, D, DOMAINS, B = 30, 8, 2, 16
KW = dict(n_expert=2, expert_params={"dims": [16]}, tower_params={"dims": [8]})
# One f32 step: torch and XLA sum matmuls in other orders (~1e-7 relative in
# the gradients), and torch.optim.Adam associates the bias correction
# differently from optax and from the sorted update's hp math. Adam divides
# by sqrt(nu), so an element whose gradient is near eps magnifies that
# noise; the JAX package's own note (tests/test_sorted_adam.py:172-175) puts
# the drift between its two formulations near 1e-4 by step 2.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
# A Linear bias followed by a train-mode BatchNorm has an exactly zero
# gradient (BN subtracts the batch mean); its f32 gradient is rounding noise
# of ~1e-9, which Adam scales to a step of about +-lr whatever its size, so
# two correct implementations move it by up to a few lr per step in
# unrelated directions. BN removes the bias again, so nothing downstream
# sees it in training; the BN running mean follows it (momentum 0.1).
BN_BIAS = re.compile(r"layers\.\d+\.(lin\.b|bn\.mean)$")
BN_BIAS_ATOL = 1e-2  # 10 x lr = 1e-3, over at most three steps
LOSS_RTOL = 1e-6
# one forward/backward: elements that are sums with cancellation carry
# ~1e-5 of the gradient's scale (~0.1) as absolute noise
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _atol(key):
    return BN_BIAS_ATOL if BN_BIAS.search(key) else STEP_ATOL


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
    x["d0"] = r.normal(size=b).astype(np.float32)
    x["domain_indicator"] = r.integers(0, DOMAINS, b).astype(np.int32)
    y = r.integers(0, 2, b).astype(np.float32)
    w = np.ones(b, np.float32)
    w[b - ragged:] = 0.0
    return x, y, w


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(sorted_mode, seed=7):
    """A JAX trainer and a port trainer holding the same weights and state."""
    kw = (dict(sparse_embedding_updates=True, sparse_update_impl="sorted")
          if sorted_mode else {})
    jt = JTrainer(JMMOE(_feats(jf), DOMAINS, **KW), seed=seed,
                  **({**kw, "sorted_block_rows": 64} if sorted_mode else kw))
    pm = PMMOE(_feats(pf), DOMAINS, device="cpu",
               generator=make_generator(torch.device("cpu"), 1), **KW)
    pt = PTrainer(pm, device="cpu", **kw)
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    return jt, pt


def _jax_step(jt, batch):
    x, y, w = (jax.tree_util.tree_map(jnp.asarray, a) for a in batch)
    jt.params, jt.opt_state, jt.state, loss = jt._train_step(
        jt.params, jt.opt_state, jt.state, x, y, w, jax.random.PRNGKey(1))
    return float(loss)


def _port_step(pt, batch):
    return float(pt._train_step(*pt._device_batch(*batch)))


def _assert_same_state(jt, pt, sorted_mode):
    """Every parameter, BN running stat and Adam moment of the two."""
    want = jax_state_dict(_np(jt._params_for_eval()), _np(jt.state))
    got = pt.model.state_dict()
    assert sorted(want) == sorted(got)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=STEP_RTOL, atol=_atol(k),
                                   err_msg=k)
    base = jt.opt_state["base"] if sorted_mode else jt.opt_state
    adam_state = base[1]  # (add_decayed_weights, scale_by_adam, scale)
    mu = jax_state_dict(_np(adam_state.mu))
    for name, p in pt._dense_named:
        np.testing.assert_allclose(pt.optimizer.state[p]["exp_avg"].numpy(), mu[name],
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=name)
    if sorted_mode:
        emb = jt.opt_state["emb"]
        vp = pt.model.embedding.packed_vocab
        assert pt.emb_opt_state["step"] == int(emb["step"])
        for k in ("mu", "nu"):
            np.testing.assert_allclose(pt.emb_opt_state[k].numpy(),
                                       np.asarray(unpack_rows(emb[k], vp, D)),
                                       rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)


# -- loss and optimizer -----------------------------------------------------

def test_bce_loss_value_and_gradient_match_jax():
    r = np.random.default_rng(0)
    p = r.random(12).astype(np.float32)
    p[:4] = [0.0, 1.0, 0.0, 1.0]  # both clamped ends, both labels
    y = np.array([0, 1, 1, 0] + list(r.integers(0, 2, 8)), np.float32)
    w = np.ones(12, np.float32)
    w[-3:] = 0.0
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        val_j, grad_j = jax.value_and_grad(jloss.bce_loss)(jnp.asarray(p), jnp.asarray(y), jw)
        pt = torch.tensor(p, requires_grad=True)
        val_p = ploss.bce_loss(pt, torch.as_tensor(y),
                               None if weights is None else torch.as_tensor(weights))
        val_p.backward()
        assert np.isfinite(pt.grad.numpy()).all()
        np.testing.assert_allclose(float(val_p), float(val_j), rtol=1e-6)
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(grad_j), rtol=1e-6, atol=0)
    pos, neg = r.normal(size=9).astype(np.float32), r.normal(size=9).astype(np.float32)
    np.testing.assert_allclose(
        float(ploss.hinge_loss(torch.as_tensor(pos), torch.as_tensor(neg))),
        float(jloss.hinge_loss(jnp.asarray(pos), jnp.asarray(neg))), rtol=1e-6)
    np.testing.assert_allclose(
        float(ploss.bpr_loss(torch.as_tensor(pos), torch.as_tensor(neg))),
        float(jloss.bpr_loss(jnp.asarray(pos), jnp.asarray(neg))), rtol=1e-6)


def test_adam_and_step_lr_match_the_optax_chain():
    r = np.random.default_rng(1)
    w0 = r.normal(size=(5, 3)).astype(np.float32)
    kw = dict(lr=1e-2, weight_decay=1e-3, b1=0.8, b2=0.99, eps=1e-7)
    chain = joptim.adam(**kw)
    jw = jnp.asarray(w0)
    state = chain.init(jw)
    pw = torch.nn.Parameter(torch.as_tensor(w0.copy()))
    opt = poptim.adam(**kw)([pw])
    assert isinstance(opt, torch.optim.Adam)
    for _ in range(6):
        g = r.normal(size=w0.shape).astype(np.float32)
        upd, state = chain.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        pw.grad = torch.as_tensor(g)
        opt.step()
        np.testing.assert_allclose(pw.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    for epoch in range(7):
        assert poptim.step_lr(2, 0.5)(epoch) == joptim.step_lr(2, 0.5)(epoch)


def test_trainer_steps_lr_once_per_epoch(tmp_path):
    _, pt = _pair(True)
    pt = PTrainer(pt.model, device="cpu", sparse_embedding_updates=True,
                  sparse_update_impl="sorted", scheduler_fn=poptim.step_lr,
                  scheduler_params={"step_size": 1, "gamma": 0.5}, n_epoch=3,
                  model_path=str(tmp_path), optimizer_params={"lr": 0.1})
    seen = []
    pt.train_one_epoch = lambda loader: seen.append(
        (pt._lr_now, pt.optimizer.param_groups[0]["lr"]))
    pt.fit([])
    assert seen == [(0.1, 0.1), (0.05, 0.05), (0.025, 0.025)]


# -- embedding rows cache -----------------------------------------------------

def test_touched_owner_segments_and_rows_forward():
    _, pt = _pair(True)
    col = pt.model.embedding
    x, _, _ = _batch(3)
    px = {k: torch.as_tensor(v) for k, v in x.items()}
    ids = col.touched_ids(px)
    segs = col.touched_owner_segments(px)
    assert segs == (("s0", 0, B), ("s1", B, B), ("s2", 2 * B, B),
                    ("s0", 3 * B, B), ("s1", 4 * B, 4 * B))
    assert ids.shape == (8 * B,)
    rows = col.packed.detach()[ids]
    feats = pt.model.features
    np.testing.assert_array_equal(
        col(px, feats, squeeze_dim=True, rows=rows).detach().numpy(),
        col(px, feats, squeeze_dim=True).detach().numpy())
    np.testing.assert_array_equal(col(px, feats[:3], rows=rows).detach().numpy(),
                                  col(px, feats[:3]).detach().numpy())


def test_touched_ids_empty_case_lies_on_the_collections_device():
    only_dense = EmbeddingCollection([pf.DenseFeature("d0")],
                                     make_generator(torch.device("cpu"), 0))
    ids = only_dense.touched_ids({"d0": torch.zeros(4)})
    assert ids.shape == (0,) and ids.dtype == torch.long and ids.device.type == "cpu"
    col = EmbeddingCollection(_feats(pf), make_generator(torch.device("cpu"), 0)).to("meta")
    ids = col.touched_ids({"d0": torch.zeros(4)}, features=[pf.DenseFeature("d0")])
    assert ids.shape == (0,) and ids.device.type == "meta"


def test_gradient_with_respect_to_rows_matches_jax():
    jt, pt = _pair(True)
    x, y, w = _batch(4, ragged=3)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    col_j = jt.model.embedding
    ids_j = col_j.touched_ids(jx)
    rows_j = jt._params_for_eval()["embedding"]["packed"][ids_j]

    def loss_fn(rows):
        p2 = {**jt.params, "embedding": {**jt.params["embedding"], "__rows__": rows}}
        probs, _ = jt.model.apply(p2, jt.state, jx, train=True, rng=None, w=jnp.asarray(w))
        return jloss.bce_loss(probs, jnp.asarray(y), jnp.asarray(w))

    loss_j, g_j = jax.value_and_grad(loss_fn)(rows_j)
    px, py, pw = pt._device_batch(x, y, w)
    col = pt.model.embedding
    ids = col.touched_ids(px)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    rows = col.packed.detach()[ids].requires_grad_()
    loss = ploss.bce_loss(pt.model.apply(px, train=True, w=pw, rows=rows), py, pw)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(rows.grad.numpy(), np.asarray(g_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


# -- train steps --------------------------------------------------------------

@pytest.mark.parametrize("sorted_mode", [True, False], ids=["sorted", "dense"])
def test_train_steps_match_jax_trainer(sorted_mode):
    jt, pt = _pair(sorted_mode)
    for step in range(3):
        batch = _batch(10 + step, ragged=2 if step == 2 else 0)
        lj, lp = _jax_step(jt, batch), _port_step(pt, batch)
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL * (1 + 10 * step))
        _assert_same_state(jt, pt, sorted_mode)


@pytest.mark.parametrize("sorted_mode", [True, False], ids=["sorted", "dense"])
def test_resume_from_carried_jax_training_state(sorted_mode):
    """k = 2 JAX steps, everything carried across, one more step each side."""
    jt, _ = _pair(sorted_mode)
    for step in range(2):
        _jax_step(jt, _batch(20 + step))
    _, pt = _pair(sorted_mode)
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    _assert_same_state(jt, pt, sorted_mode)
    batch = _batch(22)
    np.testing.assert_allclose(_port_step(pt, batch), _jax_step(jt, batch), rtol=LOSS_RTOL)
    _assert_same_state(jt, pt, sorted_mode)


def test_sorted_step_matches_plain_dense_step():
    """The no-deviation claim inside the port: the sorted trainer and the
    plain dense trainer (torch.optim.Adam over the whole table) agree."""
    _, ps = _pair(True)
    pd = PTrainer(copy.deepcopy(ps.model), device="cpu")
    for step in range(2):
        batch = _batch(30 + step)
        np.testing.assert_allclose(_port_step(ps, batch), _port_step(pd, batch),
                                   rtol=LOSS_RTOL)
    table = pd.model.embedding.packed
    np.testing.assert_allclose(ps.model.embedding.packed.detach().numpy(),
                               table.detach().numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)
    np.testing.assert_allclose(ps.emb_opt_state["mu"].numpy(),
                               pd.optimizer.state[table]["exp_avg"].numpy(),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    for (name, a), (_, b) in zip(ps._dense_named,
                                 [(n, p) for n, p in pd._dense_named
                                  if p is not table]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=STEP_RTOL, atol=_atol(name), err_msg=name)


def _loader(n=7 * B + 5, seed=40, shuffle=False):
    x, y, _ = _batch(seed, b=n)
    return pds.BatchIterable(pds.ColumnarDataset(x, y), B, shuffle=shuffle, seed=seed)


def test_scan_steps_equal_single_steps():
    _, a = _pair(True)
    b = PTrainer(copy.deepcopy(a.model), device="cpu", sparse_embedding_updates=True,
                 sparse_update_impl="sorted", scan_steps=3)
    a.train_one_epoch(_loader(), log_interval=4)   # 8 batches, one step each
    b.train_one_epoch(_loader(), log_interval=4)
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.emb_opt_state["step"] == b.emb_opt_state["step"] == 8
    assert torch.equal(a.emb_opt_state["nu"], b.emb_opt_state["nu"])


def test_early_stopper_matches_jax():
    for patience in (1, 2, 3):
        for aucs in ([0.6, 0.5, 0.55, 0.7, 0.4, 0.4, 0.4],
                     [0.5, 0.6, 0.7, 0.7, 0.71, 0.6, 0.6]):
            js, ps = jcallback.EarlyStopper(patience), pcallback.EarlyStopper(patience)
            for auc in aucs:
                assert ps.stop_training(auc, {}) == js.stop_training(auc, {})
                assert ps.trial_counter == js.trial_counter
                assert ps.best_auc == js.best_auc


@pytest.mark.parametrize("aucs,patience,stops", [
    ([0.6, 0.5, 0.55], 1, True),    # epoch 1 does not improve: stop, restore epoch 0
    ([0.6, 0.5, 0.55], 3, False),   # no stop: the last epoch's weights stay
])
def test_fit_restores_best_weights_only_on_early_stop(tmp_path, aucs, patience, stops):
    _, pt = _pair(True)
    pt.n_epoch, pt.model_path = 3, str(tmp_path)
    pt.early_stopper = pcallback.EarlyStopper(patience)
    after_epoch, it = [], iter(aucs)
    train = pt.train_one_epoch

    def train_and_snapshot(loader):
        train(loader)
        after_epoch.append(copy.deepcopy(pt.model.state_dict()))

    pt.train_one_epoch = train_and_snapshot
    pt.evaluate = lambda model, loader: (next(it), 0.5)
    pt.fit(_loader(), val_dataloader=_loader(seed=41))
    final = pt.model.state_dict()
    want = after_epoch[0] if stops else after_epoch[-1]
    assert len(after_epoch) == (2 if stops else 3)
    assert all(torch.equal(final[k], want[k]) for k in final)
    assert not all(torch.equal(final[k], after_epoch[1][k]) for k in final)


def test_save_load_round_trip(tmp_path):
    _, a = _pair(True)
    for step in range(2):
        _port_step(a, _batch(50 + step))
    a.epoch_i, a.early_stopper.best_auc = 3, 0.625
    path = a.save(str(tmp_path / "ck"))
    _, b = _pair(True, seed=8)  # other weights until the load
    meta = b.load(path)
    assert meta["sparse_update_impl"] == "sorted" and b.epoch_i == 3
    assert b.early_stopper.best_auc == 0.625 and b.emb_opt_state["step"] == 2
    batch = _batch(52)
    assert _port_step(a, batch) == _port_step(b, batch)
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    for k in ("mu", "nu"):
        assert torch.equal(a.emb_opt_state[k], b.emb_opt_state[k])
    with pytest.raises(ValueError, match="sparse_update_impl"):
        PTrainer(copy.deepcopy(a.model), device="cpu").load(path)


def test_fit_trains_evaluates_and_saves(tmp_path):
    _, pt = _pair(True)
    pt.n_epoch, pt.model_path = 2, str(tmp_path)
    path = pt.fit(_loader(shuffle=True), val_dataloader=_loader(seed=41))
    assert path.endswith(".npz") and (tmp_path / path.split("/")[-1]).exists()
    assert pt.emb_opt_state["step"] == 2 * 8
    ll, auc, tll, tauc = pt.evaluate_multi_domain_loss(pt.model, _loader(seed=42), DOMAINS)
    assert all(np.isfinite(v) for v in ll + auc + [tll, tauc])


def test_trainer_rejects_what_the_port_does_not_run():
    """A mesh that is not a ``parallel.Mesh`` raises ``TypeError``; more
    than one GPU raises with its ROADMAP item (fused eval under a mesh runs
    since A15.3); ``fused_inference="auto"`` (A10, ported) resolves to a
    bool; the JAX dials the port has no use for raise."""
    from scenario_wise_rec_tpu_torch.ops.kernels import fused_inference_auto
    from scenario_wise_rec_tpu_torch.parallel import make_mesh

    _, pt = _pair(True)
    model = pt.model
    with pytest.raises(TypeError, match="Mesh"):
        PTrainer(model, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="A15"):
        PTrainer(model, device="cpu", gpus=[0, 1])
    # fused eval runs on a mesh since A15.3
    assert PTrainer(model, device="cpu", mesh=make_mesh(1, 1),
                    fused_inference=True)._fused_inference
    auto = PTrainer(model, device="cpu", fused_inference="auto")
    assert auto._fused_inference is fused_inference_auto(model)
    for kw in (dict(sorted_kernel=False), dict(sorted_chunk_ids=100),
               dict(sorted_precision="bf16"), dict(sorted_reorder="scatter"),
               dict(scan_steps=0), dict(sorted_dtype="fp16")):
        with pytest.raises(ValueError):
            PTrainer(model, device="cpu", **kw)
    wide = PMMOE([pf.SparseFeature("s0", vocab_size=V, embed_dim=12), pf.DenseFeature("d0")],
                 DOMAINS, device="cpu", **KW)
    with pytest.raises(ValueError, match="divide 128"):
        PTrainer(wide, device="cpu", sparse_embedding_updates=True,
                 sparse_update_impl="sorted")
