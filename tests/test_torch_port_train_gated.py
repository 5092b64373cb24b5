"""SAR-Net, EPNet, PPNet and AdaSparse train steps in the port against the
JAX package's ``CTRTrainer._train_step``: 3 steps (the last on a ragged
batch) and a resume from carried JAX training state
(``load_jax_trainer_state``). SAR-Net runs the sorted and the plain dense
step; EPNet, PPNet and AdaSparse have no ``embedding`` collection, so with
``sparse_embedding_updates=True`` both trainers run the plain dense step.
The models are narrow (vocab 30, D 8); inputs come from numpy."""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.core import init as jinit  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.sorted_adam import unpack_rows  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core import init as pinit  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import (  # noqa: E402
    jax_state_dict, load_jax_trainer_state)
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402

V, D, DOMAINS, B = 30, 8, 2, 16
LR = 1e-3
# The tolerances of tests/test_torch_port_train.py (MMOE), for the same
# reasons: torch and XLA sum in other orders, and Adam divides by sqrt(nu).
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-6
# A parameter whose every effect a train-mode BatchNorm subtracts again has
# an exactly zero gradient, whose f32 rounding noise Adam turns into steps of
# about +-lr in unrelated directions: a Linear bias before a BatchNorm and
# the running mean that follows it. They are held to 10 x lr.
BN_CANCELLED = re.compile(r"layers\.\d+\.(lin\.b|bn\.mean)$")
BN_CANCELLED_ATOL = 1e-2
# Adam's first moments hold 0.1 x the gradient; an element whose gradient is
# a sum that cancels carries the backward's rounding as absolute noise (the
# reason in tests/test_torch_port_train_models.py): 1e-5 x the tensor's
# largest element besides STEP_ATOL.
MOMENT_SCALE_ATOL = 1e-5


def _feats():
    """Constructor arguments per model, narrow, for the JAX package's or the
    port's ``features`` module ``m`` and its ``init`` module ``i``.

    The tables start from N(0, 0.5), not the default N(0, 1e-4): SAR-Net
    normalizes each domain's scaled embedding, ``emb * dom_w + dom_b``, by
    its batch statistics, and at 1e-4 the rows differ by less than the
    rounding of ``dom_b`` allows (6e-8 at 0.5), so the two frameworks'
    rounding reaches the gradients at 1e-3."""
    def kw(m, i, name):
        t = dict(embed_dim=D, initializer=i.random_normal(0.0, 0.5))
        sparse = ([m.SparseFeature(f"s{k}", vocab_size=V, **t) for k in range(3)]
                  + [m.SparseFeature("alias", vocab_size=V, embed_dim=D, shared_with="s0")])
        dense = [m.DenseFeature("d0")]
        sce = [m.SparseFeature("domain_indicator", vocab_size=DOMAINS, **t)]
        ids = [m.SparseFeature("uid", vocab_size=V, **t)]
        return {
            "sarnet": dict(features=sparse + dense, domain_num=DOMAINS,
                           domain_shared_expert_num=3, domain_specific_expert_num=2),
            "epnet": dict(sce_features=sce, agn_features=sparse + dense, fcn_dims=[8]),
            "ppnet": dict(id_features=ids, agn_features=sparse + dense + sce,
                          domain_num=DOMAINS, fcn_dims=[16, 8]),
            # dropout 0: the two frameworks draw their dropout masks from
            # generators that give different bits, so a step with dropout
            # cannot match; AdaSparse's dropout itself is the shared
            # ops.nn.dropout (tests/test_torch_port_nn.py)
            "adasparse": dict(sce_features=sce, agn_features=sparse, form="Fusion",
                              mlp_params={"dims": [16, 8], "dropout": 0.0}),
        }[name]
    return kw


KW = _feats()
# (model, sparse_embedding_updates): SAR-Net has one embedding collection and
# runs the sorted step with the flag; the others run the dense step either way
CASES = [("sarnet", True), ("sarnet", False), ("epnet", True), ("ppnet", True),
         ("adasparse", True), ("adasparse", False)]
IDS = [f"{m}-{'flag' if s else 'dense'}" for m, s in CASES]


def _batch(seed, ragged=0):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, B).astype(np.int32) for i in range(3)}
    x["alias"] = r.integers(0, V, B).astype(np.int32)
    x["uid"] = r.integers(0, V, B).astype(np.int32)
    x["d0"] = r.normal(size=B).astype(np.float32)
    x["domain_indicator"] = r.integers(0, DOMAINS, B).astype(np.int32)
    y = r.integers(0, 2, B).astype(np.float32)
    w = np.ones(B, np.float32)
    w[B - ragged:] = 0.0
    return x, y, w


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mode(flag):
    return dict(sparse_embedding_updates=True, sparse_update_impl="sorted") if flag else {}


def _pair(name, flag, seed=7):
    """A JAX trainer and a port trainer holding the same weights and state."""
    jt = JTrainer(jmodels.get_model(name)(**KW(jf, jinit, name)), seed=seed,
                  **({**_mode(flag), "sorted_block_rows": 64} if flag else {}))
    pm = pmodels.get_model(name)(**KW(pf, pinit, name), device="cpu",
                                 generator=make_generator(torch.device("cpu"), 1))
    pt = PTrainer(pm, device="cpu", **_mode(flag))
    assert pt._sorted_mode == jt._sparse_emb == (flag and name == "sarnet")
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    return jt, pt


def _jax_step(jt, batch):
    x, y, w = (jax.tree_util.tree_map(jnp.asarray, a) for a in batch)
    jt.params, jt.opt_state, jt.state, loss = jt._train_step(
        jt.params, jt.opt_state, jt.state, x, y, w, jax.random.PRNGKey(1))
    return float(loss)


def _port_step(pt, batch):
    return float(pt._train_step(*pt._device_batch(*batch)))


def _close_moments(got, want, err_msg):
    atol = STEP_ATOL + MOMENT_SCALE_ATOL * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL, atol=atol, err_msg=err_msg)


def _assert_same_state(jt, pt):
    """Every parameter, buffer (BN running stats, AdaSparse's alpha) and Adam
    moment of the two."""
    want = jax_state_dict(_np(jt._params_for_eval()), _np(jt.state))
    got = pt.model.state_dict()
    assert sorted(want) == sorted(got)
    for k, v in got.items():
        atol = BN_CANCELLED_ATOL if BN_CANCELLED.search(k) else STEP_ATOL
        np.testing.assert_allclose(v.numpy(), want[k], rtol=STEP_RTOL, atol=atol, err_msg=k)
    base = jt.opt_state["base"] if pt._sorted_mode else jt.opt_state
    mu = jax_state_dict(_np(base[1].mu))  # (add_decayed_weights, scale_by_adam, scale)
    for name, p in pt._dense_named:
        _close_moments(pt.optimizer.state[p]["exp_avg"].numpy(), mu[name], name)
    if pt._sorted_mode:
        emb = jt.opt_state["emb"]
        vp = pt.model.embedding.packed_vocab
        assert pt.emb_opt_state["step"] == int(emb["step"])
        for k in ("mu", "nu"):
            _close_moments(pt.emb_opt_state[k].numpy(),
                           np.asarray(unpack_rows(emb[k], vp, D)), k)
    else:
        assert pt.emb_opt_state is None


@pytest.mark.parametrize("name,flag", CASES, ids=IDS)
def test_train_steps_match_jax_trainer(name, flag):
    jt, pt = _pair(name, flag)
    for step in range(3):
        batch = _batch(10 + step, ragged=3 if step == 2 else 0)
        lj, lp = _jax_step(jt, batch), _port_step(pt, batch)
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL * (1 + 10 * step))
        _assert_same_state(jt, pt)


@pytest.mark.parametrize("name,flag", CASES, ids=IDS)
def test_resume_from_carried_jax_training_state(name, flag):
    """2 JAX steps, everything carried across (AdaSparse's alpha too), one
    more step each side."""
    jt, _ = _pair(name, flag)
    for step in range(2):
        _jax_step(jt, _batch(20 + step))
    _, pt = _pair(name, flag, seed=8)  # other weights until the load
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    _assert_same_state(jt, pt)
    batch = _batch(22)
    np.testing.assert_allclose(_port_step(pt, batch), _jax_step(jt, batch), rtol=LOSS_RTOL)
    _assert_same_state(jt, pt)


def test_ppnet_agnostic_table_takes_its_adam_step():
    """PPNet's agnostic table reaches the loss only through ``detach``: its
    gradient is None in torch and zero in JAX. The JAX package's optax chain
    still steps it (weight decay into Adam moves each element by up to lr),
    and so must the port's trainer: 3 steps, the table equal to JAX's at the
    train tolerance and every element moved."""
    jt, pt = _pair("ppnet", False)
    table = pt.model.agn_embedding.packed
    before = table.detach().clone()
    for step in range(3):
        batch = _batch(30 + step)
        _jax_step(jt, batch), _port_step(pt, batch)
    want = np.asarray(jt.params["agn_embedding"]["packed"])
    np.testing.assert_allclose(table.detach().numpy(), want, rtol=STEP_RTOL, atol=STEP_ATOL)
    moved = (table.detach() - before).abs()
    assert bool((moved > 0).all()) and moved.max().item() <= 3 * LR
    assert float(pt.optimizer.state[table]["step"]) == 3.0


def test_fit_runs_fused_validation_for_each_model(tmp_path):
    """``fit`` with ``sparse_embedding_updates=True`` and fused validation,
    then ``evaluate_multi_domain_loss``: finite metrics; SAR-Net counts its
    sorted steps, the others have no sorted state (the dense step)."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset

    def loader(seed, n=70):
        r = np.random.default_rng(seed)
        x = {k: r.integers(0, V, n) for k in ("s0", "s1", "s2", "alias", "uid")}
        x["d0"] = r.normal(size=n).astype(np.float32)
        x["domain_indicator"] = np.arange(n) % DOMAINS
        y = (np.arange(n) // DOMAINS % 2).astype(np.float32)
        return BatchIterable(ColumnarDataset(x, y), B)

    for name in ("sarnet", "epnet", "ppnet", "adasparse"):
        pm = pmodels.get_model(name)(**KW(pf, pinit, name), device="cpu")
        pt = PTrainer(pm, device="cpu", n_epoch=1, model_path=str(tmp_path),
                      fused_inference=True, **_mode(True))
        alpha = float(getattr(pm, "alpha", 0.0))
        pt.fit(loader(1), val_dataloader=loader(2))
        if name == "sarnet":
            assert pt.emb_opt_state["step"] == 5
        else:
            assert pt.emb_opt_state is None and not pt._sorted_mode
            assert float(pt.optimizer.state[pm.agn_embedding.packed]["step"]) == 5.0
        if name == "adasparse":  # 5 train steps advance alpha; the evaluations do not
            assert abs(float(pm.alpha) - (alpha + 5e-4)) < 1e-6
        ll, auc, tll, tauc = pt.evaluate_multi_domain_loss(pm, loader(3), DOMAINS)
        assert all(np.isfinite(v) for v in ll + auc + [tll, tauc]), name
