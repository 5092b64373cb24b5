"""SharedBottom, STAR and PLE train steps in the port against the JAX
package's ``CTRTrainer._train_step``: the sorted and the plain dense step
over 3 steps (the last on a ragged batch), and resuming from carried JAX
training state (``load_jax_trainer_state``), in both update modes. The
models are narrow (vocab 30, D 8, dropout 0); inputs come from numpy."""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas.sorted_adam import unpack_rows  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import (  # noqa: E402
    jax_state_dict, load_jax_trainer_state)
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402

V, D, DOMAINS, B = 30, 8, 2, 16
# The tolerances of tests/test_torch_port_train.py (MMOE), for the same
# reasons: torch and XLA sum in other orders, and Adam divides by sqrt(nu).
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-6
# A parameter whose every effect a train-mode BatchNorm subtracts again has
# an exactly zero gradient, whose f32 rounding noise Adam turns into steps of
# about +-lr in unrelated directions: a Linear bias before a BatchNorm and
# the running mean that follows it, and in STAR also the FCN biases and the
# domain norm's betas (a per-domain constant shift before the first FCN
# layer's BatchNorm). They are held to 10 x lr.
BN_CANCELLED = re.compile(r"(layers\.\d+\.(lin\.b|bn\.mean)"
                          r"|fcn\.(share_b|dom_b)\.\d+|fcn\.bn\.\d+\.mean"
                          r"|dn\.(share_)?beta)$")
BN_CANCELLED_ATOL = 1e-2
# Adam's first moments hold 0.1 x the gradient. An element whose gradient
# is a sum that cancels (STAR's domain norm makes every embedding column's
# gradient sum to zero over the batch) carries the backward's rounding,
# ~1e-5 of the gradient's scale (GRAD_ATOL's reason in
# tests/test_torch_port_train.py), as absolute noise: the moments are held
# to 1e-5 x their tensor's largest element besides STEP_ATOL.
MOMENT_SCALE_ATOL = 1e-5

MODELS = {
    "sharedbottom": ("sharedbottom", dict(bottom_params={"dims": [16]},
                                          tower_params={"dims": [8]})),
    "star": ("star", dict(fcn_dims=[16, 8], aux_dims=[8])),
    # two levels; with one-layer [8] experts the resumed step of this seed
    # put an expert's relu input within rounding of 0, where the gradient
    # jumps (by 0.0104 in one row) on either side's last-ulp differences
    "ple": ("ple", dict(n_level=2, n_expert_specific=2, n_expert_shared=1,
                        expert_params={"dims": [16, 8]}, tower_params={"dims": [4]})),
}


def _feats(m):
    return ([m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=D) for i in range(3)]
            + [m.SparseFeature("alias", vocab_size=V, embed_dim=D, shared_with="s0")]
            + [m.DenseFeature("d0")])


def _batch(seed, ragged=0):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, B).astype(np.int32) for i in range(3)}
    x["alias"] = r.integers(0, V, B).astype(np.int32)
    x["d0"] = r.normal(size=B).astype(np.float32)
    x["domain_indicator"] = r.integers(0, DOMAINS, B).astype(np.int32)
    y = r.integers(0, 2, B).astype(np.float32)
    w = np.ones(B, np.float32)
    w[B - ragged:] = 0.0
    return x, y, w


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mode(sorted_mode):
    return (dict(sparse_embedding_updates=True, sparse_update_impl="sorted")
            if sorted_mode else {})


def _pair(name, sorted_mode, seed=7):
    """A JAX trainer and a port trainer holding the same weights and state."""
    reg, kw = MODELS[name]
    mode = _mode(sorted_mode)
    jt = JTrainer(jmodels.get_model(reg)(_feats(jf), DOMAINS, **kw), seed=seed,
                  **({**mode, "sorted_block_rows": 64} if sorted_mode else mode))
    pm = pmodels.get_model(reg)(_feats(pf), DOMAINS, device="cpu",
                                generator=make_generator(torch.device("cpu"), 1), **kw)
    pt = PTrainer(pm, device="cpu", **mode)
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


def _assert_same_state(jt, pt, sorted_mode):
    """Every parameter, BN running stat and Adam moment of the two."""
    want = jax_state_dict(_np(jt._params_for_eval()), _np(jt.state),
                          getattr(pt.model, "jax_state_map", ()))
    got = pt.model.state_dict()
    assert sorted(want) == sorted(got)
    for k, v in got.items():
        atol = BN_CANCELLED_ATOL if BN_CANCELLED.search(k) else STEP_ATOL
        np.testing.assert_allclose(v.numpy(), want[k], rtol=STEP_RTOL, atol=atol,
                                   err_msg=k)
    base = jt.opt_state["base"] if sorted_mode else jt.opt_state
    mu = jax_state_dict(_np(base[1].mu))  # (add_decayed_weights, scale_by_adam, scale)
    for name, p in pt._dense_named:
        _close_moments(pt.optimizer.state[p]["exp_avg"].numpy(), mu[name], name)
    if sorted_mode:
        emb = jt.opt_state["emb"]
        vp = pt.model.embedding.packed_vocab
        assert pt.emb_opt_state["step"] == int(emb["step"])
        for k in ("mu", "nu"):
            _close_moments(pt.emb_opt_state[k].numpy(),
                           np.asarray(unpack_rows(emb[k], vp, D)), k)


@pytest.mark.parametrize("sorted_mode", [True, False], ids=["sorted", "dense"])
@pytest.mark.parametrize("name", list(MODELS))
def test_train_steps_match_jax_trainer(name, sorted_mode):
    jt, pt = _pair(name, sorted_mode)
    for step in range(3):
        batch = _batch(10 + step, ragged=3 if step == 2 else 0)
        lj, lp = _jax_step(jt, batch), _port_step(pt, batch)
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL * (1 + 10 * step))
        _assert_same_state(jt, pt, sorted_mode)


@pytest.mark.parametrize("sorted_mode", [True, False], ids=["sorted", "dense"])
@pytest.mark.parametrize("name", list(MODELS))
def test_resume_from_carried_jax_training_state(name, sorted_mode):
    """2 JAX steps, everything carried across, one more step each side."""
    jt, _ = _pair(name, sorted_mode)
    for step in range(2):
        _jax_step(jt, _batch(20 + step))
    _, pt = _pair(name, sorted_mode, seed=8)  # other weights until the load
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    _assert_same_state(jt, pt, sorted_mode)
    batch = _batch(22)
    np.testing.assert_allclose(_port_step(pt, batch), _jax_step(jt, batch), rtol=LOSS_RTOL)
    _assert_same_state(jt, pt, sorted_mode)


def test_fit_runs_fused_validation_for_each_model(tmp_path):
    """``fit`` with the sorted update and fused validation, then
    ``evaluate_multi_domain_loss``: finite metrics, the sorted step count."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset

    def loader(seed, n=70):
        r = np.random.default_rng(seed)
        x = {f"s{i}": r.integers(0, V, n) for i in range(3)}
        x["alias"] = r.integers(0, V, n)
        x["d0"] = r.normal(size=n).astype(np.float32)
        x["domain_indicator"] = np.arange(n) % DOMAINS
        y = (np.arange(n) // DOMAINS % 2).astype(np.float32)
        return BatchIterable(ColumnarDataset(x, y), B)

    for name in MODELS:
        reg, kw = MODELS[name]
        pm = pmodels.get_model(reg)(_feats(pf), DOMAINS, device="cpu", **kw)
        pt = PTrainer(pm, device="cpu", n_epoch=1, model_path=str(tmp_path),
                      fused_inference=True, **_mode(True))
        pt.fit(loader(1), val_dataloader=loader(2))
        assert pt.emb_opt_state["step"] == 5
        ll, auc, tll, tauc = pt.evaluate_multi_domain_loss(pm, loader(3), DOMAINS)
        assert all(np.isfinite(v) for v in ll + auc + [tll, tauc]), name
