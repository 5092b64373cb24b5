"""HamurLarge, HamurSmall, MlpNLayer and AdaptDHM train steps in the port
against the JAX package's ``CTRTrainer._train_step``: 3 steps (the last on a
ragged batch) and a resume from carried JAX training state
(``load_jax_trainer_state``); ``fit`` with fused validation, and a
checkpoint that carries AdaptDHM's centers and HAMUR's running stats. HAMUR
and AdaptDHM run the sorted and the plain dense step; MlpN has no
``embedding`` attribute, so with ``sparse_embedding_updates=True`` both
trainers run the plain dense step. The models are narrow (vocab 30, D 8);
inputs come from numpy."""

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
# A parameter whose every effect a train-mode batch norm subtracts again has
# an exactly zero gradient, whose f32 rounding noise Adam turns into steps of
# about +-lr: a Linear bias before a BatchNorm and the running mean that
# follows it, the adapter's up-projection bias before its batch norm, and
# the norm's beta where a block (Linear, train-mode BatchNorm) follows the
# adapter. They are held to 10 x lr.
BN_CANCELLED = re.compile(r"(blocks|hyper)\.\d+\.(lin\.b|bn\.mean)$|adapters\.\d+\.b_up$")
BN_CANCELLED_ATOL = 1e-2
# Adam's first moments: 1e-5 x the tensor's largest element besides
# STEP_ATOL (the reason in tests/test_torch_port_train_models.py).
MOMENT_SCALE_ATOL = 1e-5


def _cancelled(model, key):
    if BN_CANCELLED.search(key):
        return True
    m = re.fullmatch(r"adapters\.(\d+)\.beta", key)
    return bool(m) and model.adapter_after[int(m.group(1))] < len(model.blocks)


def _kw(m, i, name):
    """Constructor arguments per model, narrow, for the JAX package's or the
    port's ``features`` module ``m`` and ``init`` module ``i``. The tables
    start from N(0, 0.5): at the default N(0, 1e-4) a train-mode BatchNorm
    right after the embedding divides row differences of 1e-4 by sqrt(eps)
    and the two frameworks' rounding reaches the gradients."""
    t = dict(embed_dim=D, initializer=i.random_normal(0.0, 0.5))
    sparse = ([m.SparseFeature(f"s{k}", vocab_size=V, **t) for k in range(3)]
              + [m.SparseFeature("alias", vocab_size=V, embed_dim=D, shared_with="s0")])
    dense = [m.DenseFeature("d0")]
    sce = [m.SparseFeature("domain_indicator", vocab_size=DOMAINS, **t)]
    return {
        "large": dict(features=sparse + dense, domain_num=DOMAINS,
                      fcn_dims=[16, 16, 12, 12, 8, 8, 6], hyper_dims=[8], k=4),
        "small": dict(features=sparse + dense, domain_num=DOMAINS, fcn_dims=[16, 8],
                      hyper_dims=[8], k=5),
        "mlpn": dict(features=sparse + dense, domain_num=DOMAINS, fcn_dims=[16, 8]),
        "adaptdhm": dict(features=sparse + sce, fcn_dims=[16, 8], cluster_num=3, beta=0.9),
    }[name]


CLASSES = {"large": "HamurLarge", "small": "HamurSmall", "mlpn": "MlpNLayer",
           "adaptdhm": "AdaptDHM"}
# (model, sparse_embedding_updates): MlpN runs the dense step either way
CASES = [("large", True), ("large", False), ("small", True), ("mlpn", True),
         ("adaptdhm", True), ("adaptdhm", False)]
IDS = [f"{m}-{'flag' if s else 'dense'}" for m, s in CASES]


def _batch(seed, ragged=0, n=B):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, n).astype(np.int32) for i in range(3)}
    x["alias"] = r.integers(0, V, n).astype(np.int32)
    x["d0"] = r.normal(size=n).astype(np.float32)
    x["domain_indicator"] = r.integers(0, DOMAINS, n).astype(np.int32)
    y = r.integers(0, 2, n).astype(np.float32)
    w = np.ones(n, np.float32)
    w[n - ragged:] = 0.0
    return x, y, w


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mode(flag):
    return dict(sparse_embedding_updates=True, sparse_update_impl="sorted") if flag else {}


def _randomize_adapters(jt, seed):
    """The adapters' u/v from 0.3 N(0, 1) instead of ones (at ones the
    sigmoid saturates and the norm divides near-zero variances, the JAX
    package's tests say): the optax moments are zeros before the first
    step, so the trainer state stays consistent."""
    if "adapters" not in jt.params:
        return
    r = np.random.default_rng(seed)
    jt.params = {**jt.params, "adapters": [
        {n: (jnp.asarray(0.3 * r.normal(size=v.shape), jnp.float32) if n[0] in "uv" else v)
         for n, v in a.items()} for a in jt.params["adapters"]]}


def _pair(name, flag, seed=7):
    """A JAX trainer and a port trainer holding the same weights and state."""
    jt = JTrainer(getattr(jmodels, CLASSES[name])(**_kw(jf, jinit, name)), seed=seed,
                  **({**_mode(flag), "sorted_block_rows": 64} if flag else {}))
    _randomize_adapters(jt, seed)
    pm = getattr(pmodels, CLASSES[name])(**_kw(pf, pinit, name), device="cpu",
                                         generator=make_generator(torch.device("cpu"), 1))
    pt = PTrainer(pm, device="cpu", **_mode(flag))
    assert pt._sorted_mode == jt._sparse_emb == (flag and name != "mlpn")
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
    """Every parameter, buffer (the running stats, the hyper-network's D-fold
    ones, AdaptDHM's centers) and Adam moment of the two."""
    want = jax_state_dict(_np(jt._params_for_eval()), _np(jt.state),
                          getattr(pt.model, "jax_state_map", ()))
    got = pt.model.state_dict()
    assert sorted(want) == sorted(got)
    for k, v in got.items():
        atol = BN_CANCELLED_ATOL if _cancelled(pt.model, k) else STEP_ATOL
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
    """2 JAX steps, everything carried across (running stats and centers
    too), one more step each side."""
    jt, _ = _pair(name, flag)
    for step in range(2):
        _jax_step(jt, _batch(20 + step))
    _, pt = _pair(name, flag, seed=8)  # other weights until the load
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    _assert_same_state(jt, pt)
    batch = _batch(22)
    np.testing.assert_allclose(_port_step(pt, batch), _jax_step(jt, batch), rtol=LOSS_RTOL)
    _assert_same_state(jt, pt)


def test_adaptdhm_unused_biases_and_mlpn_hyper_take_weight_decay_steps():
    """AdaptDHM's biases and MlpN's hyper-network never reach the loss: no
    gradient in torch, zero in JAX. The optax chain still steps them (weight
    decay into Adam), and so does the port's trainer: 3 steps, equal to
    JAX's and every nonzero element moved, by at most lr a step (weight
    decay leaves a zero where it is)."""
    for name, prefix in (("adaptdhm", "b."), ("mlpn", "hyper.")):
        jt, pt = _pair(name, name == "adaptdhm")
        before = {n: p.detach().clone() for n, p in pt._dense_named if n.startswith(prefix)}
        assert before
        for step in range(3):
            batch = _batch(30 + step)
            _jax_step(jt, batch), _port_step(pt, batch)
        _assert_same_state(jt, pt)
        params = dict(pt.model.named_parameters())
        for n, b in before.items():
            moved = (params[n].detach() - b).abs()
            assert bool((moved[b != 0] > 0).all()) and bool((moved[b == 0] == 0).all()), n
            assert moved.max().item() <= 3 * LR, n
            assert float(pt.optimizer.state[params[n]]["step"]) == 3.0
        assert any(bool((b != 0).any()) for b in before.values())


def _loader(seed, n=70):
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset

    x, y, _ = _batch(seed, n=n)
    x["domain_indicator"] = np.arange(n) % DOMAINS
    y = (np.arange(n) // DOMAINS % 2).astype(np.float32)
    return BatchIterable(ColumnarDataset(x, y), B)


@pytest.mark.parametrize("name", ["large", "small", "mlpn", "adaptdhm"])
def test_fit_runs_fused_validation(name, tmp_path):
    """``fit`` with ``sparse_embedding_updates=True`` and fused validation,
    then ``evaluate_multi_domain_loss``: finite metrics; the sorted steps
    counted (none for MlpN, which takes the dense step and serves op by
    op); the segment kernel's plain version runs 3 (HamurLarge) or 2
    (HamurSmall) segments a batch; the checkpoint carries every buffer."""
    from scenario_wise_rec_tpu_torch.ops.kernels import hamur_infer

    pm = getattr(pmodels, CLASSES[name])(**_kw(pf, pinit, name), device="cpu")
    pt = PTrainer(pm, device="cpu", n_epoch=1, model_path=str(tmp_path),
                  fused_inference=True, **_mode(True))
    calls = []
    segment = hamur_infer.hamur_segment_ref
    hamur_infer.hamur_segment_ref = lambda *a, **k: calls.append(1) or segment(*a, **k)
    try:
        path = pt.fit(_loader(1), val_dataloader=_loader(2))
    finally:
        hamur_infer.hamur_segment_ref = segment
    per_batch = {"large": 3, "small": 2}.get(name, 0)
    assert len(calls) == per_batch * 5  # 5 validation batches
    if name == "mlpn":
        assert pt.emb_opt_state is None and not pt._sorted_mode and not pt._fused_inference
        assert float(pt.optimizer.state[pm._modules["embedding"].packed]["step"]) == 5.0
    else:
        assert pt.emb_opt_state["step"] == 5 and pt._fused_inference
    ll, auc, tll, tauc = pt.evaluate_multi_domain_loss(pm, _loader(3), DOMAINS)
    assert all(np.isfinite(v) for v in ll + auc + [tll, tauc]), name

    fresh = getattr(pmodels, CLASSES[name])(**_kw(pf, pinit, name), device="cpu",
                                            generator=make_generator(torch.device("cpu"), 9))
    pt2 = PTrainer(fresh, device="cpu", **_mode(True))
    pt2.load(path)
    want = dict(pm.state_dict())
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    bufs = [k for k, _ in fresh.named_buffers()]
    assert ("center" in bufs) == (name == "adaptdhm")
    assert any(k.startswith("hyper") for k in bufs) == (name != "adaptdhm")
