"""M2M and M3oE train steps in the port against the JAX package's
``CTRTrainer._train_step``: 3 steps (the last on a ragged batch) and a
resume from carried JAX training state (``load_jax_trainer_state``), each
in the sorted and the plain dense step; M2M's transformer dropout at 0,
because the two frameworks draw different bits. Beside them: M2M's domain
rows take the sum of both lookups' gradients, M3oE's unused ``w_exp_t``/
``w_bal_t`` take their weight-decay steps, M3oE's gates read a detached
input, and ``fit`` with fused validation and a checkpoint. The models are
narrow (vocab 30, D 8); inputs come from numpy."""

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
from scenario_wise_rec_tpu.train.loss import bce_loss as jbce  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core import init as pinit  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import (  # noqa: E402
    jax_state_dict, load_jax_trainer_state)
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.train.loss import bce_loss as pbce  # noqa: E402

V, D, DOMAINS, B = 30, 8, 2, 16
LR = 1e-3
# The tolerances of tests/test_torch_port_train.py (MMOE), for the same
# reasons: torch and XLA sum in other orders, and Adam divides by sqrt(nu).
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-6
# A Linear bias before a train-mode BatchNorm, and the running mean after
# it, has an exactly zero gradient whose f32 rounding noise Adam turns into
# steps of about +-lr (M2M's hyper-MLPs, experts and output MLP): held to
# 10 x lr, as in the other models' train tests. So is the key bias of every
# attention (the middle third of ``in_b``): it adds ``q·b_k`` to all of a
# query's scores alike, which the softmax cancels.
BN_CANCELLED_ATOL = 1e-2
# Adam's first moments: 1e-5 x the tensor's largest element besides
# STEP_ATOL (the reason in tests/test_torch_port_train_models.py).
MOMENT_SCALE_ATOL = 1e-5
# A gradient element that is a sum of terms cancelling to near nothing (a
# relu unit dead for most of the batch; M2M's transformer mixes every row
# into every gradient) carries the sums' rounding as a large relative gap,
# and Adam, which divides by its own magnitude, maps that into a step gap
# of up to ~lr. An element whose first moments differ by more than
# NOISY_MOMENT of the JAX moment is held to BN_CANCELLED_ATOL from that step
# on (its moment is still held to the moment tolerance above), and such
# elements may be at most NOISY_SHARE of a model's dense parameters (about
# 2 % of the narrow M2M's after 3 steps, 0.3 % of M3oE's).
NOISY_MOMENT, NOISY_SHARE = 1e-3, 0.03
# One backward's gradients against jax.grad's, per parameter: 1e-5 of the
# tensor's largest element besides a few ulp.
GRAD_RTOL, GRAD_SCALE_ATOL = 1e-5, 1e-5


def _kw(m, i, name):
    """Constructor arguments, narrow, for the JAX package's or the port's
    ``features`` module ``m`` and ``init`` module ``i``. The tables start
    from N(0, 0.5): at the default N(0, 1e-4) a train-mode BatchNorm right
    after a lookup divides row differences of 1e-4 by sqrt(eps) and the two
    frameworks' rounding reaches the gradients."""
    t = dict(embed_dim=D, initializer=i.random_normal(0.0, 0.5))
    sparse = ([m.SparseFeature(f"s{k}", vocab_size=V, **t) for k in range(3)]
              + [m.SparseFeature("alias", vocab_size=V, embed_dim=D, shared_with="s0")])
    sce = [m.SparseFeature("domain_indicator", vocab_size=DOMAINS, **t)]
    if name == "m2m":
        return dict(features=sparse + sce, domain_feature=sce, domain_num=DOMAINS,
                    num_experts=4, expert_output_size=4,
                    transformer_dims={"num_encoder_layers": 2, "num_decoder_layers": 2,
                                      "dim_feedforward": 16, "dropout": 0.0})
    return dict(features=sparse + [m.DenseFeature("d0")], domain_num=DOMAINS,
                fcn_dims=[24, 16, 16, 8], expert_num=2, exp_d=0.2, exp_t=0.3, bal_d=0.5,
                bal_t=0.4)


CLASSES = {"m2m": "M2M", "m3oe": "M3oE"}
CASES = [("m2m", True), ("m2m", False), ("m3oe", True), ("m3oe", False)]
IDS = [f"{m}-{'sorted' if s else 'dense'}" for m, s in CASES]


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


def _pair(name, flag, seed=7):
    """A JAX trainer and a port trainer holding the same weights and state."""
    jt = JTrainer(getattr(jmodels, CLASSES[name])(**_kw(jf, jinit, name)), seed=seed,
                  **({**_mode(flag), "sorted_block_rows": 64} if flag else {}))
    pm = getattr(pmodels, CLASSES[name])(**_kw(pf, pinit, name), device="cpu",
                                         generator=make_generator(torch.device("cpu"), 1))
    pt = PTrainer(pm, device="cpu", **_mode(flag))
    assert pt._sorted_mode == jt._sparse_emb == flag
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


def _cancelled(key):
    """A Linear bias or the running mean around a train-mode BatchNorm, or
    the transformer's last LayerNorm beta (a per-column constant before
    the experts' BatchNorm)."""
    return key.endswith(("layers.0.lin.b", "layers.1.lin.b", "bn.mean", "dec_norm.beta"))


def _assert_same_state(jt, pt, noisy):
    """Every parameter, running stat and Adam moment of the two. ``noisy``:
    ``{name: bool mask}`` of the noise-dominated elements, updated here."""
    want = jax_state_dict(_np(jt._params_for_eval()), _np(jt.state))
    got = pt.model.state_dict()
    assert sorted(want) == sorted(got)
    base = jt.opt_state["base"] if pt._sorted_mode else jt.opt_state
    mu = jax_state_dict(_np(base[1].mu))  # (add_decayed_weights, scale_by_adam, scale)
    for name, p in pt._dense_named:
        m = pt.optimizer.state[p]["exp_avg"].numpy()
        _close_moments(m, mu[name], name)
        gap = np.abs(m - mu[name]) > NOISY_MOMENT * np.abs(mu[name])
        noisy[name] = noisy.get(name, np.zeros(m.shape, bool)) | gap
        if name.endswith("attn.in_b"):  # the key bias: noise alone
            noisy[name][m.shape[0] // 3:2 * m.shape[0] // 3] = True
    n_noisy = sum(int(v.sum()) for v in noisy.values())
    assert n_noisy <= NOISY_SHARE * sum(p.numel() for _, p in pt._dense_named), n_noisy
    for k, v in got.items():
        g = v.numpy()
        atol = np.where(noisy.get(k, False), BN_CANCELLED_ATOL,
                        BN_CANCELLED_ATOL if _cancelled(k) else STEP_ATOL)
        bad = np.abs(g - want[k]) > atol + STEP_RTOL * np.abs(want[k])
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(g - want[k]).max()))
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
    noisy = {}
    for step in range(3):
        batch = _batch(10 + step, ragged=3 if step == 2 else 0)
        lj, lp = _jax_step(jt, batch), _port_step(pt, batch)
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL * (1 + 10 * step))
        _assert_same_state(jt, pt, noisy)


@pytest.mark.parametrize("name,flag", CASES, ids=IDS)
def test_resume_from_carried_jax_training_state(name, flag):
    """2 JAX steps, everything carried across, one more step each side."""
    jt, _ = _pair(name, flag)
    for step in range(2):
        _jax_step(jt, _batch(20 + step))
    _, pt = _pair(name, flag, seed=8)  # other weights until the load
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    noisy = {}
    _assert_same_state(jt, pt, noisy)
    batch = _batch(22)
    np.testing.assert_allclose(_port_step(pt, batch), _jax_step(jt, batch), rtol=LOSS_RTOL)
    _assert_same_state(jt, pt, noisy)


def _domain_row_grads(pt, batch, detach=None):
    """The sorted step's gradient of the gathered rows (one backward), with
    the domain lookup's output (``"domain"``) or the features lookup's
    (``"features"``) detached; the running stats are left as they were."""
    model = pt.model
    stats = {k: b.clone() for k, b in model.named_buffers()}
    col = model.embedding
    x, y, w = pt._device_batch(*batch)
    rows = col.packed.detach()[col.touched_ids(x)].requires_grad_()
    forward = col.forward

    def lookup(x_, features, squeeze_dim=False, rows=None):
        out = forward(x_, features, squeeze_dim, rows)
        which = "domain" if tuple(features) == model.domain_feature else "features"
        return out.detach() if which == detach else out

    col.forward = lookup
    try:
        pbce(model.apply(x, train=True, w=w, generator=pt.generator, rows=rows), y, w).backward()
    finally:
        del col.forward
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(stats[k])
    start, size = [(s, n) for o, s, n in col.touched_owner_segments(x)
                   if o == "domain_indicator"][0]
    return rows.grad[start:start + size]


def test_m2m_domain_rows_take_both_lookups_gradients():
    """The domain feature is in ``features`` and ``domain_feature``: in the
    sorted step both lookups slice the same segment of the gathered rows, so
    its gradient is the sum of the two lookups' (each nonzero), and the
    domain rows of the table after a step equal the JAX trainer's."""
    jt, pt = _pair("m2m", True)
    batch = _batch(40)
    full = _domain_row_grads(pt, batch)
    via_domain = _domain_row_grads(pt, batch, detach="features")
    via_features = _domain_row_grads(pt, batch, detach="domain")
    assert via_domain.abs().max() > 1e-6 and via_features.abs().max() > 1e-6
    torch.testing.assert_close(full, via_domain + via_features, rtol=1e-5, atol=1e-7)
    off = pt.model.embedding.offsets["domain_indicator"]
    domain_rows = lambda: pt.model.embedding.packed.detach()[off:off + DOMAINS].numpy().copy()
    before = domain_rows()
    _jax_step(jt, batch), _port_step(pt, batch)
    want = jax_state_dict(_np(jt._params_for_eval()))["embedding.packed"][off:off + DOMAINS]
    np.testing.assert_allclose(domain_rows(), want, rtol=STEP_RTOL, atol=STEP_ATOL)
    assert np.abs(domain_rows() - before).min() > 0  # every domain row took a step
    _assert_same_state(jt, pt, {})


def test_m3oe_unused_scalars_take_weight_decay_steps():
    """``w_exp_t`` and ``w_bal_t`` never reach the loss: no gradient in
    torch, zero in JAX. Both optimizers still step them by weight decay: 3
    steps, equal to JAX's, each moved by at most lr a step."""
    jt, pt = _pair("m3oe", True)
    params = dict(pt.model.named_parameters())
    before = {n: params[n].detach().clone() for n in ("w_exp_t", "w_bal_t")}
    for step in range(3):
        batch = _batch(30 + step)
        _jax_step(jt, batch), _port_step(pt, batch)
    _assert_same_state(jt, pt, {})
    for n, b in before.items():
        moved = (params[n].detach() - b).abs()
        assert bool((moved > 0).all()) and moved.max().item() <= 3 * LR, n
        assert float(pt.optimizer.state[params[n]]["step"]) == 3.0


def test_m3oe_gates_read_a_detached_input(monkeypatch):
    """One backward of the port against ``jax.grad`` of the JAX model, every
    parameter; with the JAX model's stop_gradient taken out, the
    parameters before the gates get other gradients, which the port does
    not follow."""
    jt, pt = _pair("m3oe", False)
    x, y, w = _batch(50)
    xt, yt, wt = pt._device_batch(x, y, w)
    pt.model.zero_grad()
    pbce(pt.model.apply(xt, train=True, w=wt), yt, wt).backward()
    got = {n: p.grad for n, p in pt.model.named_parameters()}
    jm = jt.model
    xj = {k: jnp.asarray(v) for k, v in x.items()}

    def jax_grads():
        loss = lambda p: jbce(jm.apply(p, {}, xj, train=True)[0], jnp.asarray(y), jnp.asarray(w))
        return jax_state_dict(_np(jax.grad(loss)(jt.params)))

    def close(want, names):
        for n in names:
            g = got[n].numpy() if got[n] is not None else np.zeros_like(want[n])
            atol = 1e-7 + GRAD_SCALE_ATOL * float(np.abs(want[n]).max(initial=0.0))
            np.testing.assert_allclose(g, want[n], rtol=GRAD_RTOL, atol=atol, err_msg=n)

    want = jax_grads()
    assert sorted(want) == sorted(got)
    close(want, sorted(got))
    assert got["w_exp_t"] is None and got["w_bal_t"] is None
    upstream = [n for n in got if n.startswith(("skip.", "star_mlp.", "slot_", "shared_"))]
    monkeypatch.setattr(jax.lax, "stop_gradient", lambda a: a)
    undetached = jax_grads()
    with pytest.raises(AssertionError):
        close(undetached, upstream)
    gates = [n for n in got if n.startswith("gates.")]
    close(undetached, gates)  # the gates' own gradients do not depend on it


def _loader(seed, n=70):
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset

    x, y, _ = _batch(seed, n=n)
    x["domain_indicator"] = np.arange(n) % DOMAINS
    y = (np.arange(n) // DOMAINS % 2).astype(np.float32)
    return BatchIterable(ColumnarDataset(x, y), B)


@pytest.mark.parametrize("name", ["m2m", "m3oe"])
def test_fit_runs_fused_validation(name, tmp_path):
    """``fit`` with the sorted update and fused validation, then
    ``evaluate_multi_domain_loss``: finite metrics, 5 sorted steps, the
    fused kernel's plain version once per eval batch (5 validation
    batches), and a checkpoint that restores every parameter and buffer."""
    from scenario_wise_rec_tpu_torch.ops.kernels import m2m_infer, m3oe_infer

    mod = {"m2m": m2m_infer, "m3oe": m3oe_infer}[name]
    ref_name = f"{name}_fused_infer_ref"
    pm = getattr(pmodels, CLASSES[name])(**_kw(pf, pinit, name), device="cpu")
    pt = PTrainer(pm, device="cpu", n_epoch=1, model_path=str(tmp_path), fused_inference=True,
                  **_mode(True))
    calls = []
    ref = getattr(mod, ref_name)
    monkey = lambda *a, **k: calls.append(1) or ref(*a, **k)
    setattr(mod, ref_name, monkey)
    try:
        path = pt.fit(_loader(1), val_dataloader=_loader(2))
    finally:
        setattr(mod, ref_name, ref)
    assert len(calls) == 5 and pt.emb_opt_state["step"] == 5 and pt._fused_inference
    ll, auc, tll, tauc = pt.evaluate_multi_domain_loss(pm, _loader(3), DOMAINS)
    assert all(np.isfinite(v) for v in ll + auc + [tll, tauc]), name
    fresh = getattr(pmodels, CLASSES[name])(**_kw(pf, pinit, name), device="cpu",
                                            generator=make_generator(torch.device("cpu"), 9))
    pt2 = PTrainer(fresh, device="cpu", **_mode(True))
    pt2.load(path)
    want = dict(pm.state_dict())
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
