"""The port's on-device metrics (``auc_score_device``, ``log_loss_device``)
and ``CTRTrainer.evaluate`` / ``evaluate_multi_domain_loss`` with
``on_device=True``, against the JAX package's and against the port's host
path: ties, quantized scores, masks and saturated probabilities; empty
domains, NaN scores, single-class subsets and unlabeled loaders. Inputs are
made with numpy from a seed; the narrow MMOE's weights are carried across
with ``interop.load_jax_params``. Tolerances: AUC 5e-5 and logloss 5e-6
against the host's float64 scores (the JAX package's own,
tests/test_metrics_trainer_data.py), 1e-6 against the JAX package's float32
device scores."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.data import dataset as jds  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu.train import metrics as jmetrics  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.data import dataset as pds  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.models import MMOE as PMMOE  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.train import metrics as pmetrics  # noqa: E402

AUC_TOL, LL_TOL = 5e-5, 5e-6  # against the host's float64 scores
JAX_TOL = 1e-6                # against the JAX package's float32 ones
DOMAINS, BATCH, N = 3, 64, 300  # 300 = 4 * 64 + 44: a padded last batch
V = 20
KW = dict(n_expert=2, expert_params={"dims": [8]}, tower_params={"dims": [4]})


def _scores(case, n=2000, seed=0):
    """``(y, p, mask or None)`` float32 numpy of one metric case."""
    r = np.random.default_rng(seed)
    y = r.integers(0, 2, n).astype(np.float32)
    p = r.random(n).astype(np.float32) * 0.98 + 0.01
    m = None
    if case in ("ties", "masked_ties"):
        p = (np.round(p, 2) * 0.98 + 0.01).astype(np.float32)  # ~100 levels
    elif case == "three_levels":
        p = np.array([0.2, 0.5, 0.7], np.float32)[r.integers(0, 3, n)]
    elif case == "all_tied":
        p = np.full(n, 0.5, np.float32)
    elif case == "saturated":
        p[:40] = 0.0
        p[40:80] = 1.0
    if case.startswith("masked"):
        m = r.integers(0, 2, n).astype(bool)
        y[np.flatnonzero(m)[:2]] = [0, 1]  # both classes in the subset
    return y, p, m


CASES = ["random", "ties", "three_levels", "all_tied", "masked", "masked_ties", "saturated"]


@pytest.mark.parametrize("case", CASES)
def test_auc_device_matches_jax_and_host(case):
    y, p, m = _scores(case)
    got = float(pmetrics.auc_score_device(torch.from_numpy(y), torch.from_numpy(p),
                                          None if m is None else torch.from_numpy(m)))
    jax_dev = float(jmetrics.auc_score_device(jnp.asarray(y), jnp.asarray(p),
                                              None if m is None else jnp.asarray(m)))
    sel = slice(None) if m is None else m
    host = pmetrics.auc_score(y[sel], p[sel])
    assert abs(got - jax_dev) <= JAX_TOL, (got, jax_dev)
    assert abs(got - host) <= AUC_TOL, (got, host)
    if case == "all_tied":
        assert got == 0.5


@pytest.mark.parametrize("case", CASES)
def test_log_loss_device_matches_jax_and_host(case):
    """Within 5e-6 of the host's. Where a probability saturates the device
    clips at float32's 1e-7 (16.1 an entry) and the host at 1e-15 (34.5):
    there the host scores the probabilities clipped as the device clips."""
    y, p, m = _scores(case)
    got = float(pmetrics.log_loss_device(torch.from_numpy(y), torch.from_numpy(p),
                                         None if m is None else torch.from_numpy(m)))
    jax_dev = float(jmetrics.log_loss_device(jnp.asarray(y), jnp.asarray(p),
                                             None if m is None else jnp.asarray(m)))
    assert abs(got - jax_dev) <= JAX_TOL * abs(jax_dev), (got, jax_dev)
    sel = slice(None) if m is None else m
    host = pmetrics.log_loss_score(y[sel], p[sel])
    if case == "saturated":
        # the host's score of the probabilities clipped as float32 clips them
        lo, hi = np.float32(1e-7), np.float32(1 - 1e-7)
        assert got < host
        host = pmetrics.log_loss_score(y[sel], np.clip(p[sel], lo, hi))
    assert abs(got - host) <= LL_TOL, (got, host)


# -- the trainer --------------------------------------------------------------

def _feats(m):
    return [m.SparseFeature("s0", vocab_size=V, embed_dim=8),
            m.SparseFeature("s1", vocab_size=V, embed_dim=8), m.DenseFeature("d0")]


def _data(seed=0, n=N, domains=DOMAINS):
    r = np.random.default_rng(seed)
    x = {"s0": r.integers(0, V, n), "s1": r.integers(0, V, n).astype(np.int32),
         "d0": r.normal(size=n).astype(np.float32),
         "domain_indicator": r.integers(0, domains, n)}
    y = r.integers(0, 2, n).astype(np.float32)
    y[:2 * domains] = np.repeat([0, 1], domains)  # both classes in each domain
    x["domain_indicator"][:2 * domains] = np.tile(np.arange(domains), 2)
    return x, y


def _loaders(x, y):
    return (jds.BatchIterable(jds.ColumnarDataset(x, y), BATCH),
            pds.BatchIterable(pds.ColumnarDataset(x, y), BATCH))


def _trainers(fused=False, **kw):
    """A JAX trainer and a port trainer holding the same weights."""
    jt = JTrainer(JMMOE(_feats(jf), DOMAINS, **KW), seed=3, fused_inference=fused)
    pm = PMMOE(_feats(pf), DOMAINS, device="cpu",
               generator=make_generator(torch.device("cpu"), 0), **KW)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_jax_params(pm, np_tree(jt.params), np_tree(jt.state))
    return jt, PTrainer(pm, device="cpu", fused_inference=fused, **kw)


def _close(a, b, tol):
    if a is None or b is None:
        assert a is None and b is None
    else:
        assert abs(a - b) <= tol, (a, b)


def _multi_close(got, want, tol_auc, tol_ll):
    lls, aucs, tll, tauc = got
    wlls, waucs, wtll, wtauc = want
    for a, b in zip(lls + [tll], wlls + [wtll]):
        _close(a, b, tol_ll)
    for a, b in zip(aucs + [tauc], waucs + [wtauc]):
        _close(a, b, tol_auc)


@pytest.mark.parametrize("fused", [False, True], ids=["op_by_op", "fused"])
def test_trainer_on_device_matches_host_and_jax(fused):
    jt, pt = _trainers(fused)
    jl, pl = _loaders(*_data())
    host, dev = pt.evaluate(pt.model, pl), pt.evaluate(pt.model, pl, on_device=True)
    jdev = jt.evaluate(jt.model, jl, on_device=True)
    _close(dev[0], host[0], AUC_TOL)
    _close(dev[1], host[1], LL_TOL)
    _close(dev[0], jdev[0], AUC_TOL)
    _close(dev[1], jdev[1], LL_TOL)
    host_m = pt.evaluate_multi_domain_loss(pt.model, pl, DOMAINS)
    dev_m = pt.evaluate_multi_domain_loss(pt.model, pl, DOMAINS, on_device=True)
    jdev_m = jt.evaluate_multi_domain_loss(jt.model, jl, DOMAINS, on_device=True)
    _multi_close(dev_m, host_m, AUC_TOL, LL_TOL)
    _multi_close(dev_m, jdev_m, AUC_TOL, LL_TOL)
    assert dev_m[3] == dev[0] and dev_m[2] == dev[1]


def test_on_device_eval_reads_the_bf16_store():
    """After a step of the bf16 sorted mode the model's f32 table is stale
    until synced from the store: the on-device pass scores what the host
    pass scores."""
    _, pt = _trainers(True, sparse_embedding_updates=True, sparse_update_impl="sorted",
                      sorted_dtype="bf16")
    x, y = _data()
    _, pl = _loaders(x, y)
    batch = next(iter(pl))
    before = pt.model.embedding.packed.detach().clone()
    pt._train_step(*pt._device_batch(*batch))
    assert torch.equal(pt.model.embedding.packed.detach(), before)  # not synced yet
    dev = pt.evaluate_multi_domain_loss(pt.model, pl, DOMAINS, on_device=True)
    assert not torch.equal(pt.model.embedding.packed.detach(), before)
    _multi_close(dev, pt.evaluate_multi_domain_loss(pt.model, pl, DOMAINS), AUC_TOL, LL_TOL)


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "device"])
def test_empty_domain_gives_none(on_device):
    _, pt = _trainers()
    _, pl = _loaders(*_data(domains=2))
    lls, aucs, tll, tauc = pt.evaluate_multi_domain_loss(pt.model, pl, DOMAINS,
                                                         on_device=on_device)
    assert lls[2] is None and aucs[2] is None
    assert all(v is not None for v in lls[:2] + aucs[:2] + [tll, tauc])


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("multi", [False, True], ids=["evaluate", "multi_domain"])
def test_nan_score_raises(on_device, multi):
    """A NaN in one row's dense feature makes that row's score NaN: both
    paths raise, as sklearn does."""
    _, pt = _trainers()
    x, y = _data()
    x["d0"][7] = np.nan
    _, pl = _loaders(x, y)
    with pytest.raises(ValueError, match="NaN"):
        if multi:
            pt.evaluate_multi_domain_loss(pt.model, pl, DOMAINS, on_device=on_device)
        else:
            pt.evaluate(pt.model, pl, on_device=on_device)


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("where", ["domain", "total"])
def test_single_class_subset_raises(on_device, where):
    _, pt = _trainers()
    x, y = _data()
    if where == "domain":
        y[x["domain_indicator"] == 1] = 1.0
    else:
        y[:] = 0.0
    _, pl = _loaders(x, y)
    with pytest.raises(ValueError, match="Only one class"):
        pt.evaluate_multi_domain_loss(pt.model, pl, DOMAINS, on_device=on_device)
    if where == "total":
        with pytest.raises(ValueError, match="Only one class"):
            pt.evaluate(pt.model, pl, on_device=on_device)


def test_unlabeled_loader_raises_on_device():
    _, pt = _trainers()
    x, _ = _data()
    loader = pds.PredictIterable(x, BATCH)
    assert len(pt.predict(pt.model, loader)) == N  # the host path serves it
    with pytest.raises(ValueError, match="labeled batches"):
        pt.evaluate(pt.model, loader, on_device=True)
