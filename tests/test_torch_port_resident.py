"""Device-resident epochs of the port (``data/device.py``,
``CTRTrainer.train_one_epoch_resident``) against the JAX package's and
against the port's own host pipeline: the permutation stream, the padding
and weights, ``gather_batch``, the trained state in every embedding-update
mode (JAX ``scan_steps`` 1 and 3), ``fit``, ``device_shuffle``,
``resident_gather``, the deferred last loss and the device rules. Inputs are
made with numpy from a seed; MMOE is narrow with dropout 0 and its state is
carried across with ``interop.load_jax_trainer_state``."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.data import dataset as jds  # noqa: E402
from scenario_wise_rec_tpu.data.device import DeviceResidentLoader as JLoader  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset  # noqa: E402
from scenario_wise_rec_tpu_torch.data import DeviceResidentLoader as PLoader  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_trainer_state  # noqa: E402
from scenario_wise_rec_tpu_torch.models import MMOE as PMMOE  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402

import test_torch_port_sorted_bf16 as bf16_tests  # noqa: E402
import test_torch_port_train_modes as mode_tests  # noqa: E402
from test_torch_port_train import B, DOMAINS, KW, STEP_ATOL, V, _np  # noqa: E402

CPU = dict(device="cpu")
N = 3 * B + 5  # four batches, the last padded with 11 weight-0 rows
MODE_KW = {"plain": {},
           "sorted": dict(sparse_embedding_updates=True, sparse_update_impl="sorted"),
           "sorted_bf16": bf16_tests.BF16,
           "occurrence": dict(sparse_embedding_updates=True, sparse_update_impl="occurrence"),
           "dense": dict(sparse_embedding_updates=True, sparse_update_impl="dense"),
           "winner": dict(sparse_embedding_updates=True, sparse_update_impl="winner")}


def _columns(n, seed=3, vocab=V, int_dtype=np.int64):
    """The narrow MMOE's columns: three sparse ids, an alias, a sequence
    column [n, 4], a dense column, the domain indicator and labels."""
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, vocab, n).astype(int_dtype) for i in range(3)}
    x["alias"] = r.integers(0, vocab, n).astype(int_dtype)
    x["seq"] = r.integers(0, vocab, (n, 4)).astype(int_dtype)
    x["s1"][:4] = 7  # a row with duplicates (seq shares s1's table)
    x["d0"] = r.normal(size=n).astype(np.float32)
    x["domain_indicator"] = r.integers(0, DOMAINS, n).astype(int_dtype)
    return x, r.integers(0, 2, n).astype(np.float32)


def _datasets(n=N, seed=3, vocab=V, int_dtype=np.int64):
    x, y = _columns(n, seed, vocab, int_dtype)
    return jds.ColumnarDataset(x, y), ColumnarDataset(x, y)


def _port_trainer(mode="sorted", **kw):
    """A narrow port MMOE trainer on the CPU (test_torch_port_train.py's
    features, or the bf16 test's wider vocab for the bf16 store)."""
    feats = bf16_tests._feats(pf) if mode == "sorted_bf16" else mode_tests._feats(pf)
    model = PMMOE(feats, DOMAINS, generator=make_generator(torch.device("cpu"), 1),
                  **CPU, **KW)
    return PTrainer(model, **CPU, **MODE_KW[mode], **kw)


def _twins(mode, **kw):
    """Two port trainers holding the same state (each builds its update's
    state from the same weights)."""
    a = _port_trainer(mode)
    return a, PTrainer(copy.deepcopy(a.model), **CPU, **MODE_KW[mode], **kw)


def _state(t):
    """Every tensor of a trainer's state by name: the model's, the dense
    optimizer's moments and the embedding update's."""
    out = dict(t.model.state_dict())
    for name, p in t._dense_named:
        for k, v in t.optimizer.state.get(p, {}).items():
            out[f"opt/{name}/{k}"] = v
    for k, v in (t.emb_opt_state or {}).items():
        out[f"emb/{k}"] = v
    return out


def _assert_same_trainers(a, b):
    sa, sb = _state(a), _state(b)
    assert sorted(sa) == sorted(sb)
    for k, v in sa.items():
        if torch.is_tensor(v):
            assert torch.equal(v, sb[k]), k
        else:
            assert v == sb[k], k


# -- the loader ----------------------------------------------------------------

@pytest.mark.parametrize("n,shuffle", [(N, True), (4 * B, True), (N, False)],
                         ids=["padded", "exact", "unshuffled"])
def test_epoch_perm_matches_jax_and_batchiterable(n, shuffle):
    """Two epochs: the port's ids and weights equal the JAX loader's, and
    each of its batches equals the port's BatchIterable's, the padded last
    batch and the sequence column included."""
    jds_, pds_ = _datasets(n)
    host = BatchIterable(pds_, B, shuffle=shuffle, seed=5)
    res = PLoader(pds_, B, seed=5, shuffle=shuffle, **CPU)
    jres = JLoader(jds_, B, seed=5, shuffle=shuffle)
    assert len(host) == len(res) == len(jres) == -(-n // B)
    assert res.layout == jres.layout
    for _ in range(2):
        perm, w = res.epoch_perm()
        jperm, jw = jres.epoch_perm()
        assert perm.dtype == np.int32
        np.testing.assert_array_equal(perm, jperm)
        np.testing.assert_array_equal(w, jw)
        for bi, (xb, yb, wb) in enumerate(host):
            sel = perm[bi * B:(bi + 1) * B]
            np.testing.assert_array_equal(wb, w[bi * B:(bi + 1) * B])
            for k, v in xb.items():
                np.testing.assert_array_equal(v, pds_.x[k][sel], err_msg=k)
            np.testing.assert_array_equal(yb, pds_.y[sel])
    res.close()
    jres.close()


@pytest.mark.parametrize("int_dtype", [np.int64, np.int32])
def test_gather_batch_matches_jax(int_dtype):
    """The matrices, and each batch ``gather_batch`` reassembles, equal the
    JAX loader's; ids come back int64 and every column contiguous, as the
    host path hands them to the step."""
    jds_, pds_ = _datasets(int_dtype=int_dtype)
    res, jres = PLoader(pds_, B, seed=5, **CPU), JLoader(jds_, B, seed=5)
    np.testing.assert_array_equal(res.int_mat.numpy(), np.asarray(jres.int_mat))
    np.testing.assert_array_equal(res.float_mat.numpy(), np.asarray(jres.float_mat))
    assert res.int_mat.dtype == torch.int32 and res.float_mat.dtype == torch.float32
    assert res.nbytes() == N * (9 + 2) * 4  # 9 int columns (seq is 4); d0 and y
    perm, _ = res.epoch_perm()
    for bi in range(len(res)):
        sel = perm[bi * B:(bi + 1) * B]
        x, y = res.gather_batch(res.int_mat[torch.from_numpy(sel).long()],
                                res.float_mat[torch.from_numpy(sel).long()])
        jx, jy = jres.gather_batch(jres.int_mat[sel], jres.float_mat[sel])
        assert sorted(x) == sorted(jx)
        for k, v in x.items():
            assert v.is_contiguous(), k
            assert v.dtype == (torch.float32 if k == "d0" else torch.int64), k
            np.testing.assert_array_equal(v.numpy(), np.asarray(jx[k]), err_msg=k)
            np.testing.assert_array_equal(v.numpy(), pds_.x[k][sel], err_msg=k)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_loader_without_labels_or_card_raises():
    x, _ = _columns(10)
    with pytest.raises(ValueError, match="labels"):
        PLoader(ColumnarDataset(x), 4, **CPU)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PLoader(ColumnarDataset(*_columns(10)), 4)


# -- the resident epoch against the host epoch -----------------------------------

@pytest.mark.parametrize("mode", list(MODE_KW))
def test_resident_epoch_equals_host_epoch(mode):
    """Two epochs over the same rows and seed: the resident trainer's state
    equals the host trainer's bit for bit, in every update mode (the same
    batches reach the same step)."""
    host_t, res_t = _twins(mode)
    _, pds_ = _datasets(vocab=bf16_tests.V if mode == "sorted_bf16" else V)
    host = BatchIterable(pds_, B, shuffle=True, seed=5)
    res = PLoader(pds_, B, seed=5, **CPU)
    for _ in range(2):
        host_t.train_one_epoch(host, log_interval=10**9)
        res_t.train_one_epoch(res, log_interval=10**9)
    res_t.barrier()
    _assert_same_trainers(host_t, res_t)


def test_resident_epoch_defers_its_last_loss(capsys):
    """The resident epoch returns None and prints its last window at the
    next entry point; that window's mean is the host epoch's return."""
    host_t, res_t = _twins("sorted")
    _, pds_ = _datasets()
    want = host_t.train_one_epoch(BatchIterable(pds_, B, shuffle=True, seed=5),
                                  log_interval=3)
    capsys.readouterr()
    assert res_t.train_one_epoch(PLoader(pds_, B, seed=5, **CPU), log_interval=3) is None
    assert capsys.readouterr().out.count("loss") == 1  # step 3 only; step 4 deferred
    assert res_t.barrier() == want
    assert "step 4/4" in capsys.readouterr().out
    assert res_t.barrier() is None  # nothing left deferred


@pytest.mark.parametrize("scan_steps", [1, 3])
def test_resident_gather_and_scan_steps_do_not_change_the_epoch(scan_steps):
    """``resident_gather='dispatch'`` and ``'step'`` at any ``scan_steps``
    give the one-step-a-batch epoch."""
    base, other = _twins("sorted", scan_steps=scan_steps, resident_gather="dispatch")
    _, pds_ = _datasets()
    for t in (base, other):
        loader = PLoader(pds_, B, seed=5, **CPU)
        for _ in range(2):
            t.train_one_epoch(loader, log_interval=10**9)
    _assert_same_trainers(base, other)


def test_planted_permutation_fault_is_seen():
    """A resident epoch whose permutation is rolled by one row must not
    equal the host epoch: the comparison above can fail."""
    host_t, res_t = _twins("sorted")
    _, pds_ = _datasets()
    res = PLoader(pds_, B, seed=5, **CPU)
    right = res.epoch_perm
    res.epoch_perm = lambda: tuple(np.roll(a, 1) if i == 0 else a
                                   for i, a in enumerate(right()))
    host_t.train_one_epoch(BatchIterable(pds_, B, shuffle=True, seed=5))
    res_t.train_one_epoch(res)
    with pytest.raises(AssertionError):
        _assert_same_trainers(host_t, res_t)


# -- the resident epoch against the JAX package's ------------------------------

def _jax_pair(mode, scan_steps):
    """A JAX trainer and a port trainer holding the same state, and both
    packages' resident loaders over the same rows."""
    bf16 = mode == "sorted_bf16"
    feats, vocab = (bf16_tests._feats, bf16_tests.V) if bf16 else (mode_tests._feats, V)
    jkw = {**MODE_KW[mode], **({"sorted_block_rows": 64} if "sorted" in mode else {})}
    jt = JTrainer(JMMOE(feats(jf), DOMAINS, **KW), seed=7, scan_steps=scan_steps,
                  prefetch_depth=0, **jkw)
    pt = _port_trainer(mode)
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    jds_, pds_ = _datasets(vocab=vocab)
    return jt, pt, JLoader(jds_, B, seed=5), PLoader(pds_, B, seed=5, **CPU)


@pytest.mark.parametrize("scan_steps", [1, 3])
@pytest.mark.parametrize("mode", ["sorted", "occurrence", "plain"])
def test_resident_epoch_matches_jax_resident_epoch(mode, scan_steps):
    """One resident epoch (four steps, the last batch padded) from one
    carried state: every parameter, BN statistic and Adam moment within
    test_torch_port_train.py's step tolerances."""
    jt, pt, jl, pl = _jax_pair(mode, scan_steps)
    jt.train_one_epoch(jl, log_interval=10**9)
    jt.barrier()
    pt.train_one_epoch(pl, log_interval=10**9)
    pt.barrier()
    assert pt.emb_opt_state is None or pt.emb_opt_state["step"] == len(pl)
    mode_tests._assert_same_state(jt, pt)


@pytest.mark.parametrize("scan_steps", [1, 3])
def test_resident_epoch_matches_jax_resident_epoch_bf16(scan_steps, monkeypatch):
    """The bf16 store over one resident epoch of four steps. A rounding
    flipped in one step persists and moves with the later steps, so the
    one-step rule of test_torch_port_sorted_bf16.py (one ulp everywhere)
    becomes: one ulp, or within the f32 trainers' STEP_ATOL (a tiny second
    moment, ~1e-22, drifts a few ulps of its own scale); at most 0.1 % of
    the elements differ. The rest of the state at the step tolerances."""
    jt, pt, jl, pl = _jax_pair("sorted_bf16", scan_steps)
    jt.train_one_epoch(jl, log_interval=10**9)
    jt.barrier()
    pt.train_one_epoch(pl, log_interval=10**9)
    pt.barrier()
    st = pt.emb_opt_state
    assert st["step"] == int(jt.opt_state["emb"]["step"]) == len(pl)
    for name, want in bf16_tests._jax_store(jt, pt).items():
        got, want_t = st[name], torch.from_numpy(np.asarray(want, np.float32))
        ulps = bf16_tests._ulps(got, want)
        far = (ulps > 1) & ((got.float() - want_t).abs() > STEP_ATOL)
        n = int((ulps > 0).sum())
        print(f"store {name}: {n} of {ulps.numel()} elements differ, at most "
              f"{int(ulps.max())} ulp, {int(far.sum())} beyond one ulp and {STEP_ATOL}")
        assert not bool(far.any()) and n <= bf16_tests.SHARE * ulps.numel(), name
    # the rest of the bf16 test's state check; its one-step store rule is
    # the epoch rule above
    monkeypatch.setattr(bf16_tests, "_assert_held", lambda *a: None)
    bf16_tests._assert_same_state(jt, pt)


# -- fit, device_shuffle and the device rules ---------------------------------

@pytest.mark.parametrize("mode", list(MODE_KW))
def test_fit_accepts_resident_loader(tmp_path, mode):
    """``fit`` over a resident loader with a host validation loader, in
    every update mode: an epoch, its validation and the checkpoint."""
    t = _port_trainer(mode, n_epoch=2, model_path=str(tmp_path))
    _, pds_ = _datasets(vocab=bf16_tests.V if mode == "sorted_bf16" else V)
    _, val = _datasets(n=2 * B + 3, seed=9)
    path = t.fit(PLoader(pds_, B, seed=2, **CPU), BatchIterable(val, B))
    assert path.endswith(".npz")
    if t.emb_opt_state is not None:
        assert t.emb_opt_state["step"] == 2 * 4
    ll, auc, tll, tauc = t.evaluate_multi_domain_loss(t.model, BatchIterable(val, B), DOMAINS,
                                                      on_device=True)
    assert all(np.isfinite(v) for v in ll + auc + [tll, tauc])


@pytest.mark.parametrize("shuffle", [True, False])
def test_device_shuffle_covers_every_row_once(shuffle):
    """``device_shuffle``: each epoch's ids hold every row once plus the
    final partial batch's first row repeated as padding; two epochs draw
    two permutations (unshuffled: the rows in order); training on them moves
    the parameters and keeps them finite."""
    t = _port_trainer("sorted")
    _, pds_ = _datasets()
    loader = PLoader(pds_, B, seed=5, shuffle=shuffle, device_shuffle=True, **CPU)
    rem, pad = N % B, B - N % B
    epochs = []
    for _ in range(2):
        ids = t._epoch_ids(loader).numpy()
        assert ids.shape == (len(loader) * B,)
        assert sorted(ids[:N].tolist()) == list(range(N))
        assert (ids[N:] == ids[N - rem]).all() and len(ids[N:]) == pad
        epochs.append(ids)
    assert (epochs[0] != epochs[1]).any() == shuffle
    if not shuffle:
        np.testing.assert_array_equal(epochs[0][:N], np.arange(N))
    p0 = t.model.embedding.packed.detach().clone()
    for _ in range(2):
        t.train_one_epoch(loader, log_interval=10**9)
    t.barrier()
    p1 = t.model.embedding.packed.detach()
    assert not torch.equal(p0, p1) and bool(torch.isfinite(p1).all())
    assert t.emb_opt_state["step"] == 2 * len(loader)


def test_loader_on_another_device_raises():
    t = _port_trainer("sorted")
    _, pds_ = _datasets()
    loader = PLoader(pds_, B, seed=5, device="meta")
    with pytest.raises(ValueError, match=r"meta.*cpu"):
        t.train_one_epoch(loader)
    with pytest.raises(TypeError, match="Mesh"):
        PTrainer(t.model, **CPU, mesh=object())
    from scenario_wise_rec_tpu_torch.parallel import make_mesh
    # a mesh takes a resident loader since A15.3: a mesh of one rank runs
    # one process's epoch
    meshed = PTrainer(copy.deepcopy(t.model), **CPU, mesh=make_mesh(1, 1),
                      sparse_embedding_updates=True, sparse_update_impl="sorted")
    meshed.train_one_epoch(PLoader(pds_, B, seed=5, device="cpu"))
    t.train_one_epoch(PLoader(pds_, B, seed=5, device="cpu"))
    _assert_same_trainers(meshed, t)
