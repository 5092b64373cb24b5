"""``CTRTrainer(scan_steps=S)`` with S > 1 in the port: S steps a dispatch
through one step body (a CUDA graph on the card, uncaptured here on the CPU)
against the JAX package's scanned epochs (``_train_step_scan`` over a host
loader, its resident scan over a ``DeviceResidentLoader``) and against the
port's own S = 1 epoch bit for bit, in the sorted mode with an f32 and a bf16
store and the plain step (MMOE; EPNet, a model without an ``embedding``
collection). Also: the log lines, the step counts, the sorted kernel's plain
version given its Adam numbers as a tensor, the dispatch staging and what
drops a step plan. Narrow models, dropout 0, inputs made with numpy from a
seed, state carried across with ``interop.load_jax_trainer_state``."""

import copy
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.core import init as jinit  # noqa: E402
from scenario_wise_rec_tpu.data import dataset as jds  # noqa: E402
from scenario_wise_rec_tpu.data.device import DeviceResidentLoader as JLoader  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.core import init as pinit  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset  # noqa: E402
from scenario_wise_rec_tpu_torch.data import DeviceResidentLoader as PLoader  # noqa: E402
from scenario_wise_rec_tpu_torch.data.device import gather_columns  # noqa: E402
from scenario_wise_rec_tpu_torch.data.prefetch import stage_dispatches  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_trainer_state  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as psa  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.train import optim as poptim  # noqa: E402
from scenario_wise_rec_tpu_torch.train import trainer as ptrainer  # noqa: E402

import test_torch_port_resident as res_tests  # noqa: E402
import test_torch_port_sorted_bf16 as bf16_tests  # noqa: E402
import test_torch_port_train_gated as gated_tests  # noqa: E402
import test_torch_port_train_modes as mode_tests  # noqa: E402
from test_torch_port_train import B, DOMAINS, KW, STEP_ATOL, V, _np  # noqa: E402

CPU = dict(device="cpu")
N = 6 * B + 5  # seven batches, the last padded with 11 weight-0 rows
MODE_KW = res_tests.MODE_KW
SCANNED = ["sorted", "sorted_bf16", "plain"]
LOADERS = ["host", "resident"]


def _vocab(mode):
    return bf16_tests.V if mode == "sorted_bf16" else V


def _loaders(mode, loader, n=N, seed=3):
    """The JAX and the port loader of one kind over the same rows."""
    jds_, pds_ = res_tests._datasets(n=n, seed=seed, vocab=_vocab(mode))
    if loader == "host":
        return (jds.BatchIterable(jds_, B, shuffle=True, seed=5),
                BatchIterable(pds_, B, shuffle=True, seed=5))
    return JLoader(jds_, B, seed=5), PLoader(pds_, B, seed=5, **CPU)


def _port_loader(mode, loader, n=N):
    return _loaders(mode, loader, n)[1]


def _jax_pair(mode, scan_steps):
    """A JAX trainer and a port trainer at ``scan_steps`` holding one state."""
    bf16 = mode == "sorted_bf16"
    feats = bf16_tests._feats if bf16 else mode_tests._feats
    jkw = {**MODE_KW[mode], **({"sorted_block_rows": 64} if "sorted" in mode else {})}
    jt = JTrainer(JMMOE(feats(jf), DOMAINS, **KW), seed=7, scan_steps=scan_steps,
                  prefetch_depth=0, **jkw)
    pt = res_tests._port_trainer(mode, scan_steps=scan_steps)
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    return jt, pt


def _epoch(t, loader, log_interval=10**9):
    t.train_one_epoch(loader, log_interval=log_interval)
    return t.barrier()


def _assert_bf16_epoch(jt, pt, monkeypatch):
    """test_torch_port_resident.py's rule for a bf16 store over an epoch, for
    seven steps: a rounding flipped in one step persists and moves with the
    later ones, so at most one ulp a step, or within the f32 trainers'
    STEP_ATOL (the port's S = 1 epoch against JAX's S = 1 epoch holds one
    table element 3 ulps off after these seven steps); at most 0.1 % of the
    elements differ. The rest of the state at the step tolerances."""
    st = pt.emb_opt_state
    for name, want in bf16_tests._jax_store(jt, pt).items():
        got, want_t = st[name], torch.from_numpy(np.asarray(want, np.float32))
        ulps = bf16_tests._ulps(got, want)
        far = (ulps > st["step"]) & ((got.float() - want_t).abs() > STEP_ATOL)
        n = int((ulps > 0).sum())
        assert not bool(far.any()) and n <= bf16_tests.SHARE * ulps.numel(), name
    monkeypatch.setattr(bf16_tests, "_assert_held", lambda *a: None)
    bf16_tests._assert_same_state(jt, pt)


# -- against the JAX package's scanned epochs ----------------------------------

@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("scan_steps", [2, 3, 4])
@pytest.mark.parametrize("mode", SCANNED)
def test_scan_epoch_matches_jax_scanned_epoch(mode, scan_steps, loader, monkeypatch):
    """One epoch of seven batches (S = 2, 3 and 4 leave remainders of 1, 1
    and 3 steps) from one carried state, the port's S steps a dispatch
    against the JAX trainer's ``lax.scan`` of S steps: every parameter, BN
    statistic and Adam moment within test_torch_port_train.py's step
    tolerances (a bf16 store within its epoch rule)."""
    jt, pt = _jax_pair(mode, scan_steps)
    jl, pl = _loaders(mode, loader)
    _epoch(jt, jl)
    _epoch(pt, pl)
    assert len(pl) == 7
    if pt.emb_opt_state is not None:
        assert pt.emb_opt_state["step"] == int(jt.opt_state["emb"]["step"]) == 7
    assert not pt.graphed  # the CPU runs the step body uncaptured
    if mode == "sorted_bf16":
        _assert_bf16_epoch(jt, pt, monkeypatch)
    else:
        mode_tests._assert_same_state(jt, pt)


def _gated_columns(n, seed=3):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, gated_tests.V, n).astype(np.int64) for i in range(3)}
    x["alias"] = r.integers(0, gated_tests.V, n).astype(np.int64)
    x["uid"] = r.integers(0, gated_tests.V, n).astype(np.int64)
    x["d0"] = r.normal(size=n).astype(np.float32)
    x["domain_indicator"] = r.integers(0, gated_tests.DOMAINS, n).astype(np.int64)
    return x, r.integers(0, 2, n).astype(np.float32)


@pytest.mark.parametrize("loader", LOADERS)
def test_epnet_scan_epoch_matches_jax_scanned_epoch(loader):
    """EPNet, whose tables are no ``embedding`` collection, runs the plain
    step: seven batches at S = 3 against the JAX scanned epoch."""
    kw = gated_tests.KW
    jt = JTrainer(jmodels.get_model("epnet")(**kw(jf, jinit, "epnet")), seed=7,
                  scan_steps=3, prefetch_depth=0)
    pm = pmodels.get_model("epnet")(**kw(pf, pinit, "epnet"), **CPU,
                                    generator=make_generator(torch.device("cpu"), 1))
    pt = PTrainer(pm, **CPU, scan_steps=3, sparse_embedding_updates=True,
                  sparse_update_impl="sorted")
    assert pt._emb_mode is None and pt._dispatched
    load_jax_trainer_state(pt, _np(jt.params), _np(jt.state), _np(jt.opt_state))
    x, y = _gated_columns(N)
    jd, pd_ = jds.ColumnarDataset(x, y), ColumnarDataset(x, y)
    if loader == "host":
        jl, pl = (jds.BatchIterable(jd, B, shuffle=True, seed=5),
                  BatchIterable(pd_, B, shuffle=True, seed=5))
    else:
        jl, pl = JLoader(jd, B, seed=5), PLoader(pd_, B, seed=5, **CPU)
    _epoch(jt, jl)
    _epoch(pt, pl)
    gated_tests._assert_same_state(jt, pt)


LINE = re.compile(r"step (\d+)/(\d+) loss ([0-9.]+)")


def _lines(out):
    return [(int(a), int(b), float(c)) for a, b, c in LINE.findall(out)]


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("scan_steps", [2, 3])
def test_log_lines_match_jax(scan_steps, loader, capsys):
    """The same loss lines as the JAX trainer's for the same loader at
    ``log_interval=3``: a line where ``done % 3 < S`` after a full dispatch,
    none inside the remainder, the last at the epoch's end (a resident
    epoch's deferred to the barrier); the same steps, the losses within
    1e-5."""
    jt, pt = _jax_pair("sorted", scan_steps)
    jl, pl = _loaders("sorted", loader)
    capsys.readouterr()
    _epoch(jt, jl, log_interval=3)
    want = _lines(capsys.readouterr().out)
    _epoch(pt, pl, log_interval=3)
    got = _lines(capsys.readouterr().out)
    assert [g[:2] for g in got] == [w[:2] for w in want] and got[-1][:2] == (7, 7)
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= 1e-5 * max(1.0, abs(w[2])), (g, w)


# -- against the port's own single steps ----------------------------------------

def _twins(mode, scan_steps=3, **kw):
    """A port trainer at S = 1 and one at ``scan_steps`` holding one state."""
    a = res_tests._port_trainer(mode, **kw)
    b = PTrainer(copy.deepcopy(a.model), **CPU, **MODE_KW[mode], scan_steps=scan_steps,
                 **kw)
    return a, b


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("mode", SCANNED)
def test_scan_epochs_equal_single_step_epochs(mode, loader):
    """Two epochs of seven batches at S = 3 (two dispatches and a remainder
    of one an epoch) leave the S = 1 trainer's state bit for bit: weights,
    BN statistics, torch.optim's moments and steps, the embedding update's
    moments, store and step."""
    one, three = _twins(mode)
    for _ in range(2):
        _epoch(one, _port_loader(mode, loader))
        _epoch(three, _port_loader(mode, loader))
    res_tests._assert_same_trainers(one, three)


@pytest.mark.parametrize("mode", ["sorted", "plain"])
def test_every_step_advances_the_step_counts(mode):
    """The sorted update's host step count and torch.optim's step count
    advance by every step of every dispatch, the remainder's too."""
    _, t = _twins(mode)
    loader = _port_loader(mode, "host")
    for epoch in (1, 2):
        _epoch(t, loader)
        if t.emb_opt_state is not None:
            assert t.emb_opt_state["step"] == 7 * epoch
        for _, p in t._dense_named:
            assert float(t.optimizer.state[p]["step"]) == 7 * epoch


def test_a_dispatch_whose_hp_row_is_not_advanced_is_seen(monkeypatch):
    """A planted fault: every step of a dispatch given its first step's
    Adam numbers (the bias corrections of step t at t + 1, t + 2) must not
    equal the S = 1 epoch."""
    right = ptrainer.adam_hparams_rows

    def frozen(step0, n, *a):
        return np.repeat(right(step0, 1, *a), n, axis=0)

    monkeypatch.setattr(ptrainer, "adam_hparams_rows", frozen)
    one, three = _twins("sorted")
    _epoch(one, _port_loader("sorted", "host"))
    _epoch(three, _port_loader("sorted", "host"))
    with pytest.raises(AssertionError):
        res_tests._assert_same_trainers(one, three)


def test_fit_with_a_step_lr_equals_single_steps(tmp_path):
    """``fit`` over three epochs with an epoch StepLR (the lr halves after
    each epoch: each dispatch's Adam numbers take the new lr, and on the card
    the changed lr drops the captured step) at S = 3 equals S = 1."""
    kw = dict(scheduler_fn=poptim.step_lr, scheduler_params={"step_size": 1, "gamma": 0.5},
              n_epoch=3, model_path=str(tmp_path))
    one, three = _twins("sorted", **kw)
    for t in (one, three):
        t.fit(_port_loader("sorted", "resident"))
    res_tests._assert_same_trainers(one, three)


def test_cpu_keeps_torch_adam_uncapturable():
    """The CPU runs no graph: torch.optim.Adam stays as at S = 1 (torch's
    capturable Adam runs on a card only)."""
    _, t = _twins("plain")
    assert t.optimizer.defaults["capturable"] is False and not t._capturable


# -- the sorted kernel's Adam numbers as a tensor -------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_ref_takes_hp_as_a_tensor(dtype):
    """``sorted_dense_adam_apply_ref`` and the wrapper given ``hp`` as a [7]
    float32 tensor equal them given host floats, bit for bit; a tensor of
    another shape or type raises."""
    r = np.random.default_rng(0)
    V_, D_ = 300, 8
    base = [torch.from_numpy(r.normal(size=(V_, D_)).astype(np.float32)).to(dtype)
            for _ in range(2)]
    base.insert(2, torch.from_numpy(r.random((V_, D_)).astype(np.float32)).to(dtype))
    ids, _ = torch.sort(torch.from_numpy(r.integers(-3, V_ + 3, 500).astype(np.int32)))
    g = torch.from_numpy(r.normal(size=(500, D_)).astype(np.float32))
    hp = psa.adam_hparams(5, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    rows = psa.adam_hparams_rows(3, 4, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    assert rows.dtype == np.float32 and rows.shape == (4, 7)
    assert tuple(float(v) for v in rows[2]) == hp  # step 3 + 2
    hp_t = torch.from_numpy(rows[2].copy())
    for fn in (psa.sorted_dense_adam_apply_ref, psa.sorted_dense_adam_apply):
        want = [t.clone() for t in base]
        got = [t.clone() for t in base]
        fn(*want, ids, g, hp)
        fn(*got, ids, g, hp_t)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    for bad in (hp_t[:6], hp_t.double(), hp_t.view(1, 7)):
        with pytest.raises(ValueError, match="hp"):
            psa.sorted_dense_adam_apply(*[t.clone() for t in base], ids, g, bad)


# -- the dispatch staging and the step plan -------------------------------------

def test_stage_dispatches_pack_and_gather_back():
    """``stage_dispatches`` groups seven batches into dispatches of 3, 3 and
    1; each packed batch gathers back (``gather_columns``) to the batch's own
    columns, label and weights; a batch of another size closes its group."""
    _, pds_ = res_tests._datasets(n=N)
    batches = list(BatchIterable(pds_, B, shuffle=True, seed=5))
    ds = list(stage_dispatches(batches, 3, pin=False))
    assert [d.n for d in ds] == [3, 3, 1] and all(d.b == B for d in ds)
    i = 0
    for d in ds:
        for k in range(d.n):
            rows = slice(k * B, (k + 1) * B)
            x, y = gather_columns(d.layout, d.ints[rows], d.floats[rows])
            bx, by, bw = batches[i]
            assert sorted(x) == sorted(bx)
            for name, v in x.items():
                assert torch.equal(v, torch.from_numpy(np.asarray(bx[name])).to(v.dtype)), name
            assert torch.equal(y, torch.from_numpy(by)) and torch.equal(
                d.w[rows], torch.from_numpy(bw))
            i += 1
    x2, y2, w2 = batches[2]
    short = batches[:2] + [({k: v[:B - 3] for k, v in x2.items()}, y2[:B - 3], w2[:B - 3])]
    assert [d.n for d in stage_dispatches(short, 3, pin=False)] == [2, 1]
    with pytest.raises(ValueError, match="labeled"):
        list(stage_dispatches([(batches[0][0], None, batches[0][2])], 3, pin=False))


def test_load_and_rebound_state_drop_the_step_plan(tmp_path):
    """``load`` drops the step plan (the next dispatch builds, warms up and,
    on the card, captures anew), and the state a captured step writes is
    read by address: a rebound optimizer moment changes it, so a kept graph
    would not be replayed over it."""
    t = _twins("sorted")[1]
    loader = _port_loader("sorted", "host")
    _epoch(t, loader)
    plan = t._plan
    assert plan is not None and plan.loader is loader
    state = t._graph_state()
    assert state == t._graph_state()
    p = t._dense_named[0][1]
    t.optimizer.state[p]["exp_avg"] = t.optimizer.state[p]["exp_avg"].clone()
    assert t._graph_state() != state
    path = t.save(str(tmp_path / "ckpt"))
    t.load(path)
    assert t._plan is None
    _epoch(t, loader)
    assert t._plan is not None and t._plan is not plan


def test_constants_made_in_an_eval_pass_serve_a_train_step():
    """The attention scale (M2M's transformer) and the plain gather's offset
    row are made once per device, where a captured step could not copy them
    from the host; one first made inside an eval pass's inference mode still
    serves a train step's backward."""
    from scenario_wise_rec_tpu_torch.ops.transformer import MultiheadAttention

    sparse = [pf.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8) for i in range(3)]
    sce = [pf.SparseFeature("domain_indicator", vocab_size=DOMAINS, embed_dim=8)]
    model = pmodels.get_model("m2m")(
        features=sparse + sce, domain_feature=sce, domain_num=DOMAINS, num_experts=4,
        expert_output_size=4, transformer_dims={"num_encoder_layers": 1,
                                                "num_decoder_layers": 1,
                                                "dim_feedforward": 16, "dropout": 0.0},
        **CPU, generator=make_generator(torch.device("cpu"), 1))
    t = PTrainer(model, **CPU)
    x, y = res_tests._columns(B)
    batch = t._device_batch({k: x[k] for k in ("s0", "s1", "s2", "domain_indicator")}, y,
                            np.ones(B, np.float32))
    attention = [m for m in model.modules() if isinstance(m, MultiheadAttention)]
    assert not model.embedding._offset_rows and not any(m._scales for m in attention)
    with torch.inference_mode():
        model.apply(batch[0], train=False, w=batch[2])
    assert model.embedding._offset_rows and all(m._scales for m in attention)
    assert float(t._train_step(*batch)) > 0
