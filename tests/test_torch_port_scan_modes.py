"""``CTRTrainer(scan_steps=S)`` with S > 1 in the ``occurrence``, ``dense``
and ``winner`` embedding-update modes: S steps a dispatch through one step
body (a CUDA graph on the card; uncaptured here on the CPU) against the JAX
package's scanned epochs over host and resident loaders, against the port's
own S = 1 epoch bit for bit, the loss lines against JAX's (S > 1 logs after
a full dispatch where ``done % log_interval < S``), the step counts, a
planted stale-row fault per mode, the update functions given their Adam
numbers as a row, and the winner update's mask-free write-back against the
JAX package's and under permuted occurrences. Narrow MMOE, dropout 0,
inputs made with numpy from a seed, state carried across with
``interop.load_jax_trainer_state`` (the helpers of
``test_torch_port_scan_graphs.py``)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as pfa  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as psa  # noqa: E402
from scenario_wise_rec_tpu_torch.train import optim as poptim  # noqa: E402
from scenario_wise_rec_tpu_torch.train import trainer as ptrainer  # noqa: E402

import test_torch_port_resident as res_tests  # noqa: E402
import test_torch_port_scan_graphs as scan_tests  # noqa: E402
import test_torch_port_train_modes as mode_tests  # noqa: E402

MODES = ["occurrence", "dense", "winner"]
LOADERS = scan_tests.LOADERS
# each mode's row helper, as the trainer imports it
ROWS = {"occurrence": "occurrence_hparams_rows", "dense": "adam_hparams_rows",
        "winner": "occurrence_hparams_rows"}


# -- against the JAX package's scanned epochs ----------------------------------

@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("scan_steps", [2, 3, 4])
@pytest.mark.parametrize("mode", MODES)
def test_scan_epoch_matches_jax_scanned_epoch(mode, scan_steps, loader):
    """One epoch of seven batches (S = 2, 3 and 4 leave remainders of 1, 1
    and 3 steps) from one carried state, the port's S steps a dispatch
    against the JAX trainer's ``lax.scan`` of S steps: every parameter, BN
    statistic and Adam moment within test_torch_port_train.py's step
    tolerances, and both update step counts at 7."""
    jt, pt = scan_tests._jax_pair(mode, scan_steps)
    assert pt._dispatched and not pt.graphed  # the CPU runs the body uncaptured
    jl, pl = scan_tests._loaders(mode, loader)
    scan_tests._epoch(jt, jl)
    scan_tests._epoch(pt, pl)
    assert len(pl) == 7
    assert pt.emb_opt_state["step"] == int(jt.opt_state["emb"]["step"]) == 7
    assert pt._plan is not None and pt._plan.loader is pl
    mode_tests._assert_same_state(jt, pt)


LINE = scan_tests.LINE


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("scan_steps", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_log_lines_match_jax(mode, scan_steps, loader, capsys):
    """The same loss lines as the JAX trainer's for the same loader at
    ``log_interval=3``: a line where ``done % 3 < S`` after a full dispatch,
    none inside the remainder, the last at the epoch's end (a resident
    epoch's deferred to the barrier); the same steps, the losses within
    1e-5."""
    jt, pt = scan_tests._jax_pair(mode, scan_steps)
    jl, pl = scan_tests._loaders(mode, loader)
    capsys.readouterr()
    scan_tests._epoch(jt, jl, log_interval=3)
    want = scan_tests._lines(capsys.readouterr().out)
    scan_tests._epoch(pt, pl, log_interval=3)
    got = scan_tests._lines(capsys.readouterr().out)
    assert [g[:2] for g in got] == [w[:2] for w in want] and got[-1][:2] == (7, 7)
    assert len(got) < 7  # not a line every step, nor S = 1's lines at 3 and 6
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= 1e-5 * max(1.0, abs(w[2])), (g, w)


# -- against the port's own single steps ----------------------------------------

@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("mode", MODES)
def test_scan_epochs_equal_single_step_epochs(mode, loader):
    """Two epochs of seven batches at S = 3 (two dispatches and a remainder
    of one an epoch) leave the S = 1 trainer's state bit for bit: weights,
    BN statistics, torch.optim's moments and steps, the embedding update's
    moments (the occurrence mode's combined store) and step."""
    one, three = scan_tests._twins(mode)
    assert not one._dispatched and three._dispatched
    for _ in range(2):
        scan_tests._epoch(one, scan_tests._port_loader(mode, loader))
        scan_tests._epoch(three, scan_tests._port_loader(mode, loader))
    assert three._plan is not None and one._plan is None
    res_tests._assert_same_trainers(one, three)


@pytest.mark.parametrize("mode", MODES)
def test_every_step_advances_the_step_counts(mode):
    """The update's host step count and torch.optim's step count advance by
    every step of every dispatch, the remainder's too: once, by the
    dispatch (the update given its row leaves the count alone)."""
    _, t = scan_tests._twins(mode)
    loader = scan_tests._port_loader(mode, "host")
    for epoch in (1, 2):
        scan_tests._epoch(t, loader)
        assert t.emb_opt_state["step"] == 7 * epoch
        for _, p in t._dense_named:
            assert float(t.optimizer.state[p]["step"]) == 7 * epoch


@pytest.mark.parametrize("mode", MODES)
def test_a_dispatch_whose_row_is_not_advanced_is_seen(mode, monkeypatch):
    """A planted fault: every step of a dispatch given its first step's
    row of Adam numbers (the bias corrections of step t at t + 1, t + 2)
    must not equal the S = 1 epoch."""
    right = getattr(ptrainer, ROWS[mode])
    monkeypatch.setattr(ptrainer, ROWS[mode],
                        lambda step0, n, *a: np.repeat(right(step0, 1, *a), n, axis=0))
    one, three = scan_tests._twins(mode)
    scan_tests._epoch(one, scan_tests._port_loader(mode, "host"))
    scan_tests._epoch(three, scan_tests._port_loader(mode, "host"))
    with pytest.raises(AssertionError):
        res_tests._assert_same_trainers(one, three)


@pytest.mark.parametrize("mode", ["plain", "sorted", "occurrence", "dense", "winner"])
def test_every_mode_is_dispatched(mode):
    """At S > 1 every mode runs S steps a dispatch (on the CPU none is
    graphed, on the card every one: winner too); each plan holds the row of
    Adam numbers its update reads: 7 for the sorted and dense kernels, 3 for
    the occurrence and winner updates, none for the plain step."""
    _, t = scan_tests._twins(mode)
    assert t._dispatched and not t.graphed
    scan_tests._epoch(t, scan_tests._port_loader(mode, "resident"))
    width = {"sorted": 7, "dense": 7, "occurrence": 3, "winner": 3}.get(mode)
    assert (t._plan.hp is None) if width is None else (t._plan.hp.shape == (3, width))
    t.device = torch.device("cuda")  # what the flag reads: a dispatch on the card
    assert t.graphed


# -- the updates given their Adam numbers as a row ------------------------------

def _rows_case(r, k=200, v=50, d=4):
    ids = torch.from_numpy(r.integers(0, v, k))
    comb = torch.from_numpy(r.normal(size=(v, 3 * d)).astype(np.float32))
    comb[:, 2 * d:] = comb[:, 2 * d:].abs()
    g = torch.from_numpy(r.normal(size=(k, d)).astype(np.float32))
    return ids, comb, g, (("f", 0, k // 2), ("g", k // 2, k - k // 2))


def test_occurrence_rows_are_the_host_bias_corrections():
    """``occurrence_hparams_rows`` holds ``(lr, 1 - b1^t, 1 - b2^t)`` of each
    step as ``_bias_corrections`` computes them in float32."""
    rows = poptim.occurrence_hparams_rows(4, 3, 1e-3, 0.9, 0.999)
    assert rows.dtype == np.float32 and rows.shape == (3, 3)
    for i, row in enumerate(rows):
        assert tuple(float(v) for v in row[1:]) == poptim._bias_corrections(4 + i, 0.9, 0.999)
        assert row[0] == np.float32(1e-3)


@pytest.mark.parametrize("frozen", [(), ((10, 5),)])
def test_occurrence_update_given_its_row_equals_its_own(frozen):
    """``sparse_adam_occurrence_update(hp=row)`` equals the update that
    stages its step's row itself, bit for bit, and leaves the step count to
    the caller; with ids of length 0 too."""
    r = np.random.default_rng(0)
    ids, comb, g, segs = _rows_case(r)
    a = {"comb": comb.clone(), "step": 4}
    b = {"comb": comb.clone(), "step": 4}
    poptim.sparse_adam_occurrence_update(a, g, ids, segs, a["comb"][ids], frozen_spans=frozen)
    row = torch.from_numpy(poptim.occurrence_hparams_rows(5, 1, 1e-3, 0.9, 0.999)[0])
    poptim.sparse_adam_occurrence_update(b, g, ids, segs, b["comb"][ids], hp=row,
                                         frozen_spans=frozen)
    assert a["step"] == 5 and b["step"] == 4
    assert torch.equal(a["comb"], b["comb"]) and not torch.equal(a["comb"], comb)
    empty = torch.zeros(0, dtype=torch.long)
    poptim.sparse_adam_occurrence_update(b, g[:0], empty, (), b["comb"][empty], hp=row)
    poptim.sparse_adam_occurrence_update(a, g[:0], empty, (), a["comb"][empty])
    assert (a["step"], b["step"]) == (6, 4)


def test_fused_dense_update_given_its_row_equals_host_numbers():
    """``fused_dense_adam_update(hp=row)`` and ``fused_dense_adam_apply``
    given a ``[7]`` tensor equal them given host numbers, bit for bit; the
    update then leaves the step count to the caller; a tensor of another
    shape or type raises."""
    r = np.random.default_rng(1)
    ids, comb, g, segs = _rows_case(r)
    table = comb[:, :4].contiguous()
    a = dict(poptim.sparse_adam_init(table), step=2)
    b = dict(poptim.sparse_adam_init(table), step=2)
    ta, tb = table.clone(), table.clone()
    poptim.fused_dense_adam_update(ta, a, g, ids, segs, frozen_spans=((3, 4),))
    hp = psa.adam_hparams_rows(3, 1, 1e-3, 1e-5, 0.9, 0.999, 1e-8)[0]
    poptim.fused_dense_adam_update(tb, b, g, ids, segs, frozen_spans=((3, 4),),
                                   hp=torch.from_numpy(hp))
    assert (a["step"], b["step"]) == (3, 2)
    for x, y in ((ta, tb), (a["mu"], b["mu"]), (a["nu"], b["nu"])):
        assert torch.equal(x, y)
    assert torch.equal(ta[3:7], table[3:7]) and not torch.equal(ta, table)
    sid, pos, sizes = poptim.segment_sorted_ids(ids, segs)
    for bad in (torch.from_numpy(hp[:6].copy()), torch.from_numpy(hp).double()):
        with pytest.raises(ValueError, match="hp"):
            pfa.fused_dense_adam_apply(tb, b["mu"], b["nu"], g, sid, pos, sizes, bad)


def test_winner_sums_duplicates_in_their_order():
    """The winner update's per-id gradient sums equal ``index_add_``'s,
    which sums in the order of occurrence, bit for bit."""
    r = np.random.default_rng(2)
    ids = torch.from_numpy(r.integers(0, 5, 400))
    g = torch.from_numpy((r.normal(size=(400, 3)) * 10.0 ** r.integers(-6, 3, (400, 1)))
                         .astype(np.float32))
    table = torch.zeros(5, 3)
    st = poptim.sparse_adam_init(table)
    poptim.sparse_adam_rowgrads_update(table, st, g, ids, lr=1.0, weight_decay=0.0,
                                       b1=0.0, b2=0.0, eps=0.0)
    want = torch.zeros(5, 3).index_add_(0, ids, g)
    # b1 = b2 = 0: mu is the sum, and the step -sum / |sum| its sign
    assert torch.equal(st["mu"], want)


def test_segment_rows_are_made_once_outside_inference_mode():
    """The dense update's segment sizes and the kernel's segment offsets are
    device rows made once per layout, outside inference mode (a train step
    may use one an eval pass made; a captured step copies nothing from the
    host)."""
    sizes = (3, 0, 5)
    with torch.inference_mode():
        a = poptim._sizes_row(sizes, torch.device("cpu"))
        o = pfa._segment_offsets(sizes, torch.device("cpu"))
    assert not a.is_inference() and not o.is_inference()
    assert a is poptim._sizes_row(sizes, torch.device("cpu"))
    assert o.tolist() == [0, 3, 3, 8] and o.dtype == torch.int32


# -- the winner update: its Adam numbers as a row, its write-back without a mask --

def _winner_case(r, k=300, v=40, d=4, exact=False):
    """Ids with duplicates, both edges of the table (0 and V - 1) and a
    frozen span's ids among them, rows ``[V - 10, V - 1)`` untouched, and
    their gradient rows; ``exact``: the rows are multiples of 1/64 below 4,
    so that every duplicate sum is exact in float32 in any order."""
    ids = r.integers(0, v - 10, k)
    ids[:3], ids[-3:] = 0, v - 1
    ids[10:40] = 7
    if exact:
        g = (r.integers(-256, 256, (k, d)) / 64.0).astype(np.float32)
    else:
        g = r.normal(size=(k, d)).astype(np.float32)
    table = r.normal(size=(v, d)).astype(np.float32)
    return ids, g, table


@pytest.mark.parametrize("frozen", [(), ((0, 5),), ((30, 10),)])
def test_winner_update_given_its_row_equals_its_own(frozen):
    """``sparse_adam_rowgrads_update(hp=row)`` equals the update that stages
    its step's row itself, bit for bit, over three steps (frozen spans at
    either edge of the table or none), and leaves the step count to the
    caller; with ids of length 0 too."""
    r = np.random.default_rng(3)
    ids, g, table = _winner_case(r)
    ta, tb = torch.from_numpy(table.copy()), torch.from_numpy(table.copy())
    a, b = poptim.sparse_adam_init(ta), poptim.sparse_adam_init(tb)
    for step in range(1, 4):
        gs = torch.from_numpy(g * step)
        poptim.sparse_adam_rowgrads_update(ta, a, gs, torch.from_numpy(ids),
                                           frozen_spans=frozen)
        row = torch.from_numpy(poptim.occurrence_hparams_rows(step, 1, 1e-3, 0.9, 0.999)[0])
        poptim.sparse_adam_rowgrads_update(tb, b, gs, torch.from_numpy(ids), hp=row,
                                           frozen_spans=frozen)
    assert a["step"] == 3 and b["step"] == 0
    for x, y in ((ta, tb), (a["mu"], b["mu"]), (a["nu"], b["nu"])):
        assert torch.equal(x, y)
    assert not torch.equal(ta, torch.from_numpy(table))
    for lo, n in frozen:
        assert torch.equal(ta[lo:lo + n], torch.from_numpy(table[lo:lo + n]))
        assert not a["mu"][lo:lo + n].any()
    empty = torch.zeros(0, dtype=torch.long)
    poptim.sparse_adam_rowgrads_update(tb, b, torch.zeros(0, 4), empty, hp=row)
    poptim.sparse_adam_rowgrads_update(ta, a, torch.zeros(0, 4), empty)
    assert (a["step"], b["step"]) == (4, 0)


@pytest.mark.parametrize("frozen", [(), ((0, 5), (30, 10))], ids=["trainable", "frozen"])
def test_winner_update_without_a_mask_matches_jax(frozen):
    """The winner update, its rows written back by ``scatter_rows`` (its
    plain version here) with no mask index, against the JAX package's
    ``sparse_adam_rowgrads_update`` over three steps, ids at both edges of
    the table, duplicates and frozen spans: within the tolerance of
    test_torch_port_row_update.py's winner parity test; untouched rows
    bit-identical."""
    import jax.numpy as jnp

    import test_torch_port_row_update as row_tests
    from scenario_wise_rec_tpu.train import optim as joptim

    r = np.random.default_rng(4)
    ids, g, table = _winner_case(r)
    jt, js = jnp.asarray(table), joptim.sparse_adam_init(jnp.asarray(table))
    pt = torch.from_numpy(table.copy())
    ps = poptim.sparse_adam_init(pt)
    for step in range(3):
        gs = g * (step + 1)
        jt, js = joptim.sparse_adam_rowgrads_update(jt, js, jnp.asarray(gs), jnp.asarray(ids),
                                                    frozen_spans=frozen, **row_tests.KW)
        poptim.sparse_adam_rowgrads_update(pt, ps, torch.from_numpy(gs), torch.from_numpy(ids),
                                           frozen_spans=frozen, **row_tests.KW)
    assert ps["step"] == int(js["step"]) == 3
    for got, want, what in ((pt, jt, "table"), (ps["mu"], js["mu"], "mu"),
                            (ps["nu"], js["nu"], "nu")):
        row_tests._close(got, want, what)
    untouched = np.setdiff1d(np.arange(table.shape[0]), ids)
    assert untouched.size
    np.testing.assert_array_equal(pt.numpy()[untouched], table[untouched])


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_winner_result_does_not_depend_on_the_winning_duplicate(order):
    """Permuting the occurrences changes which duplicate of an id wins its
    slot: with gradients whose duplicate sums are exact in any order, the
    table, ``mu`` and ``nu`` come out the same, bit for bit, over three
    steps (a frozen span too)."""
    r = np.random.default_rng(5)
    ids, g, table = _winner_case(r, exact=True)
    perm = np.arange(ids.shape[0])[::-1] if order == "reversed" else r.permutation(ids.shape[0])
    out = []
    for i, gi in ((ids, g), (ids[perm], g[perm])):
        t = torch.from_numpy(table.copy())
        st = poptim.sparse_adam_init(t)
        for step in range(1, 4):
            poptim.sparse_adam_rowgrads_update(t, st, torch.from_numpy(gi * step),
                                               torch.from_numpy(i), frozen_spans=((30, 4),))
        out.append((t, st["mu"], st["nu"]))
    for x, y in zip(*out):
        assert torch.equal(x, y)
    assert not torch.equal(out[0][0], torch.from_numpy(table))
