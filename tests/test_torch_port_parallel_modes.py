"""The port's dense, occurrence and winner embedding updates and its plain
step on a ``(data, embed)`` mesh (``CTRTrainer(mesh=...)``), on the CPU:
MMOE in every mode, EPNet's and PPNet's plain steps with both of their
collections row-sharded, each with a loose table of its own width, at the
worker's small odd vocab (``_torch_port_parallel_worker.py``: 31 rows a
table).

- (a) ``param_specs`` row-shards every 2-D ``packed`` and ``tables`` entry
  (the JAX rule); ``fused_dense_adam_apply_sharded``'s plain version over E
  shards equals the unsharded one bit for bit; the differentiable sharded
  lookup's gradient is the whole table's gather's, shard by shard;
- (b) the first step on a (2, 2) gloo mesh against the JAX mesh trainer of
  the same shape on four CPU devices, both from one JAX state carried
  across by ``interop`` (a vocab of 32, which JAX's even row sharding
  needs), within ``test_torch_port_parallel.py``'s tolerances; with the
  occurrence update's sentinel replaced by ``id - row0`` (a planted fault)
  that gate must fail;
- (c) against the single-process port: a (2, 2) first step and a padded
  tail step (data rank 1 without a real row) within the training gate, and
  a (1, 2) mesh's ``fit`` (scan_steps 2, a padded last batch, validation
  and the metrics) bit for bit; the MMOE fits with a frozen ``Pretrained``
  table whose rows straddle the second shard's first row, kept fixed;
- (d) checkpoints: a (2, 2) ``fit``'s file loads in one process and on a
  (1, 2) mesh with 0 elements differing, and a JAX trainer's file of each
  mode loads into the (2, 2) mesh as into one process.

One module fixture spawns the (2, 2) group and then the (1, 2) group (which
loads the (2, 2) group's checkpoints), each rank running every job.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_port_parallel_worker as W  # noqa: E402
import test_torch_port_parallel as P  # noqa: E402
from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.core import init as jinit  # noqa: E402
from scenario_wise_rec_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch import parallel  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_trainer_state  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as pfa  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as psa  # noqa: E402

# (mode, model): the three lazy/exact updates and the plain step on MMOE,
# and the plain step of EPNet, PPNet and AdaSparse (two collections each)
CASES = [("dense", "mmoe"), ("occurrence", "mmoe"), ("winner", "mmoe"), ("plain", "mmoe"),
         ("plain", "epnet"), ("plain", "ppnet"), ("plain", "adasparse")]
IDS = [f"{mode}-{model}" for mode, model in CASES]
# the port-only runs: the worker's odd vocab, a loose table; the MMOE fits
# with a frozen table straddling row0
PORT = {"v": W.V, "loose": True}
JAX_V = 32  # JAX row-shards a table evenly only


def _spec(model, **kw):
    return dict(PORT, model=model, **kw)


def _jax_trainer(mode, model, mesh=None, seed=7):
    spec = {"model": model, "v": JAX_V, "loose": True}
    cls = getattr(jmodels, W.MODELS[model])
    kw = {} if mode == "plain" else dict(sparse_embedding_updates=True, sparse_update_impl=mode)
    return JTrainer(cls(**W.model_kwargs(jf, jinit, spec)), mesh=mesh, seed=seed, **kw), spec


def _jax_after_step(jt, spec, mode, b):
    """One JAX mesh step on ``b``: its loss, and its state as the port's
    checkpoint entries (carried into a one-process port trainer)."""
    loss = P._jax_step(jt, b)
    t = W.mode_trainer(W.spec_model(spec), mode)
    load_jax_trainer_state(t, *P._portable((jt.params, jt.state, jt.opt_state)))
    return loss, W.state(t)


# tail step: the global batch's last 8 rows, all of data rank 1's, weight 0
STEP_BATCHES = [W.batch(50), W.batch(51, ragged=W.B // 2)]
FIT = dict(kind="mode_fit", seed=11, n=7 * W.B + 5)
# the (2, 2) fits that run again with the dense gradients left unsummed over
# ``data`` (a planted fault the free-running fits' control rule must see)
FAULT_FITS = ["plain-adasparse", "dense-mmoe"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("modes"))
    jobs22, jobs12, jax_ref = {}, {}, {}
    b = W.batch(21, ragged=3)
    jmesh = jmake_mesh(n_data=2, n_embed=2, devices=jax.devices()[:4])
    for mode, model in CASES:
        name = f"{mode}-{model}"
        jt, spec = _jax_trainer(mode, model, jmesh)
        carried = P._portable((jt.params, jt.state, jt.opt_state))
        jobs22[f"jax {name}"] = dict(kind="mode_jax_step", mode=mode, spec=spec, batch=b,
                                     jax_state=carried)
        if mode == "occurrence":
            jobs22["fault"] = dict(jobs22[f"jax {name}"], fault="sentinel")
        jax_ref[name] = _jax_after_step(jt, spec, mode, b)
        jobs22[f"steps {name}"] = dict(kind="mode_steps", mode=mode, spec=_spec(model),
                                       batches=STEP_BATCHES)
        fit_spec = _spec(model, frozen=model == "mmoe", dropout=0.2 if model == "mmoe" else 0)
        for shape, jobs in (("22", jobs22), ("12", jobs12)):
            jobs[f"fit {name}"] = dict(FIT, mode=mode, spec=fit_spec,
                                       dir=os.path.join(tmp, f"fit{shape}-{name}"))
        if name in FAULT_FITS:
            jobs22[f"fit fault {name}"] = dict(jobs22[f"fit {name}"], fault="unsummed_grads",
                                               dir=os.path.join(tmp, f"fault22-{name}"))
        # a single-device JAX trainer's checkpoint after one step
        jt1, spec1 = _jax_trainer(mode, model, seed=9)
        x, y, w = (jax.tree_util.tree_map(jnp.asarray, a) for a in W.batch(40))
        jt1.params, jt1.opt_state, jt1.state, _ = jt1._train_step(
            jt1.params, jt1.opt_state, jt1.state, x, y, w, jax.random.PRNGKey(1))
        jt1.save(os.path.join(tmp, f"jax-{name}"))
        jobs22[f"load jax {name}"] = dict(kind="mode_load_save", mode=mode, spec=spec1,
                                          path=os.path.join(tmp, f"jax-{name}.npz"),
                                          out=os.path.join(tmp, f"jax-again-{name}"))
    res22 = W.spawn((2, 2), jobs22, os.path.join(tmp, "g22"), timeout=240)
    for mode, model in CASES:
        name = f"{mode}-{model}"
        jobs12[f"load {name}"] = dict(kind="mode_load_save", mode=mode,
                                      spec=jobs22[f"fit {name}"]["spec"],
                                      path=res22[0][f"fit {name}"]["path"],
                                      out=os.path.join(tmp, f"again12-{name}"))
    res12 = W.spawn((1, 2), jobs12, os.path.join(tmp, "g12"), timeout=240)
    one = {}
    with W.one_thread():
        for mode, model in CASES:
            name = f"{mode}-{model}"
            one[f"steps {name}"] = W.run_mode_steps(None, jobs22[f"steps {name}"])
            one[f"fit {name}"] = W.run_mode_fit(None, dict(jobs22[f"fit {name}"],
                                                           dir=os.path.join(tmp, f"fit1-{name}")))
            # the control of the free-running (2, 2) fit: one process, each
            # batch padded by MESH_PAD weight-0 rows
            one[f"control {name}"] = W.run_mode_fit(None, dict(
                jobs22[f"fit {name}"], dir=os.path.join(tmp, f"control-{name}"),
                pad_rows=P.MESH_PAD))
    return SimpleNamespace(res22=res22, res12=res12, one=one, jax=jax_ref, jobs22=jobs22,
                           tmp=tmp)


# -- (a) the pieces ------------------------------------------------------------

def test_param_specs_shard_every_table():
    """Every collection's packed table and every loose table, 2-D, and
    nothing else (EPNet's two collections included)."""
    for model in ("mmoe", "epnet"):
        m = W.spec_model(_spec(model))
        specs = parallel.param_specs(m)
        want = {k for k, v in m.state_dict().items()
                if v.ndim == 2 and ({"packed", "tables"} & set(k.split(".")))}
        assert {k for k, s in specs.items() if s == "embed"} == want
        assert want >= ({"sce_embedding.packed", "agn_embedding.packed",
                         "agn_embedding.tables.narrow"} if model == "epnet"
                        else {"embedding.packed", "embedding.tables.narrow"})


@pytest.mark.parametrize("e", [2, 3])
def test_fused_sharded_plain_version_matches_unsharded(e):
    """``fused_dense_adam_apply_sharded`` on the CPU (its plain version)
    over E shards of a padded table, ids on the boundaries, equals the
    unsharded form bit for bit."""
    d, v, k = 8, 301, 96
    r = np.random.default_rng(e)
    rows = parallel.pad_vocab(v, e) // e
    ids = r.integers(0, v, k)
    ids[:3 * (e - 1)] = np.repeat([j * rows for j in range(1, e)], 3)
    sizes = [40, 56]
    sid, pos, _ = _segment_sorted(torch.from_numpy(ids), sizes)
    g = torch.from_numpy(r.normal(size=(k, d)).astype(np.float32))
    start = [torch.from_numpy(r.normal(size=(v, d)).astype(np.float32)),
             torch.full((v, d), 1e-3), torch.full((v, d), 1e-6)]
    hp = psa.adam_hparams(2, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    whole = [t.clone() for t in start]
    pfa.fused_dense_adam_apply(*whole, g, sid, pos, sizes, hp)
    shards = [torch.cat([t, torch.zeros(rows * e - v, d)]) for t in start]
    before = pfa.fused_dense_adam_apply.launches_sharded
    for j in range(e):
        pfa.fused_dense_adam_apply_sharded(*(t[j * rows:(j + 1) * rows] for t in shards), g, sid,
                                           pos, sizes, hp, row0=j * rows)
    assert pfa.fused_dense_adam_apply.launches_sharded == before  # the CPU launches nothing
    for a, b in zip(shards, whole):
        assert torch.equal(a[:v], b)
    with pytest.raises(ValueError, match="row0"):
        pfa.fused_dense_adam_apply_sharded(*start, g, sid, pos, sizes, hp, row0=-1)


def _segment_sorted(ids, sizes):
    from scenario_wise_rec_tpu_torch.train.optim import segment_sorted_ids

    segs, at = [], 0
    for i, z in enumerate(sizes):
        segs.append((f"o{i}", at, z))
        at += z
    return segment_sorted_ids(ids, segs)


def test_sharded_gather_gradient_is_the_shards_of_the_whole_gradient():
    """``ShardedLookup``'s backward on each shard of E = 2, 3 (no group:
    the parts summed by hand) equals the rows of the whole table's gather's
    gradient bit for bit, duplicates and boundary ids included."""
    from scenario_wise_rec_tpu_torch.parallel.sharded_embedding import ShardedLookup

    r = np.random.default_rng(4)
    v, d = 37, 8
    table = torch.from_numpy(r.normal(size=(v, d)).astype(np.float32)).requires_grad_()
    ids = torch.from_numpy(r.integers(0, v, (6, 5)))
    ids[0] = torch.tensor([18, 19, 18, 0, 36])
    up = torch.from_numpy(r.normal(size=(6, 5, d)).astype(np.float32))
    (table[ids] * up).sum().backward()
    for e in (2, 3):
        rows = parallel.pad_vocab(v, e) // e
        full = torch.cat([table.detach(), torch.zeros(rows * e - v, d)])
        grads = []
        for j in range(e):
            local = full[j * rows:(j + 1) * rows].clone().requires_grad_()
            ctx = SimpleNamespace(saved_tensors=(ids,), row0=j * rows, rows=rows)
            grads.append(ShardedLookup.backward(ctx, up)[0])
        assert torch.equal(torch.cat(grads)[:v], table.grad), e


# -- (b) against the JAX mesh trainer -----------------------------------------

def _jax_gate(got, loss, want_loss, want):
    """The first step's gate against JAX: the loss within LOSS_ATOL, every
    sharded table within TABLE_ATOL and its moments within MU_ATOL (the
    JAX package's own mesh-against-one-device tolerances)."""
    bad = []
    if abs(loss - want_loss) > P.LOSS_ATOL:
        bad.append(f"loss {loss} vs {want_loss}")
    for k, v in want.items():
        tab = k.startswith("model/") and (k.endswith(".packed") or ".tables." in k)
        mom = k.startswith("opt/emb/") or (k.startswith("opt/base/") and (
            ".packed/" in k or ".tables." in k) and not k.endswith("/step"))
        if not (tab or mom):
            continue
        gap = float((got[k].float() - v.float()).abs().max())
        if gap > (P.TABLE_ATOL if tab else P.MU_ATOL):
            bad.append(f"{k} off by {gap:.3e}")
    return bad


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_first_step_matches_jax_mesh_trainer(runs, case):
    name = f"{case[0]}-{case[1]}"
    want_loss, want = runs.jax[name]
    for rank, res in enumerate(runs.res22):
        got = res[f"jax {name}"]
        assert sorted(got["state"]) == sorted(want)
        bad = _jax_gate(got["state"], got["loss"], want_loss, want)
        assert not bad, f"rank {rank}: {bad}"


def test_planted_sentinel_fault_fails_the_jax_gate(runs):
    """The occurrence update with ``id - row0`` for the sentinel: shard 1's
    write-back wraps shard 0's ids onto its tail rows, which the gate sees."""
    want_loss, want = runs.jax["occurrence-mmoe"]
    for res in runs.res22:
        got = res["fault"]
        assert _jax_gate(got["state"], got["loss"], want_loss, want)


# -- (c) against one process --------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_steps_match_one_process(runs, case):
    """(2, 2): the first step and then a padded tail step (data rank 1
    without a real row), each rank's loss and whole state within the
    training gate of ``test_torch_port_parallel.py``."""
    name = f"{case[0]}-{case[1]}"
    one = runs.one[f"steps {name}"]
    for rank, res in enumerate(runs.res22):
        got = res[f"steps {name}"]
        for i, (a, b) in enumerate(zip(got["losses"], one["losses"])):
            assert abs(a - b) <= P.LOSS_ATOL, (rank, i, a, b)
            P._assert_close_state(got["states"][i], one["states"][i], i + 1,
                                  f"{name} rank {rank} step {i + 1}")


def test_adasparse_steps_under_the_one_state_gate(runs):
    """AdaSparse's plain step on (2, 2), whose pruners read every batch
    row's scenario embedding: the first and the padded step against one
    process, and the first step against the JAX mesh trainer, under the
    one-state gate of ``test_torch_port_parallel.py`` (the gates above hold
    the tables and moments to absolute tolerances only)."""
    name = "plain-adasparse"
    one = runs.one[f"steps {name}"]
    want_loss, want = runs.jax[name]
    for rank, res in enumerate(runs.res22):
        got, noisy = res[f"steps {name}"], {}
        for i, (a, b) in enumerate(zip(got["losses"], one["losses"])):
            assert abs(a - b) <= P.ONE_STATE_LOSS_ATOL, (rank, i, a, b)
            bad = P.one_state_gate(got["states"][i], one["states"][i], noisy)
            assert not bad, f"rank {rank} step {i + 1}: {bad[:6]}"
        got = res[f"jax {name}"]
        assert abs(got["loss"] - want_loss) <= P.ONE_STATE_LOSS_ATOL, rank
        bad = P.one_state_gate(got["state"], want, {})
        assert not bad, f"rank {rank} against JAX: {bad[:6]}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_fit_matches_one_process(runs, case):
    """``fit`` on the (1, 2) mesh equals one process bit for bit (losses,
    metrics, state); on the (2, 2) mesh the state within the training gate,
    the loss lines and metrics within the control rule of
    ``test_torch_port_parallel.py`` (``_free_run_gaps`` against the padded
    one-process control), every rank's metrics alike. The MMOE fits hold a frozen table straddling the
    second shard's first row: its rows keep their pretrained values and,
    in the plain step, zero moments."""
    mode, model = case
    name = f"{mode}-{model}"
    one = runs.one[f"fit {name}"]
    for rank, res in enumerate(runs.res12):
        fit = res[f"fit {name}"]
        assert fit["log"] == one["log"] and fit["metrics"] == one["metrics"], rank
        assert fit["step"] == one["step"]
        for k, v in one["state"].items():
            assert torch.equal(fit["state"][k], v), f"(1, 2) rank {rank}: {k}"
        assert not any(fit["launches"].values())  # the CPU launches no kernel
    for rank, res in enumerate(runs.res22):
        fit = res[f"fit {name}"]
        assert fit["metrics"] == runs.res22[0][f"fit {name}"]["metrics"]
        assert len(fit["log"]) == len(one["log"]) and fit["log"]
        for a, b in zip(fit["log"], one["log"]):
            assert a.split("loss")[0] == b.split("loss")[0]
        outside = P._free_run_gaps(fit, one, runs.one[f"control {name}"])
        assert not outside, f"(2, 2) {name} rank {rank}: {outside}"
        P._assert_close_state(fit["state"], one["state"], 16, f"(2, 2) {name} rank {rank}")
    if model == "mmoe":
        v = W.V
        table = one["state"]["model/embedding.packed"]
        frozen = torch.from_numpy(W.frozen_weights(v))
        for st in [one["state"]] + [r[f"fit {name}"]["state"] for r in runs.res22]:
            assert torch.equal(st["model/embedding.packed"][v:2 * v], frozen)
            if mode == "plain":
                assert not st["opt/base/embedding.packed/exp_avg"][v:2 * v].any()
        # and the other tables moved
        assert not torch.equal(table[:v], W.spec_model(_spec("mmoe", frozen=True), 11)
                               .embedding.packed.detach()[:v])


@pytest.mark.parametrize("name", FAULT_FITS)
def test_planted_data_axis_fault_fails_the_mesh_fit_gate(runs, name):
    """The (2, 2) fit with the dense gradients left unsummed over ``data``:
    the control rule of ``test_mesh_fit_matches_one_process`` sees it on
    every rank."""
    one, control = runs.one[f"fit {name}"], runs.one[f"control {name}"]
    for rank, res in enumerate(runs.res22):
        assert P._free_run_gaps(res[f"fit fault {name}"], one, control), rank


# -- (d) checkpoints ------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_checkpoints_move_between_mesh_shapes(runs, case):
    """The (2, 2) fit's checkpoint: one process loads it and holds its
    gathered state with 0 elements differing; the (1, 2) mesh loads it and
    saves the same tensors again."""
    mode, model = case
    name = f"{mode}-{model}"
    fit = runs.res22[0][f"fit {name}"]
    t = W.mode_trainer(W.spec_model(runs.jobs22[f"fit {name}"]["spec"], 5), mode)
    meta = t.load(fit["path"])
    assert meta["mesh"] == {"data": 2, "embed": 2}
    for k, v in W.state(t).items():
        assert torch.equal(v, fit["state"][k]), k
    a, b = P._npz(fit["path"]), P._npz(runs.res12[0][f"load {name}"]["path"])
    assert sorted(a) == sorted(b)
    differ = [k for k in a if k != "__metadata__" and not np.array_equal(a[k], b[k])]
    assert not differ
    for res in runs.res12:
        for k, v in res[f"load {name}"]["state"].items():
            assert torch.equal(v, fit["state"][k]), k


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_checkpoint_loads_into_the_mesh(runs, case):
    """A single-device JAX trainer's checkpoint of each mode: the (2, 2)
    mesh loads its rows and saves what one process that loaded the file
    saves, bit for bit but for the metadata."""
    mode, model = case
    name = f"{mode}-{model}"
    job = runs.jobs22[f"load jax {name}"]
    t = W.mode_trainer(W.spec_model(job["spec"], 5), mode)
    t.load(job["path"])
    one = P._npz(t.save(os.path.join(runs.tmp, f"jax-one-{name}")))
    got = P._npz(runs.res22[0][f"load jax {name}"]["path"])
    assert sorted(got) == sorted(one)
    for k in one:
        if k != "__metadata__":
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
