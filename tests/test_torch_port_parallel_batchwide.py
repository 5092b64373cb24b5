"""The port's batch-wide operations and fused eval on a ``(data, embed)``
mesh (``CTRTrainer(mesh=...)``), on the CPU: gloo groups of (2, 1) and
(2, 2) ranks (``_torch_port_parallel_worker.py``), one spawn a shape.

- (a) M2M's transformer attends over the global batch (every self- and
  cross-attention's keys, values and key mask gathered over ``data``,
  ``parallel.mesh.all_gather_rows_autograd``) and AdaptDHM's EMA centers
  move by the global batch's weighted sums: the plain step's first step
  and a padded one (data rank 1 without a real row) against one process,
  M2M's transformer with dropout 0.1 (its attention masks must be one
  process's), and the first step against the JAX mesh trainer on four
  CPU devices from one carried state, under the one-state training gate
  below. Planted faults: attention over this rank's keys only, and a
  center update over this rank's rows only; each must fail the gate.
- (c) fused eval on the (2, 2) mesh (``fused_inference=True``; on the CPU
  the kernels' plain versions) of MMOE, STAR, HamurLarge, AdaptDHM and M2M
  from a JAX mesh trainer's state after one step: probabilities within
  ``PRED_ATOL`` of op-by-op mesh eval and of the JAX trainer's fused eval
  under the same mesh (its Pallas kernels in interpret mode), the
  metrics within the eval gate, every rank's metrics equal, on the host
  and on the device.

The training gate is ``test_torch_port_parallel.one_state_gate``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port_parallel_worker as W  # noqa: E402
import test_torch_port_parallel as P  # noqa: E402
import test_torch_port_parallel_modes as M  # noqa: E402
from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.core import init as jinit  # noqa: E402
from scenario_wise_rec_tpu.data import dataset as jds  # noqa: E402
from scenario_wise_rec_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.parallel import mesh as pmesh  # noqa: E402

# the eval gate (PERF.md §2): probabilities, and AUC / logloss of the
# ~53-row loader, whose ties and threshold rows the probabilities' gate
# already bounds
PRED_ATOL, METRIC_ATOL = 1e-5, 1e-4

# the two models with a batch-wide op besides BatchNorm, and the fault each
# gate must see (_torch_port_parallel_worker.planted)
STEP_MODELS = {"m2m": "local_keys", "adaptdhm": "local_centers"}
SHAPES = [(2, 1), (2, 2)]
SHAPE_IDS = ["2x1", "2x2"]
# fused eval: each model and its kernel's launch counter (module, function)
EVAL_MODELS = {"mmoe": ("mmoe_infer", "mmoe_fused_infer"),
               "star": ("star_infer", "star_fused_infer"),
               "hamur": ("hamur_infer", "hamur_segment"),
               "adaptdhm": ("adaptdhm_infer", "adaptdhm_fused_infer"),
               "m2m": ("m2m_infer", "m2m_fused_infer")}
STEP_BATCHES = [W.batch(50), W.batch(51, ragged=W.B // 2)]


def _spec(model, **kw):
    """The worker's odd vocab, a loose table, tables from N(0, 0.5)."""
    return dict(dict(v=W.V, loose=True, model=model, emb_std=0.5), **kw)


def _jax_spec(model, **kw):
    """The JAX mesh trainer's: a vocab of 32 (JAX row-shards tables evenly
    only), dropout 0 (the two packages' dropout streams differ)."""
    return dict(_spec(model, v=M.JAX_V), **kw)


def _jax_trainer(spec, jmesh, **kw):
    cls = getattr(jmodels, W.MODELS[spec["model"]])
    return JTrainer(cls(**W.model_kwargs(jf, jinit, spec)), mesh=jmesh, seed=7, **kw)


def _jax_eval(jt, seed):
    """The JAX trainer's probabilities and per-domain metrics on the
    worker's eval loader."""
    x, y, _ = W.batch(seed, b=3 * W.B + 5)
    loader = lambda: jds.BatchIterable(jds.ColumnarDataset(x, y), W.B, shuffle=False)
    return (np.asarray(jt.predict(jt.model, loader())),
            jt.evaluate_multi_domain_loss(jt.model, loader(), W.DOMAINS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("batchwide"))
    b = W.batch(21, ragged=3)
    jobs = {shape: {} for shape in SHAPES}
    jax_ref, jax_eval = {}, {}
    for shape in SHAPES:
        jmesh = jmake_mesh(n_data=shape[0], n_embed=shape[1],
                           devices=jax.devices()[:shape[0] * shape[1]])
        for model, fault in STEP_MODELS.items():
            steps = dict(kind="mode_steps", mode="plain", batches=STEP_BATCHES,
                         spec=_spec(model, dropout=0.1))
            jobs[shape][f"steps {model}"] = steps
            jobs[shape][f"fault {model}"] = dict(steps, fault=fault)
            spec = _jax_spec(model)
            jt = _jax_trainer(spec, jmesh)
            jobs[shape][f"jax {model}"] = dict(
                kind="mode_jax_step", mode="plain", spec=spec, batch=b,
                jax_state=P._portable((jt.params, jt.state, jt.opt_state)))
            jax_ref[shape, model] = M._jax_after_step(jt, spec, "plain", b)
        if shape != (2, 2):
            continue
        for model, (mod, fn) in EVAL_MODELS.items():
            spec = _jax_spec(model)
            jt = _jax_trainer(spec, jmesh, fused_inference=True)
            P._jax_step(jt, W.batch(60))  # running stats and weights off their init
            jobs[shape][f"eval {model}"] = dict(
                kind="eval", spec=spec, seed=61,
                launches=(f"scenario_wise_rec_tpu_torch.ops.kernels.{mod}", fn),
                jax_state=P._portable((jt.params, jt.state, jt.opt_state)))
            jax_eval[model] = _jax_eval(jt, 61)
    res = {shape: W.spawn(shape, jobs[shape], os.path.join(tmp, f"g{shape[0]}{shape[1]}"),
                          timeout=240)
           for shape in SHAPES}
    with W.one_thread():
        one = {model: W.run_mode_steps(None, jobs[SHAPES[0]][f"steps {model}"])
               for model in STEP_MODELS}
        one_eval = {model: W.run_eval(None, jobs[(2, 2)][f"eval {model}"])
                    for model in EVAL_MODELS}
    return SimpleNamespace(res=res, one=one, jax=jax_ref, jax_eval=jax_eval, one_eval=one_eval)


# -- the pieces ------------------------------------------------------------------

def test_all_gather_rows_autograd_without_a_group_is_the_identity():
    """A group of one: the tensor itself, its gradient untouched; the
    ranks' agreement check passes."""
    t = torch.arange(6.0).reshape(3, 2).requires_grad_()
    out = pmesh.all_gather_rows_autograd(t, None)
    assert out is t
    pmesh.same_on_every_rank(pmesh.make_mesh(1, 1), ("anything",), "a value")


# -- (a) M2M and AdaptDHM steps ----------------------------------------------------

def _steps_gate(got, one):
    bad, noisy = [], {}
    for i, (a, b) in enumerate(zip(got["losses"], one["losses"])):
        if abs(a - b) > P.ONE_STATE_LOSS_ATOL:
            bad.append(f"step {i + 1} loss {a} vs {b}")
        bad += [f"step {i + 1}: {x}" for x in P.one_state_gate(got["states"][i],
                                                              one["states"][i], noisy)]
    return bad


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("model", list(STEP_MODELS))
def test_mesh_steps_match_one_process(runs, model, shape):
    """The first step and a padded step (data rank 1 without a real row)
    with M2M's transformer dropout at 0.1, every rank against one process
    under the one-state gate."""
    for rank, res in enumerate(runs.res[shape]):
        bad = _steps_gate(res[f"steps {model}"], runs.one[model])
        assert not bad, f"{shape} rank {rank}: {bad[:6]}"


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("model", list(STEP_MODELS))
def test_planted_fault_fails_the_gate(runs, model, shape):
    """Attention over this rank's keys only (M2M), or centers moved by this
    rank's rows only (AdaptDHM): the same gate must fail on every rank."""
    for rank, res in enumerate(runs.res[shape]):
        assert _steps_gate(res[f"fault {model}"], runs.one[model]), (shape, rank)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("model", list(STEP_MODELS))
def test_mesh_step_matches_jax_mesh_trainer(runs, model, shape):
    """The first step on a batch with 3 padded rows from the JAX mesh
    trainer's carried state: every rank against the JAX trainer's step
    under the same mesh, the one-state gate."""
    want_loss, want = runs.jax[shape, model]
    for rank, res in enumerate(runs.res[shape]):
        got = res[f"jax {model}"]
        assert abs(got["loss"] - want_loss) <= P.ONE_STATE_LOSS_ATOL, (rank, got["loss"],
                                                                      want_loss)
        bad = P.one_state_gate(got["state"], want, {})
        assert not bad, f"{shape} rank {rank}: {bad[:6]}"


# -- (c) fused eval on the mesh ------------------------------------------------------

def _metrics_close(a, b):
    """Per-domain and overall (logloss, AUC) within the eval gate."""
    ll, auc, tll, tauc = a
    ll1, auc1, tll1, tauc1 = b
    np.testing.assert_allclose(ll + auc + [tll, tauc], ll1 + auc1 + [tll1, tauc1], rtol=0,
                               atol=METRIC_ATOL)


@pytest.mark.parametrize("model", list(EVAL_MODELS))
def test_fused_mesh_eval_matches_op_by_op_and_jax(runs, model):
    """(2, 2): fused against op-by-op mesh eval on every rank, and against
    the JAX trainer's fused eval under the same mesh and the port's fused
    eval in one process; every rank's metrics equal, host and device
    scoring alike; on the CPU no kernel launches."""
    want_p, want_m = runs.jax_eval[model]
    one = runs.one_eval[model]["fused"]
    for rank, res in enumerate(runs.res[(2, 2)]):
        got = res[f"eval {model}"]
        fused, op = got["fused"], got["op"]
        what = f"{model} rank {rank}"
        np.testing.assert_allclose(fused["probs"], op["probs"], rtol=0, atol=PRED_ATOL,
                                   err_msg=what)
        np.testing.assert_allclose(fused["probs"], want_p, rtol=0, atol=PRED_ATOL, err_msg=what)
        np.testing.assert_allclose(fused["probs"], one["probs"], rtol=0, atol=PRED_ATOL,
                                   err_msg=what)
        _metrics_close(fused["metrics"], op["metrics"])
        _metrics_close(fused["metrics"], want_m)
        _metrics_close(fused["device"], fused["metrics"])
        first = runs.res[(2, 2)][0][f"eval {model}"]
        for path in ("fused", "op"):
            assert got[path]["metrics"] == first[path]["metrics"], (what, path)
            assert got[path]["device"] == first[path]["device"], (what, path)
        assert fused["launches"] == op["launches"] == 0
