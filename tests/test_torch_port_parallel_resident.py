"""Device-resident epochs on a ``(data, embed)`` mesh
(``CTRTrainer.train_one_epoch`` over a ``DeviceResidentLoader`` with
``mesh=...``), on the CPU: gloo groups of (2, 2) and (1, 2) ranks
(``_torch_port_parallel_worker.py``), one spawn a shape.

- (b) every rank holds the loader's columns, draws the same epoch ids and
  takes its rows of each global batch: one resident mesh epoch against the
  host-loader mesh epoch from the same init, 0 elements differing, in the
  ``sorted`` and ``occurrence`` updates at ``scan_steps`` 1 and 2, with a
  padded last batch (seven full batches and one of 5 real rows of 16), and
  the plain step; a planted fault (every data rank taking data rank 0's
  rows) must differ;
- one resident mesh epoch against the JAX trainer's resident mesh epoch at
  the same seed from one carried state, within the one-state training gate
  (``test_torch_port_parallel.one_state_gate``);
- ranks whose loaders disagree (another seed on each rank) raise on every
  rank.
"""

import os
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port_parallel_worker as W  # noqa: E402
import test_torch_port_parallel as P  # noqa: E402
import test_torch_port_parallel_batchwide as BW  # noqa: E402
import test_torch_port_parallel_modes as M  # noqa: E402
from scenario_wise_rec_tpu.data import dataset as jds  # noqa: E402
from scenario_wise_rec_tpu.data.device import DeviceResidentLoader as JLoader  # noqa: E402
from scenario_wise_rec_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402

SHAPES = [(2, 2), (1, 2)]
SHAPE_IDS = ["2x2", "1x2"]
N = 7 * W.B + 5
# (mode, scan_steps)
CASES = [("sorted", 1), ("sorted", 2), ("occurrence", 1), ("occurrence", 2), ("plain", 1)]
CASE_IDS = [f"{m}-s{s}" for m, s in CASES]
JAX_MODE = "sorted"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("resident"))
    spec = M._spec("mmoe", dropout=0.2)
    jobs = {shape: {} for shape in SHAPES}
    for shape in SHAPES:
        for mode, s in CASES:
            jobs[shape][f"{mode}-s{s}"] = dict(kind="resident", mode=mode, scan_steps=s,
                                               spec=spec, n=N, seed=11)
    jobs[(2, 2)]["fault"] = dict(jobs[(2, 2)]["sorted-s1"], fault="rank0_rows")
    jobs[(2, 2)]["mismatch"] = dict(kind="resident_mismatch", mode="sorted", spec=spec, n=N,
                                    seed=11)
    # the JAX resident mesh epoch from the JAX trainer's init, dropout 0
    jspec = BW._jax_spec("mmoe")
    jmesh = jmake_mesh(n_data=2, n_embed=2, devices=jax.devices()[:4])
    jt = BW._jax_trainer(jspec, jmesh, sparse_embedding_updates=True,
                         sparse_update_impl=JAX_MODE, sorted_block_rows=64)
    jobs[(2, 2)]["jax"] = dict(kind="resident", mode=JAX_MODE, spec=jspec, n=N, seed=11,
                               host=False,
                               jax_state=P._portable((jt.params, jt.state, jt.opt_state)))
    x, y = W.columns(N, 11)
    jt.train_one_epoch(JLoader(jds.ColumnarDataset(x, y), W.B, seed=11), log_interval=10**9)
    jt.barrier()
    t = W.mode_trainer(W.spec_model(jspec), JAX_MODE)
    from scenario_wise_rec_tpu_torch.interop import load_jax_trainer_state
    load_jax_trainer_state(t, *P._portable((jt.params, jt.state, jt.opt_state)))
    res = {shape: W.spawn(shape, jobs[shape], os.path.join(tmp, f"g{shape[0]}{shape[1]}"),
                          timeout=240)
           for shape in SHAPES}
    return SimpleNamespace(res=res, jax=W.state(t))


def _differ(a, b):
    """Elements that differ between two states, by entry."""
    assert sorted(a) == sorted(b)
    return {k: int((a[k] != b[k]).sum()) for k in a if not torch.equal(a[k], b[k])}


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_resident_mesh_epoch_equals_host_mesh_epoch(runs, case, shape):
    """0 elements differ on every rank: the same batches, rows, weights
    and dropout masks as the host loader's mesh epoch."""
    for rank, res in enumerate(runs.res[shape]):
        got = res[f"{case[0]}-s{case[1]}"]
        assert not _differ(got["resident"], got["host"]), (shape, rank)


def test_planted_row_fault_differs(runs):
    """Every data rank taking data rank 0's rows of each batch: the ranks
    of data rank 1 train on other rows, and the gate above sees it."""
    for rank, res in enumerate(runs.res[(2, 2)]):
        assert _differ(res["fault"]["resident"], res["fault"]["host"]), rank


def test_resident_mesh_epoch_matches_jax_resident_mesh_epoch(runs):
    """The (2, 2) resident epoch of the sorted update (8 steps, the last
    batch padded) from the JAX trainer's carried init against the JAX
    trainer's resident epoch under the same mesh and seed."""
    for rank, res in enumerate(runs.res[(2, 2)]):
        bad = P.one_state_gate(res["jax"]["resident"], runs.jax, {})
        assert not bad, f"rank {rank}: {bad[:6]}"


def test_ranks_with_other_loaders_raise(runs):
    for rank, res in enumerate(runs.res[(2, 2)]):
        assert "disagree" in res["mismatch"], (rank, res["mismatch"])
