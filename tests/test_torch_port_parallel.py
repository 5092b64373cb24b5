"""The port's multi-GPU training path (``scenario_wise_rec_tpu_torch/parallel``)
against the JAX package's and against the port's single-process trainer, on
the CPU.

- (a) ``sharded_lookup``: the shards' parts over E in {1, 2, 3, 4} sum to a
  whole-table gather bit for bit, and equal JAX's ``make_sharded_lookup_fn``
  on a ``make_mesh(2, 4)`` CPU mesh; the port's ``make_sharded_lookup_fn``
  over each process group's ``embed`` ranks;
- (b) ``sorted_dense_adam_apply_sharded``'s plain version over E shards
  (V not a multiple of E, so padded; ids on the boundaries, duplicates, a
  frozen span across a boundary; f32 and bf16) against the unsharded plain
  version and against JAX's sharded kernel in interpret mode;
- (c) gloo process groups of (2, 2), (1, 2) and (2, 1) ranks
  (``_torch_port_parallel_worker.py``): one step against the JAX mesh
  trainer of the same shape from its carried state, and ``fit`` with
  ``scan_steps=2``, dropout 0.2 and a padded last batch against the
  single-process port;
- (d) a checkpoint written at (2, 2) loads at world size 1, and one written
  at world size 1 loads at (2, 2), bit for bit;
- (e) what a mesh refuses, each with its ROADMAP item.

Every rank group is spawned with its own timeout and rendezvous file under
the test's temporary directory (no TCP port), one thread a rank.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_port_parallel_worker as W  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.ops.pallas import sorted_adam as jsa  # noqa: E402
from scenario_wise_rec_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from scenario_wise_rec_tpu.parallel.sharded_embedding import (  # noqa: E402
    make_sharded_lookup_fn as jlookup_fn)
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu.train import optim as joptim  # noqa: E402
from scenario_wise_rec_tpu_torch import parallel  # noqa: E402
from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as psa  # noqa: E402
from scenario_wise_rec_tpu_torch.parallel.sharded_embedding import local_lookup  # noqa: E402
from scenario_wise_rec_tpu_torch.train import optim as poptim  # noqa: E402

# one step against the JAX mesh trainer: tests/test_parallel.py's own
# tolerances for its mesh against one device
LOSS_ATOL, TABLE_ATOL, MU_ATOL = 1e-6, 2e-5, 1e-5
# the mesh against the single-process port over a fit of 16 steps: the two
# sum the batch statistics, the loss and the dense gradients in other orders
# (~1e-7 relative), and 16 Adam steps carry that as the JAX package's own
# mesh-against-one-device check allows (weights TABLE_ATOL, moments MU_ATOL),
# with tests/test_torch_port_train.py's relative part
STEP_RTOL = 1e-4
# a Linear bias before a train-mode BatchNorm (and BN's running mean, which
# follows it) has an exactly zero gradient, all rounding noise: Adam moves it
# up to lr each step in a direction the summation order picks, so two
# correct runs part by up to 2 lr a step
LR = 1e-3


def _bn_cancelled(key):
    import re
    return re.search(r"layers\.\d+\.(lin\.b|bn\.mean)$", key) is not None


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _portable(tree):
    """A JAX trainer's state as numpy, optax's Adam state as a plain
    namespace of ``count``/``mu``/``nu`` (what ``interop`` reads), so the
    rank processes can unpickle it without JAX."""
    if hasattr(tree, "_fields"):
        if all(hasattr(tree, f) for f in ("count", "mu", "nu")):
            return SimpleNamespace(count=np.asarray(tree.count), mu=_np(tree.mu),
                                   nu=_np(tree.nu))
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_portable(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _portable(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


# -- (a) the sharded lookup ---------------------------------------------------

def test_sharded_lookup_equals_whole_table_gather_and_jax():
    r = np.random.default_rng(0)
    table = torch.from_numpy(r.normal(size=(37, 8)).astype(np.float32))
    ids = torch.from_numpy(r.integers(0, 37, (4, 6)))
    ids[0, :4] = torch.tensor([0, 36, 9, 10])
    for e in (1, 2, 3, 4):
        rows = parallel.pad_vocab(37, e) // e
        full = torch.cat([table, torch.zeros(rows * e - 37, 8)])
        parts = [local_lookup(full[j * rows:(j + 1) * rows], ids, j * rows) for j in range(e)]
        got = parts[0]
        for part in parts[1:]:
            got = got + part
        assert torch.equal(got, table[ids]), e
        # one rank's view, no group: its own shard is the whole table
        if e == 1:
            assert torch.equal(parallel.sharded_lookup(table, ids, 0, None), table[ids])
    mesh = jmake_mesh(n_data=2, n_embed=4)
    sharded, lookup = jlookup_fn(mesh, jnp.asarray(table.numpy()))
    want = np.asarray(lookup(sharded, jnp.asarray(ids.numpy())))
    rows = parallel.pad_vocab(37, 4) // 4
    full = torch.cat([table, torch.zeros(rows * 4 - 37, 8)])
    got = sum(local_lookup(full[j * rows:(j + 1) * rows], ids, j * rows) for j in range(4))
    np.testing.assert_array_equal(got.numpy(), want)


# -- (b) the sharded update's plain version ----------------------------------

def _shard_mesh(e, j):
    """Rank ``j`` of a (1, e) mesh, without a process group: the update's
    collectives over ``data`` are then none."""
    return parallel.Mesh(1, e, j, None, None, None, None)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("e", [2, 3])
def test_sharded_update_plain_version_matches_unsharded_and_jax(dtype, e):
    """The shards' ``sorted_dense_adam_update(mesh=...)`` (the sharded plain
    version) concatenated equal the unsharded plain version bit for bit and
    JAX's ``sorted_dense_adam_update(mesh=...)`` through the shard_map'd
    Pallas kernel in interpret mode (f32: the JAX test's 2e-5 / 1e-5 of
    tests/test_parallel.py; bf16: the stored values within one bf16 ulp,
    the two frameworks' f32 sums rounding apart)."""
    d, v, k = 8, 301, 96  # V not a multiple of e: padded
    r = np.random.default_rng(e)
    rows = parallel.pad_vocab(v, e) // e
    ids = r.integers(0, v, k)
    bounds = [j * rows + o for j in range(1, e) for o in (-1, 0)]
    ids[:3 * len(bounds)] = np.repeat(bounds, 3)  # boundary ids, each three times
    g = r.normal(size=(k, d)).astype(np.float32) * 1e-2
    table = r.normal(size=(v, d)).astype(np.float32)
    frozen = ((rows - 5, 10),)  # across the first boundary
    kw = dict(lr=1e-3, weight_decay=1e-5, b1=0.9, b2=0.999, eps=1e-8, frozen_spans=frozen)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    # the kernel's plain versions themselves: the shards' re-based steps
    # concatenated are the unsharded step
    sid, gs = psa.owner_sorted_grads(torch.from_numpy(ids), torch.from_numpy(g))
    hp = psa.adam_hparams(2, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    start = [torch.from_numpy(table).to(tdt), torch.full((v, d), 1e-3).to(tdt),
             torch.full((v, d), 1e-6).to(tdt)]
    whole = [t.clone() for t in start]
    psa.sorted_dense_adam_apply_ref(*whole, sid, gs, hp)
    shards = [torch.cat([t, torch.zeros(rows * e - v, d, dtype=tdt)]) for t in start]
    for j in range(e):
        psa.sorted_dense_adam_apply_sharded_ref(*(t[j * rows:(j + 1) * rows] for t in shards),
                                                sid, gs, hp, row0=j * rows)
    for a, b in zip(shards, whole):
        assert torch.equal(a[:v], b)
    # the update: the unsharded plain version
    whole = poptim.sorted_dense_adam_init(torch.from_numpy(table), dtype=tdt)
    wt = whole.get("table", torch.from_numpy(table).clone())
    poptim.sorted_dense_adam_update(wt, whole, torch.from_numpy(g), torch.from_numpy(ids), **kw)
    # the shards
    full = torch.cat([torch.from_numpy(table), torch.zeros(rows * e - v, d)])
    got = {"table": [], "mu": [], "nu": []}
    for j in range(e):
        st = poptim.sorted_dense_adam_init(full[j * rows:(j + 1) * rows].clone(), dtype=tdt)
        t = st.get("table", full[j * rows:(j + 1) * rows].clone())
        poptim.sorted_dense_adam_update(t, st, torch.from_numpy(g), torch.from_numpy(ids),
                                        mesh=_shard_mesh(e, j), segments=(("s", 0, k),), **kw)
        for name, x in (("table", t), ("mu", st["mu"]), ("nu", st["nu"])):
            got[name].append(x)
    got = {name: torch.cat(x)[:v] for name, x in got.items()}
    for name, want in (("table", wt), ("mu", whole["mu"]), ("nu", whole["nu"])):
        assert torch.equal(got[name], want), name
    frozen_rows = slice(rows - 5, rows + 5)
    assert torch.equal(got["table"][frozen_rows].float(),
                       torch.from_numpy(table[frozen_rows]).to(tdt).float())
    assert not got["mu"][frozen_rows].float().any()
    # JAX: its sharded kernel on a (2, e) mesh, the ids replicated
    mesh = jmake_mesh(n_data=2, n_embed=e, devices=jax.devices()[:2 * e])
    jst = joptim.sorted_dense_adam_init(jnp.asarray(table), block_rows=64,
                                        dtype=jnp.bfloat16 if dtype == "bf16" else None,
                                        n_shards=e)
    out = joptim.sorted_dense_adam_update(jst, jnp.asarray(g), jnp.asarray(ids.astype(np.int32)),
                                          (("s", 0, k),), {"s": 0}, d, block_rows=64,
                                          use_pallas=True, mesh=mesh, **kw)
    for name in ("table", "mu", "nu"):
        want = np.asarray(jsa.unpack_rows(out[name], v, d).astype(jnp.float32))
        mine = got[name].float().numpy()
        if dtype == "bf16":
            # one bf16 ulp at the larger magnitude
            ulp = np.maximum(np.abs(want), np.abs(mine)) * 2.0 ** -7
            assert np.all(np.abs(mine - want) <= ulp + 1e-30), name
        else:
            np.testing.assert_allclose(mine, want, rtol=0,
                                       atol=TABLE_ATOL if name == "table" else MU_ATOL,
                                       err_msg=name)


# -- (c) process groups against JAX's mesh trainer and the single-process port

SHAPES = [(2, 2), (1, 2), (2, 1)]
FIT = dict(kind="fit", seed=11, dropout=0.2, scan_steps=2, n_epoch=2, n=7 * W.B + 5)


def _jax_trainer(shape, sorted_dtype=None):
    n, e = shape
    mesh = jmake_mesh(n_data=n, n_embed=e, devices=jax.devices()[:n * e])
    return JTrainer(JMMOE(W.feats(jf), W.DOMAINS, **W.KW), mesh=mesh, seed=7,
                    sparse_embedding_updates=True, sparse_update_impl="sorted",
                    sorted_block_rows=64, sorted_dtype=sorted_dtype)


def _jax_step(jt, b):
    x, y, w = (jax.tree_util.tree_map(jnp.asarray, a) for a in b)
    xs, ys, ws = jt._shard(x, y, w)
    jt.params, jt.opt_state, jt.state, loss = jt._train_step(
        jt.params, jt.opt_state, jt.state, xs, ys, ws, jax.random.PRNGKey(1))
    return float(loss)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, tmp_path_factory):
    """One gloo group of the shape: a step from each JAX trainer's carried
    state, ``fit``, and at (2, 2) a world-size-1 checkpoint loaded and saved
    again; with the JAX trainers' own steps and the single-process fit."""
    shape = request.param
    tmp = str(tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}"))
    b = W.batch(21, ragged=3)
    dtypes = (None, "bf16") if shape == (2, 2) else (None,)
    jts = {dt: _jax_trainer(shape, dt) for dt in dtypes}
    jobs = {f"jax_{dt}": dict(kind="jax_step", sorted_dtype=dt, batch=b,
                              jax_state=_portable((jt.params, jt.state, jt.opt_state)))
            for dt, jt in jts.items()}
    jobs["fit"] = dict(FIT, dir=os.path.join(tmp, "fit"))
    jobs["lookup"] = dict(kind="lookup", v=37, seed=3)
    t = W.trainer(W.port_model(seed=13))
    for s in range(2):
        t._train_step(*t._device_batch(*W.batch(30 + s, ragged=s)))
    single = t.save(os.path.join(tmp, "world1"))
    jobs["load_save"] = dict(kind="load_save", path=single, out=os.path.join(tmp, "again"))
    results = W.spawn(shape, jobs, tmp)
    jax_losses = {dt: _jax_step(jt, b) for dt, jt in jts.items()}
    fit1 = W.run_fit(None, dict(FIT, dir=os.path.join(tmp, "fit1")))
    return SimpleNamespace(shape=shape, results=results, jts=jts, jax_losses=jax_losses,
                           fit1=fit1, single=single)


def test_mesh_layout_is_jax_reshape(mesh_run):
    n, e = mesh_run.shape
    assert [r["layout"] for r in mesh_run.results] == [divmod(k, e) for k in range(n * e)]


def test_sharded_lookup_over_the_embed_group(mesh_run):
    """``make_sharded_lookup_fn`` on every rank: its shard holds V/E rows
    (37 padded to a multiple of E) and its lookup, summed over the ``embed``
    group, is the whole table's gather bit for bit."""
    e = mesh_run.shape[1]
    for res in mesh_run.results:
        got = res["lookup"]
        assert got["local_rows"] == parallel.pad_vocab(37, e) // e
        assert torch.equal(got["rows"], got["want"])


def test_mesh_step_matches_jax_mesh_trainer(mesh_run):
    for dt, jt in mesh_run.jts.items():
        want_table = np.asarray(jt._params_for_eval()["embedding"]["packed"], np.float32)
        mu = np.asarray(jsa.unpack_rows(jt.opt_state["emb"]["mu"], want_table.shape[0], W.D)
                        .astype(jnp.float32))
        for rank, res in enumerate(mesh_run.results):
            got = res[f"jax_{dt}"]
            what = f"{mesh_run.shape} rank {rank} {dt or 'float32'}"
            assert abs(got["loss"] - mesh_run.jax_losses[dt]) <= LOSS_ATOL, what
            np.testing.assert_allclose(got["state"]["model/embedding.packed"].numpy(),
                                       want_table, rtol=0, atol=TABLE_ATOL, err_msg=what)
            np.testing.assert_allclose(got["state"]["opt/emb/mu"].float().numpy(), mu, rtol=0,
                                       atol=MU_ATOL, err_msg=what)


def _assert_close_state(got, want, steps, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        a, b = got[k].float().numpy(), v.float().numpy()
        atol = (2 * LR * steps if _bn_cancelled(k)
                else TABLE_ATOL if k.startswith("model/") else MU_ATOL)
        np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=atol, err_msg=f"{what}: {k}")


def test_mesh_fit_matches_single_process(mesh_run):
    """``fit`` (2 epochs of 8 steps, the last batch 5 real rows of 16, at
    ``scan_steps=2``, dropout 0.2 on the towers, validation and a
    checkpoint) and the per-domain metrics, every rank against the
    single-process port: the same dispatch loss lines, state and metrics
    (at n_data = 1 bit for bit); every rank's metrics the same."""
    one = mesh_run.fit1
    steps = one["step"]
    assert steps == 16
    for rank, res in enumerate(mesh_run.results):
        fit = res["fit"]
        what = f"{mesh_run.shape} rank {rank}"
        assert fit["step"] == steps
        if mesh_run.shape[0] == 1:
            # every rank sees the whole batch, so it runs one process's
            # products and reductions; the sharded lookup and update are
            # exact: bit for bit
            assert fit["log"] == one["log"] and fit["metrics"] == one["metrics"], what
            for k, v in one["state"].items():
                assert torch.equal(fit["state"][k], v), f"{what}: {k}"
        assert len(fit["log"]) == len(one["log"]) and fit["log"], (fit["log"], one["log"])
        for a, b in zip(fit["log"], one["log"]):
            assert a.split("loss")[0] == b.split("loss")[0]
            assert abs(float(a.split()[-1]) - float(b.split()[-1])) <= 2e-5, (a, b)
        _assert_close_state(fit["state"], one["state"], steps, what)
        ll, auc, tll, tauc = fit["metrics"]
        assert fit["metrics"] == mesh_run.results[0]["fit"]["metrics"], what
        ll1, auc1, tll1, tauc1 = one["metrics"]
        np.testing.assert_allclose(ll + auc + [tll, tauc], ll1 + auc1 + [tll1, tauc1],
                                   rtol=1e-4, err_msg=what)


# -- (d) checkpoints between mesh shapes --------------------------------------

def _npz(path):
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def test_checkpoint_moves_between_mesh_shapes(mesh_run):
    """The mesh -> world size 1: the mesh's fit checkpoint loads into a
    single-process trainer bit for bit; world size 1 -> the mesh: the mesh
    loads a single-process checkpoint and saves it again, unchanged but
    for its metadata's mesh shape."""
    fit = mesh_run.results[0]["fit"]
    t = W.trainer(W.port_model(seed=5))
    meta = t.load(fit["path"])
    n, e = mesh_run.shape
    assert meta["mesh"] == {"data": n, "embed": e}
    for k, v in W.state(t).items():
        assert torch.equal(v, fit["state"][k]), k
    again = mesh_run.results[0]["load_save"]
    a, b = _npz(mesh_run.single), _npz(again["path"])
    assert sorted(a) == sorted(b)
    for k in a:
        if k != "__metadata__":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for res in mesh_run.results:
        assert res["load_save"]["path"] == again["path"]
        for k, v in res["load_save"]["state"].items():
            assert torch.equal(v, torch.from_numpy(a[k]) if a[k].dtype != np.uint16
                               else torch.from_numpy(a[k].view(np.int16)).view(torch.bfloat16)), k


# -- (e) what a mesh refuses -------------------------------------------------

def test_mesh_refusals_name_their_roadmap_items():
    from scenario_wise_rec_tpu_torch.data.device import DeviceResidentLoader
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    mesh = parallel.make_mesh(1, 1)
    model = W.port_model()
    with pytest.raises(TypeError, match="parallel.Mesh"):
        CTRTrainer(model, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="mesh="):
        CTRTrainer(model, device="cpu", gpus=[0, 1])
    for kw in (dict(sparse_update_impl="occurrence"), dict(sparse_update_impl="dense"),
               dict(sparse_update_impl="winner")):
        with pytest.raises(NotImplementedError, match="A15.2"):
            CTRTrainer(model, device="cpu", mesh=mesh, sparse_embedding_updates=True, **kw)
    with pytest.raises(NotImplementedError, match="A15.2"):
        CTRTrainer(model, device="cpu", mesh=mesh)  # the plain dense step
    for fused in (True, "auto"):
        with pytest.raises(NotImplementedError, match="A15.3"):
            W.trainer(model, mesh, fused_inference=fused)
    t = W.trainer(model, mesh)
    assert not t.graphed
    x, y, _ = W.batch(3, b=40)
    from scenario_wise_rec_tpu_torch.data import dataset as pds
    loader = DeviceResidentLoader(pds.ColumnarDataset(x, y), W.B, device="cpu")
    with pytest.raises(NotImplementedError, match="A15.3"):
        t.train_one_epoch(loader)
    with pytest.raises(ValueError, match="nccl"):
        parallel.init_distributed("nccl", "file:///nonexistent", 0, 2)
    with pytest.raises(ValueError, match="backend"):
        parallel.init_distributed("mpi", "file:///nonexistent", 0, 1)
    with pytest.raises(ValueError, match="ranks"):
        parallel.make_mesh(2, 1)
