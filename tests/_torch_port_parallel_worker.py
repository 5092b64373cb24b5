"""One rank of ``tests/test_torch_port_parallel.py``'s process groups.

Run as ``python _torch_port_parallel_worker.py RANK WORLD N_DATA N_EMBED
INIT_FILE JOBS OUT_DIR [BACKEND]``: joins a process group (gloo unless
BACKEND says nccl) through ``file://INIT_FILE``, builds the port's
``(N_DATA, N_EMBED)`` mesh, runs every job of the pickled ``JOBS`` dict (on
the job's ``device``: the CPU, or with ``"cuda"`` the card
``init_distributed`` gave the rank) and pickles its results to
``OUT_DIR/rank<RANK>.pkl``. The test files import the same builders, so the
single-process runs they hold the mesh against are made alike. Imports no
JAX.
"""

import contextlib
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, DOMAINS, B = 31, 8, 2, 16
KW = dict(n_expert=2, expert_params={"dims": [16]}, tower_params={"dims": [8]})


def feats(m, v=V, loose=False, frozen=None, init=None):
    """Three owned tables, an alias of one and a pooled sequence feature
    sharing another (so a row id recurs across segments), and a dense one;
    packed V = 93, odd, so an even embed axis pads it. ``v``: the tables'
    vocab instead. ``loose``: a fourth table of width 4, kept loose. ``frozen``:
    ``s1``'s init (``init.pretrained(..., freeze=True)``), whose rows
    ``[v, 2 v)`` straddle the second shard's first row at E = 2. ``init``:
    every other owned table's initializer."""
    own = {} if init is None else {"initializer": init}
    s1 = own if frozen is None else {"initializer": frozen}
    return ([m.SparseFeature(f"s{i}", vocab_size=v, embed_dim=D, **(s1 if i == 1 else own))
             for i in range(3)]
            + [m.SparseFeature("alias", vocab_size=v, embed_dim=D, shared_with="s0")]
            + [m.SequenceFeature("seq", vocab_size=v, embed_dim=D, pooling="mean",
                                 shared_with="s1")]
            + ([m.SparseFeature("narrow", vocab_size=v, embed_dim=4, **own)] if loose else [])
            + [m.DenseFeature("d0")])


def frozen_weights(v=V):
    """The frozen table's pretrained rows."""
    return np.random.default_rng(99).normal(size=(v, D)).astype(np.float32)


MODELS = {"mmoe": "MMOE", "epnet": "EPNet", "ppnet": "PPNet", "adasparse": "AdaSparse",
          "m2m": "M2M", "adaptdhm": "AdaptDHM", "star": "Star", "hamur": "HamurLarge"}


def model_kwargs(m, i, spec):
    """The constructor arguments of ``spec`` (``{"model": a key of MODELS,
    "v", "loose", "frozen", "dropout", "emb_std"}``) for the JAX package's
    or the port's ``features`` module ``m`` and ``init`` module ``i``; with
    ``emb_std`` the owned tables start from N(0, emb_std) (at the default
    N(0, 1e-4) a train-mode BatchNorm after a lookup divides row
    differences of 1e-4 by sqrt(eps), and AdaptDHM's rows all route
    alike). EPNet, AdaSparse and PPNet keep two collections: the domain
    indicator (PPNet: the ``narrow`` ids at width D) in one, the rest in
    the other. M2M reads
    ``s2`` as its scenario feature (two domains' embeddings take two values,
    which its hyper-MLPs' BatchNorms would reduce to rounding noise) and
    takes no dense column (its transformer's width must divide by its 4
    heads); its transformer's dropout is ``dropout``. STAR, HamurLarge and
    AdaptDHM read the features alone (the domain ids from the batch)."""
    v = spec.get("v", V)
    frozen = i.pretrained(frozen_weights(v), freeze=True) if spec.get("frozen") else None
    init = i.random_normal(0.0, spec["emb_std"]) if spec.get("emb_std") else None
    f = feats(m, v, spec.get("loose", False), frozen, init)
    sce = [m.SparseFeature("domain_indicator", vocab_size=DOMAINS, embed_dim=D)]
    model = spec.get("model", "mmoe")
    if model == "epnet":
        return dict(sce_features=sce, agn_features=f, fcn_dims=[8])
    if model == "adasparse":
        return dict(sce_features=sce, agn_features=f, mlp_params={"dims": [16, 8]})
    if model == "m2m":
        tr = {"num_encoder_layers": 1, "num_decoder_layers": 1, "dim_feedforward": 8,
              "dropout": spec.get("dropout", 0.0)}
        return dict(features=[g for g in f if not isinstance(g, m.DenseFeature)],
                    domain_feature=[f[2]], domain_num=DOMAINS, num_experts=2,
                    expert_output_size=4, transformer_dims=tr)
    if model == "adaptdhm":
        return dict(features=f, fcn_dims=[16, 8], cluster_num=3, beta=0.9)
    if model == "star":
        return dict(features=f, num_domains=DOMAINS, fcn_dims=[16, 8], aux_dims=[8])
    if model == "hamur":
        return dict(features=f, domain_num=DOMAINS, fcn_dims=[16, 16, 8, 8, 8, 8, 8],
                    hyper_dims=[8], k=4)
    if model == "ppnet":
        ids = [m.SparseFeature("narrow", vocab_size=v, embed_dim=D)]
        return dict(id_features=ids, agn_features=f + sce, domain_num=DOMAINS, fcn_dims=[16, 8])
    tower = {"dims": [8], "dropout": spec.get("dropout", 0.0)}
    return dict(features=f, domain_num=DOMAINS, **dict(KW, tower_params=tower))


def spec_model(spec, seed=1):
    """The port's model of ``spec`` (see :func:`model_kwargs`) on the CPU."""
    from scenario_wise_rec_tpu_torch import models
    from scenario_wise_rec_tpu_torch.core import features as pf
    from scenario_wise_rec_tpu_torch.core import init as pinit
    from scenario_wise_rec_tpu_torch.core.config import make_generator

    cls = getattr(models, MODELS[spec.get("model", "mmoe")])
    return cls(**model_kwargs(pf, pinit, spec), device="cpu",
               generator=make_generator(torch.device("cpu"), seed))


def batch(seed, b=B, ragged=0):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, b).astype(np.int32) for i in range(3)}
    x["alias"] = r.integers(0, V, b).astype(np.int32)
    x["seq"] = r.integers(0, V, (b, 4)).astype(np.int32)
    x["d0"] = r.normal(size=b).astype(np.float32)
    x["domain_indicator"] = r.integers(0, DOMAINS, b).astype(np.int32)
    y = r.integers(0, 2, b).astype(np.float32)
    w = np.ones(b, np.float32)
    w[b - ragged:] = 0.0
    x["narrow"] = r.integers(0, V, b).astype(np.int32)  # the loose table's ids
    return x, y, w


def port_model(seed=1, dropout=0.0):
    return spec_model({"dropout": dropout}, seed)


def loader(n, seed, shuffle):
    from scenario_wise_rec_tpu_torch.data import dataset as pds

    x, y, _ = batch(seed, b=n)
    return pds.BatchIterable(pds.ColumnarDataset(x, y), B, shuffle=shuffle, seed=seed)


def trainer(model, mesh=None, device="cpu", **kw):
    return mode_trainer(model, "sorted", mesh, device, **kw)


def mode_trainer(model, mode, mesh=None, device="cpu", **kw):
    """A trainer of ``mode``: an embedding update (``"dense"``,
    ``"occurrence"``, ``"winner"``, ``"sorted"``) or ``"plain"``, the plain
    step."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    sparse = {} if mode == "plain" else dict(sparse_embedding_updates=True,
                                              sparse_update_impl=mode)
    return CTRTrainer(model, device=device, mesh=mesh, seed=3, **sparse, **kw)


def mode_launches():
    """The launch counters of the update kernels the modes run."""
    from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as fa
    from scenario_wise_rec_tpu_torch.ops.kernels import row_update as ru

    return {"fused_dense_adam_apply": fa.fused_dense_adam_apply.launches,
            "fused_dense_adam_apply_sharded": fa.fused_dense_adam_apply.launches_sharded,
            "occurrence_segsum": ru.occurrence_segsum.launches,
            "scatter_rows": ru.scatter_rows.launches}


@contextlib.contextmanager
def one_thread():
    """Run the enclosed single-process reference at the ranks' thread
    count (``main`` sets one thread a rank): with more threads the CPU's
    products sum in another order, and a (1, E) mesh is then no longer
    bit for bit one process."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(kept)


def _device(job):
    """The job's device: "cpu", or for "cuda" the rank's current card."""
    if job.get("device", "cpu") == "cpu":
        return "cpu"
    return f"cuda:{torch.cuda.current_device()}"


def state(t):
    """The trainer's whole state as its checkpoint holds it (a mesh's
    shards gathered), as CPU tensors."""
    return {k: v.detach().cpu().clone() for k, v in t._checkpoint_tensors().items()}


@contextlib.contextmanager
def unpadded_dropout(pad):
    """With ``pad`` > 0, the MLPs' dropout draws its masks for all rows but
    the last ``pad`` (the padding a padded run appends), so that a padded
    run's masks are the unpadded run's."""
    from scenario_wise_rec_tpu_torch.ops import nn as pnn

    if not pad:
        yield
        return
    kept = pnn.dropout

    def dropout(x, p, train, generator):
        b = x.shape[-2] - pad
        return torch.cat([kept(x[..., :b, :], p, train, generator), x[..., b:, :]], dim=-2)

    pnn.dropout = dropout
    try:
        yield
    finally:
        pnn.dropout = kept


def pad_steps(t, pad):
    """With ``pad`` > 0, every train step of ``t`` takes its batch with
    ``pad`` weight-0 copies of its first row appended."""
    if not pad:
        return
    step = t._train_step

    def padded(x, y, w, **kw):
        more = lambda v: torch.cat([v, v[:1].expand(pad, *v.shape[1:])])
        return step({k: more(v) for k, v in x.items()}, more(y),
                    torch.cat([w, w.new_zeros(pad)]), **kw)

    t._train_step = padded


def run_fit(mesh, job):
    """``fit`` over a shuffled loader with a padded last batch, then the
    per-domain metrics; the loss lines it printed, its state and the path
    of the checkpoint it wrote. ``job["pad_rows"]``: each train batch padded
    with that many weight-0 copies of its first row (the same math and
    dropout masks, every product and reduction of another shape: how far a
    correct run parts from itself when only the order of its sums changes);
    ``job["fault"]``: a planted fault of :func:`planted`."""
    t = trainer(port_model(job["seed"], job["dropout"]), mesh, _device(job),
                scan_steps=job["scan_steps"], n_epoch=job["n_epoch"], model_path=job["dir"])
    pad = job.get("pad_rows", 0)
    pad_steps(t, pad)
    from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa
    before = (sa.sorted_dense_adam_apply.launches, sa.sorted_dense_adam_apply.launches_sharded)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), planted(job.get("fault")), unpadded_dropout(pad):
        path = t.fit(loader(job["n"], job["seed"], True), loader(3 * B, job["seed"] + 1, False))
    metrics = t.evaluate_multi_domain_loss(t.model, loader(3 * B, job["seed"] + 2, False),
                                           DOMAINS)
    lines = [ln for ln in out.getvalue().splitlines() if "loss" in ln]
    launches = (sa.sorted_dense_adam_apply.launches - before[0],
                sa.sorted_dense_adam_apply.launches_sharded - before[1])
    return {"log": lines, "path": path, "state": state(t), "metrics": metrics,
            "step": t.emb_opt_state["step"], "launches": launches}


def run_jax_step(mesh, job):
    """One train step from a JAX trainer's carried state."""
    from scenario_wise_rec_tpu_torch.interop import load_jax_trainer_state
    from scenario_wise_rec_tpu_torch.parallel import shard_batch_fn

    t = trainer(port_model(), mesh, sorted_dtype=job["sorted_dtype"])
    load_jax_trainer_state(t, *job["jax_state"])
    b = job["batch"] if mesh is None else shard_batch_fn(mesh)(*job["batch"])
    loss = float(t._train_step(*t._device_batch(*b)))
    return {"loss": loss, "state": state(t)}


def run_lookup(mesh, job):
    """``make_sharded_lookup_fn``'s shard and lookup of a random ``[v, D]``
    table, and the whole table's gather."""
    from scenario_wise_rec_tpu_torch.parallel import make_sharded_lookup_fn

    r = np.random.default_rng(job["seed"])
    table = torch.from_numpy(r.normal(size=(job["v"], D)).astype(np.float32))
    ids = torch.from_numpy(r.integers(0, job["v"], (4, 6)))
    local, lookup = make_sharded_lookup_fn(mesh, table)
    return {"rows": lookup(local, ids), "want": table[ids], "local_rows": local.shape[0]}


def run_load_save(mesh, job):
    """Load a checkpoint, then save it again."""
    t = trainer(port_model(seed=5), mesh)
    t.load(job["path"])
    return {"path": t.save(job["out"]), "state": state(t)}


@contextlib.contextmanager
def planted(fault):
    """A planted fault for the gates that must see it, or none:
    ``"sentinel"``: the occurrence and winner updates' out-of-shard ids left
    as ``id - row0`` in place of the sentinel; ``"local_keys"``: M2M's
    attention over this rank's keys, values and key mask only;
    ``"local_centers"``: AdaptDHM's center update over this rank's rows
    only; ``"rank0_rows"``:
    a resident mesh epoch's ranks all taking data rank 0's rows of each
    global batch; ``"unsummed_grads"``: the dense gradients left unsummed
    over the ``data`` group."""
    from scenario_wise_rec_tpu_torch.models import adaptdhm
    from scenario_wise_rec_tpu_torch.ops import transformer
    from scenario_wise_rec_tpu_torch.train import optim, trainer

    where = {"sentinel": (optim, "shard_local_ids",
                          lambda ids, row0, rows: ids.long() - int(row0)),
             "local_keys": (transformer, "current_step", lambda: None),
             "local_centers": (adaptdhm, "all_reduce_", lambda t, group: t),
             "rank0_rows": (trainer, "local_rows",
                            lambda mesh, b: slice(0, b // mesh.shape["data"])),
             "unsummed_grads": (trainer.CTRTrainer, "_sum_dense_grads", lambda self: None)}
    if not fault:
        yield
        return
    owner, name, wrong = where[fault]
    kept = owner.__dict__[name]
    setattr(owner, name, wrong)
    try:
        yield
    finally:
        setattr(owner, name, kept)


def run_mode_jax_step(mesh, job):
    """One step of ``job["mode"]`` from a JAX trainer's carried state, with
    the planted ``fault`` of :func:`planted` if the job names one."""
    from scenario_wise_rec_tpu_torch.interop import load_jax_trainer_state
    from scenario_wise_rec_tpu_torch.parallel import shard_batch_fn

    t = mode_trainer(spec_model(job["spec"]), job["mode"], mesh)
    load_jax_trainer_state(t, *job["jax_state"])
    b = shard_batch_fn(mesh)(*job["batch"])
    with planted(job.get("fault")):
        loss = float(t._train_step(*t._device_batch(*b)))
    return {"loss": loss, "state": state(t)}


def run_mode_steps(mesh, job):
    """Steps of ``job["mode"]`` on ``job["batches"]`` from the port's own
    init (a mesh's rows of each; ``mesh`` None: one process), with the
    planted ``fault`` of :func:`planted` if the job names one: each step's
    loss and the state after it."""
    from scenario_wise_rec_tpu_torch.parallel import shard_batch_fn

    t = mode_trainer(spec_model(job["spec"]), job["mode"], mesh)
    losses, states = [], []
    for b in job["batches"]:
        if mesh is not None:
            b = shard_batch_fn(mesh)(*b)
        with planted(job.get("fault")):
            losses.append(float(t._train_step(*t._device_batch(*b))))
        states.append(state(t))
    return {"losses": losses, "states": states}


def eval_loader(seed, n=3 * B + 5):
    """An unshuffled eval loader whose last batch is padded."""
    return loader(n, seed, False)


def run_eval(mesh, job):
    """The model of ``job["spec"]`` from a JAX trainer's carried state
    (``job["jax_state"]``), or from the port's init, scored on one loader by
    op-by-op and fused eval: each path's probabilities (``predict``) and
    per-domain metrics on the host and on the device, and the fused
    kernel's launches (``job["launches"]``: a module path and counter)."""
    import importlib

    from scenario_wise_rec_tpu_torch.interop import load_jax_trainer_state

    out = {}
    for fused in (False, True):
        t = mode_trainer(spec_model(job["spec"]), "plain", mesh, _device(job),
                         fused_inference=fused)
        if job.get("jax_state") is not None:
            load_jax_trainer_state(t, *job["jax_state"])
        mod, attr = job.get("launches", (None, None))
        fn = None if mod is None else getattr(importlib.import_module(mod), attr)
        before = None if fn is None else fn.launches
        probs = np.asarray(t.predict(t.model, eval_loader(job["seed"])))
        launched = None if fn is None else fn.launches - before
        out["fused" if fused else "op"] = {
            "probs": probs, "launches": launched,
            "metrics": t.evaluate_multi_domain_loss(t.model, eval_loader(job["seed"]), DOMAINS),
            "device": t.evaluate_multi_domain_loss(t.model, eval_loader(job["seed"]), DOMAINS,
                                                   on_device=True)}
    return out


def columns(n, seed):
    """The worker's columns of ``n`` rows and their labels."""
    x, y, _ = batch(seed, b=n)
    return x, y


def run_resident(mesh, job):
    """One epoch of ``job["mode"]`` over a ``DeviceResidentLoader`` and one
    over the host ``BatchIterable`` of the same rows and seed, each from the
    port's init (or, with ``job["jax_state"]``, a JAX trainer's carried
    state) at ``job["scan_steps"]``; both states. With ``job["host"]``
    False the host epoch is skipped."""
    from scenario_wise_rec_tpu_torch.data import dataset as pds
    from scenario_wise_rec_tpu_torch.data.device import DeviceResidentLoader
    from scenario_wise_rec_tpu_torch.interop import load_jax_trainer_state

    x, y = columns(job["n"], job["seed"])
    loaders = {"resident": lambda: DeviceResidentLoader(pds.ColumnarDataset(x, y), B,
                                                        seed=job["seed"], device=_device(job))}
    if job.get("host", True):
        loaders["host"] = lambda: pds.BatchIterable(pds.ColumnarDataset(x, y), B, shuffle=True,
                                                    seed=job["seed"])
    out = {}
    for name, make in loaders.items():
        t = mode_trainer(spec_model(job["spec"]), job["mode"], mesh, _device(job),
                         scan_steps=job.get("scan_steps", 1))
        if job.get("jax_state") is not None:
            load_jax_trainer_state(t, *job["jax_state"])
        with contextlib.redirect_stdout(io.StringIO()), \
                planted(job.get("fault") if name == "resident" else None):
            t.train_one_epoch(make(), log_interval=10**9)
            t.barrier()
        out[name] = state(t)
    return out


def run_resident_mismatch(mesh, job):
    """A resident epoch whose loader has another seed on every rank: the
    error every rank raises (the trainer checks the ranks' loaders agree)."""
    from scenario_wise_rec_tpu_torch.data import dataset as pds
    from scenario_wise_rec_tpu_torch.data.device import DeviceResidentLoader

    x, y = columns(job["n"], job["seed"])
    t = mode_trainer(spec_model(job["spec"]), job["mode"], mesh, _device(job))
    loader = DeviceResidentLoader(pds.ColumnarDataset(x, y), B, seed=job["seed"] + mesh.rank,
                                  device=_device(job))
    try:
        t.train_one_epoch(loader)
    except ValueError as e:
        return str(e)
    return "no error"


def run_mode_fit(mesh, job):
    """``fit`` of ``job["mode"]`` (two epochs at ``scan_steps=2``, or the
    job's, over a shuffled loader with a padded last batch, validation, a
    checkpoint into ``job["dir"]``; on the job's device), then the
    per-domain metrics: the loss lines, the state, the checkpoint's path,
    the update's step count and launches. ``job["pad_rows"]`` and
    ``job["fault"]`` as in :func:`run_fit`."""
    t = mode_trainer(spec_model(job["spec"], job["seed"]), job["mode"], mesh, _device(job),
                     scan_steps=job.get("scan_steps", 2), n_epoch=2, model_path=job["dir"])
    pad = job.get("pad_rows", 0)
    pad_steps(t, pad)
    before = mode_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), planted(job.get("fault")), unpadded_dropout(pad):
        path = t.fit(loader(job["n"], job["seed"], True), loader(3 * B, job["seed"] + 1, False))
    metrics = t.evaluate_multi_domain_loss(t.model, loader(3 * B, job["seed"] + 2, False),
                                           DOMAINS)
    lines = [ln for ln in out.getvalue().splitlines() if "loss" in ln]
    after = mode_launches()
    return {"log": lines, "path": path, "state": state(t), "metrics": metrics,
            "step": None if t.emb_opt_state is None else t.emb_opt_state["step"],
            "launches": {k: after[k] - before[k] for k in after}}


def run_mode_load_save(mesh, job):
    """Load a checkpoint (the port's or a JAX one) into a trainer of
    ``job["mode"]``, then save it again."""
    t = mode_trainer(spec_model(job["spec"], seed=5), job["mode"], mesh)
    t.load(job["path"])
    return {"path": t.save(job["out"]), "state": state(t)}


def spawn(shape, jobs, tmp, backend="gloo", timeout=90):
    """Run ``jobs`` on a process group of ``shape`` ranks, this file as each
    rank, the whole group within ``timeout`` seconds (each finishes in well
    under 30 s alone); every rank's results. No TCP port: the rendezvous is
    a file under ``tmp``."""
    n, e = shape
    world = n * e
    jobs_path, out = os.path.join(tmp, "jobs.pkl"), os.path.join(tmp, "out")
    os.makedirs(out, exist_ok=True)
    with open(jobs_path, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    init = os.path.join(tmp, "rendezvous")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(n), str(e), init, jobs_path, out, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {shape} failed:\n{log}"
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


JOBS = {"fit": run_fit, "jax_step": run_jax_step, "load_save": run_load_save,
        "lookup": run_lookup, "mode_jax_step": run_mode_jax_step, "mode_steps": run_mode_steps,
        "mode_fit": run_mode_fit, "mode_load_save": run_mode_load_save, "eval": run_eval,
        "resident": run_resident, "resident_mismatch": run_resident_mismatch}


def main(argv):
    rank, world, n_data, n_embed = (int(a) for a in argv[:4])
    init_file, jobs_path, out_dir = argv[4:7]
    backend = argv[7] if len(argv) > 7 else "gloo"
    torch.set_num_threads(1)
    from scenario_wise_rec_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(backend, f"file://{init_file}", rank, world)
    mesh = make_mesh(n_data, n_embed)
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    results = {"layout": (mesh.data_index, mesh.embed_index)}
    for name, job in jobs.items():
        results[name] = JOBS[job["kind"]](mesh, job)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
