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


def feats(m):
    """Three owned tables, an alias of one and a pooled sequence feature
    sharing another (so a row id recurs across segments), and a dense one;
    packed V = 93, odd, so an even embed axis pads it."""
    return ([m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=D) for i in range(3)]
            + [m.SparseFeature("alias", vocab_size=V, embed_dim=D, shared_with="s0")]
            + [m.SequenceFeature("seq", vocab_size=V, embed_dim=D, pooling="mean",
                                 shared_with="s1")]
            + [m.DenseFeature("d0")])


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
    return x, y, w


def port_model(seed=1, dropout=0.0):
    from scenario_wise_rec_tpu_torch.core import features as pf
    from scenario_wise_rec_tpu_torch.core.config import make_generator
    from scenario_wise_rec_tpu_torch.models import MMOE

    kw = dict(KW, tower_params={"dims": [8], "dropout": dropout})
    return MMOE(feats(pf), DOMAINS, device="cpu",
                generator=make_generator(torch.device("cpu"), seed), **kw)


def loader(n, seed, shuffle):
    from scenario_wise_rec_tpu_torch.data import dataset as pds

    x, y, _ = batch(seed, b=n)
    return pds.BatchIterable(pds.ColumnarDataset(x, y), B, shuffle=shuffle, seed=seed)


def trainer(model, mesh=None, device="cpu", **kw):
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    return CTRTrainer(model, device=device, mesh=mesh, sparse_embedding_updates=True,
                      sparse_update_impl="sorted", seed=3, **kw)


def _device(job):
    """The job's device: "cpu", or for "cuda" the rank's current card."""
    if job.get("device", "cpu") == "cpu":
        return "cpu"
    return f"cuda:{torch.cuda.current_device()}"


def state(t):
    """The trainer's whole state as its checkpoint holds it (a mesh's
    shards gathered), as CPU tensors."""
    return {k: v.detach().cpu().clone() for k, v in t._checkpoint_tensors().items()}


def run_fit(mesh, job):
    """``fit`` over a shuffled loader with a padded last batch, then the
    per-domain metrics; the loss lines it printed, its state and the path
    of the checkpoint it wrote."""
    t = trainer(port_model(job["seed"], job["dropout"]), mesh, _device(job),
                scan_steps=job["scan_steps"], n_epoch=job["n_epoch"], model_path=job["dir"])
    from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa
    before = (sa.sorted_dense_adam_apply.launches, sa.sorted_dense_adam_apply.launches_sharded)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
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
        "lookup": run_lookup}


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
