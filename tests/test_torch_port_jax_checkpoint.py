"""Checkpoints that the JAX package's ``CTRTrainer.save`` wrote, read by the
port (``train/checkpoint.py:read_jax``, ``interop.load_jax_checkpoint``,
``CTRTrainer.load``): in every update mode (sorted with f32 and bf16
storage, sorted from a two-shard JAX mesh and at the JAX default
``block_rows``, occurrence, dense, winner, the plain step) a JAX trainer
takes two steps and saves; a port trainer built from other weights loads
the file, predicts as the JAX trainer does within 1e-5, and one more step on
both sides agrees within the training gate of ``test_torch_port_train.py``
(1e-6 + 1e-4·|v|, the loss within 1e-5), which shows that the optimizer
state came across. A file of another mode, storage type or model class
raises. MMOE is narrow (vocab 30, D 8, experts [16], dropout 0). The
committed fixture of ``scripts/make_jax_checkpoint_fixture.py`` (read on the
card by ``test_torch_port_cuda.py`` and ``chip_smoke.py``) regenerates to its
committed probabilities within 1e-6, and the port meets them within 1e-5."""

import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import test_torch_port_sorted_bf16 as bf16_tests  # noqa: E402
import test_torch_port_train_modes as mode_tests  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.data import PredictIterable  # noqa: E402
from scenario_wise_rec_tpu_torch.core.config import make_generator  # noqa: E402
from scenario_wise_rec_tpu_torch.models import MMOE as PMMOE  # noqa: E402
from scenario_wise_rec_tpu_torch.models import SharedBottom as PSharedBottom  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.train import checkpoint as ckpt  # noqa: E402

from test_torch_port_train import (  # noqa: E402
    DOMAINS, KW, _batch, _feats, _loader)

PRED_ATOL = 1e-5
LOSS_RTOL = 1e-5
SORTED = dict(sparse_embedding_updates=True, sparse_update_impl="sorted")
# case -> (JAX trainer keywords, port trainer keywords, JAX mesh (data, embed))
CASES = {
    "sorted": (dict(SORTED, sorted_block_rows=64), SORTED, None),
    "sorted_default_block_rows": (SORTED, SORTED, None),
    "sorted_bf16": (dict(SORTED, sorted_block_rows=64, sorted_dtype="bf16"),
                    dict(SORTED, sorted_dtype="bf16"), None),
    "sorted_mesh_1x2": (dict(SORTED, sorted_block_rows=64), SORTED, (1, 2)),
    "occurrence": (mode_tests._kw("occurrence"), mode_tests._kw("occurrence"), None),
    "dense": (mode_tests._kw("dense"), mode_tests._kw("dense"), None),
    "winner": (mode_tests._kw("winner"), mode_tests._kw("winner"), None),
    "plain": ({}, {}, None),
}


def _jax_trainer(case, feats=_feats):
    jkw, _, shape = CASES[case]
    mesh = None
    if shape is not None:
        n, e = shape
        mesh = jmake_mesh(n_data=n, n_embed=e, devices=jax.devices()[:n * e])
    return JTrainer(JMMOE(feats(jf), DOMAINS, **KW), seed=7, mesh=mesh, **jkw)


def _jax_step(jt, batch):
    x, y, w = (jax.tree_util.tree_map(jnp.asarray, a) for a in batch)
    if jt._shard is not None:
        x, y, w = jt._shard(x, y, w)
    jt.params, jt.opt_state, jt.state, loss = jt._train_step(
        jt.params, jt.opt_state, jt.state, x, y, w, jax.random.PRNGKey(1))
    return float(loss)


def _port_trainer(case, feats=_feats, model=PMMOE, seed=3, **model_kw):
    """A port trainer of the case's mode on other weights than the JAX one's."""
    m = model(feats(pf), DOMAINS, device="cpu",
              generator=make_generator(torch.device("cpu"), seed), **(model_kw or KW))
    return PTrainer(m, device="cpu", **CASES[case][1])


def _saved(case, tmp_path, feats=_feats, batch=_batch):
    jt = _jax_trainer(case, feats)
    for step in range(2):
        _jax_step(jt, batch(20 + step))
    jt.save(str(tmp_path / f"jax_{case}"))
    return jt, str(tmp_path / f"jax_{case}.npz")


def _assert_same_state(case, jt, pt):
    if case == "sorted_bf16":
        bf16_tests._assert_same_state(jt, pt)
    else:
        mode_tests._assert_same_state(jt, pt)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_loads_predicts_and_resumes(case, tmp_path):
    feats, batch = ((bf16_tests._feats, bf16_tests._batch) if case == "sorted_bf16"
                    else (_feats, _batch))
    jt, path = _saved(case, tmp_path, feats, batch)
    pt = _port_trainer(case, feats)
    assert ckpt.is_jax(path)
    meta = pt.load(path)
    assert meta["model"] == "MMOE" and pt.epoch_i == meta["epoch"]
    _assert_same_state(case, jt, pt)
    loader = bf16_tests._loader() if case == "sorted_bf16" else _loader()
    np.testing.assert_allclose(np.asarray(pt.predict(pt.model, loader)),
                               np.asarray(jt.predict(jt.model, loader)),
                               rtol=0, atol=PRED_ATOL)
    b = batch(22, ragged=2)
    lp = float(pt._train_step(*pt._device_batch(*b)))
    np.testing.assert_allclose(lp, _jax_step(jt, b), rtol=LOSS_RTOL)
    _assert_same_state(case, jt, pt)


def test_read_jax_rebuilds_the_trees(tmp_path):
    """The key grammar: dict keys by name, sequence entries by index (an
    optax chain's empty states absent, so ``None``), an optax NamedTuple's
    fields by ``.name``; bf16 leaves come back as bfloat16 tensors."""
    jt, path = _saved("sorted_bf16", tmp_path, bf16_tests._feats, bf16_tests._batch)
    trees, meta, bf16 = ckpt.read_jax(path)
    assert meta["sparse_update_impl"] == "sorted" and "sorted_dtype" not in meta
    assert set(trees) == {"params", "state", "opt_state"}
    base = trees["opt_state"]["base"]
    assert isinstance(base, list) and base[0] is None  # add_decayed_weights: no leaf
    adam = base[1]
    assert int(adam.count) == 2 == int(jt.opt_state["base"][1].count)
    want = jt.opt_state["base"][1].mu["experts"]["layers"][0]["lin"]["w"]
    np.testing.assert_array_equal(adam.mu["experts"]["layers"][0]["lin"]["w"],
                                  np.asarray(want))
    emb = trees["opt_state"]["emb"]
    assert "table" not in emb and {"opt_state/emb/mu", "opt_state/emb/nu"} <= bf16
    for k in ("mu", "nu"):
        assert emb[k].dtype == torch.bfloat16
        assert torch.equal(emb[k].view(torch.int16),
                           torch.from_numpy(np.array(jt.opt_state["emb"][k])
                                            .view(np.int16)))


def test_state_tree_without_leaves_reads_as_empty(tmp_path):
    """A JAX tree that wrote no leaf (M3oE's state) is ``{}``; a file
    without ``params/`` entries is not a JAX checkpoint."""
    np.savez(tmp_path / "j.npz", **{"params/a/0": np.ones(2), "opt_state/0/.count": np.int32(1)})
    trees, _, _ = ckpt.read_jax(str(tmp_path / "j.npz"))
    assert trees["state"] == {} and isinstance(trees["params"]["a"], list)
    assert trees["opt_state"][0].count == 1
    np.savez(tmp_path / "p.npz", **{"model/a": np.ones(2)})
    assert not ckpt.is_jax(str(tmp_path / "p.npz"))
    with pytest.raises(ValueError, match="not under"):
        ckpt.read_jax(str(tmp_path / "p.npz"))
    np.savez(tmp_path / "s.npz", **{"state/a": np.ones(2)})
    with pytest.raises(ValueError, match="no params"):
        ckpt.read_jax(str(tmp_path / "s.npz"))


@pytest.mark.parametrize("saved,loader,match", [
    ("sorted", "occurrence", "sparse_update_impl"),
    ("occurrence", "plain", "sparse_update_impl"),
    ("sorted", "sorted_bf16", "sorted_dtype"),
    ("sorted_bf16", "sorted", "sorted_dtype"),
])
def test_mismatched_mode_or_storage_raises(saved, loader, match, tmp_path):
    feats, batch = ((bf16_tests._feats, bf16_tests._batch) if saved == "sorted_bf16"
                    else (_feats, _batch))
    _, path = _saved(saved, tmp_path, feats, batch)
    with pytest.raises(ValueError, match=match):
        _port_trainer(loader, feats).load(path)


def test_mismatched_model_class_raises(tmp_path):
    _, path = _saved("plain", tmp_path)
    pt = _port_trainer("plain", model=PSharedBottom, bottom_params={"dims": [16]},
                       tower_params={"dims": [8]})
    with pytest.raises(ValueError, match="MMOE"):
        pt.load(path)


# -- the committed fixture -------------------------------------------------------

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = "jax_mmoe_sorted"


def fixture_probabilities(device, fused_inference=False, data_dir=DATA):
    """The port's probabilities on the fixture's batch, from a trainer on
    ``device`` that loaded the JAX checkpoint; and the JAX ones."""
    with open(os.path.join(data_dir, FIXTURE + ".json")) as f:
        spec = json.load(f)
    feats = ([pf.SparseFeature(n, vocab_size=v, embed_dim=spec["embed_dim"])
              for n, v in spec["sparse"]] + [pf.DenseFeature(n) for n in spec["dense"]])
    model = PMMOE(feats, spec["domain_num"], device=device, **spec["model_kwargs"])
    trainer = PTrainer(model, device=device, fused_inference=fused_inference,
                       **spec["trainer_kwargs"])
    trainer.load(os.path.join(data_dir, FIXTURE + ".npz"))
    with np.load(os.path.join(data_dir, FIXTURE + "_batch.npz")) as z:
        want = z["__prob__"]
        x = {k: z[k] for k in z.files if k != "__prob__"}
    got = np.asarray(trainer.predict(model, PredictIterable(x, spec["batch_rows"])))
    return got, want


def test_fixture_regenerates_to_the_committed_probabilities(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(DATA), "..", "scripts"))
    import make_jax_checkpoint_fixture as fixture

    fixture.main(str(tmp_path))
    with np.load(tmp_path / (FIXTURE + "_batch.npz")) as new, \
            np.load(os.path.join(DATA, FIXTURE + "_batch.npz")) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            if k != "__prob__":
                np.testing.assert_array_equal(new[k], old[k], err_msg=k)
        # the JAX trainer's two steps and forward sum in f32 in an order
        # XLA:CPU picks for the host's CPU (1.1e-6 apart on some): held to
        # the gate the fixture's readers use
        np.testing.assert_allclose(new["__prob__"], old["__prob__"], rtol=0, atol=PRED_ATOL)
    # the checkpoint: the same entries, shapes and types; every entry that
    # is not a float (step counts, metadata) exactly
    with np.load(tmp_path / (FIXTURE + ".npz"), allow_pickle=False) as new, \
            np.load(os.path.join(DATA, FIXTURE + ".npz"), allow_pickle=False) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            assert (new[k].shape, new[k].dtype) == (old[k].shape, old[k].dtype), k
            if new[k].dtype.kind != "f":
                np.testing.assert_array_equal(new[k], old[k], err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["op_by_op", "fused_plain"])
def test_port_reads_the_committed_fixture(fused):
    got, want = fixture_probabilities("cpu", fused_inference=fused)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_ATOL)
