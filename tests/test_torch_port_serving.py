"""The port's serving path (CTRTrainer predict / evaluate /
evaluate_multi_domain_loss, data pipeline, host metrics) against the JAX
package, plus the port's import and device rules."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.data import dataset as jds  # noqa: E402
from scenario_wise_rec_tpu.models import MMOE as JMMOE  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402
from scenario_wise_rec_tpu.train import metrics as jmetrics  # noqa: E402
from scenario_wise_rec_tpu_torch.core import config as port_config  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.data import dataset as pds  # noqa: E402
from scenario_wise_rec_tpu_torch.data.prefetch import prefetch  # noqa: E402
from scenario_wise_rec_tpu_torch.interop import load_jax_params  # noqa: E402
from scenario_wise_rec_tpu_torch.models import MMOE as PMMOE  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu_torch.train import metrics as pmetrics  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
V, D, N_ROWS, BATCH = 50, 3, 100, 32  # 100 = 3 * 32 + 4: a ragged tail
KW = dict(n_expert=2, expert_params={"dims": [16, 8]}, tower_params={"dims": [4]})
PROB_RTOL, PROB_ATOL, METRIC_TOL = 1e-5, 1e-6, 1e-6


def _feats(m):
    return ([m.DenseFeature("d0"), m.DenseFeature("d1")]
            + [m.SparseFeature(f"s{i}", vocab_size=V, embed_dim=8) for i in range(4)])


def _data(seed=0, n=N_ROWS, domains=D):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, n) for i in range(4)}
    x.update({f"d{i}": r.normal(size=n).astype(np.float32) for i in range(2)})
    x["domain_indicator"] = np.arange(n) % domains  # every domain present
    y = (r.random(n) < 0.4).astype(np.float32)
    y[:2 * domains] = np.repeat([0, 1], domains)  # both classes per domain
    return x, y


def _trainers(fused):
    jm = JMMOE(_feats(jf), D, **KW)
    jt = JTrainer(jm, fused_inference=fused, seed=3)
    pm = PMMOE(_feats(pf), D, device="cpu",
               generator=port_config.make_generator(torch.device("cpu"), 0), **KW)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_jax_params(pm, np_tree(jt.params), np_tree(jt.state))
    pt = PTrainer(pm, device="cpu", fused_inference=fused)
    return jt, pt


def _close(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        assert abs(a - b) <= METRIC_TOL, (a, b)


@pytest.mark.parametrize("fused", [True, False])
def test_serving_matches_jax_trainer(fused):
    jt, pt = _trainers(fused)
    x, y = _data()
    jl = jds.BatchIterable(jds.ColumnarDataset(x, y), BATCH)
    pl = pds.BatchIterable(pds.ColumnarDataset(x, y), BATCH)

    want = np.asarray(jt.predict(jt.model, jl))
    got = np.asarray(pt.predict(pt.model, pl))
    assert got.shape == want.shape == (N_ROWS,)  # padding rows dropped
    np.testing.assert_allclose(got, want, rtol=PROB_RTOL, atol=PROB_ATOL)

    for a, b in zip(pt.evaluate(pt.model, pl), jt.evaluate(jt.model, jl)):
        _close(a, b)
    p_ll, p_auc, p_tll, p_tauc = pt.evaluate_multi_domain_loss(pt.model, pl, D)
    j_ll, j_auc, j_tll, j_tauc = jt.evaluate_multi_domain_loss(jt.model, jl, D)
    for a, b in zip(p_ll + p_auc + [p_tll, p_tauc], j_ll + j_auc + [j_tll, j_tauc]):
        _close(a, b)


def test_empty_domain_reports_none_like_jax():
    jt, pt = _trainers(True)
    x, y = _data(seed=1, domains=2)  # domain 2 of 3 never appears
    jl = jds.BatchIterable(jds.ColumnarDataset(x, y), BATCH)
    pl = pds.BatchIterable(pds.ColumnarDataset(x, y), BATCH)
    p = pt.evaluate_multi_domain_loss(pt.model, pl, D)
    j = jt.evaluate_multi_domain_loss(jt.model, jl, D)
    assert p[0][2] is None and p[1][2] is None
    for a, b in zip(p[0] + p[1] + [p[2], p[3]], j[0] + j[1] + [j[2], j[3]]):
        _close(a, b)


def test_predict_iterable_matches_jax():
    jt, pt = _trainers(True)
    x, _ = _data(seed=2)
    want = np.asarray(jt.predict(jt.model, jds.PredictIterable(x, BATCH)))
    got = np.asarray(pt.predict(pt.model, pds.PredictIterable(x, BATCH)))
    np.testing.assert_allclose(got, want, rtol=PROB_RTOL, atol=PROB_ATOL)


def test_batches_pad_like_jax():
    x, y = _data()
    jb = list(jds.BatchIterable(jds.ColumnarDataset(x, y), BATCH))
    pb = list(pds.BatchIterable(pds.ColumnarDataset(x, y), BATCH))
    assert len(pb) == len(jb) == 4
    for (px, py, pw), (jx, jy, jw) in zip(pb, jb):
        np.testing.assert_array_equal(pw, jw)
        np.testing.assert_array_equal(py, jy)
        for k in jx:
            np.testing.assert_array_equal(px[k], jx[k])
    # the tail: 4 real rows, then row 0 of the tail repeated with weight 0
    tx, _, tw = pb[-1]
    assert tw.tolist() == [1.0] * 4 + [0.0] * (BATCH - 4)
    assert (tx["s0"][4:] == x["s0"][96]).all()
    pg = pds.DataGenerator(x, y).generate_dataloader(split_ratio=[0.6, 0.2],
                                                     batch_size=BATCH, seed=4)
    jg = jds.DataGenerator(x, y).generate_dataloader(split_ratio=[0.6, 0.2],
                                                     batch_size=BATCH, seed=4)
    for p_it, j_it in zip(pg, jg):
        np.testing.assert_array_equal(p_it.dataset.y, j_it.dataset.y)


def test_prefetch_keeps_order_and_errors():
    assert list(prefetch(range(50), 3)) == list(range(50))

    def boom():
        yield 1
        raise KeyError("producer failed")

    it = iter(prefetch(boom(), 2))
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)


def test_host_metrics_match_jax():
    r = np.random.default_rng(9)
    y = (r.random(500) < 0.3).astype(np.float32)
    p = np.round(r.random(500), 2)  # many ties
    p[:3] = [0.0, 1.0, 1.0]  # clipping at 1e-15
    assert abs(pmetrics.auc_score(y, p) - jmetrics.auc_score(y, p)) <= METRIC_TOL
    assert abs(pmetrics.log_loss_score(y, p) - jmetrics.log_loss_score(y, p)) <= METRIC_TOL
    with pytest.raises(ValueError):
        pmetrics.auc_score(np.ones(4), np.arange(4.0))
    with pytest.raises(ValueError):
        pmetrics.auc_score(y[:2] * 0 + [0, 1], [np.nan, 0.5])


def test_trainer_rejects_what_this_slice_does_not_do():
    """``fused_inference="auto"`` resolves (to the port's measured set, as
    JAX's trainer resolves to its own), a stray string raises, and so on
    a mesh."""
    from scenario_wise_rec_tpu_torch.ops.kernels import FUSED_INFERENCE_WINS

    _, pt = _trainers(False)
    model = pt.model
    auto = PTrainer(model, device="cpu", fused_inference="auto")
    assert auto._fused_inference is ("MMOE" in FUSED_INFERENCE_WINS)
    with pytest.raises(ValueError):
        PTrainer(model, device="cpu", fused_inference="false")
    with pytest.raises(TypeError):
        PTrainer(model, device="cpu", mesh=object())
    from scenario_wise_rec_tpu_torch.parallel import make_mesh
    meshed = PTrainer(model, device="cpu", mesh=make_mesh(1, 1), sparse_embedding_updates=True,
                      sparse_update_impl="sorted", fused_inference="auto")
    assert meshed._fused_inference is ("MMOE" in FUSED_INFERENCE_WINS)  # A15.3: it runs


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PMMOE(_feats(pf), D, **KW)
    _, pt = _trainers(False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PTrainer(pt.model)


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import scenario_wise_rec_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('scenario_wise_rec_tpu.')\n"
        "       or m == 'scenario_wise_rec_tpu']\n"
        "print('BAD', bad)\n"
        "print('N', len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout
    assert int(out.stdout.split("N ")[1]) >= 20
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
    imported += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    roots = {m.split(".")[0] for m in imported}
    assert "scenario_wise_rec_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "scenario_wise_rec_tpu"}, roots


def test_kernel_module_imports_and_runs_on_cpu_without_nvcc():
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = "/nonexistent"
    code = (
        "import sys, torch\n"
        "from scenario_wise_rec_tpu_torch.ops.kernels import mmoe_infer as k\n"
        "E, D, F = 2, 2, 6\n"
        "st = [(torch.randn(E, F, 4), torch.randn(E, 4))]\n"
        "g = (torch.randn(D, F, E), torch.randn(D, E))\n"
        "o = (torch.randn(D, 4, 1), torch.randn(D, 1))\n"
        "p = k.mmoe_fused_infer(torch.randn(3, F), torch.tensor([0, 1, 5]), st, g, [], o)\n"
        "assert p.shape == (3,) and k.mmoe_fused_infer.launches == 0\n"
        "print('BUILT', 'scenario_wise_rec_tpu_torch.ops.kernels._build' in sys.modules)\n")
    out = _run(code, env)
    assert out.returncode == 0, out.stderr
    assert "BUILT False" in out.stdout
