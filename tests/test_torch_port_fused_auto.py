"""``CTRTrainer(fused_inference="auto")`` in the port (the JAX package's
``ops/pallas.fused_inference_auto``): the gate ``fused_inference_auto`` and
its set ``FUSED_INFERENCE_WINS`` in ``scenario_wise_rec_tpu_torch/ops/
kernels``. With the port's set patched to the JAX package's, every registry
model at narrow widths resolves as the JAX trainer resolves it; with the
port's own set (measured on the card by ``scripts/fused_auto_pairs.py``)
each resolves to its class's membership and MlpNLayer never fuses; an
``"auto"`` trainer predicts what the explicit trainer it resolved to
predicts; neither the gate's module nor the script imports JAX. Inputs made
with numpy from a seed; the CPU runs the kernels' plain versions."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scenario_wise_rec_tpu import models as jmodels  # noqa: E402
from scenario_wise_rec_tpu.core import features as jf  # noqa: E402
from scenario_wise_rec_tpu.ops import pallas as jpallas  # noqa: E402
from scenario_wise_rec_tpu_torch import models as pmodels  # noqa: E402
from scenario_wise_rec_tpu_torch.core import features as pf  # noqa: E402
from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset  # noqa: E402
from scenario_wise_rec_tpu_torch.ops import kernels as pkernels  # noqa: E402
from scenario_wise_rec_tpu_torch.train import CTRTrainer as PTrainer  # noqa: E402
from scenario_wise_rec_tpu.train import CTRTrainer as JTrainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
V, N = 20, 150
# one registry name for each model class of the registry
NAMES = ["mmoe", "sharedbottom", "ple", "star", "sarnet", "epnet", "ppnet", "adasparse",
         "hamur", "hamur_small", "adaptdhm", "m2m", "m3oe", "mlpn", "base"]
# narrow constructor arguments (features module -> (args, kwargs)), the same
# for both packages
NARROW = {
    "mmoe": dict(n_expert=2, expert_params={"dims": [16, 8]}, tower_params={"dims": [4]}),
    "sharedbottom": dict(bottom_params={"dims": [16]}, tower_params={"dims": [8, 4]}),
    "star": dict(fcn_dims=[8, 4], aux_dims=[4]),
    "ple": dict(n_level=2, n_expert_specific=2, n_expert_shared=1,
                expert_params={"dims": [16, 8]}, tower_params={"dims": [4]}),
    "hamur": dict(fcn_dims=[16, 16, 12, 12, 8, 8, 6], hyper_dims=[8], k=4),
    "hamur_small": dict(fcn_dims=[16, 8], hyper_dims=[8], k=5),
    "mlpn": dict(fcn_dims=[16, 8]),
    "m3oe": dict(fcn_dims=[16, 8, 8, 4], expert_num=2, exp_d=1, exp_t=1, bal_d=1, bal_t=1),
    "base": {},
}


def _arguments(name, m):
    dense = [m.DenseFeature("d0")]
    sparse = [m.SparseFeature(f"s{i}", V, embed_dim=8) for i in range(3)]
    sce = [m.SparseFeature("domain_indicator", 2, embed_dim=8)]
    ids = [m.SparseFeature("uid", V, embed_dim=8)]
    if name in NARROW:
        return (dense + sparse, 2), NARROW[name]
    return (), {
        "sarnet": dict(features=dense + sparse, domain_num=2, domain_shared_expert_num=3,
                       domain_specific_expert_num=2),
        "epnet": dict(sce_features=sce, agn_features=sparse + dense, fcn_dims=[8]),
        "ppnet": dict(id_features=ids, agn_features=sparse + dense + sce, domain_num=2,
                      fcn_dims=[16, 8]),
        "adasparse": dict(sce_features=sce, agn_features=sparse,
                          mlp_params={"dims": [16, 8], "dropout": 0.0}),
        "adaptdhm": dict(features=sparse + sce, fcn_dims=[16, 8], cluster_num=3, beta=0.9),
        "m2m": dict(features=sparse + sce, domain_feature=sce, domain_num=2, num_experts=4,
                    expert_output_size=4,
                    transformer_dims={"num_encoder_layers": 2, "num_decoder_layers": 2,
                                      "dim_feedforward": 16, "dropout": 0.0}),
    }[name]


def _port_model(name, seed=0):
    args, kw = _arguments(name, pf)
    return pmodels.get_model(name)(*args, **kw, device="cpu",
                                   generator=torch.Generator().manual_seed(seed))


def _jax_model(name):
    args, kw = _arguments(name, jf)
    return jmodels.get_model(name)(*args, **kw)


def _loader(seed=1):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, V, N) for i in range(3)}
    x["uid"] = r.integers(0, V, N)
    x["d0"] = r.normal(size=N).astype(np.float32)
    x["domain_indicator"] = r.integers(0, 2, N)
    return BatchIterable(ColumnarDataset(x, (r.random(N) < 0.4).astype(np.float32)), 64)


def test_every_registry_class_is_covered():
    """The narrow builders cover one name of every class of both registries,
    which hold the same class names."""
    assert ({c.__name__ for c in pmodels.MODEL_REGISTRY.values()}
            == {c.__name__ for c in jmodels.MODEL_REGISTRY.values()})
    assert ({pmodels.get_model(n).__name__ for n in NAMES}
            == {c.__name__ for c in pmodels.MODEL_REGISTRY.values()})
    assert len(NAMES) == 15


@pytest.mark.parametrize("name", NAMES)
def test_resolves_as_jax_with_jax_set(name, monkeypatch):
    """With the port's set patched to the JAX package's
    ``FUSED_INFERENCE_WINS``, the port's gate and an ``"auto"`` trainer
    resolve as the JAX package's gate and trainer do."""
    monkeypatch.setattr(pkernels, "FUSED_INFERENCE_WINS", jpallas.FUSED_INFERENCE_WINS)
    pm, jm = _port_model(name), _jax_model(name)
    assert type(pm).__name__ == type(jm).__name__
    want = jpallas.fused_inference_auto(jm)
    assert pkernels.fused_inference_auto(pm) is want
    assert PTrainer(pm, device="cpu", fused_inference="auto")._fused_inference is want
    assert JTrainer(jm, fused_inference="auto")._fused_inference is want


@pytest.mark.parametrize("name", NAMES)
def test_resolves_to_the_ports_own_set(name):
    """With the port's own set, a model fuses iff its class is in the set
    (and it has a fused eval); MlpNLayer and Base have none."""
    pm = _port_model(name)
    cls = type(pm).__name__
    want = cls in pkernels.FUSED_INFERENCE_WINS
    assert pkernels.fused_inference_auto(pm) is want
    assert PTrainer(pm, device="cpu", fused_inference="auto")._fused_inference is want
    if cls in ("MlpNLayer", "Base"):
        assert not hasattr(pm, "apply_fused_eval") and not want


def test_the_set_names_fused_registry_classes():
    """Every member of the port's set is the class name of a registry model
    that has a fused eval path."""
    fused = {c.__name__ for c in pmodels.MODEL_REGISTRY.values()
             if hasattr(c, "apply_fused_eval")}
    assert len(fused) == 13 and "MlpNLayer" not in fused
    assert set(pkernels.FUSED_INFERENCE_WINS) <= fused


def _pairs_script():
    spec = importlib.util.spec_from_file_location(
        "fused_auto_pairs", REPO / "scripts" / "fused_auto_pairs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_set_is_the_records_verdict():
    """The committed set is what ``scripts/fused_auto_pairs.py``'s rule
    gives over its committed record of sittings on the card, and the record
    covers the 13 fused classes in every sitting."""
    script = _pairs_script()
    record = script.load_record(script.RECORD)
    assert record["sittings"] and all(len(s["models"]) == 13 for s in record["sittings"])
    table = script.verdict(record["sittings"])
    assert {c for c, v in table.items() if v["in"]} == set(pkernels.FUSED_INFERENCE_WINS)


@pytest.mark.parametrize("leads,n,inside", [(6, 6, True), (5, 6, False), (10, 12, True),
                                            (9, 12, False), (4, 4, False), (0, 0, False)])
def test_the_pairs_rule_is_a_sign_test(leads, n, inside):
    """A class is in iff fused led in so many sittings that a fair coin
    would do as well less than 5 times in 100; ties in a sitting are not
    leads."""
    script = _pairs_script()
    row = lambda f, o: {"fused": {"median": f, "min": f, "max": f},
                        "op_by_op": {"median": o, "min": o, "max": o}}
    sittings = [{"models": {"MMOE": row(2.0, 1.0) if i < leads else row(1.0, 1.0)}}
                for i in range(n)]
    assert script.verdict(sittings)["MMOE"]["in"] is inside


def test_mlpn_never_fuses(monkeypatch):
    """MlpNLayer hides ``apply_fused_eval``: it serves op by op under
    ``"auto"`` even where its class name is in the set."""
    monkeypatch.setattr(pkernels, "FUSED_INFERENCE_WINS", frozenset({"MlpNLayer", "Base"}))
    for name in ("mlpn", "base"):
        pm = _port_model(name)
        assert not pkernels.fused_inference_auto(pm)
        assert not PTrainer(pm, device="cpu", fused_inference="auto")._fused_inference


@pytest.mark.parametrize("member", [True, False], ids=["in_set", "out_of_set"])
@pytest.mark.parametrize("name", NAMES)
def test_auto_predicts_as_the_path_it_resolved_to(name, member, monkeypatch):
    """An ``"auto"`` trainer's predictions equal, bit for bit, those of the
    trainer with the explicit ``fused_inference`` it resolved to, with the
    model's class put into the set or left out of it."""
    pm = _port_model(name)
    cls = type(pm).__name__
    monkeypatch.setattr(pkernels, "FUSED_INFERENCE_WINS",
                        frozenset({cls}) if member else frozenset())
    auto = PTrainer(pm, device="cpu", fused_inference="auto")
    resolved = member and hasattr(pm, "apply_fused_eval")
    assert auto._fused_inference is resolved
    explicit = PTrainer(pm, device="cpu", fused_inference=resolved)
    got = np.asarray(auto.predict(pm, _loader()))
    want = np.asarray(explicit.predict(pm, _loader()))
    assert got.shape == (N,) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_a_stray_string_still_raises():
    pm = _port_model("mmoe")
    for bad in ("Auto", "true", "fused"):
        with pytest.raises(ValueError, match="fused_inference"):
            PTrainer(pm, device="cpu", fused_inference=bad)


def test_the_gate_and_the_script_import_no_jax():
    """The gate's module and the trainer load without JAX or the JAX
    package, and ``scripts/fused_auto_pairs.py`` imports neither."""
    code = ("import sys\n"
            "import scenario_wise_rec_tpu_torch.ops.kernels as k\n"
            "import scenario_wise_rec_tpu_torch.train.trainer\n"
            "assert callable(k.fused_inference_auto)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'scenario_wise_rec_tpu' or m.startswith('scenario_wise_rec_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    tree = ast.parse((REPO / "scripts" / "fused_auto_pairs.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names and not names & {"jax", "jaxlib", "scenario_wise_rec_tpu"}
