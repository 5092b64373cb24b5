"""Per-dataset x per-model configuration ladders (the JAX package's
``configs/__init__.py``, copied whole).

The reference has no config system: each run script hard-codes model
hyperparameters in an if/elif ladder (e.g. run_ali_ccp…py:134-163,
run_movielens…py:200-223). This module holds every one of those
combinations behind one ``build_model(dataset, model, data)`` entry point,
with the reference's exact per-dataset settings.

``data`` is the loader's dict with keys ``dense_feas / sparse_feas /
scenario_feas / id_feas / domain_num`` (as applicable). The port adds
``**model_kw`` for the model's constructor (``device``, ``generator``).
"""

from __future__ import annotations

import functools

from ..models import get_model


def _feats(d, *keys):
    out = []
    for k in keys:
        out = out + list(d.get(k, []))
    return out


def _get(name, kw):
    """The model class of ``name`` with ``kw`` bound."""
    return functools.partial(get_model(name), **kw)


# --------------------------------------------------------------------------
# Ali-CCP ladder (reference run_ali_ccp…py:134-163)
# --------------------------------------------------------------------------


def _ali_ccp(model_name, d, **kw):
    D = d["domain_num"]
    dense, sparse = d.get("dense_feas", []), d.get("sparse_feas", [])
    sce, ids = d.get("scenario_feas", []), d.get("id_feas", [])
    m = model_name.lower()
    if m == "star":
        return _get("star", kw)(dense + sparse, D, fcn_dims=[256, 128, 64, 32, 16, 8],
                            aux_dims=[16])
    if m in ("sharedbottom", "sharebottom"):
        return _get("sharedbottom", kw)(dense + sparse, D,
                                    bottom_params={"dims": [512]},
                                    tower_params={"dims": [256, 128, 64, 32, 16, 8]})
    if m == "mmoe":
        return _get("mmoe", kw)(dense + sparse, D, n_expert=D,
                            expert_params={"dims": [256, 128, 64, 32, 16, 8]},
                            tower_params={"dims": [16]})
    if m == "ple":
        return _get("ple", kw)(dense + sparse, D, n_level=1, n_expert_specific=2,
                           n_expert_shared=1,
                           expert_params={"dims": [256, 128, 64, 32, 16, 8]},
                           tower_params={"dims": [16]})
    if m == "adasparse":
        return _get("adasparse", kw)(sce_features=sce, agn_features=sparse,
                                 form="Fusion", epsilon=1e-2, alpha=1.0,
                                 delta_alpha=1e-4,
                                 mlp_params={"dims": [256, 128, 64, 32, 16, 8],
                                             "dropout": 0.2, "activation": "relu"})
    if m == "sarnet":
        return _get("sarnet", kw)(sparse, D, domain_shared_expert_num=8,
                              domain_specific_expert_num=2)
    if m == "m2m":
        return _get("m2m", kw)(dense + sparse + sce, sce, D, num_experts=4,
                           expert_output_size=16)
    if m == "adaptdhm":
        return _get("adaptdhm", kw)(features=sparse + sce,
                                fcn_dims=[256, 128, 64, 32, 16, 8],
                                cluster_num=3, beta=0.9)
    if m == "epnet":
        return _get("epnet", kw)(sce_features=sce, agn_features=sparse + dense,
                             fcn_dims=[256, 128, 64, 32, 16, 8])
    if m == "ppnet":
        return _get("ppnet", kw)(id_features=ids,
                             agn_features=sparse + dense + sce,
                             domain_num=D, fcn_dims=[256, 128, 64, 32, 16, 8])
    if m == "m3oe":
        return _get("m3oe", kw)(features=dense + sparse, domain_num=D,
                            fcn_dims=[512, 256, 256, 64], expert_num=4,
                            exp_d=1, exp_t=1, bal_d=1, bal_t=1)
    if m == "hamur":
        return _get("hamur", kw)(dense + sparse, domain_num=D,
                             fcn_dims=[256, 128, 64, 64, 32, 16, 8],
                             hyper_dims=[64], k=65)
    raise KeyError(f"unknown model '{model_name}' for ali_ccp")


# --------------------------------------------------------------------------
# MovieLens ladder (reference run_movielens…py:200-223)
# --------------------------------------------------------------------------


def _movielens(model_name, d, **kw):
    D = d["domain_num"]
    dense, sparse = d.get("dense_feas", []), d.get("sparse_feas", [])
    sce, ids = d.get("scenario_feas", []), d.get("id_feas", [])
    m = model_name.lower()
    if m == "star":
        return _get("star", kw)(dense + sparse, D, fcn_dims=[128, 64, 32], aux_dims=[32])
    if m in ("sharedbottom", "sharebottom"):
        return _get("sharedbottom", kw)(dense + sparse, D,
                                    bottom_params={"dims": [128]},
                                    tower_params={"dims": [8]})
    if m == "mmoe":
        return _get("mmoe", kw)(dense + sparse, D, n_expert=D,
                            expert_params={"dims": [16]},
                            tower_params={"dims": [8]})
    if m == "ple":
        return _get("ple", kw)(dense + sparse, D, n_level=1, n_expert_specific=2,
                           n_expert_shared=1, expert_params={"dims": [16]},
                           tower_params={"dims": [8]})
    if m == "adasparse":
        return _get("adasparse", kw)(sce_features=sce, agn_features=sparse,
                                 form="Fusion", epsilon=1e-2, alpha=1.0,
                                 delta_alpha=1e-4,
                                 mlp_params={"dims": [32, 32],
                                             "dropout": 0.2, "activation": "relu"})
    if m == "sarnet":
        return _get("sarnet", kw)(sparse, D, domain_shared_expert_num=8,
                              domain_specific_expert_num=2)
    if m == "m2m":
        return _get("m2m", kw)(sparse + sce, sce, D, num_experts=4,
                           expert_output_size=16)
    if m == "adaptdhm":
        return _get("adaptdhm", kw)(features=sparse + sce, fcn_dims=[64, 64],
                                cluster_num=3, beta=0.9)
    if m == "epnet":
        return _get("epnet", kw)(sce_features=sce, agn_features=sparse + dense,
                             fcn_dims=[128, 64, 32])
    if m == "ppnet":
        return _get("ppnet", kw)(id_features=ids, agn_features=sparse + dense + sce,
                             domain_num=D, fcn_dims=[128, 64, 32])
    if m == "m3oe":
        return _get("m3oe", kw)(features=dense + sparse, domain_num=D,
                            fcn_dims=[128, 64, 64, 32], expert_num=4,
                            exp_d=1, exp_t=1, bal_d=1, bal_t=1)
    if m == "hamur":
        return _get("hamur_small", kw)(dense + sparse, domain_num=D,
                                   fcn_dims=[256, 128], hyper_dims=[64], k=35)
    raise KeyError(f"unknown model '{model_name}' for movielens")


def _small_ladder(dataset, mmoe_dims, ple_dims, sb_tower, adasparse_dims,
                  fcn3=[128, 64, 32]):
    """KuaiRand/Amazon/Douban/MIND share a ladder shape with per-dataset dims
    (run_kuairand…py:128-152, run_amazon…py:130-153, run_douban…py:107-132,
    run_mind…py:99-122)."""

    def ladder(model_name, d, **kw):
        D = d["domain_num"]
        dense, sparse = d.get("dense_feas", []), d.get("sparse_feas", [])
        sce, ids = d.get("scenario_feas", []), d.get("id_feas", [])
        m = model_name.lower()
        if m == "star":
            return _get("star", kw)(dense + sparse, D, fcn_dims=fcn3, aux_dims=[32])
        if m in ("sharedbottom", "sharebottom"):
            return _get("sharedbottom", kw)(dense + sparse, D,
                                        bottom_params={"dims": [128]},
                                        tower_params={"dims": sb_tower})
        if m == "mmoe":
            return _get("mmoe", kw)(dense + sparse, D, n_expert=D,
                                expert_params={"dims": mmoe_dims},
                                tower_params={"dims": [16] if mmoe_dims == [32]
                                              else [8]})
        if m == "ple":
            return _get("ple", kw)(dense + sparse, D, n_level=1,
                               n_expert_specific=2, n_expert_shared=1,
                               expert_params={"dims": ple_dims},
                               tower_params={"dims": [16] if ple_dims == [64, 32]
                                             else [8]})
        if m == "adasparse":
            return _get("adasparse", kw)(sce_features=sce, agn_features=sparse,
                                     form="Fusion", epsilon=1e-2, alpha=1.0,
                                     delta_alpha=1e-4,
                                     mlp_params={"dims": adasparse_dims,
                                                 "dropout": 0.2,
                                                 "activation": "relu"})
        if m == "sarnet":
            return _get("sarnet", kw)(sparse, D, domain_shared_expert_num=8,
                                  domain_specific_expert_num=2)
        if m == "m2m":
            return _get("m2m", kw)(sparse + sce, sce, D, num_experts=4,
                               expert_output_size=16)
        if m == "adaptdhm":
            return _get("adaptdhm", kw)(features=sparse + sce, fcn_dims=[64, 64],
                                    cluster_num=3, beta=0.9)
        if m == "epnet":
            return _get("epnet", kw)(sce_features=sce, agn_features=sparse + dense,
                                 fcn_dims=[128, 64, 32])
        if m == "ppnet":
            return _get("ppnet", kw)(id_features=ids,
                                 agn_features=sparse + dense + sce,
                                 domain_num=D, fcn_dims=[128, 64, 32])
        if m == "m3oe":
            return _get("m3oe", kw)(features=dense + sparse, domain_num=D,
                                fcn_dims=[128, 64, 64, 32], expert_num=4,
                                exp_d=1, exp_t=1, bal_d=1, bal_t=1)
        if m == "hamur":
            return _get("hamur_small", kw)(dense + sparse, domain_num=D,
                                       fcn_dims=[256, 128], hyper_dims=[64],
                                       k=35)
        raise KeyError(f"unknown model '{model_name}' for {dataset}")

    return ladder


# KuaiRand/MIND: MMOE [32]/t16, PLE [64,32]/t16, SharedBottom tower [64,32]
# Amazon/Douban: MMOE [16]/t8,  PLE [16]/t8,     SharedBottom tower [8]
_kuairand = _small_ladder("kuairand", mmoe_dims=[32], ple_dims=[64, 32],
                          sb_tower=[64, 32], adasparse_dims=[128, 64, 32])
_mind = _small_ladder("mind", mmoe_dims=[32], ple_dims=[64, 32],
                      sb_tower=[64, 32], adasparse_dims=[128, 64, 32])
_amazon = _small_ladder("amazon", mmoe_dims=[16], ple_dims=[16],
                        sb_tower=[8], adasparse_dims=[32, 32])
_douban = _small_ladder("douban", mmoe_dims=[16], ple_dims=[16],
                        sb_tower=[8], adasparse_dims=[32, 32])


_LADDERS = {
    "ali_ccp": _ali_ccp,
    "aliccp": _ali_ccp,
    "movielens": _movielens,
    "kuairand": _kuairand,
    "amazon": _amazon,
    "amazon_5_core": _amazon,
    "douban": _douban,
    "mind": _mind,
}


def register_ladder(name: str, fn) -> None:
    """Add a dataset: ``fn(model_name, data, **model_kw)`` builds a model,
    passing ``model_kw`` (``device``, ``generator``) to its constructor."""
    _LADDERS[name] = fn


def build_model(dataset: str, model_name: str, data: dict, **model_kw):
    """The model ``model_name`` with ``dataset``'s settings. ``model_kw``
    goes to the model's constructor: ``device`` (default the card) and
    ``generator`` (the initial weights' draws)."""
    key = dataset.lower().replace("-", "_")
    if key not in _LADDERS:
        raise KeyError(f"unknown dataset '{dataset}' (have {sorted(_LADDERS)})")
    return _LADDERS[key](model_name, data, **model_kw)
