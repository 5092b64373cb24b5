"""Carry weights from the JAX package into a port module.

The JAX package keeps a model's weights in ``(params, state)`` trees of
nested dicts and lists. :func:`load_jax_params` takes those trees with
**numpy** leaves (``jax.tree_util.tree_map(np.asarray, tree)``) and copies
every leaf into the module entry of the same path:

- ``embedding/packed`` and ``embedding/tables/<name>``;
- ``<bank>/layers[i]/{lin/{w,b}, bn/{gamma,beta}, act/...}`` and
  ``<bank>/out/{w,b}``, for every bank of MMOE, SharedBottom and PLE
  (``levels[l]/{spec,shared,gates,gate_shared}`` and ``towers``) and
  STAR's ``aux``;
- ``state/<bank>/layers[i]/{mean,var}``, the BatchNorm running stats,
  which the port keeps as ``layers.i.bn.{mean,var}`` buffers;
- ``<collection>/packed`` of the models with two embedding collections
  (EPNet, AdaSparse: ``sce_embedding``/``agn_embedding``; PPNet:
  ``id_embedding``/``agn_embedding``), and every other leaf of SAR-Net,
  EPNet, PPNet and AdaSparse by its own path: ``dom_w``, ``dom_b``, the
  debias banks ``{shared,spec}/{bn,lin}`` with ``state/{shared,spec}/bn``
  and ``gate``; ``gatenu/{l1,l2}`` and ``mlp/out``; ``towers/{mlps[i],
  gates[i]/{l1,l2}, final}``; ``layers[i]``, ``pruners[i]/w``, ``final``
  and the scalar ``state/alpha``, which the port keeps as a buffer;
- STAR's other leaves by their own paths (``dn/*``, ``fcn/{share_w,
  share_b, dom_w, dom_b}[i]``, ``fcn/bn[i]/{gamma,beta}``). Its FCN
  BatchNorm's running stats sit at ``state/bn[i]/{mean,var}`` in the JAX
  tree and beside their parameters, at ``fcn.bn.i.{mean,var}``, in the
  module: a module whose layout departs from its JAX tree says so in a
  ``jax_state_map`` of ``(pattern, replacement)`` rules over state paths,
  applied before the generic rule. HAMUR (and MlpN) map
  ``state/{blocks,hyper}[i]/{mean,var}`` so to ``{blocks,hyper}.i.bn.*``;
- HAMUR's other leaves by their own paths (``blocks[i]/{lin,bn}``,
  ``final``, ``hyper[i]/{lin,bn}``, ``adapters[j]/<name>``), and
  AdaptDHM's ``w[branch][layer]``, ``b[branch][layer]`` and
  ``state/center``, which the port keeps as a buffer;
- M2M's ``transformer/{enc[i]/{attn/{in_w,in_b,out_w,out_b}, ff/{l1,l2}/
  {w,b}, norm1, norm2}, dec[i]/{self_attn, cross_attn, ff, norm1, norm2,
  norm3}, enc_norm, dec_norm}`` (each norm ``{gamma, beta}``), ``v``, and
  its banks ``experts`` (stacked on the expert axis), ``task``,
  ``scenario``, ``vw``, ``vb``, ``tw``, ``tb`` and ``out`` by the bank rule
  above;
- M3oE's ``w_{exp,bal}_{d,t}``, ``skip[i]/{lin,ln}``, ``shared_w``,
  ``shared_b``, ``slot_w``, ``slot_b``, ``star_mlp[i]``, the lists of lists
  ``experts[e][i]`` and ``domain_experts[d][i]``, ``gates[d]/{w,b}`` and
  ``towers[d]/{l1, ln, l2}``; its state is empty.

Any shape mismatch, and any entry missing or left over on either side,
raises. No JAX is imported.

:func:`load_jax_trainer_state` carries a JAX ``CTRTrainer``'s training
state across as well: optax's ``scale_by_adam`` state becomes the
``torch.optim.Adam`` state, and the embedding update's state becomes the
port's: the sorted mode's packed ``[V2/r, 128]`` table and moments (f32, or
bf16 bit for bit into the port's bf16 store), the
occurrence mode's combined ``[V, 3·D]`` store, the dense and winner modes'
``[V, D]`` moments.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from .parallel import shard_range

_BN_STAT = re.compile(r"(^|\.)(layers\.\d+)\.(mean|var)$")


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a": {"b": [x, y]}}`` -> ``{"a.b.0": x, "a.b.1": y}``; ``None``
    leaves and empty containers contribute nothing."""
    out: Dict[str, np.ndarray] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = np.asarray(tree)
        return out
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def jax_state_dict(params, state=None, state_map=()) -> Dict[str, np.ndarray]:
    """The JAX ``(params, state)`` trees as ``{state_dict key: array}`` of a
    port module laid out like them; ``state_map``: the module's
    ``jax_state_map`` rules for state paths."""
    src = flatten_tree(params)
    for path, arr in flatten_tree(state).items():
        key = path
        for pattern, repl in state_map:
            key = re.sub(pattern, repl, key)
        key = _BN_STAT.sub(r"\1\2.bn.\3", key)
        if key in src:
            raise ValueError(f"state entry {path} collides with a parameter")
        src[key] = arr
    return src


def load_jax_params(module: nn.Module, params, state=None) -> None:
    """Copy the JAX ``(params, state)`` trees into ``module`` in place."""
    src = jax_state_dict(params, state, getattr(module, "jax_state_map", ()))
    dst = module.state_dict()
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"JAX tree and module differ: missing {missing}, "
                       f"left over {extra}")
    for key, arr in src.items():
        t = dst[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: JAX shape {tuple(arr.shape)} != "
                             f"module shape {tuple(t.shape)}")
    with torch.no_grad():
        for key, arr in src.items():
            dst[key].copy_(torch.tensor(np.asarray(arr), dtype=dst[key].dtype))


def _is_bf16(a) -> bool:
    """A numpy array of the bfloat16 type JAX hands out (ml_dtypes'; numpy
    has none of its own)."""
    return np.asarray(a).dtype.name == "bfloat16"


def _bf16_tensor(a) -> torch.Tensor:
    """A bfloat16 numpy array as a torch tensor, bit for bit: ``torch``
    refuses the array itself, so through its raw bits."""
    return torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(torch.bfloat16)


def _own_rows(trainer, a):
    """``a`` (``[V, ...]``, numpy) as the trainer holds it: whole, or on a
    mesh this rank's row range, padded with zero rows past V."""
    mesh = getattr(trainer, "mesh", None)
    a = np.asarray(a)
    if mesh is None:
        return a
    row0, rows = shard_range(a.shape[0], mesh)
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    part = a[row0:row0 + rows]
    out[:part.shape[0]] = part
    return out


def _find_adam_state(tree):
    """optax's ``ScaleByAdamState`` inside an optimizer state (found by its
    ``count``/``mu``/``nu`` fields, so optax need not be imported)."""
    if all(hasattr(tree, f) for f in ("count", "mu", "nu")):
        return tree
    if isinstance(tree, (list, tuple)):
        for t in tree:
            found = _find_adam_state(t)
            if found is not None:
                return found
    return None


def load_jax_trainer_state(trainer, params, state, opt_state) -> None:
    """Carry a JAX ``CTRTrainer``'s ``(params, state, opt_state)``, with
    numpy leaves, into a port ``CTRTrainer`` built for the same model and
    update mode, in place.

    - optax's ``scale_by_adam`` ``count``/``mu``/``nu`` trees become the
      ``torch.optim.Adam`` ``step``/``exp_avg``/``exp_avg_sq`` of the
      parameter of the same path (a frozen loose table, which takes no step
      in the port, has none);
    - with ``sparse_embedding_updates``, ``opt_state["emb"]`` becomes the
      model's ``[V, D]`` table (where the JAX params carry none) and the
      trainer's ``emb_opt_state``: in the sorted mode the packed
      ``[V2/r, 128]`` ``table``/``mu``/``nu``, padded past V (a reshape and a
      ``[:V]`` slice), in float32 or, from a JAX trainer built with
      ``sorted_dtype="bf16"``, in bfloat16 bit for bit into the port's bf16
      store (the model's table its float32 copy); in the occurrence mode the
      combined ``comb [V, 3·D]`` (its first D columns the weights); in the
      dense and winner modes ``mu``/``nu``; and ``step``;
    - into a trainer on a mesh (``trainer.mesh``), each rank takes its row
      range of the table and its moments (``parallel.shard_range``, zero
      rows past V), from a JAX single-device trainer's arrays or a JAX mesh
      trainer's (``np.asarray`` gathers those).
    """
    model = trainer.model
    base, emb = opt_state, None
    if trainer._emb_mode is not None:
        emb, base = opt_state["emb"], opt_state["base"]
        col = model.embedding
        v, d = col.packed_vocab, col.packed_dim
        unpack = lambda a: np.asarray(a).reshape(-1, d)[:v]
        if "table" in emb:
            if _is_bf16(emb["table"]) != trainer._bf16_store:
                raise ValueError(
                    f"the JAX sorted table is {np.asarray(emb['table']).dtype} but the "
                    f"trainer's sorted_dtype is {trainer._sorted_dtype!r}")
            packed = unpack(emb["table"])
            if _is_bf16(packed):
                packed = _bf16_tensor(packed).float().numpy()
        elif "comb" in emb:
            packed = np.asarray(emb["comb"])[:, :d]
        else:
            packed = params["embedding"]["packed"]
        packed = _own_rows(trainer, packed)
        params = {**params, "embedding": {**params["embedding"], "packed": packed}}
    load_jax_params(model, params, state)
    adam_state = _find_adam_state(base)
    if adam_state is None:
        raise ValueError("no scale_by_adam state (count, mu, nu) in opt_state")
    frozen = set()
    if getattr(model, "embedding", None) is not None:
        frozen = {f"embedding.tables.{n}" for n in model.embedding.frozen_loose}
    mu, nu = flatten_tree(adam_state.mu), flatten_tree(adam_state.nu)
    mu, nu = ({k: a for k, a in m.items() if k not in frozen} for m in (mu, nu))
    names = [n for n, _ in trainer._dense_named]
    if sorted(mu) != sorted(names) or sorted(nu) != sorted(names):
        raise KeyError(f"optax moments {sorted(mu)} do not match the trainer's "
                       f"parameters {sorted(names)}")
    step = torch.tensor(float(np.asarray(adam_state.count)), dtype=torch.float32)
    as_t = lambda a, p: torch.tensor(np.asarray(a), dtype=p.dtype, device=p.device)
    for name, p in trainer._dense_named:
        trainer.optimizer.state[p] = {"step": trainer._opt_step_tensor(step, p),
                                      "exp_avg": as_t(mu[name], p),
                                      "exp_avg_sq": as_t(nu[name], p)}
    if emb is None:
        return
    st = trainer.emb_opt_state
    with torch.no_grad():
        if "comb" in emb:
            st["comb"][:, d:].copy_(as_t(np.asarray(emb["comb"])[:, d:], st["comb"]))
        elif trainer._bf16_store:
            for k in ("table", "mu", "nu"):
                st[k].copy_(_bf16_tensor(_own_rows(trainer, unpack(emb[k]))))
        else:
            for k in ("mu", "nu"):
                a = unpack(emb[k]) if "table" in emb else emb[k]
                st[k].copy_(as_t(_own_rows(trainer, a), st[k]))
    st["step"] = int(np.asarray(emb["step"]))
