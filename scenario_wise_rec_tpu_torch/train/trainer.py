"""CTR trainer (the JAX package's ``train/trainer.py``): train steps, ``fit``
with early stopping and a final checkpoint, and the reference's eval
protocol.

- **Train step**: forward + BCE on probabilities + backward + torch-Adam.
  The plain step (``sparse_embedding_updates=False``) differentiates the
  packed embedding table itself and leaves it to ``torch.optim.Adam``. With
  ``sparse_embedding_updates=True`` the table leaves the autograd graph and
  ``torch.optim``: the step gathers the batch's rows ``packed[touched_ids]``,
  differentiates with respect to those ``[K, D]`` rows (no dense ``[V, D]``
  gradient exists), steps ``torch.optim.Adam`` on every other parameter and
  updates the table by ``sparse_update_impl`` (``train/optim.py``):

  - ``"sorted"``: exact dense Adam on every row through the sorted kernel
    (``ops/kernels/sorted_adam.py``), ids sorted globally. With
    ``sorted_dtype="bf16"`` the table and its moments live in a bf16 store
    of their own (``emb_opt_state["table"|"mu"|"nu"]``): the step gathers its
    rows from the store and the kernel's bf16 form steps it, rounding every
    value back to bf16. The model's ``embedding.packed`` is then a float32
    copy, refreshed from the store before every eval or predict pass and
    every ``save`` (so every early-stop snapshot); ``load`` and an early-stop
    restore refill the store from it, which is exact;
  - ``"dense"``: the same semantics through the kernel of
    ``ops/kernels/fused_adam.py``, ids sorted within each feature's segment;
  - ``"occurrence"`` (the default): lazy ``torch.optim.SparseAdam``
    semantics on a combined ``[V, 3·D]`` store of weights and moments: one
    gather ``comb[ids]`` feeds the forward and the update, the duplicate
    sums and the one row write-back are the kernels of
    ``ops/kernels/row_update.py``. The model's ``embedding.packed`` becomes
    the strided view ``comb[:, :D]``, so eval, ``predict``, ``save``,
    ``load`` and ``fit``'s early-stop snapshot and restore always see the
    live weights;
  - ``"winner"``: the same lazy semantics on the model's table: a winner
    scatter into an O(V) scratch sums the duplicates, and the row write-back
    kernel of ``ops/kernels/row_update.py`` writes the table and both
    moments.

  The two exact modes compute the reference's ``torch.optim.Adam``
  semantics; the two lazy ones differ from it as ``SparseAdam`` does
  (untouched rows take no weight decay and keep their moments). A model
  without an ``embedding`` collection (EPNet, PPNet and AdaSparse keep two)
  runs the plain step whatever ``sparse_embedding_updates`` says, as the JAX
  trainer does. Every dense parameter takes its Adam step every step, one
  the loss does not reach too (its gradient is zero, as in the JAX
  package's optax chain). Frozen ``Pretrained`` tables of the
  ``embedding`` collection stay fixed in every mode (``train/freeze.py``).
- **Eval**: ``predict``, ``evaluate`` and ``evaluate_multi_domain_loss``
  (the reference's per-domain slicing protocol, the acceptance metric of
  the benchmark) run the eval forward batch by batch and score on the host
  with sklearn-parity AUC/logloss; with ``on_device=True`` predictions,
  labels, domains and weights stay on the device and score there
  (``auc_score_device``/``log_loss_device``, one host read of the results).
  With ``fused_inference=True`` a model
  that has ``apply_fused_eval`` (every registered model but ``Base`` and
  ``MlpNLayer``) runs everything after the embedding in one CUDA kernel, its
  BatchNorm folded once per eval pass; ``"auto"`` does so for the models
  that the port's measured set says fuse faster
  (``ops/kernels.fused_inference_auto``). The step passes each batch's padding mask ``w``:
  STAR's domain norm reads the batch's own statistics at eval too.
- **Batches**: a host loader's batches are sliced on the prefetch thread
  and, on a CUDA trainer, staged there in pinned memory, so their copies to
  the card do not sync the host (``data/prefetch.py:stage_batches``). A
  ``DeviceResidentLoader`` (``data/device.py``) keeps the epoch's columns on
  the device, and each step gathers its batch there
  (:meth:`CTRTrainer.train_one_epoch_resident`).
- **scan_steps = S > 1** (the JAX package's S steps a dispatch, its
  ``lax.scan``), in every mode: each dispatch stages S batches as one int
  and one float matrix (a host loader's packed on the prefetch thread and
  copied from pinned memory, a resident loader's gathered on the device)
  and runs S steps of one step body that picks its batch rows, its
  embedding update's Adam numbers ``hp`` and its loss slot by a device-side
  step counter. In every mode, that body is captured once on the card as a
  CUDA graph, after warm-up steps of the epoch run eagerly, and replayed for
  every later step (the remainder is fewer replays); on the CPU it runs
  uncaptured. Replays equal eager steps: the dense ``torch.optim.Adam`` is
  ``capturable``, the dropout generator is registered with the graph, and
  the update reads each step's Adam numbers from device memory (the sorted
  and dense kernels a 7-number row, the occurrence and winner updates a
  3-number one). Losses are logged as the JAX trainer logs them.
- **fit**: per-epoch StepLR, ``train_one_epoch`` (over a host loader or a
  ``DeviceResidentLoader``), validation AUC, early stopping that restores
  the best weights only on a stop, and a final checkpoint (reference
  ctr_trainer.py:62-97).
- **Mesh** (``mesh=parallel.make_mesh(n_data, n_embed)``, the JAX trainer's
  ``mesh``; one process a rank of a ``torch.distributed`` group, every rank
  running the same calls): the sorted update only. The batch is sharded over
  ``data``; the packed table, and the sorted update's moments (and bf16
  store), are row-sharded over ``embed`` (``parallel/sharding_rules.py``).
  Every rank draws the same full init, keeps its row shard and frees the
  rest; rank 0's dense parameters and BN buffers are broadcast. A step takes
  this rank's rows of the global batch: ``touched_ids``, rows from
  ``sharded_lookup``, the forward and loss inside ``parallel.mesh_step``
  (batch statistics, dropout masks and the loss's mean are the global
  batch's), backward, the dense gradients summed over ``data``,
  ``torch.optim.Adam``, and the shard's sorted update
  (``sorted_dense_adam_apply_sharded`` on the ids and rows gathered over
  ``data``). The logged loss is the global one. ``scan_steps`` S > 1 runs a
  dispatch's steps one by one, uncaptured (``graphed`` is False under a
  mesh). Eval scores each rank's rows op by op through ``sharded_lookup``
  and gathers the scores over ``data``, so every rank returns the
  single-process metrics. ``save`` gathers the shards over ``embed`` and
  rank 0 writes the single-process format; ``load`` takes each rank's rows,
  so a checkpoint moves between mesh shapes.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Optional

import numpy as np
import torch

from . import checkpoint as ckpt_lib
from ..core.config import make_generator, resolve_device
from ..data.device import DeviceResidentLoader, gather_columns
from ..data.prefetch import prefetch, stage_batches, stage_dispatches
from ..ops.kernels import fused_inference_auto
from ..ops.kernels.sorted_adam import adam_hparams_rows, check_jax_dials
from ..parallel import (Mesh, gather_rows, mesh_step, param_specs, replicate,
                        shard_batch_fn, shard_rows, shard_stacked_batch_fn, sharded_lookup)
from ..parallel.mesh import all_gather_rows, all_reduce_, barrier, broadcast_object
from .callback import EarlyStopper
from .freeze import rows_kept, zero_rows
from .loss import bce_loss
from .metrics import auc_score, auc_score_device, log_loss_device, log_loss_score
from .optim import (adam, fused_dense_adam_update, occurrence_hparams_rows,
                    sorted_dense_adam_init, sorted_dense_adam_update, sparse_adam_init,
                    sparse_adam_occurrence_init, sparse_adam_occurrence_update,
                    sparse_adam_rowgrads_update)

_EMB_MODES = ("dense", "winner", "occurrence", "sorted")
# the width of the Adam-number row a step of each update reads from the
# device in a dispatch (sorted_adam.adam_hparams_rows, optim.occurrence_hparams_rows)
_HP_WIDTH = {"sorted": 7, "dense": 7, "occurrence": 3, "winner": 3}
# eager steps of a new step plan before its capture: the optimizer's state,
# cuBLAS's workspace and the kernels' libraries exist before capture
WARMUP_STEPS = 2


class _StepPlan:
    """The static buffers of ``scan_steps`` steps of ``b`` rows, and on the
    card the captured step: every tensor the step body reads is one of
    these, so a replay reads what the dispatch staged.

    ``ints``/``floats``/``w``: the dispatch's packed batches (the
    ``DeviceResidentLoader`` layout, label last), ``hp``: one row of the
    embedding update's Adam numbers a step (``hp_width`` of them: 7 for the
    sorted and dense kernels, 3 for the occurrence and winner updates; None
    for the plain step), ``losses``: one slot a step,
    ``counter``: the step within the dispatch, advanced by the step body."""

    def __init__(self, loader, layout, b, steps, n_int, n_float1, device, hp_width):
        self.loader, self.layout, self.b = loader, layout, b
        self.ints = torch.empty((steps * b, n_int), dtype=torch.int32, device=device)
        self.floats = torch.empty((steps * b, n_float1), dtype=torch.float32, device=device)
        self.w = torch.empty((steps * b,), dtype=torch.float32, device=device)
        self.hp = (torch.empty((steps, hp_width), dtype=torch.float32, device=device)
                   if hp_width else None)
        self.losses = torch.empty((steps,), dtype=torch.float32, device=device)
        self.counter = torch.zeros((1,), dtype=torch.long, device=device)
        self.rows = torch.arange(b, device=device)
        self.graph = None
        self.state = None  # what the graph writes, as it was at capture
        self.warm = 0

    def matches(self, loader, layout, b, n_int, n_float1) -> bool:
        return (self.loader is loader and self.layout == layout and self.b == b
                and self.ints.shape[1] == n_int and self.floats.shape[1] == n_float1)


class CTRTrainer:
    """General single-task CTR trainer (reference ctr_trainer.py:10-60 API).

    Args:
        model: an ``nn.Module`` exposing ``apply(x, train, w, generator,
            rows) -> probs``.
        optimizer_fn / optimizer_params: ``optimizer_fn(**optimizer_params)``
            returns a ``params -> torch.optim.Optimizer`` factory; default
            :func:`optim.adam` with ``{"lr": 1e-3, "weight_decay": 1e-5}``
            (torch-Adam, ctr_trainer.py:50-52).
        scheduler_fn / scheduler_params: optional epoch-level lr multiplier,
            e.g. ``optim.step_lr``; the reference never instantiates one.
        n_epoch / earlystop_patience / model_path / data_set_type: as the
            reference; ``fit`` saves ``<model_path>/<Model>_<data_set_type>_
            <time>.npz``.
        device: where the model and batches live; default ``"cuda"``. With
            no card present this raises unless the caller passes ``"cpu"``.
        seed: seeds the generator that dropout draws from.
        sparse_embedding_updates / sparse_update_impl: ``True`` with
            ``"occurrence"`` (default), ``"dense"``, ``"winner"`` or
            ``"sorted"`` runs that embedding update (see the module
            docstring); ``"sorted"`` needs a packed width dividing 128, as
            in the JAX package.
        fused_inference: ``True`` runs eval through ``apply_fused_eval``;
            ``"auto"`` resolves to ``ops.kernels.fused_inference_auto(model)``
            (the models whose fused eval measured faster on the card).
        scan_steps: the JAX package's optimizer steps per device dispatch
            (a positive int). 1: one eager step a batch. S > 1: S steps a
            dispatch through one step body, with the same result as S
            single steps; captured once as a CUDA graph and replayed on the
            card in every mode (see the module docstring; :attr:`graphed`,
            :attr:`graph_replays`). A
            graphed trainer's dense optimizer must take ``capturable``
            (torch's Adam does), which the trainer sets. A failed capture
            raises; nothing falls back to eager steps.
        prefetch_depth: host batches prepared ahead on a thread (0: none).
        sorted_block_rows: the sorted kernel's vocab tile (default: the
            port's own for the storage type, ``DEFAULT_BLOCK_ROWS`` or
            ``DEFAULT_BLOCK_ROWS_BF16`` of ``ops/kernels/sorted_adam.py``).
        sorted_dtype: the sorted mode's storage of the table and its
            moments, None or "float32" (the model's own table) or "bf16" (a
            bf16 store; see the module docstring). The Adam math is float32
            in both.
        sorted_reorder / sorted_chunk_ids / sorted_precision: the JAX dials,
            checked here and not used: on the card one stable sort orders
            the ids, no operand is rounded to bf16 and there are no id
            chunks (``sorted_dense_adam_apply``'s docstring).
        resident_gather: ``"step"`` or ``"dispatch"``, the JAX package's
            gather of a resident batch per step or per dispatch of S steps.
            Both give the same result; the port gathers a dispatch's rows
            at once, outside its graph.
        donate_buffers / sorted_kernel: accepted for the JAX signature; the
            port updates in place and picks the kernel by the tensor's
            device (``sorted_kernel=False`` is refused).
        mesh: a ``parallel.Mesh`` (``make_mesh``) for multi-GPU training
            with the sorted update (see the module docstring); any other
            object raises ``TypeError``. The global batch must divide by
            the mesh's ``data`` size. More than one entry in ``gpus`` raises:
            one process drives one card, and ranks join through ``mesh``.

    Not ported yet under a mesh, each raising ``NotImplementedError`` with
    its ROADMAP item: the occurrence, dense and winner updates and the plain
    step (A15.2); a ``DeviceResidentLoader`` and ``fused_inference`` other
    than False (A15.3).
    """

    def __init__(
        self,
        model,
        data_set_type: str = "dataset",
        optimizer_fn=None,
        optimizer_params: Optional[dict] = None,
        scheduler_fn=None,
        scheduler_params: Optional[dict] = None,
        n_epoch: int = 10,
        earlystop_patience: int = 10,
        device: str = "cuda",
        gpus=None,
        model_path: str = "./",
        seed: int = 0,
        mesh=None,
        sparse_embedding_updates: bool = False,
        sparse_update_impl: str = "occurrence",
        fused_inference=False,  # False | True | "auto"
        donate_buffers: bool = False,
        scan_steps: int = 1,
        prefetch_depth: int = 2,
        sorted_reorder: str = "gather",
        sorted_block_rows: Optional[int] = None,
        sorted_chunk_ids: int = 128,
        sorted_dtype: Optional[str] = None,
        sorted_precision: Optional[str] = None,
        sorted_kernel: Optional[bool] = None,
        resident_gather: str = "step",
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a scenario_wise_rec_tpu_torch.parallel.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        if gpus is not None and len(gpus) > 1:
            raise NotImplementedError(
                "one process drives one card: run one process a rank and pass "
                "mesh=parallel.make_mesh(n_data, n_embed) (ROADMAP A15)")
        if mesh is not None and fused_inference is not False:
            raise NotImplementedError(
                "fused_inference under a mesh is ROADMAP A15.3; pass fused_inference=False")
        if fused_inference == "auto":
            fused_inference = fused_inference_auto(model)
        elif not isinstance(fused_inference, bool):
            # a stray string like "false"/"off" would otherwise coerce to True
            raise ValueError(
                f"fused_inference must be True, False or 'auto', got "
                f"{fused_inference!r}")
        if sparse_update_impl not in _EMB_MODES:
            raise ValueError(f"unknown sparse_update_impl {sparse_update_impl!r}")
        emb = getattr(model, "embedding", None)
        self._sparse_emb = bool(sparse_embedding_updates and emb is not None
                                and emb.packed_names)
        if sorted_dtype not in (None, "float32", "bf16"):
            raise ValueError(f"sorted_dtype must be None, 'float32' or 'bf16', "
                             f"got {sorted_dtype!r}")
        check_jax_dials(sorted_chunk_ids, sorted_precision, sorted_reorder)
        if int(scan_steps) < 1:
            raise ValueError(f"scan_steps must be a positive int, got {scan_steps!r}")
        if sorted_kernel not in (None, True):
            raise ValueError("the port picks the sorted kernel by the table's "
                             "device: the CPU runs the plain version, the card "
                             "the kernel; sorted_kernel=False has no meaning")
        if resident_gather not in ("step", "dispatch"):
            raise ValueError(f"unknown resident_gather {resident_gather!r}")
        if mesh is not None and not (self._sparse_emb and sparse_update_impl == "sorted"):
            raise NotImplementedError(
                "under a mesh only sparse_embedding_updates=True with "
                "sparse_update_impl='sorted' is ported; the "
                f"{sparse_update_impl if self._sparse_emb else 'plain'} step is ROADMAP A15.2")
        self.mesh = mesh
        self._sparse_impl = sparse_update_impl
        self.scan_steps = int(scan_steps)
        self._deferred_log = None
        if self._sorted_mode and 128 % emb.packed_dim:
            # the JAX package's rule, kept so both accept the same configs
            raise ValueError(
                "sparse_update_impl='sorted' requires the packed embed_dim to "
                f"divide 128, got {emb.packed_dim}")
        self._sorted_block_rows = int(sorted_block_rows) if sorted_block_rows else None
        self._sorted_dtype = sorted_dtype or "float32"
        # frozen pretrained tables of the embedding collection (train/freeze.py)
        self._frozen_spans = tuple(emb.frozen_spans) if emb is not None else ()

        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if mesh is not None:
            self._place_on_mesh()
        self.data_set_type = data_set_type
        if optimizer_params is None:
            optimizer_params = {"lr": 1e-3, "weight_decay": 1e-5}
        self._opt_params = dict(optimizer_params)
        self._base_lr = self._opt_params.get("lr", 1e-3)
        self._lr_now = self._base_lr
        self._epoch_schedule = (scheduler_fn(**(scheduler_params or {}))
                                if scheduler_fn is not None else None)
        if emb is not None:
            # a frozen loose table takes no gradient and no step, as
            # nn.Embedding.from_pretrained(freeze=True)
            for name in emb.frozen_loose:
                self.model.embedding.tables[name].requires_grad_(False)
        # every sparse mode keeps the packed table out of torch.optim
        packed = self.model.embedding.packed if self._sparse_emb else None
        self._dense_named = [(n, p) for n, p in self.model.named_parameters()
                             if p.requires_grad and p is not packed]
        factory = (optimizer_fn or adam)(**self._opt_params)
        self.optimizer = (factory([p for _, p in self._dense_named])
                          if self._dense_named else None)
        if self.graphed and self.optimizer is not None:
            if "capturable" not in self.optimizer.defaults:
                raise ValueError(
                    f"scan_steps={self.scan_steps} captures the train step in a CUDA "
                    f"graph: the optimizer needs torch's capturable option, which "
                    f"{type(self.optimizer).__name__} lacks")
            for group in self.optimizer.param_groups:
                group["capturable"] = True
        self.emb_opt_state = self._init_emb_state()
        self.n_epoch = n_epoch
        self.early_stopper = EarlyStopper(patience=earlystop_patience)
        self.model_path = model_path
        self.seed = seed
        self.generator = make_generator(self.device, seed)
        self.epoch_i = 0
        # the step plan of scan_steps > 1 and its graph (one at a time, in a
        # memory pool of the trainer's own); findings counters
        self._plan = None
        self._graph_pool = None
        self._graph_stream = None
        self.graph_replays = 0
        self.graph_captures = 0
        self.graph_capture_s = None
        self.graph_pool_bytes = None
        self._fused_inference = fused_inference and hasattr(model, "apply_fused_eval")
        self.prefetch_depth = max(0, int(prefetch_depth))
        self._eval_step = self._build_eval_step()

    @property
    def _emb_mode(self) -> Optional[str]:
        """The embedding update of the step, or None for the plain step."""
        return self._sparse_impl if self._sparse_emb else None

    @property
    def _sorted_mode(self) -> bool:
        return self._emb_mode == "sorted"

    @property
    def _dispatched(self) -> bool:
        """``scan_steps > 1``: the steps run S a dispatch, in every mode."""
        return self.scan_steps > 1

    @property
    def graphed(self) -> bool:
        """True when the train steps run as a CUDA graph: ``scan_steps > 1``
        on the card, in every mode. False at ``scan_steps=1``, on the CPU
        and under a mesh (capture with collectives is ROADMAP A15.4)."""
        return self._dispatched and self.device.type == "cuda" and self.mesh is None

    @property
    def _capturable(self) -> bool:
        return self.optimizer is not None and any(
            g.get("capturable", False) for g in self.optimizer.param_groups)

    def _opt_step_tensor(self, value, p) -> torch.Tensor:
        """torch.optim's step count for ``p``, a tensor of its own: on
        ``p``'s device when the optimizer is capturable, else on the host."""
        t = torch.tensor(float(value), dtype=torch.float32)
        return t.to(p.device) if self._capturable else t

    @property
    def _bf16_store(self) -> bool:
        """The sorted mode with its table and moments in a bf16 store."""
        return self._sorted_mode and self._sorted_dtype == "bf16"

    def _sync_packed(self):
        """With a bf16 store: copy its table into the model's f32 table."""
        if self._bf16_store:
            with torch.no_grad():
                self.model.embedding.packed.copy_(self.emb_opt_state["table"])

    def _refill_store(self):
        """With a bf16 store: take the model's table into it (after ``load``
        or a restore; a table synced from the store comes back exactly).
        Drops the captured step in every mode: state was rewritten."""
        self._drop_graph()
        if self._bf16_store:
            with torch.no_grad():
                self.emb_opt_state["table"].copy_(self.model.embedding.packed)

    # -- mesh (parallel/) ----------------------------------------------------

    def _place_on_mesh(self):
        """Keep this rank's row shard of the packed table (freeing the full
        one) and take rank 0's dense parameters and buffers."""
        col, mesh = self.model.embedding, self.mesh
        self._vocab = col.packed_vocab
        local, self._row0 = shard_rows(col.packed.detach(), mesh)
        col.packed = torch.nn.Parameter(local)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        specs = param_specs(self.model)
        replicate(mesh, [v for k, v in self.model.state_dict().items() if specs[k] is None])
        self._shard = shard_batch_fn(mesh)
        self._shard_stacked = shard_stacked_batch_fn(mesh)

    def _lookup(self, table, ids) -> torch.Tensor:
        """The packed rows of global ``ids`` from this rank's shard
        ``table`` (``sharded_lookup`` over ``embed``)."""
        return sharded_lookup(table, ids, self._row0, self.mesh.embed_group)

    def _sum_dense_grads(self):
        """Sum the dense gradients over ``data``: each rank's loss is its
        share of the global mean, so the sum is the global gradient."""
        group = self.mesh.data_group
        if group is None or not self._dense_named:
            return
        grads = [p.grad for _, p in self._dense_named]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def _init_emb_state(self):
        if self._emb_mode is None:
            return None
        col = self.model.embedding
        if self._bf16_store:
            return sorted_dense_adam_init(col.packed.detach(), dtype=torch.bfloat16)
        if self._emb_mode != "occurrence":
            return sparse_adam_init(col.packed.detach())
        state = sparse_adam_occurrence_init(col.packed.detach())
        # the model's table becomes the weight columns of the combined store,
        # a strided view that every reader and writer of the weights shares
        col.packed = torch.nn.Parameter(state["comb"][:, :col.packed_dim])
        return state

    def _build_eval_step(self):
        model = self.model
        if self._fused_inference:
            def step(x, w, folded):
                return model.apply_fused_eval(x, w=w, folded=folded)

            return step

        def step(x, w, folded):
            return model.apply(x, train=False, w=w)

        return step

    def _batches(self, data_loader):
        """``((x, y, w), host)`` for each batch of a host loader, prepared
        ``prefetch_depth`` batches ahead on a thread; on a CUDA trainer
        ``host`` lies in pinned memory (``stage_batches``)."""
        return prefetch(stage_batches(data_loader, pin=self.device.type == "cuda"),
                        self.prefetch_depth)

    def _device_batch(self, x, y, w):
        """A host batch on the trainer's device. Numpy columns are copied as
        they are; CPU tensors (``stage_batches``' staging) go with
        ``non_blocking=True``, which for pinned ones neither syncs the
        stream nor blocks the host."""
        def to(a, dtype=None):
            if isinstance(a, torch.Tensor):
                return a.to(self.device, non_blocking=True)
            return torch.as_tensor(np.asarray(a, dtype), device=self.device)

        return ({k: to(v) for k, v in x.items()},
                None if y is None else to(y, np.float32), to(w))

    # -- training ---------------------------------------------------------

    def _train_step(self, x, y, w, hp=None) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (on the
        device: reading it is the caller's sync). ``hp``: the embedding
        update's Adam numbers as a device row (a dispatch's step
        body); the caller then advances the update's step count."""
        model, mode, st = self.model, self._emb_mode, self.emb_opt_state
        rows = None
        if mode is not None:
            col = model.embedding
            ids = col.touched_ids(x)
            if mode == "occurrence":
                # one gather: the weights feed the forward, the moments ride
                # along to the update
                r3 = st["comb"][ids]
                rows = r3[:, :col.packed_dim].detach().requires_grad_()
            else:
                # a gathered copy: the update may change the live table in place
                src = st["table"] if self._bf16_store else col.packed.detach()
                rows = src[ids] if self.mesh is None else self._lookup(src, ids)
                rows = rows.float().requires_grad_()
        with (mesh_step(self.mesh, w.shape[0]) if self.mesh is not None
              else contextlib.nullcontext()):
            probs = model.apply(x, train=True, w=w, generator=self.generator, rows=rows)
            loss = bce_loss(probs, y, w)
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.optimizer is not None:
            # torch.optim.Adam skips a parameter whose .grad is None; the JAX
            # package's optax chain steps every leaf, a zero gradient
            # included, so weight decay still moves it (PPNet's agnostic
            # table, which the loss reaches only through detach)
            for _, p in self._dense_named:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.mesh is not None:
                self._sum_dense_grads()
            self._optimizer_step()
        if mode is None:
            return loss.detach()
        p = self._opt_params
        kw = dict(lr=self._lr_now, weight_decay=p.get("weight_decay", 1e-5),
                  b1=p.get("b1", 0.9), b2=p.get("b2", 0.999), eps=p.get("eps", 1e-8),
                  frozen_spans=self._frozen_spans)
        if mode == "sorted":
            sorted_dense_adam_update(st["table"] if self._bf16_store else col.packed, st,
                                     rows.grad, ids, block_rows=self._sorted_block_rows,
                                     hp=hp, mesh=self.mesh,
                                     segments=col.touched_owner_segments(x), **kw)
            if self.mesh is not None:
                # the global batch's loss: the ranks' shares summed
                return all_reduce_(loss.detach().clone(), self.mesh.data_group)
        elif mode == "dense":
            fused_dense_adam_update(col.packed, st, rows.grad, ids,
                                    col.touched_owner_segments(x), hp=hp, **kw)
        elif mode == "winner":
            sparse_adam_rowgrads_update(col.packed, st, rows.grad, ids, hp=hp, **kw)
        else:
            sparse_adam_occurrence_update(st, rows.grad, ids,
                                          col.touched_owner_segments(x), r3, hp=hp, **kw)
        return loss.detach()

    def _optimizer_step(self):
        """``torch.optim`` over the dense parameters. In the plain step the
        packed table is one of them: its frozen rows then keep their weights
        and their moments stay zero (``train/freeze.py``)."""
        if self._emb_mode is not None or not self._frozen_spans:
            self.optimizer.step()
            return
        packed = self.model.embedding.packed
        with rows_kept([packed], self._frozen_spans):
            self.optimizer.step()
        st = self.optimizer.state[packed]
        zero_rows([st["exp_avg"], st["exp_avg_sq"]], self._frozen_spans)

    @staticmethod
    def _log_losses(done, n_total, pending) -> float:
        """Print the mean of the pending losses (a read, so a sync with the
        device) and return it."""
        mean = float(torch.stack([l.mean() for l in pending]).mean())
        print(f"  step {done}/{n_total} loss {mean:.5f}", flush=True)
        return mean

    def _flush_epoch_log(self) -> Optional[float]:
        """Print a resident epoch's deferred last loss line and return its
        mean (None if nothing is deferred). Reading it waits for the epoch's
        last step."""
        d, self._deferred_log = self._deferred_log, None
        return None if d is None else self._log_losses(*d)

    def barrier(self) -> Optional[float]:
        """Wait for all queued device work: print the deferred loss line of a
        resident epoch, then synchronize the trainer's device. Returns that
        line's mean loss, or None."""
        last = self._flush_epoch_log()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return last

    # -- scan_steps > 1: S steps a dispatch, a CUDA graph on the card --------

    def _drop_graph(self):
        """Forget the step plan and its captured graph (the next dispatch
        warms up and captures anew)."""
        self._plan = None

    def _graph_state(self):
        """What a captured step writes and bakes in: the address, type and
        shape of every parameter, buffer and optimizer state tensor, the
        dense optimizer's hyperparameters and the dropout generator. A graph
        captured under other values would write tensors the trainer no
        longer holds."""
        ts = list(self.model.parameters()) + list(self.model.buffers())
        if self.optimizer is not None:
            for st in self.optimizer.state.values():
                ts += [v for v in st.values() if torch.is_tensor(v)]
        ts += [v for v in (self.emb_opt_state or {}).values() if torch.is_tensor(v)]
        groups = tuple(tuple((k, v) for k, v in sorted(g.items()) if k != "params"
                             and isinstance(v, (int, float, bool, tuple)))
                       for g in getattr(self.optimizer, "param_groups", ()))
        return (tuple((t.data_ptr(), t.dtype, tuple(t.shape)) for t in ts), groups,
                self.generator)

    def _plan_for(self, loader, layout, b, n_int, n_float1) -> _StepPlan:
        """The step plan for ``loader``'s batches (kept by the loader's
        identity and the batch shape), new if the kept one's graph would
        write tensors the trainer no longer holds."""
        p = self._plan
        if (p is not None and p.matches(loader, layout, b, n_int, n_float1)
                and (p.graph is None or p.state == self._graph_state())):
            return p
        self._plan = None  # release the old graph before a new capture
        self._plan = _StepPlan(loader, layout, b, self.scan_steps, n_int, n_float1,
                               self.device, _HP_WIDTH.get(self._emb_mode))
        return self._plan

    def _plan_step(self, plan: _StepPlan):
        """The step body: the batch at the plan's counter, one
        :meth:`_train_step`, its loss into its slot, the counter advanced.
        Nothing here reads the host, so it can be captured."""
        sel = plan.counter * plan.b + plan.rows
        x, y = gather_columns(plan.layout, plan.ints.index_select(0, sel),
                              plan.floats.index_select(0, sel))
        hp = (None if plan.hp is None
              else plan.hp.index_select(0, plan.counter).view(plan.hp.shape[1]))
        loss = self._train_step(x, y, plan.w.index_select(0, sel), hp=hp)
        plan.losses.index_copy_(0, plan.counter, loss.view(1))
        plan.counter.add_(1)

    def _warm_step(self, plan: _StepPlan):
        """One eager step of the plan on the graph's stream."""
        cur = torch.cuda.current_stream(self.device)
        self._graph_stream.wait_stream(cur)
        with torch.cuda.stream(self._graph_stream):
            self._plan_step(plan)
        cur.wait_stream(self._graph_stream)
        plan.warm += 1

    def _capture(self, plan: _StepPlan):
        """Capture the step body as the plan's CUDA graph, in the trainer's
        memory pool, with the dropout generator registered so that every
        replay draws fresh masks. Raises if the capture fails."""
        g = torch.cuda.CUDAGraph()
        if self.generator.device.type == "cuda":
            g.register_generator_state(self.generator)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        # torch.cuda.graph collects garbage before the capture; no collection
        # may run inside it (freeing another graph's memory there is a call
        # the capture refuses)
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g, pool=self._graph_pool, stream=self._graph_stream,
                                  capture_error_mode="thread_local"):
                before = torch.cuda.memory_reserved(self.device)
                self._plan_step(plan)
        except RuntimeError as e:
            self._plan = None
            raise RuntimeError(
                f"capturing the train step as a CUDA graph failed (scan_steps="
                f"{self.scan_steps}, update {self._emb_mode or 'plain'}); pass "
                "scan_steps=1 for eager steps") from e
        finally:
            if gc_was_on:
                gc.enable()
        self.graph_pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.graph_capture_s = time.perf_counter() - t0
        self.graph_captures += 1
        plan.graph, plan.state = g, self._graph_state()

    def _hp_rows(self, n: int) -> np.ndarray:
        """The embedding update's Adam numbers for the next ``n`` steps, one
        row a step, computed on the host from the int step count."""
        p, step = self._opt_params, int(self.emb_opt_state["step"]) + 1
        b1, b2 = p.get("b1", 0.9), p.get("b2", 0.999)
        if self._emb_mode in ("occurrence", "winner"):
            return occurrence_hparams_rows(step, n, self._lr_now, b1, b2)
        return adam_hparams_rows(step, n, self._lr_now, p.get("weight_decay", 1e-5), b1, b2,
                                 p.get("eps", 1e-8))

    def _run_dispatch(self, plan: _StepPlan, n: int) -> torch.Tensor:
        """``n`` steps of the plan over its staged batches; returns their
        losses ``[n]`` (a copy on the device, so the next dispatch can
        overwrite the plan's slots). Graphed: eager warm-up steps until the
        plan is captured, then replays; on the CPU the body, uncaptured."""
        if plan.hp is not None:
            rows = torch.from_numpy(self._hp_rows(n))
            if self.device.type == "cuda":
                rows = rows.pin_memory()
            plan.hp[:n].copy_(rows, non_blocking=True)
        plan.counter.zero_()
        i = 0
        if self.graphed:
            if self._graph_stream is None:
                self._graph_stream = torch.cuda.Stream(self.device)
            while i < n and plan.graph is None:
                if plan.warm < WARMUP_STEPS:
                    self._warm_step(plan)
                    i += 1
                else:
                    self._capture(plan)
            for _ in range(n - i):
                plan.graph.replay()
            self.graph_replays += n - i
        else:
            for _ in range(n):
                self._plan_step(plan)
        if plan.hp is not None:
            # the body read its rows and left the count to this dispatch
            self.emb_opt_state["step"] = int(self.emb_opt_state["step"]) + n
        return plan.losses[:n].clone()

    def _log_dispatch(self, losses, n, done, n_total, log_interval, pending):
        """Count a dispatch's ``n`` losses into ``pending`` as the JAX
        trainer does: a full dispatch is one entry and logs when ``done %
        log_interval < S``; a remainder adds its steps one by one and logs
        nothing. Returns ``(done, logged mean or None, pending)``."""
        done += n
        if n < self.scan_steps:
            pending.extend(losses.unbind(0))
            return done, None, pending
        pending.append(losses)
        if done % log_interval < self.scan_steps:
            return done, self._log_losses(done, n_total, pending), []
        return done, None, pending

    def _train_dispatched(self, data_loader, log_interval):
        """A host epoch at ``scan_steps > 1``: dispatches staged on the
        prefetch thread (pinned on the card), copied into the plan's
        buffers without a host sync, then run."""
        pending, done, last = [], 0, None
        n_total = len(data_loader)
        cuda = self.device.type == "cuda"
        for d in prefetch(stage_dispatches(data_loader, self.scan_steps, pin=cuda),
                          self.prefetch_depth):
            if self.mesh is not None:
                d = self._local_dispatch(d)
            plan = self._plan_for(data_loader, d.layout, d.b, d.ints.shape[1],
                                  d.floats.shape[1])
            rows = slice(0, d.n * d.b)
            for dst, src in ((plan.ints, d.ints), (plan.floats, d.floats), (plan.w, d.w)):
                dst[rows].copy_(src, non_blocking=True)
            losses = self._run_dispatch(plan, d.n)
            done, logged, pending = self._log_dispatch(losses, d.n, done, n_total,
                                                       log_interval, pending)
            last = logged if logged is not None else last
        if pending:
            last = self._log_losses(done, n_total, pending)
        return last

    def _local_dispatch(self, d):
        """A staged dispatch of ``n`` global batches cut to this rank's rows
        of each (``shard_stacked_batch_fn`` over ``[n, b, ...]``)."""
        x, _, w = self._shard_stacked({"ints": d.ints.view(d.n, d.b, -1),
                                       "floats": d.floats.view(d.n, d.b, -1)}, None,
                                      d.w.view(d.n, d.b))
        b = w.shape[1]
        return d._replace(b=b, ints=x["ints"].reshape(d.n * b, -1),
                          floats=x["floats"].reshape(d.n * b, -1), w=w.reshape(-1))

    def train_one_epoch(self, data_loader, log_interval: int = 10):
        """One pass over ``data_loader``. Over a host loader returns the
        mean loss of the last logged window (None for an empty loader); a
        ``DeviceResidentLoader`` runs :meth:`train_one_epoch_resident`,
        which returns None and defers its last loss line. At ``scan_steps``
        S > 1, S steps a dispatch (graphed: a CUDA graph's replays), logging
        as the JAX trainer does: after a full dispatch where ``done %
        log_interval < S``, not inside the remainder. At S = 1 a line every
        ``log_interval`` steps."""
        self._flush_epoch_log()
        if isinstance(data_loader, DeviceResidentLoader):
            return self.train_one_epoch_resident(data_loader, log_interval)
        if self._dispatched:
            return self._train_dispatched(data_loader, log_interval)
        # Losses stay on the device until a log boundary: reading one every
        # step would sync the host with the card each step.
        pending, done, last = [], 0, None
        n_total = len(data_loader)
        for _, host in self._batches(data_loader):
            if self.mesh is not None:
                host = self._shard(*host)
            pending.append(self._train_step(*self._device_batch(*host)))
            done += 1
            if done % log_interval == 0:
                last, pending = self._log_losses(done, n_total, pending), []
        if pending:
            last = self._log_losses(done, n_total, pending)
        return last

    # -- device-resident epochs (data/device.py) --------------------------

    def _check_resident(self, loader):
        have = loader.int_mat.device
        want = self.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        if have != want:
            raise ValueError(
                f"the DeviceResidentLoader's columns lie on {have}, the trainer on "
                f"{self.device}: build the loader with device={str(self.device)!r}")

    def _epoch_ids(self, loader) -> torch.Tensor:
        """The epoch's row ids ``[len(loader) * B]`` on the device, the final
        partial batch padded with its own first row (``epoch_perm``'s
        semantics).

        Host stream: ``epoch_perm``'s ids go to the device once an epoch,
        from pinned memory with ``non_blocking=True`` on a CUDA trainer, so
        the copy does not block the host (4 bytes a row, small beside the
        resident matrices; one copy an epoch in place of one a step).
        ``device_shuffle``: ``torch.randperm`` on the device from a generator
        seeded by ``loader.epoch_seed()``; its stream differs from numpy's,
        as the JAX package's ``jax.random`` stream does."""
        if not loader.device_shuffle:
            ids = torch.from_numpy(loader.epoch_perm()[0])
            if self.device.type == "cuda":
                ids = ids.pin_memory()
            return ids.to(self.device, non_blocking=True)
        n, b = loader.n, loader.batch_size
        if loader.shuffle:
            gen = torch.Generator(device=self.device).manual_seed(loader.epoch_seed())
            idx = torch.randperm(n, generator=gen, device=self.device)
        else:
            idx = torch.arange(n, device=self.device)
        rem = n % b
        if rem:
            idx = torch.cat([idx, idx[n - rem].expand(b - rem)])
        return idx

    def train_one_epoch_resident(self, loader: DeviceResidentLoader,
                                 log_interval: int = 10):
        """One epoch from device-resident columns, with the host path's
        batch semantics: the same permutation stream, padding and weights,
        so the same trained state (``tests/test_torch_port_resident.py``).

        Each step is :meth:`_train_step` on a batch gathered on the device:
        the loader's matrices indexed by the batch's slice of the epoch's
        ids, its weights from position math (``pos < n``: zero exactly on
        the padded tail). Dropout draws from ``self.generator`` in the host
        loop's order. At ``scan_steps`` S > 1, each dispatch gathers its S
        batches' rows into the step plan's buffers at once and runs S steps
        (graphed: replays of the captured step); the remainder is a
        dispatch of fewer steps. ``resident_gather`` changes nothing.

        Returns None: the last losses stay on the device, and their line
        prints at the next trainer entry point or :meth:`barrier`, so the
        epoch boundary does not wait for the card."""
        self._flush_epoch_log()
        if self.mesh is not None:
            raise NotImplementedError("a DeviceResidentLoader under a mesh is ROADMAP A15.3")
        self._check_resident(loader)
        b, nb = loader.batch_size, len(loader)
        ids = self._epoch_ids(loader)
        weights = (torch.arange(nb * b, device=self.device) < loader.n).float()
        pending, done = [], 0
        if self._dispatched:
            s = self.scan_steps
            for d0 in range(0, nb, s):
                n = min(s, nb - d0)
                plan = self._plan_for(loader, loader.layout, b, loader.int_mat.shape[1],
                                      loader.float_mat.shape[1])
                sel, rows = ids[d0 * b:(d0 + n) * b], slice(0, n * b)
                torch.index_select(loader.int_mat, 0, sel, out=plan.ints[rows])
                torch.index_select(loader.float_mat, 0, sel, out=plan.floats[rows])
                plan.w[rows].copy_(weights[d0 * b:(d0 + n) * b])
                losses = self._run_dispatch(plan, n)
                done, _, pending = self._log_dispatch(losses, n, done, nb, log_interval,
                                                      pending)
            if pending:
                self._deferred_log = (done, nb, pending)
            return None
        for i in range(nb):
            sel = ids[i * b:(i + 1) * b]
            x, y = loader.gather_batch(loader.int_mat.index_select(0, sel),
                                       loader.float_mat.index_select(0, sel))
            pending.append(self._train_step(x, y, weights[i * b:(i + 1) * b]))
            done += 1
            if done % log_interval == 0:
                self._log_losses(done, nb, pending)
                pending = []
        if pending:
            self._deferred_log = (done, nb, pending)

    def fit(self, train_dataloader, val_dataloader=None):
        for epoch_i in range(self.epoch_i, self.n_epoch):
            print("epoch:", epoch_i)
            self.epoch_i = epoch_i
            if self._epoch_schedule is not None:
                # epoch-level StepLR: the moments carry over, the lr changes
                self._lr_now = self._base_lr * float(self._epoch_schedule(epoch_i))
                for group in getattr(self.optimizer, "param_groups", []):
                    group["lr"] = self._lr_now
            self.train_one_epoch(train_dataloader)
            if val_dataloader:
                auc, logloss = self.evaluate(self.model, val_dataloader)
                print(f"epoch:{epoch_i} | val auc: {auc} | val logloss: {logloss}")
                self._sync_packed()  # the snapshot holds the live table
                if self.early_stopper.stop_training(auc, self.model.state_dict()):
                    print(f"validation: best auc: {self.early_stopper.best_auc}")
                    self.model.load_state_dict(self.early_stopper.best_weights)
                    self._refill_store()  # and drops the captured step
                    break
        # like the reference, best weights are restored only on an early
        # stop; a natural end of the epoch loop keeps the last weights
        # (ctr_trainer.py:88-93)
        time_now = time.strftime("%m_%d_%H_%M", time.localtime())
        if self.mesh is not None:
            time_now = broadcast_object(self.mesh, time_now)  # one name for all ranks
        name = type(self.model).__name__ + "_" + self.data_set_type + "_" + time_now
        return self.save(os.path.join(self.model_path, name))

    # -- eval -------------------------------------------------------------

    def _predict_loader(self, data_loader):
        """Run the eval step over a loader; returns (y, p, domain, w) with
        the weight-0 padding rows dropped host-side."""
        self._flush_epoch_log()
        ys, ps, ds, ws = [], [], [], []
        self._sync_packed()
        with torch.inference_mode():
            # fold once per pass: the weights cannot change inside it
            folded = self.model.fold_eval() if self._fused_inference else None
            for (x, y, w), (hx, _, hw) in self._batches(data_loader):
                xb, _, wb = self._device_batch(hx, None, hw)
                probs = self._score(xb, wb, folded)
                keep = np.asarray(w) > 0
                ps.append(probs.cpu().numpy()[keep])
                if y is not None:
                    ys.append(np.asarray(y)[keep])
                if "domain_indicator" in x:
                    ds.append(np.asarray(x["domain_indicator"])[keep])
                ws.append(np.asarray(w)[keep])
        cat = lambda lst: np.concatenate(lst) if lst else np.array([])
        return cat(ys), cat(ps), cat(ds), cat(ws)

    def _predict_loader_device(self, data_loader):
        """An eval pass whose probabilities, labels, domain ids and padding
        weights stay on the device (one concatenated tensor each): no copy
        to the host per batch."""
        self._flush_epoch_log()
        ys, ps, ds, ws = [], [], [], []
        self._sync_packed()
        with torch.inference_mode():
            folded = self.model.fold_eval() if self._fused_inference else None
            for _, host in self._batches(data_loader):
                xb, yb, wb = self._device_batch(*host)
                if yb is None:
                    raise ValueError(
                        "on_device evaluation requires labeled batches; use "
                        "predict() (host path) for unlabeled loaders")
                ps.append(self._score(xb, wb, folded))
                ys.append(yb)
                ws.append(wb)
                if "domain_indicator" in xb:
                    ds.append(xb["domain_indicator"])
        cat = lambda lst: (torch.cat(lst) if lst
                           else torch.zeros((0,), device=self.device))
        return cat(ys), cat(ps), cat(ds), cat(ws)

    def _score(self, xb, wb, folded):
        """The eval step's probabilities of a device batch. Under a mesh each
        rank scores its rows op by op, its packed rows from
        ``sharded_lookup``, and the scores are gathered over ``data``: every
        rank returns the whole batch's."""
        if self.mesh is None:
            return self._eval_step(xb, wb, folded)
        lx, _, lw = self._shard(xb, None, wb)
        with mesh_step(self.mesh, lw.shape[0]):
            col = self.model.embedding
            rows = self._lookup(col.packed.detach(), col.touched_ids(lx))
            probs = self.model.apply(lx, train=False, w=lw, rows=rows)
        return all_gather_rows(probs, self.mesh.data_group)

    def evaluate(self, model, data_loader, mode: str = "val",
                 on_device: bool = False):
        """Overall AUC + logloss (reference ctr_trainer.py:99-111).

        ``on_device=True``: score with the device AUC/logloss under the
        padding-weight mask (float32 ranks and sums, within 5e-5 / 5e-6 of
        the host's; the log loss clips at 1e-7, ``log_loss_device``)."""
        if on_device:
            y, p, _, w = self._predict_loader_device(data_loader)
            self._check_eval_scores(p)
            m = w > 0
            self._check_two_classes(y, m)
            return (float(auc_score_device(y, p, m)),
                    float(log_loss_device(y, p, m)))
        y, p, _, _ = self._predict_loader(data_loader)
        return auc_score(y, p), log_loss_score(y, p)

    @staticmethod
    def _check_two_classes(y, m):
        """The host AUC's single-class error on the device path, where a
        single-class subset would divide by zero silently."""
        n_pos = float((y * m).sum())
        n = float(m.sum())
        if n_pos == 0 or n_pos == n:
            raise ValueError(
                "Only one class present in y_true. ROC AUC score is not "
                "defined."
            )

    @staticmethod
    def _check_eval_scores(p):
        """The host AUC's NaN error on the device path: a diverged model
        raises instead of returning a bogus AUC."""
        if bool(torch.isnan(p).any()):
            raise ValueError("Input contains NaN.")

    def evaluate_multi_domain_loss(self, model, data_loader, domain_num: int,
                                   on_device: bool = False):
        """Per-domain + overall AUC/logloss (reference ctr_trainer.py:113-152).

        Returns ``(domain_logloss[D], domain_auc[D], total_logloss,
        total_auc)`` with ``None`` for empty domains, exactly as reference.
        ``on_device=True`` computes every metric from device tensors with
        static-shape per-domain masks (one host read for the counts).
        """
        if on_device:
            y, p, d, w = self._predict_loader_device(data_loader)
            self._check_eval_scores(p)
            keep = w > 0
            masks = [(d == dom) & keep if d.numel() else torch.zeros_like(keep)
                     for dom in range(domain_num)]
            counts = (torch.stack([m.sum() for m in masks]).tolist()
                      if masks else [])
            domain_logloss_list, domain_auc_list = [], []
            for m, count in zip(masks, counts):
                if count > 0:
                    # as the host path: a single-class domain raises
                    self._check_two_classes(y, m)
                    domain_logloss_list.append(float(log_loss_device(y, p, m)))
                    domain_auc_list.append(float(auc_score_device(y, p, m)))
                else:
                    domain_logloss_list.append(None)
                    domain_auc_list.append(None)
            if not bool(keep.any()):
                return domain_logloss_list, domain_auc_list, None, None
            self._check_two_classes(y, keep)
            return (domain_logloss_list, domain_auc_list,
                    float(log_loss_device(y, p, keep)),
                    float(auc_score_device(y, p, keep)))
        y, p, d, _ = self._predict_loader(data_loader)
        domain_logloss_list, domain_auc_list = [], []
        for dom in range(domain_num):
            m = d == dom
            if m.any():
                domain_logloss_list.append(log_loss_score(y[m], p[m]))
                domain_auc_list.append(auc_score(y[m], p[m]))
            else:
                domain_logloss_list.append(None)
                domain_auc_list.append(None)
        total_logloss = log_loss_score(y, p) if len(p) else None
        total_auc = auc_score(y, p) if len(p) else None
        return domain_logloss_list, domain_auc_list, total_logloss, total_auc

    def predict(self, model, data_loader):
        _, p, _, _ = self._predict_loader(data_loader)
        return list(p)

    # -- checkpoints ------------------------------------------------------

    def _checkpoint_tensors(self):
        """Everything a resume needs, path-keyed: the model's state dict
        (the live table in every mode), the torch optimizer's moments and
        step per parameter name (zeros before the first step) and the
        embedding update's moments and step (in the occurrence mode the
        moment columns of the combined store; with a bf16 store its bf16
        moments, its table as the model's)."""
        self._sync_packed()
        out = {f"model/{k}": v for k, v in self.model.state_dict().items()}
        for name, p in self._dense_named:
            st = self.optimizer.state.get(p, {})
            out[f"opt/base/{name}/step"] = torch.as_tensor(
                float(st.get("step", 0.0)), dtype=torch.float32)
            out[f"opt/base/{name}/exp_avg"] = st.get("exp_avg", torch.zeros_like(p))
            out[f"opt/base/{name}/exp_avg_sq"] = st.get("exp_avg_sq", torch.zeros_like(p))
        for k, v in self._emb_moments().items():
            out[f"opt/emb/{k}"] = v
        if self.emb_opt_state is not None:
            out["opt/emb/step"] = torch.tensor(self.emb_opt_state["step"])
        if self.mesh is not None:
            for k in self._sharded_keys():
                out[k] = gather_rows(out[k], self.mesh, self._vocab)
        return out

    def _sharded_keys(self):
        """The checkpoint entries a mesh row-shards: the packed table and
        the sorted update's moments."""
        return ("model/embedding.packed", "opt/emb/mu", "opt/emb/nu")

    def _emb_moments(self):
        """The embedding update's moments by checkpoint name, as views of
        its state (so ``load`` can copy into them)."""
        st, mode = self.emb_opt_state, self._emb_mode
        if mode == "occurrence":
            return {"comb_moments": st["comb"][:, self.model.embedding.packed_dim:]}
        return {} if mode is None else {"mu": st["mu"], "nu": st["nu"]}

    def save(self, path: str) -> str:
        """Write the checkpoint; returns the ``.npz`` path. Under a mesh
        every rank calls it: the shards are gathered over ``embed`` and rank
        0 writes the single-process format (the mesh's shape in the
        metadata, for information); the others wait for the file."""
        self._flush_epoch_log()
        tensors = self._checkpoint_tensors()
        meta = {
            "epoch": self.epoch_i,
            "best_auc": self.early_stopper.best_auc,
            "model": type(self.model).__name__,
            "sparse_embedding_updates": bool(self._sparse_emb),
            "sparse_update_impl": self._sparse_impl if self._sparse_emb else None,
            "sorted_dtype": self._sorted_dtype if self._sorted_mode else None,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
        }
        if self.mesh is None or self.mesh.rank == 0:
            ckpt_lib.save(path, tensors, metadata=meta)
        if self.mesh is not None:
            barrier(self.mesh)
        return ckpt_lib.npz_path(path)

    def load(self, path: str):
        meta = ckpt_lib.read_metadata(path)
        if "sparse_update_impl" in meta:
            mine = self._sparse_impl if self._sparse_emb else None
            if meta["sparse_update_impl"] != mine:
                raise ValueError(
                    f"checkpoint was written with sparse_update_impl="
                    f"{meta['sparse_update_impl']!r} but this trainer uses "
                    f"{mine!r}; construct CTRTrainer with the matching "
                    "sparse_embedding_updates/sparse_update_impl to resume")
            if self._sorted_mode:
                # a checkpoint from before the key existed stored float32
                theirs = meta.get("sorted_dtype") or "float32"
                if theirs != self._sorted_dtype:
                    raise ValueError(
                        f"checkpoint was written with sorted_dtype={theirs!r} but this "
                        f"trainer uses sorted_dtype={self._sorted_dtype!r}; construct "
                        "CTRTrainer with the matching sorted_dtype to resume")
        arrays, meta = ckpt_lib.load(path, self._checkpoint_tensors())
        if self.mesh is not None:
            # this rank's rows of whatever mesh wrote the file
            for k in self._sharded_keys():
                arrays[k] = shard_rows(arrays[k], self.mesh)[0]
        t = lambda key, like: arrays[key].to(like.device)
        sd = self.model.state_dict()
        self.model.load_state_dict({k: t(f"model/{k}", v) for k, v in sd.items()})
        for name, p in self._dense_named:
            self.optimizer.state[p] = {
                "step": self._opt_step_tensor(arrays[f"opt/base/{name}/step"], p),
                "exp_avg": t(f"opt/base/{name}/exp_avg", p),
                "exp_avg_sq": t(f"opt/base/{name}/exp_avg_sq", p)}
        with torch.no_grad():
            for k, v in self._emb_moments().items():
                v.copy_(t(f"opt/emb/{k}", v))
        if self.emb_opt_state is not None:
            self.emb_opt_state["step"] = int(arrays["opt/emb/step"])
        self._refill_store()
        self.epoch_i = int(meta.get("epoch", 0))
        self.early_stopper.best_auc = float(meta.get("best_auc", 0.0))
        return meta
