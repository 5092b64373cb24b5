#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one card and
check its kernels: MMOE, SharedBottom, STAR, PLE, SAR-Net, EPNet, PPNet,
AdaSparse, HamurLarge, AdaptDHM, M2M and M3oE, each built at its Ali-CCP
width through ``configs.build_model`` (EPNet, AdaSparse, AdaptDHM and M2M
from the scenario loader's features, PPNet from the ppnet loader's, as
``scripts/run_ali_ccp.py`` builds them).

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases; each asserts, and any failure exits non-zero:

1. Card and build: the card's name and power limit (nvidia-smi), then every
   ``scenario_wise_rec_tpu_torch/csrc/*.cu`` built with nvcc (one process per
   source, all started together), with the compiler's register report.
2. Kernels vs plain on the card, each timed with CUDA events (warm-up,
   median of repeats) beside the bound of its work:
   - ``mmoe_fused_infer`` against ``mmoe_fused_infer_ref`` at (a) the
     Ali-CCP shape, B = 4096, (b) ragged B = 4095, B = 1, B = 31 and 33
     (a 32-row tile -+ 1) and B = 1000, (c) a narrow configuration, (d)
     domain ids -1, D and D+5, (e) widths off the mma tile, a layer wider
     than one 256-column pass and 9 experts, (f) a NaN in one row, which
     must stay there, (g) KuaiRand's MMOE (F = 800, 5 domains, 5 experts of
     [32], tower [16]); max |error| <= 1e-5 (3xTF32 products and another summation order
     than cuBLAS's); with its Step-0 reading (device ms, host µs, launches)
     for each ``block_rows`` of the sweep, beside its f32 SIMT bound and the
     3xTF32 design's;
   - ``sorted_dense_adam_apply`` against ``sorted_dense_adam_apply_ref``
     over 3 steps at (a) the Ali-CCP table (V = 10,741,000, D = 16,
     K = 94,208 uniform ids), (b) a hot row (one feature's 4096 ids one
     row, the rest Zipf), (c) V not a multiple of the tile, empty tiles and
     ids -1, -7, V, V+3, (d) K = 0; |error| <= 1e-6 + 1e-5 |plain| (the
     plain version's index_add_ sums duplicates with atomics in a varying
     order) but for the elements of ``AdamOrderRule`` (rows of 3 or more
     duplicates whose gradient sum lies within its f32 order error of zero:
     counted, printed, held to looser bounds and to 0.01 % of the table),
     two planted faults that rule must catch (one of the hot row's
     duplicates left out, one touched row's update undone), the nearest
     PyTorch composition (index_add_ + fused torch.optim.Adam) and a
     ``block_rows`` sweep on uniform and on hot-row ids;
   - its bf16 form (table, mu and nu bf16) against the plain version at the
     Ali-CCP shape with uniform and with hot-row ids, 3 steps, each from
     one state: every element within one bf16 ulp or within its f32 order
     slack plus one ulp (``bf16_held``), the elements that differ counted,
     printed and held to ``AdamOrderRule``'s share; two planted
     faults it must catch (results truncated instead of rounded, one
     untouched row's decay left out); a ``block_rows`` sweep, each tile
     held to the same rule; its time and Step 0 beside its bound, the plain
     version and index_add_ + fused torch.optim.Adam over bf16 tensors; and
     the Step 0 of the f32 form and of ``fused_dense_adam_apply`` beside it
     (the three share ``csrc/embedding_adam.cuh``);
   - ``sorted_dense_adam_apply_sharded`` (``[2]
     sorted_dense_adam_apply_sharded``): E = 2 and 4 shards in turn into
     row slices of one Ali-CCP table, f32 and bf16, hp by value and in
     device memory, uniform and hot-row Zipf ids with ids on every shard
     boundary, one step from one state each: 0 elements may differ from the
     unsharded kernel's step on a copy, and each shard is held against the
     plain version at row 13's rule; each shard's Step 0 beside the
     unsharded form's in the same call and the shard's byte bound, the
     plain version and index_add_ + fused torch.optim.Adam on one shard;
   - ``occurrence_segsum`` against ``occurrence_segsum_ref`` at the Ali-CCP
     ids as the trainer passes them (int64, one ``[23, 4096]`` launch) and
     as int32, a hot row (one feature's 4096 ids one row) with Zipf ids, two
     alias segments of one owner, sentinel ids, runs of 64 and 65 (either
     side of the long-run threshold), ragged N = 4097 with D = 3, rows of
     16384 (the shared-memory limit) and 16385 and ``[1, 94208]`` (the
     sorted route), and K = 0: within n ulp of each run's sum of |g|, every
     duplicate's sum bit-identical, a second call equal, and every
     ``splits`` equal; ``scatter_rows`` against ``scatter_rows_ref`` into
     the occurrence mode's ``[10,741,000, 48]`` store (its bulk copies) with
     the same ids as int64 and int32, ids -1, -7, -V and the wrapped twins of
     positive ids (a negative id wraps once, as the reference's XLA form
     does), -V-1, V, V+3, 2^31-1, -2^31 (dropped), and K = 0, and rows of 5
     and 1024 floats (its lanes) with the same kinds of ids, and the winner
     update's write-back into ``[10,741,000, 16]`` f32 (K = 94,208 uniform
     and Zipf ids, every duplicate but one and a frozen span set to V):
     equal; both timed, the scatter
     beside ``index_copy_``, and each with its device ms apart from the
     host (a ``torch.cuda._sleep`` holds the stream until the host has
     queued the timed calls), host µs and profiler launches per call, as
     are their plain versions, ``index_copy_`` and the whole occurrence
     update of a train step;
   - ``fused_dense_adam_apply`` against ``fused_dense_adam_ref`` over 3
     steps at the Ali-CCP table with 23 segments of uniform ids, the hot
     row with Zipf ids, two alias segments of one owner, V = 1,000,003 with
     an empty segment and ids -1, -7, V, V+3, and K = 0; |error| <= 1e-6 +
     1e-5 |plain| under the same counted rule and planted faults, timed
     beside index_add_ + fused torch.optim.Adam, with a ``block_rows``
     sweep;
   - ``trunk_towers_fused_infer``, ``star_fused_infer`` and
     ``ple_fused_infer`` against their plain versions at (a) their model's
     Ali-CCP shape, B = 4096, (b) ragged B = 4095 and B = 1, (c) a narrow
     configuration, (d) domain ids -1, D and D+5, and (e) SharedBottom
     without a head, STAR on a batch padded with weight-0 rows (its norm's
     statistics masked), PLE at 2 levels with the Ali-CCP expert widths;
     max |error| <= 1e-5, with a ``block_rows`` sweep; SharedBottom also
     with (g) 90 % of the rows in one domain, (h) domain counts astride its
     tiles, (i) KuaiRand's ladder (F 800, 5 domains, trunk [128], towers
     [64, 32]), (j) Amazon's (F 48, trunk [128], towers [8]) and (k) B =
     65,536, STAR with (g) 90 % of the rows in one domain, (h) domain
     counts astride its tiles, (i) KuaiRand's ladder (F 800, 5 domains, FCN
     [128, 64, 32], aux [32]) and (j) B = 65,536, PLE with (f) 90 % of the
     rows in one domain, (g) domain counts astride its tiles, (h) KuaiRand's
     ladder (F 800, 5 domains, experts [64, 32]) and (i) B = 65,536; for all
     three, each output into a block just freed full of NaN, the sweep over
     the tile rule (16, 32, 48, 64 and the kernel's choice; 64 rows at
     SharedBottom's Ali-CCP and KuaiRand widths, at STAR's KuaiRand widths
     and at PLE's, and 48 at 2 levels, must raise), int64 ids against
     int32, the 3xTF32 bound beside the f32 one and the Step 0 of
     SharedBottom's KuaiRand, Amazon and B 65,536 cases, of STAR's KuaiRand
     and B 65,536 cases and of PLE's 2-level case;
   - ``sarnet_fused_infer``, ``epnet_fused_infer``, ``ppnet_fused_infer``
     and ``adasparse_fused_infer`` the same at their model's Ali-CCP shape
     (SAR-Net F = 368; EPNet S = 16, A = 360; PPNet G = 376; AdaSparse
     S = 16, A = 352), ragged, narrow and (SAR-Net, PPNet: the others have
     no domain ids) out-of-range domain ids; SAR-Net also with (e) 90 % of
     the rows in one domain, (f) every row in one domain, (g) domain counts
     astride its tiles, (h) KuaiRand's widths (F 796, 5 domains) and (i) B =
     65,536, each output into a block just freed full of NaN, every tile of
     the rule (16, 32, 48, 64 and the kernel's choice; 64 rows at KuaiRand's
     widths must raise), int64 ids against int32, a NaN kept in its row, one
     launch a call on its own counter and none on another, its 3xTF32 bound
     beside the f32 one and the Step 0 of (h) and (i); EPNet (AdaSparse's kernel on
     two steps) also with (d) KuaiRand's width (S 16, A 800), (e) B =
     65,536 and (f) widths off 8 (S 5, A 41, gate hidden 7), each output
     into a block just freed full of NaN, every tile of the rule (16, 32,
     48, 64 and the kernel's choice; 32, 48 and 64 rows at KuaiRand's width
     must raise), a NaN kept in its row, one launch a call on its own
     counter and none on AdaSparse's, and its 3xTF32 bound beside the f32
     one; PPNet also with (e) domain 1
     absent, (f) every row in one domain, (g) domain counts astride its
     tiles, (h) KuaiRand's width (G 832, 5 domains, [128, 64, 32]) and (i)
     B = 65,536, each output into a block just freed full of NaN so that a
     row left unwritten fails, its sweep over the tile rule (16, 32, 48, 64
     and the kernel's choice) and its 3xTF32 bound beside the f32 one;
     AdaSparse in all three forms, alpha = 1.37 folded into its
     pruners, and (e) pruner inputs that are exact integers, so that a few
     percent of the factors are negative, (f) no layers (the head on
     [sce ‖ agn]), (g) KuaiRand's width (S 16, A 796, [128, 64, 32]), (h)
     B = 65,536 and (i) widths off 8 (S 5, A 41, [7, 3]), each output into
     a block just freed full of NaN, the Ali-CCP, narrow and no-layer cases
     at every tile of the rule (16, 32, 48, 64 and the kernel's choice),
     48 and 64 rows at KuaiRand's width must raise, and its 3xTF32 bound
     beside the f32 one. AdaSparse's hard threshold: a row in which some
     pruner element lies within 1e-5 of epsilon is excused from the 1e-5
     check, and such rows are counted, printed and held to 0.01 % of the
     batch;
   - ``hamur_segment`` (HAMUR's segment kernel, one launch per segment) in
     each of its forms alone from identical inputs (outputs held to 1e-5 of
     their scale), and ``hamur_fused_infer`` (the whole chain: the
     hyper-network and the adapter norms' masked statistics in PyTorch
     between the launches) against the plain chain, at (a) HamurLarge's
     Ali-CCP shape (F = 376, blocks [256,128,64,64,32,16 | 8], hyper [64],
     k = 65, adapters' u/v from 0.1 N(0, 1) as the JAX package's tests draw
     them), B = 4096, (b) HamurSmall's ([256, 128], hyper [64], k = 35),
     (c) ragged B = 4095 and B = 1, (d) a batch padded with weight-0 rows
     (its real rows also against the unpadded batch), (e) domain ids -1, D
     and D+5, (f) HamurSmall at KuaiRand's width (F = 800, 5 domains);
     probabilities within 1e-5; HamurLarge's three launches timed at every
     ``block_rows`` of the tile rule (16, 32, 48, 64 and the kernel's
     choice), each segment's Step 0 beside its plain version, and the bound
     by the design's 3xTF32 blocks beside the f32 one;
     ``adaptdhm_fused_infer`` (SharedBottom's chain kernel without trunk and
     biases) at AdaptDHM's Ali-CCP shape (F = 368, [256,...,8,1], 3
     clusters), ragged, narrow, router ids -1, C and C+5 (int64 ids also as
     int32 and plus 2^32: the same outputs, one launch a call on AdaptDHM's
     counter and none on SharedBottom's), with a cluster absent, 90 % of the
     rows in one cluster, counts astride a tile, KuaiRand's ladder ([64, 64]
     at F 812) and B = 65,536, each into an output left full of NaN; the
     edge cases at every ``block_rows`` of the tile rule (64 rows must raise
     at KuaiRand's width: the tile does not fit in shared memory), timed at
     each, Step 0 at KuaiRand and B = 65,536, and its 3xTF32 bound beside
     the f32 one;
   - ``m2m_fused_infer`` (M2M after its transformer) at M2M's Ali-CCP shape
     (F = 376, scenario embedding 16, 4 experts of 16, vw 16 -> 1024, output
     MLP [64, 32]), ragged B = 4095 and B = 1, a narrow configuration, E = 5
     with hidden expert and hyper stages, no output MLP, KuaiRand's widths
     (F = 812) and B = 65,536, each into an output left full of NaN; the
     edge cases at every ``block_rows`` of the tile rule (64 rows must raise
     at KuaiRand's widths), a NaN in one row of each input that must stay
     there; timed at each tile, Step 0 at KuaiRand and B = 65,536, with its
     3xTF32 bound beside the f32 one;
     ``m3oe_fused_infer`` at M3oE's (F = 376, star [512, 256], 4 experts and
     3 domain experts [256 -> 64], each layer with its LayerNorm), ragged,
     narrow, domain ids -1, D and D+5 (int64 ids also as int32 and plus
     2^32: the same outputs), one domain (the balance mix's own branch), 90 %
     of the rows in one domain, counts astride a tile, KuaiRand's width (F =
     800, 5 domains, star [128, 64], experts 64 -> 32) and B = 65,536, each
     into an output left full of NaN (no row unwritten); probabilities within
     1e-5; the edge cases at every ``block_rows`` of the tile rule (48 and 64
     must raise at Ali-CCP: the tile does not fit in shared memory), timed at
     16, 32 and the kernel's choice, with the bound by the design's 3xTF32
     products beside the f32 one.
3. Serving path: MMOE at Ali-CCP width (23 sparse x 16, 8 dense, 3 domains,
   experts [256,128,64,32,16,8], tower [16]) with 467,000 ids per feature
   (a packed [10.74M, 16] f32 table) built on the card from ``--seed``;
   ``CTRTrainer(fused_inference=True).evaluate_multi_domain_loss`` and
   ``.predict`` over 8*4096+123 synthetic rows in batches of 4096. Every
   launch counter is set to 0 just before and read just after; the fused
   kernel must have launched once per batch. Predictions are held against
   the op-by-op path (``fused_inference=False``) and a narrow model against
   the CPU's plain path. Then the same for SharedBottom, STAR, PLE,
   SAR-Net, EPNet, PPNet and AdaSparse (the last four with their tables
   drawn from N(0, 0.5), AdaSparse's alpha at 1.37 and its threshold rule),
   HamurLarge (3 segment launches a batch; its tolerance and a planted fault
   that drops the padding mask from the adapter norms' statistics, which the
   check must catch on the ragged last batch; narrow HamurLarge, HamurSmall
   and MlpN, which serves op by op, on the card against the CPU) and
   AdaptDHM (rows whose top two routing logits lie within 1e-6 excused,
   counted and held to 0.01 % of the batch), M2M (its transformer in
   PyTorch, timed alone beside the kernel; a planted fault that drops the
   transformer's key mask, which the check must catch on the ragged last
   batch; a narrow copy with its dropout at 0 on the card against the CPU)
   and M3oE, each with its own kernel and no other launched. For every
   model, ``CTRTrainer(fused_inference="auto")`` resolves to its class's
   membership in the port's measured set (``FUSED_INFERENCE_WINS``; the
   narrow HamurSmall's too, MlpN never). One ``"auto"`` predict pass of the
   first served model in the set launches its kernel as many times a batch
   as the fused pass and nothing else, its predictions the fused path's;
   one of the narrow MlpN, outside it, launches no kernel.
4. Training path: the same model trained by ``CTRTrainer(
   sparse_embedding_updates=True, sparse_update_impl="sorted",
   fused_inference=True).fit`` for one epoch over 16*4096+123 rows with a
   validation loader, then ``evaluate_multi_domain_loss``; the counters are
   set to 0 before and read after: the sorted kernel once per train step,
   the eval kernel once per eval batch. Then train examples/s over a second
   epoch, a profile of train steps, the sorted trainer against the plain
   dense trainer (torch.optim.Adam over the whole table) for 2 steps at
   full width, beside two planted faults that this check must catch, and a
   narrow model trained 3 steps on the card and the CPU. Each gated step
   starts both sides from one state (``sorted_vs_dense``). Then MMOE over a
   ``DeviceResidentLoader`` (``[4] training mmoe resident``): (a) ``fit``
   for one epoch of 16*4096+123 resident rows in the sorted mode with
   validation, then ``evaluate_multi_domain_loss(..., on_device=True)``: the
   sorted kernel once a step, the eval kernel once an eval batch, every
   metric finite; (b) from one state (``clone_trainer``), a host epoch and a
   resident epoch over the same rows and seed, within ``GROUP_TOL`` (the
   differing elements printed), and a resident epoch on a permutation rolled
   by one row, which must fail; (c) the on-device metrics against the
   host's over the validation set (AUC within 1e-4, logloss within 1e-5),
   and a NaN planted in one score, which both paths must refuse; (d) no
   gate: host and resident epochs of 2^18+123 rows in turns (examples/s,
   host clock, synchronised), stream syncs and device busy share a step
   from a profile of 5 steps of each, the loader's bytes on the card. Then each other
   model's ``fit`` (8*4096+123 rows), evaluation, a timed second epoch and a
   narrow card-vs-CPU copy: the sorted kernel launches once per step for
   the models with one ``embedding`` collection, and never for EPNet, PPNet
   and AdaSparse, which take the dense step. The narrow HamurLarge and
   AdaptDHM steps hold the hyper-network's D-fold running stats and the
   refined centers like every buffer, AdaptDHM's unused biases and M3oE's
   unused ``w_exp_t``/``w_bal_t`` must move by weight decay; a narrow MlpN
   takes the dense step (no sorted launch). The narrow M2M runs its
   transformer's dropout at 0 (the card's and the CPU's generators draw
   differently). Then MMOE's ``fit`` (8*4096+123 rows) and evaluation in
   the sorted mode with bf16 storage (``sorted_dtype="bf16"``), the
   occurrence, dense and winner modes (and the f32 sorted one again beside
   them, for step times alike), the counters read exactly (bf16: the bf16
   form once a step, the f32 form never; occurrence: the segsum and the
   scatter once a step; dense: ``fused_dense_adam_apply`` once a step;
   winner: the scatter three times a step), for bf16 a ``save``/``load``
   round trip bit for bit on the card, a timed second epoch and a profile;
   the gates occurrence vs winner (both lazy SparseAdam) and dense vs
   sorted (both exact dense Adam), each from one state with planted faults
   it must catch (a segsum that drops duplicate sums, the old row written
   back; duplicate sums dropped); a narrow model
   in each mode on the card against the CPU (the bf16 store within one ulp
   but where its row's scale excuses it: ``bf16_store_gaps``); and a narrow
   model with a
   frozen pretrained table in its packed table and a frozen loose one in
   all five modes (both bit-identical). Last, ``[4] training mmoe
   graphed``: MMOE at ``scan_steps=64`` (the train step captured as a CUDA
   graph and replayed) in the sorted mode with the f32 and the bf16 store
   and in the occurrence, dense and winner modes, each (a) a resident epoch
   of 2^18+123 rows graphed against the eager trainer from one state (0
   elements may differ, and ``GROUP_TOL``), beside replays that keep a
   dispatch's first row of Adam numbers, which must fail; each update
   kernel's warm-up launches, its capture and the replays, checked against
   its runs in a profile (every profile here has margins at both ends,
   ``settled_profile``; one that lost records by its own bookkeeping and
   disagrees is taken again, ``profile_records``); (b) no gate: resident (and for the f32 store
   host) examples/s in turns eager, graphed, graphed, eager, host µs a
   step, syncs and busy share, capture seconds and the graph's pool; with
   rows 13's and 14's Step 0 by value and from device memory (measured in
   ``[2] sorted_dense_adam_apply bf16``, where one step of each form is
   held against the plain version). Then ``[4] training mmoe mesh``: this
   script spawns itself four times as the ranks of a (2, 2) ``(data,
   embed)`` mesh on the one card over gloo (``--mesh-rank``; the kernels
   built here first), each running MMOE's ``fit`` at Ali-CCP width in the
   sorted f32 mode (one epoch of 10 steps of 4096, the last padded, with
   validation) and ``evaluate_multi_domain_loss`` through
   ``CTRTrainer(mesh=make_mesh(2, 2))``, the counts set to 0 before and
   read after in every rank: the sharded kernel once a step a rank, nothing
   else; then the same ``fit`` in this process from the same weights and
   batches: the first step's loss within 1e-6 and the state one step from
   the common start within ``GROUP_TOL`` (``phase_train_mesh``), every
   rank's metrics the same, the later losses and the metrics printed beside
   one process padded with weight-0 rows; then a (1, 2) mesh, equal to one
   process bit for bit over the whole fit; with the backend, world size,
   ranks' memory and seconds.
5. ``[5] done in ... s`` with each phase's wall seconds (each phase also
   prints its own on a line when it ends), the card line, one
   ``{"kernels": [...]}`` line with all sixteen kernels and the sorted
   kernel's bf16 form (the sorted kernel's row also with its resident
   launches and the resident findings of (d); an eval kernel's
   ``ms`` is its Step-0 device time, beside ``back_to_back_ms``), and last
   the line ``{"ok": true, "device": {...}}``. The kernels line also holds
   the sharded form (``sorted_dense_adam_apply_sharded``: its Step 0 for
   each E and type, its bound, and its launches on the mesh path).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch

# Published peaks (dense, no sparsity) by card: f32 outside the tensor cores
# and memory bandwidth, from NVIDIA's data sheets, at full power.
PEAKS = {  # name fragment -> (f32 FLOP/s, bytes/s, dense TF32 tensor-core FLOP/s)
    "H100 PCIe": (51e12, 2.0e12, 378e12),
    "H100 NVL": (60e12, 3.9e12, 417e12),
    "H200": (67e12, 4.8e12, 495e12),
    "H100": (67e12, 3.35e12, 495e12),  # SXM
}
VOCAB, N_SPARSE, N_DENSE, DOMAINS, BATCH = 467_000, 23, 8, 3, 4096
EXPERT_DIMS, TOWER_DIMS = [256, 128, 64, 32, 16, 8], [16]
# Every fused eval kernel against its plain version: f32 FMA order differs
# from cuBLAS and from PyTorch's separate multiply and add, by a few ulp of
# the logits; the MMOE kernel meets it too.
TOL = 1e-5
# each model's fused eval kernel (wrapper name), source and TPU original
EVAL_KERNELS = {
    "mmoe": ("mmoe_fused_infer", "mmoe_infer", "scenario_wise_rec_tpu/ops/pallas/mmoe_infer.py:34"),
    "sharedbottom": ("trunk_towers_fused_infer", "tower_infer",
                     "scenario_wise_rec_tpu/ops/pallas/tower_infer.py:29"),
    "star": ("star_fused_infer", "tower_infer", "scenario_wise_rec_tpu/ops/pallas/star_infer.py:35"),
    "ple": ("ple_fused_infer", "ple_infer", "scenario_wise_rec_tpu/ops/pallas/ple_infer.py:58"),
    "sarnet": ("sarnet_fused_infer", "sarnet_infer",
               "scenario_wise_rec_tpu/ops/pallas/sarnet_infer.py:33"),
    "epnet": ("epnet_fused_infer", "adasparse_infer",
              "scenario_wise_rec_tpu/ops/pallas/gated_infer.py:47"),
    "ppnet": ("ppnet_fused_infer", "ppnet_infer",
              "scenario_wise_rec_tpu/ops/pallas/gated_infer.py:91"),
    "adasparse": ("adasparse_fused_infer", "adasparse_infer",
                  "scenario_wise_rec_tpu/ops/pallas/gated_infer.py:174"),
    "hamur": ("hamur_segment", "hamur_infer", "scenario_wise_rec_tpu/ops/pallas/hamur_infer.py:40"),
    "adaptdhm": ("adaptdhm_fused_infer", "tower_infer",
                 "scenario_wise_rec_tpu/ops/pallas/adaptdhm_infer.py:29"),
    "m2m": ("m2m_fused_infer", "m2m_infer", "scenario_wise_rec_tpu/ops/pallas/m2m_infer.py:43"),
    "m3oe": ("m3oe_fused_infer", "m3oe_infer", "scenario_wise_rec_tpu/ops/pallas/m3oe_infer.py:43"),
}
NEW_MODELS = ("sharedbottom", "star", "ple")
GATED_MODELS = ("sarnet", "epnet", "ppnet", "adasparse")
HAMUR_MODELS = ("hamur", "adaptdhm")
META_MODELS = ("m2m", "m3oe")
# m2m_fused_infer's tile rule: every value, and None (the kernel's choice);
# every tile fits at M2M's Ali-CCP widths (the tiles alive at vw's last
# stage take 600 floats a row)
M2M_BLOCK_ROWS = (16, 32, 48, 64, None)
# m3oe_fused_infer's tile rule: every value, and None (the kernel's choice);
# at Ali-CCP 48 and 64 rows do not fit (the emb, skip and star tiles take
# 1164 floats a row) and must raise
M3OE_BLOCK_ROWS = (16, 32, 48, 64, None)
M3OE_ALI_TOO_WIDE = (48, 64)
# ple_fused_infer's tile rule: every value, and None (the kernel's choice);
# 64 rows do not fit at Ali-CCP's widths nor at KuaiRand's, nor 48 at 2
# levels (the emb tile, an expert's 256- and 128-wide tiles and, at 2
# levels, the D + 1 gates and streams), and must raise
PLE_BLOCK_ROWS = (16, 32, 48, 64, None)
PLE_TOO_WIDE, PLE_TWO_LEVELS_TOO_WIDE = (64,), (48, 64)
# trunk_towers_fused_infer's tile rule: every value, and None (the kernel's
# choice); 64 rows do not fit at SharedBottom's Ali-CCP widths (the emb tile
# and the trunk's 512-wide tile take 936 floats a row) nor at KuaiRand's
# (1000 floats at F 800), and must raise
TOWER_BLOCK_ROWS = (16, 32, 48, 64, None)
TOWER_TOO_WIDE = (64,)
# adaptdhm_fused_infer's (the same kernel without trunk and biases): every
# value fits at AdaptDHM's Ali-CCP widths (the emb tile and the first
# 256-wide tile take 648 floats a row); 64 rows do not at KuaiRand's (904
# floats a row at F 812) and must raise
ADAPTDHM_BLOCK_ROWS = (16, 32, 48, 64, None)
ADAPTDHM_KUAIRAND_TOO_WIDE = (64,)
# star_fused_infer's (the same kernel, two chains and the domain norm):
# every value fits at STAR's Ali-CCP widths (the emb tile, the aux logit's and
# the first 256-wide tile take 684 floats a row); 64 rows do not at
# KuaiRand's (972 floats a row at F 800) and must raise
STAR_BLOCK_ROWS = (16, 32, 48, 64, None)
STAR_KUAIRAND_TOO_WIDE = (64,)
# sarnet_fused_infer's tile rule: every value, and None (the kernel's
# choice); every tile fits at SAR-Net's Ali-CCP widths (the emb tile and the
# experts' and gate's 176 columns take 584 floats a row); 64 rows do not at
# KuaiRand's (1000 floats a row at F 796) and must raise
SARNET_BLOCK_ROWS = (16, 32, 48, 64, None)
SARNET_KUAIRAND_TOO_WIDE = (64,)
# mmoe_fused_infer's block_rows sweep at the Ali-CCP shape
MMOE_BLOCK_ROWS = (16, 32, 48, 64)
# hamur_segment's, ppnet_fused_infer's and adasparse_fused_infer's: the tile
# rule's every value, and None (the kernel's choice)
HAMUR_BLOCK_ROWS = PPNET_BLOCK_ROWS = ADASPARSE_BLOCK_ROWS = (16, 32, 48, 64, None)
# at KuaiRand's AdaSparse widths (A 796) the [s ‖ a] tile and pruner 0's
# output take 1640 floats a row: 48 and 64 rows do not fit and must raise
ADASPARSE_KUAIRAND_TOO_WIDE = (48, 64)
# epnet_fused_infer's (AdaSparse's kernel on two steps): every value fits at
# Ali-CCP (the [s ‖ a] tile and the gate's hidden tile, 776 floats a row);
# at KuaiRand's (A 800, 1640 floats a row) 32, 48 and 64 rows do not and
# must raise
EPNET_BLOCK_ROWS = (16, 32, 48, 64, None)
EPNET_KUAIRAND_TOO_WIDE = (32, 48, 64)
# eval kernel launches a batch: HamurLarge runs 3 segments
LAUNCHES_PER_BATCH = {"hamur": 3}
# HamurLarge served fused against op by op, end to end: the op-by-op path
# sums the adapter's products in cuBLAS, the blocks with their BatchNorm
# unfolded, and the two adapter norms divide by the batch's std twice in a
# row, which amplifies those roundings; held to the JAX package's own HAMUR
# tolerance, |fused - op by op| <= 1e-5 + 1e-4 |op by op|.
SERVE_TOL = {"hamur": (1e-5, 1e-4)}
# AdaptDHM routes each row by the argmax of its logits: two paths that round
# a logit differently may route a row whose top two logits lie within
# ROUTE_GAP to different clusters. Such rows are excused, counted, printed
# and held to THRESHOLD_ROWS of the batch, as AdaSparse's threshold rows.
ROUTE_GAP = 1e-6
# AdaSparse's pruners threshold sign(beta * sigmoid(v) - eps): a kernel and a
# plain version that differ in the last ulp of v can flip one factor. A row is
# held to TOL unless some pruner element of it lies within THRESHOLD_GAP of
# eps (by the plain version: a flip needs both versions within rounding of
# it); such rows are counted, printed, and may be at most THRESHOLD_ROWS of
# the batch.
THRESHOLD_GAP, THRESHOLD_ROWS = 1e-5, 1e-4
# sorted_dense_adam_apply and fused_dense_adam_apply vs their plain versions,
# per element: both round each elementwise step alike; three or more
# duplicate gradients sum in another order (the plain index_add_ uses
# atomics). Elements whose sum lies within that order error of zero take
# AdamOrderRule's counted excuse; every other element is held to this.
SA_RTOL, SA_ATOL = 1e-5, 1e-6
# One train step of the sorted trainer against the plain dense trainer
# (torch.optim.Adam over the whole table) at full width, and of the card
# against the CPU on a narrow model, from one state. Every element of the
# table and the dense parameters must lie within STEP_ATOL + STEP_RTOL |v| (lr
# is 1e-3). The table's moments are judged the same way by the step they
# imply, lr * mu_hat / (sqrt(nu_hat) + eps): a raw mu element whose gradient
# sum cancels carries the backward's rounding as a large relative gap that
# moves no parameter (the card's and the CPU's BLAS round differently). A
# Linear bias before a train-mode BatchNorm, and the running mean that
# follows it, has an exactly zero gradient, all noise: those are held to
# NOISE_ATOL = 10 x lr (the first pattern also takes SAR-Net's final MLP,
# PPNet's tower layers and AdaSparse's layers). In STAR the FCN biases and
# the domain norm's betas are cancelled the same way (a per-domain constant
# before a BatchNorm), and in M2M the transformer's last LayerNorm beta (a
# per-column constant before the experts' BatchNorm).
# A step that starts from states that already differ by rounding is held to
# NOISE_ATOL only: Adam maps a relative gap in a gradient near eps into a
# step gap of up to ~lr (PERF.md, Findings).
STEP_RTOL, STEP_ATOL, NOISE_ATOL = 1e-4, 1e-6, 1e-2
# In HAMUR the blocks' and the hyper-network's Linear biases and running
# means are cancelled so, the adapter's up-projection bias by its own batch
# norm, and that norm's beta where a block follows the adapter.
BN_BIAS = re.compile(r"(layers\.\d+\.(lin\.b|bn\.mean)|fcn\.(share_b|dom_b)\.\d+"
                     r"|fcn\.bn\.\d+\.mean|dn\.(share_)?beta"
                     r"|(blocks|hyper)\.\d+\.(lin\.b|bn\.mean)|adapters\.\d+\.b_up"
                     r"|dec_norm\.beta)$")
# M2M's transformer mixes every row of a batch into every gradient, and
# M3oE's LayerNorms take two directions out of each row's gradient: a
# gradient element can be a sum that cancels to near nothing, or to near
# Adam's eps, and then carries the card's and the CPU's rounding as a large
# relative gap, which Adam (dividing by its magnitude) maps into a step gap
# of up to ~lr. For these models an element whose two first moments differ
# by more than NOISY_MOMENT of the CPU's (a table element too, by its sorted
# moments) is held to NOISE_ATOL, and such elements may be at most
# NOISY_SHARE of the parameters (the CPU tests against JAX: ~2 % of a narrow
# M2M's, 0.3 % of M3oE's). So is every attention's key bias, the middle
# third of ``in_b``: it adds q.b_k to all of a query's scores alike, which
# the softmax cancels.
NOISY_MODELS, NOISY_MOMENT, NOISY_SHARE = ("m2m", "m3oe"), 1e-3, 0.03
GROUP_TOL = {"table": (STEP_ATOL, STEP_RTOL), "table moments": (STEP_ATOL, STEP_RTOL),
             "dense": (STEP_ATOL, STEP_RTOL), "BN-cancelled": (NOISE_ATOL, 0.0),
             "bf16 store": None}  # bf16_store_gaps
# The bf16 store (table, mu, nu) of one train step on the card against the
# CPU, from one state: both round the same f32 chain to nearest even, but
# the card's and the CPU's gradients differ by their BLAS's rounding, which
# flips a rounding here and there. Every element must be within one bf16 ulp
# or within BF16_ROW_SCALE of its row's largest magnitude (a moment whose
# update cancels to a small fraction of its row carries the row's gradient
# noise, not its own); the elements that differ at all may be at most
# NOISY_SHARE.
BF16_ROW_SCALE = 2.0 ** -10  # a quarter ulp of the row's largest value
N_TRAIN = 16 * BATCH + 123
N_TRAIN_NEW = 8 * BATCH + 123  # the new models' fit: fewer steps than MMOE's
# the embedding-update kernels: wrapper -> (source, TPU original)
UPDATE_KERNELS = {
    "sorted_dense_adam_apply": ("sorted_adam", "scenario_wise_rec_tpu/ops/pallas/sorted_adam.py:281"),
    "fused_dense_adam_apply": ("fused_adam", "scenario_wise_rec_tpu/ops/pallas/fused_adam.py:96"),
    "occurrence_segsum": ("row_update", "scenario_wise_rec_tpu/ops/pallas/row_update.py:71"),
    "scatter_rows": ("row_update", "scenario_wise_rec_tpu/ops/pallas/row_update.py:177"),
    # the bf16 form of the sorted kernel (the TPU kernel on bf16 tiles)
    "sorted_dense_adam_apply_bf16": (
        "sorted_adam", "scenario_wise_rec_tpu/ops/pallas/sorted_adam.py:281"),
    # its row-sharded form, one shard of a mesh's table (f32; the bf16 form
    # is held in its own phase)
    "sorted_dense_adam_apply_sharded": (
        "sorted_adam", "scenario_wise_rec_tpu/ops/pallas/sorted_adam.py:436"),
}
# a kernel form counted apart from its wrapper's own count: name -> (wrapper,
# counter attribute)
FORM_COUNTERS = {"sorted_dense_adam_apply_bf16": ("sorted_dense_adam_apply", "launches_bf16"),
                 "sorted_dense_adam_apply_sharded": ("sorted_dense_adam_apply",
                                                     "launches_sharded")}
# each embedding update's kernel launches per train step (the plain step: none)
STEP_LAUNCHES = {"sorted": {"sorted_dense_adam_apply": 1},
                 "sorted_bf16": {"sorted_dense_adam_apply_bf16": 1},
                 "dense": {"fused_dense_adam_apply": 1},
                 "occurrence": {"occurrence_segsum": 1, "scatter_rows": 1},
                 "winner": {"scatter_rows": 3}}
# CTRTrainer's keywords of each update mode this script names
MODE_KW = {"sorted_bf16": dict(sparse_update_impl="sorted", sorted_dtype="bf16")}


def mode_kw(mode):
    return dict(sparse_embedding_updates=True, **MODE_KW.get(mode, {"sparse_update_impl": mode}))


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(*a):
    print(*a, flush=True)


PHASE_S = {}  # wall seconds of each phase of this run, in order


@contextlib.contextmanager
def phase(label):
    """Times one phase of the run (host clock, the card synced at its end)
    and prints its wall seconds on a line of its own."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        PHASE_S[label] = time.perf_counter() - t0
        log(f"  phase {label}: {PHASE_S[label]:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    for frag, p in PEAKS.items():
        if frag in name:
            return frag, p
    log(f"note: no published peaks for {name!r}; using the H100 SXM's")
    return "H100", PEAKS["H100"]


def time_ms(fn, reps=5, inner=20, warmup=3):
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls, from CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / inner)
    return statistics.median(runs)


def device_and_host(fn, inner=50, reps=5, warmup=3):
    """``(device ms, host µs)`` per call of ``fn``, the host's issue cost
    kept out of the first. ``torch.cuda._sleep`` holds the stream before the
    start event long enough that the host has queued all ``inner`` calls
    before the card reaches them, so the events bracket device work only;
    the host's ``perf_counter`` over the same calls (the queue never drains
    while it runs) gives the issue cost. A run in which the card caught up
    with the host is repeated with a longer sleep; a ``fn`` that waits for
    the card itself (a sync inside) can never be held so, and gives
    ``(None, host µs)``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    # ~2 GHz: 4x the whole run's wall time, host and device together
    cycles = max(1_000_000, int(4 * (time.perf_counter() - t0) * 2e9))
    dev, host, misses = [], [], 0
    while misses < 3:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        tq = time.perf_counter()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        if (t1 - tq) * 1e3 >= s.elapsed_time(a):  # the card reached the calls first
            cycles, misses = 2 * cycles, misses + 1
            continue
        dev.append(a.elapsed_time(b) / inner)
        host.append((t1 - t0) * 1e6 / inner)
        if len(dev) == reps:
            return statistics.median(dev), statistics.median(host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    return None, (time.perf_counter() - t0) * 1e6 / inner


def device_ms(event):
    """A profiler event's own device time, ms."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0)) / 1e3


def device_events(averages):
    """The device-side events (kernels, copies, memsets) of a profile's
    ``key_averages()``: an op's row, and a user annotation's such as
    ``Optimizer.step``, repeats the time of the kernels inside it; the
    pad of :func:`settled_profile` is left out."""
    from torch.autograd import DeviceType

    return [e for e in averages if e.device_type != DeviceType.CPU and device_ms(e) > 0
            and not getattr(e, "is_user_annotation", False) and PAD_KERNEL not in e.key]


PAD = "chip_smoke: profile pad"  # settled_profile's closing range
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel, the pad's


@contextlib.contextmanager
def settled_profile():
    """torch.profiler over the host and the card, with margins at both
    ends: a few launches and a sync in the profiler's warm-up step, whose
    records are dropped, before the recorded step opens; and after the
    caller's work, inside the recorded step, a range ``PAD`` of 16
    ``torch.cuda._sleep`` kernels (500,000 cycles each), a sync and a 5 ms pause,
    which every device count here leaves out (``device_events``,
    ``profile_records``; the host rows of ``profile_device`` still hold its
    16 launches and its sync). Without margins a profile on the H100 missed
    the records of its first few launches, more of them the more profiles
    the process had taken, and now and then those of its last work (the
    last graph launch's last kernels and the launches after it)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(1024, device="cuda")
        for _ in range(16):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        yield prof
        with record_function(PAD):
            for _ in range(16):
                torch.cuda._sleep(500_000)
            torch.cuda.synchronize()
            time.sleep(0.005)


def profiled_launches(fn, calls=10):
    """``(launches, device ms)`` per call of ``fn`` under torch.profiler:
    every kernel and memset or copy on the card, and their summed device
    time (the card's busy time, gaps excluded); and the names seen."""
    fn()
    torch.cuda.synchronize()
    with settled_profile() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof.key_averages())
    names = {}
    for e in events:
        names[e.key[:60]] = names.get(e.key[:60], 0) + e.count / calls
    return (sum(e.count for e in events) / calls, sum(device_ms(e) for e in events) / calls,
            names)


def wrapper_cost(label, fn):
    """Step 0's three readings of one call of ``fn``: device ms (host kept
    out), host µs, launches (profiler), logged with the profiler's busy
    time per call as the cross-check of the device reading. The timed run
    queues at most ~400 launches, well inside the card's launch queue (a
    full queue would make the host wait for the card)."""
    launches, busy_ms, names = profiled_launches(fn)
    device_ms, host_us = device_and_host(fn, inner=max(5, min(50, int(400 // max(1, launches)))))
    shown = "not measurable (the call syncs)" if device_ms is None else f"{device_ms:.4f} ms"
    log(f"    {label}: device {shown}, host {host_us:.1f} us, {launches:g} launches per call "
        f"(profiler busy {busy_ms:.4f} ms): {names}")
    return {"device_ms": device_ms, "host_us": host_us, "launches_per_call": launches,
            "profiled_busy_ms": busy_ms}


def design_bound(label, flops, moved, tc, peak, device_ms=None):
    """The bound of a kernel that runs ``tc`` of its ``flops`` as three TF32
    products each on the tensor cores (3xTF32) and the rest in f32, beside
    the f32 SIMT bound of the same work, both against ``moved`` bytes over
    HBM; logged, with the share of it that ``device_ms`` reaches. Returns the
    entry's ``bound_ms``, ``bound_by`` and ``f32_simt_bound_ms``."""
    t_bytes = moved / peak[1] * 1e3
    f32 = max(flops / peak[0] * 1e3, t_bytes)
    t_ops = (3 * tc / peak[2] + (flops - tc) / peak[0]) * 1e3
    bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    share = "" if device_ms is None else f", {100 * bound / device_ms:.1f}% of it"
    log(f"  {label}bounds: f32 SIMT {f32:.4f} ms; 3xTF32 design {bound:.4f} ms ({by}: "
        f"{3 * tc / 1e9:.3f} GFLOP TF32 at {peak[2] / 1e12:g} TFLOP/s + {(flops - tc) / 1e9:.4f} "
        f"GFLOP f32 take {t_ops:.4f} ms, {moved / 1e6:.2f} MB {t_bytes:.4f} ms){share}")
    return {"bound_ms": bound, "bound_by": by, "f32_simt_bound_ms": f32}


def random_stages(gen, F, E, D, expert_dims, tower_dims):
    """Weights scaled like torch's Linear init (std ~ 1/sqrt(in))."""
    def n(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    ex, w = [], F
    for o in expert_dims:
        ex.append((n(E, w, o, scale=w ** -0.5), n(E, o, scale=0.1)))
        w = o
    gate = (n(D, F, E, scale=F ** -0.5), n(D, E))
    tw, h = [], w
    for o in tower_dims:
        tw.append((n(D, h, o, scale=h ** -0.5), n(D, o, scale=0.1)))
        h = o
    return ex, gate, tw, (n(D, h, 1, scale=h ** -0.5), n(D, 1))


def work(emb, did, ex, gate, tw, out):
    """(FLOPs, bytes, expert FLOPs) the function needs on these inputs: 2
    per multiply-add, each row's own-domain gate and tower; each input read
    once, the output written once. The experts' share is what the kernel
    runs on the tensor cores."""
    B = emb.shape[0]
    expert = sum(w.shape[0] * w.shape[1] * w.shape[2] for w, _ in ex)  # E * in * out
    macs = expert + gate[0].shape[1] * gate[0].shape[2]
    macs += sum(w.shape[1] * w.shape[2] for w, _ in tw) + out[0].shape[1]
    tensors = [emb, did] + [t for s in ex for t in s] + list(gate) \
        + [t for s in tw for t in s] + list(out)
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + B * 4
    return 2.0 * B * macs, float(nbytes), 2.0 * B * expert


def phase_kernels(gen, peak):
    from scenario_wise_rec_tpu_torch.ops.kernels.mmoe_infer import (
        mmoe_fused_infer, mmoe_fused_infer_ref)

    F = N_SPARSE * 16 + N_DENSE
    ali = random_stages(gen, F, DOMAINS, DOMAINS, EXPERT_DIMS, TOWER_DIMS)
    narrow = random_stages(gen, 42, 2, 2, [8], [4])

    def ids(B, D, lo=0, hi=None):
        return torch.randint(lo, D if hi is None else hi, (B,), generator=gen,
                             device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    cases = {
        "a_alicpp_b4096": (randn(4096, F), ids(4096, DOMAINS), ali),
        "b_ragged_b4095": (randn(4095, F), ids(4095, DOMAINS), ali),
        "b_ragged_b1": (randn(1, F), ids(1, DOMAINS), ali),
        "b_ragged_b31_b33": (randn(33, F), ids(33, DOMAINS), ali),  # a tile's 32 rows +- 1
        # 32 tiles of 32 rows, the last of 8
        "b_ragged_b1000": (randn(1000, F), ids(1000, DOMAINS), ali),
        "c_narrow_b1000": (randn(1000, 42), ids(1000, 2), narrow),
        # widths off the mma tile (8), a layer past one 256-column pass, 9
        # experts
        "e_odd_widths_b1000": (randn(1000, 201), ids(1000, 2),
                               random_stages(gen, 201, 9, 2, [300, 33, 7], [5])),
    }
    # KuaiRand's MMOE ladder (5 domains, 5 experts of [32], tower [16]) at a
    # wide F: its loader keeps each column as a 16-wide sparse feature. Its
    # own generator: the phases after this one draw what they drew without it
    kr = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 1)
    cases["g_kuairand_b4096"] = (
        torch.randn(4096, 800, generator=kr, device="cuda"),
        torch.randint(0, 5, (4096,), generator=kr, device="cuda"),
        random_stages(kr, 800, 5, 5, [32], [16]))
    nan_emb = randn(4096, F)
    nan_emb[2049, 100] = float("nan")  # stays in its row: the others are checked
    cases["f_nan_row_b4096"] = (nan_emb, cases["a_alicpp_b4096"][1], ali)
    oob = torch.tensor([-1, DOMAINS, DOMAINS + 5, 0, 1, 2], device="cuda")
    cases["d_domain_oob_b4096"] = (
        cases["a_alicpp_b4096"][0], oob[ids(4096, len(oob))], ali)
    max_err = 0.0
    for name, (emb, did, st) in cases.items():
        got = mmoe_fused_infer(emb, did, *st)
        torch.cuda.synchronize()
        want = mmoe_fused_infer_ref(emb, did, *st)
        if name.startswith("f_nan"):
            check(bool(torch.isnan(got[2049])), f"{name}: the NaN row is not NaN")
            keep = torch.arange(emb.shape[0], device="cuda") != 2049
            got, want = got[keep], want[keep]
        elif name == "b_ragged_b31_b33":
            check(torch.equal(mmoe_fused_infer(emb[:31], did[:31], *st), got[:31]),
                  f"{name}: B = 31 differs from the first 31 rows of B = 33")
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name}: bad output")
        err = (got - want).abs().max().item()
        log(f"  {name}: max_abs_err {err:.3e}")
        check(err <= TOL, f"{name}: kernel disagrees with plain ({err} > {TOL})")
        max_err = max(max_err, err)
    emb, did, st = cases["d_domain_oob_b4096"]
    clipped = mmoe_fused_infer(emb, did.clamp(0, DOMAINS - 1), *st)
    check(torch.equal(mmoe_fused_infer(emb, did, *st), clipped),
          "out-of-range domain ids are not clipped")

    emb, did, st = cases["a_alicpp_b4096"]
    want = mmoe_fused_infer_ref(emb, did, *st)
    sweep, sweep_device = {}, {}
    log("  a_alicpp_b4096 block_rows sweep: back to back, then step 0 per call:")
    for rows in MMOE_BLOCK_ROWS:
        err = (mmoe_fused_infer(emb, did, *st, block_rows=rows) - want).abs().max().item()
        check(err <= TOL, f"block_rows={rows} disagrees ({err} > {TOL})")
        max_err = max(max_err, err)
        sweep[rows] = time_ms(lambda: mmoe_fused_infer(emb, did, *st, block_rows=rows))
        cost = wrapper_cost(f"mmoe_fused_infer block_rows={rows} (back to back "
                            f"{sweep[rows]:.4f} ms, max_abs_err {err:.3e})",
                            lambda: mmoe_fused_infer(emb, did, *st, block_rows=rows))
        sweep_device[rows] = cost["device_ms"]
    kernel_ms = time_ms(lambda: mmoe_fused_infer(emb, did, *st))
    plain_ms = time_ms(lambda: mmoe_fused_infer_ref(emb, did, *st))
    cost = wrapper_cost("mmoe_fused_infer, default block_rows",
                        lambda: mmoe_fused_infer(emb, did, *st))
    flops, nbytes, expert_flops = work(emb, did, *st)
    # the design's own: three TF32 products a multiply-add of the experts on
    # the tensor cores, the gate, tower and head in f32
    bounds = design_bound("", flops, nbytes, expert_flops, peak)
    bound, device = bounds["bound_ms"], cost["device_ms"]
    log(f"  a_alicpp_b4096: kernel device {device:.4f} ms (back to back {kernel_ms:.4f}), "
        f"host {cost['host_us']:.1f} us, plain {plain_ms:.4f} ms, "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB, bound {bound:.4f} ms "
        f"({bounds['bound_by']}), "
        f"{flops / device / 1e9:.2f} TFLOP/s achieved ({100 * bound / device:.1f}% of bound)")
    fn, source, replaces = EVAL_KERNELS["mmoe"]
    return {"name": fn, "route": "cuda",
            "source": f"scenario_wise_rec_tpu_torch/csrc/{source}.cu", "replaces": replaces,
            "max_abs_err": max_err, "ms": device, "back_to_back_ms": kernel_ms,
            "host_us": cost["host_us"], "launches_per_call": cost["launches_per_call"],
            "plain_ms": plain_ms, **bounds, "library_ms": None,
            "block_rows_sweep_ms": sweep, "block_rows_sweep_device_ms": sweep_device}


def affines(gen, lead, dims):
    """Stages (W [*lead, in, out], b [*lead, out]) between the widths
    ``dims``, scaled like torch's Linear init (std ~ 1/sqrt(in))."""
    return [(torch.randn(*lead, i, o, generator=gen, device="cuda") * i ** -0.5,
             torch.randn(*lead, o, generator=gen, device="cuda") * 0.1)
            for i, o in zip(dims[:-1], dims[1:])]


def macs(stages):
    """Multiply-adds per row of one member's path through ``stages``."""
    return sum(w.shape[-2] * w.shape[-1] for w, _ in stages)


def nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def flat(*groups):
    """Every tensor of a nest of stage lists, LevelSpecs and tensors."""
    out = []
    for g in groups:
        if torch.is_tensor(g):
            out.append(g)
        elif g is None:
            continue
        elif hasattr(g, "spec_stages"):
            out += flat(g.spec_stages, g.shared_stages, g.gate_stages, g.gate_shared_stages)
        else:
            out += flat(*g)
    return out


def tower_work(emb, did, trunk, towers, head):
    """(FLOPs, bytes): 2 per multiply-add of the trunk and the row's own
    tower and head; each input read once, the output written once."""
    per_row = macs(trunk) + macs(towers) + (macs([head]) if head is not None else 0)
    B = emb.shape[0]
    return 2.0 * B * per_row, nbytes(emb, did, *flat(trunk, towers, head)) + B * 4


def star_work(emb, did, mean, rstd, g, b, fcn, aux, aux_out):
    """(FLOPs, bytes): the row's own FCN, the aux MLP and head (2 per
    multiply-add) and the domain norm (3 per element)."""
    B, F = emb.shape
    per_row = 2.0 * (macs(fcn) + macs(aux) + macs([aux_out])) + 3.0 * F
    return B * per_row, nbytes(emb, did, mean, rstd, g, b, *flat(fcn, aux, aux_out)) + B * 4


def ple_work(emb, did, levels, towers, head):
    """(FLOPs, bytes): at the last level the row's own S specific experts,
    the shared ones, its own gate and mixture; at a level before it every
    domain's experts and gates, the shared gate and all D + 1 mixtures; then
    the own tower and head. 2 per multiply-add."""
    D, S = levels[0].spec_stages[0][0].shape[:2]
    n_sh = levels[0].shared_stages[0][0].shape[0]
    E, per_row = S + n_sh, 0
    for i, lv in enumerate(levels):
        H = lv.spec_stages[-1][0].shape[-1]
        if i < len(levels) - 1:
            per_row += D * S * macs(lv.spec_stages) + n_sh * macs(lv.shared_stages)
            per_row += D * macs(lv.gate_stages) + macs(lv.gate_shared_stages)
            per_row += (D * E + D * S + n_sh) * H
        else:
            per_row += S * macs(lv.spec_stages) + n_sh * macs(lv.shared_stages)
            per_row += macs(lv.gate_stages) + E * H
    per_row += macs(towers) + macs([head])
    B = emb.shape[0]
    return 2.0 * B * per_row, nbytes(emb, did, *flat(levels, towers, head)) + B * 4


def ple_product_macs(levels, towers):
    """Multiply-adds per row of ple_work's products (all but the mixes and
    the 1-wide head): what the kernel runs on the tensor cores."""
    D, S = levels[0].spec_stages[0][0].shape[:2]
    n_sh = levels[0].shared_stages[0][0].shape[0]
    per_row = macs(towers)
    for i, lv in enumerate(levels):
        if i < len(levels) - 1:
            per_row += D * S * macs(lv.spec_stages) + n_sh * macs(lv.shared_stages)
            per_row += D * macs(lv.gate_stages) + macs(lv.gate_shared_stages)
        else:
            per_row += S * macs(lv.spec_stages) + n_sh * macs(lv.shared_stages)
            per_row += macs(lv.gate_stages)
    return per_row


def near_threshold(margin_fn, inputs, args):
    """AdaSparse's threshold rule: the rows whose pruners lie within
    THRESHOLD_GAP of epsilon (``margin_fn`` gives each row's least gap, by
    the plain version); None for a kernel without a hard threshold."""
    return None if margin_fn is None else margin_fn(*inputs, *args) <= THRESHOLD_GAP


def kernel_gap(got, want, near):
    """max |got - want| over the rows not ``near`` the threshold."""
    diff = (got - want).abs()
    if near is not None:
        diff = diff[~near]
    return diff.max().item() if diff.numel() else 0.0


def nan_filled(wrapper):
    """``wrapper`` with its output in a block just freed full of NaN: a row
    the kernel leaves unwritten fails run_cases' finiteness check."""
    def call(*a, **kw):
        torch.cuda.synchronize()
        nan = torch.full((a[0].shape[0],), float("nan"), device="cuda")
        del nan
        return wrapper(*a, **kw)
    return call


def counted(g, *counts):
    """``counts[d]`` ids of each domain d, shuffled by ``g``."""
    did = torch.cat([torch.full((c,), d, device="cuda") for d, c in enumerate(counts)])
    return did[torch.randperm(len(did), generator=g, device="cuda")]


def rows_of(g, B, F):
    """``[B, F]`` normal rows drawn from ``g``."""
    return torch.randn(B, F, generator=g, device="cuda")


def run_cases(label, wrapper, ref, cases, margin_fn=None):
    """Each case's kernel output against the plain version's, and the
    out-of-range ids (the last input) against the same ids clipped; returns
    the max error. ``margin_fn``: the threshold rule, whose excused rows are
    counted, printed and held to THRESHOLD_ROWS of the batch."""
    max_err = 0.0
    for name, (inputs, args) in cases.items():
        got = wrapper(*inputs, *args)
        torch.cuda.synchronize()
        want = ref(*inputs, *args)
        B = inputs[0].shape[0]
        check(got.shape == want.shape == (B,) and bool(torch.isfinite(got).all()),
              f"{label} {name}: bad output")
        near = near_threshold(margin_fn, inputs, args)
        err = kernel_gap(got, want, near)
        rule = "" if near is None else f", {int(near.sum())} of {B} rows at the threshold"
        log(f"  {label} {name}: max_abs_err {err:.3e}{rule}")
        check(err <= TOL, f"{label} {name}: kernel disagrees with plain ({err} > {TOL})")
        if near is not None:
            check(int(near.sum()) <= THRESHOLD_ROWS * B,
                  f"{label} {name}: {int(near.sum())} rows at the threshold")
        max_err = max(max_err, err)
        if "oob" in name:
            clipped = wrapper(*inputs[:-1], inputs[-1].clamp(0, DOMAINS - 1), *args)
            check(torch.equal(wrapper(*inputs, *args), clipped),
                  f"{label}: out-of-range domain ids are not clipped")
    return max_err


def time_entry(label, model, wrapper, ref, inputs, args, work_fn, peak, max_err,
               margin_fn=None, sweep_rows=(8, 16, 24, 32, 48)):
    """The kernel beside its plain version and its bound at the main path's
    shape, with a ``block_rows`` sweep over ``sweep_rows``; the kernels-line
    entry."""
    sweep = {}
    want = ref(*inputs, *args)
    near = near_threshold(margin_fn, inputs, args)
    for rows in sweep_rows:
        got = wrapper(*inputs, *args, block_rows=rows)
        check(kernel_gap(got, want, near) <= TOL, f"{label} block_rows={rows} disagrees")
        sweep[rows] = time_ms(lambda: wrapper(*inputs, *args, block_rows=rows))
    log(f"  {label} block_rows sweep, ms: " + ", ".join(f"{r} -> {t:.4f}" for r, t in sweep.items()))
    kernel_ms = time_ms(lambda: wrapper(*inputs, *args))
    plain_ms = time_ms(lambda: ref(*inputs, *args))
    cost = wrapper_cost(f"{label} a_alicpp_b4096, step 0", lambda: wrapper(*inputs, *args))
    device = cost["device_ms"]
    flops, moved = work_fn(*inputs, *args)
    t_ops, t_bytes = flops / peak[0] * 1e3, moved / peak[1] * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  {label} a_alicpp_b4096: kernel device {device:.4f} ms (back to back "
        f"{kernel_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB, bound {bound:.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{flops / device / 1e9:.2f} TFLOP/s achieved ({100 * bound / device:.1f}% of bound)")
    fn, source, replaces = EVAL_KERNELS[model]
    return {"name": fn, "route": "cuda",
            "source": f"scenario_wise_rec_tpu_torch/csrc/{source}.cu", "replaces": replaces,
            "max_abs_err": max_err, "ms": device, "back_to_back_ms": kernel_ms,
            "host_us": cost["host_us"], "launches_per_call": cost["launches_per_call"],
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "block_rows_sweep_ms": sweep}


def phase_new_kernels(gen, peak):
    """``trunk_towers_fused_infer``, ``star_fused_infer`` and
    ``ple_fused_infer`` against their plain versions at every case, then
    timed at their model's Ali-CCP shape."""
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.nn import batch_stats

    F, D = N_SPARSE * 16 + N_DENSE, DOMAINS
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    ids = lambda B, d=D: torch.randint(0, d, (B,), generator=gen, device="cuda")
    oob = torch.tensor([-1, D, D + 5, 0, 1, 2], device="cuda")
    emb4096 = randn(4096, F)

    def shaped(args_ali, args_narrow, extra):
        """The cases (a)-(d) with the kernel's arguments, plus ``extra``."""
        cases = {"a_alicpp_b4096": ((emb4096, ids(4096)), args_ali),
                 "b_ragged_b4095": ((randn(4095, F), ids(4095)), args_ali),
                 "b_ragged_b1": ((randn(1, F), ids(1)), args_ali),
                 "c_narrow_b1000": ((randn(1000, 42), ids(1000, 2)), args_narrow),
                 "d_domain_oob_b4096": ((emb4096, oob[ids(4096, len(oob))]), args_ali)}
        return {**cases, **extra}

    entries = {}
    # SharedBottom: trunk [512], towers [256,...,8], a 1-unit head
    tower_dims = [512, 256, 128, 64, 32, 16, 8]
    ali = (affines(gen, (), [F, 512]), affines(gen, (D,), tower_dims),
           affines(gen, (D,), [8, 1])[0])
    narrow = (affines(gen, (), [42, 24]), affines(gen, (2,), [24, 8, 4]),
              affines(gen, (2,), [4, 1])[0])
    no_head = (ali[0], affines(gen, (D,), tower_dims + [1]), None)
    cases = shaped(ali, narrow, {"f_no_head_b4096": ((emb4096, ids(4096)), no_head)})
    # the partition by domain at its edges, KuaiRand's and Amazon's ladders and
    # B 65,536, from a generator of its own: the shared one feeds every later
    # phase's data
    tg = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 8)
    t_counted, t_rows = partial(counted, tg), partial(rows_of, tg)

    def ladder(Fi, Dn, trunk, towers):
        return (affines(tg, (), [Fi] + trunk), affines(tg, (Dn,), trunk[-1:] + towers),
                affines(tg, (Dn,), [towers[-1], 1])[0])

    cases["g_skewed_b4096"] = ((t_rows(4096, F), t_counted(3700, 300, 96)), ali)  # 90 % in one
    # 33 / 32 / 1 rows: a tile and one row, a whole tile, one row (32-row tiles)
    cases["h_counts_astride_tiles_b66"] = ((t_rows(66, F), t_counted(33, 32, 1)), ali)
    # KuaiRand's SharedBottom (trunk [128], towers [64, 32], 5 domains) at
    # MMOE's KuaiRand F 800; Amazon's (trunk [128], towers [8]) at its 3
    # sparse features of 16
    cases["i_kuairand_b4096"] = (
        (t_rows(4096, 800), torch.randint(0, 5, (4096,), generator=tg, device="cuda")),
        ladder(800, 5, [128], [64, 32]))
    cases["j_amazon_b4096"] = (
        (t_rows(4096, 48), torch.randint(0, D, (4096,), generator=tg, device="cuda")),
        ladder(48, D, [128], [8]))
    cases["k_b65536"] = (
        (t_rows(65_536, F), torch.randint(0, D, (65_536,), generator=tg, device="cuda")), ali)
    unwritten_nan = nan_filled(k.trunk_towers_fused_infer)
    err = run_cases("trunk_towers_fused_infer", unwritten_nan, k.trunk_towers_fused_infer_ref,
                    cases)
    for rows in TOWER_BLOCK_ROWS:  # every tile: at the edges of the partition, the ladders
        for name in ("g_skewed_b4096", "h_counts_astride_tiles_b66", "f_no_head_b4096",
                     "i_kuairand_b4096", "j_amazon_b4096"):
            inputs, args = cases[name]
            if rows in TOWER_TOO_WIDE and not name.startswith("j_amazon"):
                try:
                    k.trunk_towers_fused_infer(*inputs, *args, block_rows=rows)
                except RuntimeError as e:
                    check("shared memory" in str(e), f"trunk_towers_fused_infer block_rows={rows}: {e}")
                    continue
                check(False, f"trunk_towers_fused_infer {name} block_rows={rows} ran past shared memory")
            got = unwritten_nan(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.trunk_towers_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"trunk_towers_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    log(f"  trunk_towers_fused_infer block_rows {TOWER_TOO_WIDE} at Ali-CCP's and KuaiRand's "
        f"widths: raise, naming the shared memory")
    # int64 ids as they are, modulo 2^32 as int32, then clipped
    (emb, did), args = cases["d_domain_oob_b4096"]
    check(torch.equal(k.trunk_towers_fused_infer(emb, did, *args),
                      k.trunk_towers_fused_infer(emb, did.to(torch.int32), *args))
          and torch.equal(k.trunk_towers_fused_infer(emb, did + 2**32, *args),
                          k.trunk_towers_fused_infer(emb, did, *args)),
          "trunk_towers_fused_infer: int64 ids differ from the same ids as int32")
    fits = tuple(r for r in TOWER_BLOCK_ROWS if r is not None and r not in TOWER_TOO_WIDE)
    entry = time_entry("trunk_towers_fused_infer", "sharedbottom", k.trunk_towers_fused_infer,
                       k.trunk_towers_fused_infer_ref, *cases["a_alicpp_b4096"], tower_work,
                       peak, err, sweep_rows=fits)
    # the design's own bound: every product (trunk, tower, head) as three TF32
    # products on the tensor cores
    inputs, args = cases["a_alicpp_b4096"]
    flops, moved = tower_work(*inputs, *args)
    entry.update(design_bound("trunk_towers_fused_infer ", flops, moved, flops, peak,
                              entry["ms"]))
    for name in ("i_kuairand_b4096", "j_amazon_b4096", "k_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"trunk_towers_fused_infer {name}, step 0",
                            lambda: k.trunk_towers_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["sharedbottom"] = entry

    # STAR: FCN [256,...,8,1] per domain, aux [16]; mean/rstd of each batch
    def star_args(emb, Dn, fcn, aux, w=None, g=gen):
        mean, var, _ = batch_stats(emb, w)
        gamma = 0.5 + torch.rand(Dn, emb.shape[1], generator=g, device="cuda")
        beta = 0.1 * torch.randn(Dn, emb.shape[1], generator=g, device="cuda")
        return (mean, torch.rsqrt(var + 1e-6), gamma, beta,
                affines(g, (Dn,), [emb.shape[1]] + fcn + [1]),
                affines(g, (), [emb.shape[1]] + aux), affines(g, (), [aux[-1], 1])[0])

    fcn_dims = [256, 128, 64, 32, 16, 8]
    cases = {}
    for name, ((emb, did), _) in shaped(None, None, {}).items():
        narrow_case = name.startswith("c_")
        cases[name] = ((emb, did), star_args(emb, 2 if narrow_case else D,
                                             [8, 4] if narrow_case else fcn_dims,
                                             [4] if narrow_case else [16]))
    # a batch padded past row 3000 with copies of row 0 and weight 0: the
    # domain norm's statistics come from the 3000 real rows only
    real = 3000
    padded = torch.cat([emb4096[:real], emb4096[:1].expand(4096 - real, F)]).contiguous()
    w = torch.cat([torch.ones(real, device="cuda"), torch.zeros(4096 - real, device="cuda")])
    pad_args = star_args(padded, D, fcn_dims, [16], w)
    pad_ids = ids(4096)
    cases["e_padded_rows_b4096"] = ((padded, pad_ids), pad_args)
    # the partition by domain at its edges, KuaiRand's ladder and B 65,536,
    # from a generator of its own: the shared one feeds every later phase's
    # data
    sg = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 11)
    s_counted, s_rows = partial(counted, sg), partial(rows_of, sg)

    def star_case(emb, did, Dn=D, fcn=fcn_dims, aux=(16,)):
        return (emb, did), star_args(emb, Dn, fcn, list(aux), g=sg)

    cases["g_skewed_b4096"] = star_case(s_rows(4096, F), s_counted(3700, 300, 96))  # 90 % in one
    # 33 / 32 / 1 rows: a tile and one row, a whole tile, one row (32-row tiles)
    cases["h_counts_astride_tiles_b66"] = star_case(s_rows(66, F), s_counted(33, 32, 1))
    # KuaiRand's STAR (FCN [128, 64, 32], aux [32], 5 domains) at MMOE's
    # KuaiRand F 800
    cases["i_kuairand_b4096"] = star_case(
        s_rows(4096, 800), torch.randint(0, 5, (4096,), generator=sg, device="cuda"), 5,
        [128, 64, 32], (32,))
    cases["j_b65536"] = star_case(
        s_rows(65_536, F), torch.randint(0, D, (65_536,), generator=sg, device="cuda"))
    unwritten_nan = nan_filled(k.star_fused_infer)
    err = run_cases("star_fused_infer", unwritten_nan, k.star_fused_infer_ref, cases)
    for rows in STAR_BLOCK_ROWS:  # every tile: at the edges of the partition, the ladder
        for name in ("b_ragged_b4095", "e_padded_rows_b4096", "g_skewed_b4096",
                     "h_counts_astride_tiles_b66", "i_kuairand_b4096"):
            inputs, args = cases[name]
            if rows in STAR_KUAIRAND_TOO_WIDE and name.startswith("i_kuairand"):
                try:
                    k.star_fused_infer(*inputs, *args, block_rows=rows)
                except RuntimeError as e:
                    check("shared memory" in str(e), f"star_fused_infer block_rows={rows}: {e}")
                    continue
                check(False, f"star_fused_infer {name} block_rows={rows} ran past shared memory")
            got = unwritten_nan(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.star_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"star_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    log(f"  star_fused_infer every tile {STAR_BLOCK_ROWS} at Ali-CCP's widths holds; "
        f"{STAR_KUAIRAND_TOO_WIDE} at KuaiRand's raises, naming the shared memory")
    mean, var, _ = batch_stats(emb4096[:real])
    unpadded = k.star_fused_infer_ref(emb4096[:real].contiguous(), pad_ids[:real], mean,
                                      torch.rsqrt(var + 1e-6), *pad_args[2:])
    pad_err = (k.star_fused_infer(padded, pad_ids, *pad_args)[:real] - unpadded).abs().max().item()
    log(f"  star_fused_infer e_padded_rows_b4096: real rows vs the unpadded batch, "
        f"max_abs_err {pad_err:.3e}")
    check(pad_err <= TOL, "STAR's padded rows move its real rows")
    # int64 ids as they are, modulo 2^32 as int32, then clipped; one launch a
    # call on STAR's counter, none on SharedBottom's or AdaptDHM's
    (emb, did), args = cases["d_domain_oob_b4096"]
    before = read_counts()
    same = (torch.equal(k.star_fused_infer(emb, did, *args),
                        k.star_fused_infer(emb, did.to(torch.int32), *args))
            and torch.equal(k.star_fused_infer(emb, did + 2**32, *args),
                            k.star_fused_infer(emb, did, *args)))
    delta = {n: c - before[n] for n, c in read_counts().items() if c != before[n]}
    check(same, "star_fused_infer: int64 ids differ from the same ids as int32")
    check(delta == {"star_fused_infer": 4}, f"star_fused_infer: 4 calls moved the counts by {delta}")
    entry = time_entry("star_fused_infer", "star", k.star_fused_infer, k.star_fused_infer_ref,
                       *cases["a_alicpp_b4096"], star_work, peak, max(err, pad_err),
                       sweep_rows=STAR_BLOCK_ROWS)
    # the design's own bound: every product (the aux stages and head, the own
    # FCN) as three TF32 products on the tensor cores, the norm in f32
    inputs, args = cases["a_alicpp_b4096"]
    flops, moved = star_work(*inputs, *args)
    entry.update(design_bound("star_fused_infer ", flops, moved,
                              flops - 3.0 * inputs[0].numel(), peak, entry["ms"]))
    for name in ("i_kuairand_b4096", "j_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"star_fused_infer {name}, step 0",
                            lambda: k.star_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["star"] = entry

    # PLE: 1 level of 2 specific + 1 shared experts [256,...,8], tower [16];
    # and 2 levels at the same expert widths (the shared gate's path)
    def ple_args(F_in, Dn, S, n_sh, levels, towers, g=gen):
        out, width = [], F_in
        for i, dims in enumerate(levels):
            gs = None if i == len(levels) - 1 else affines(g, (), [width, Dn * S + n_sh])
            out.append(k.LevelSpec(affines(g, (Dn, S), [width] + dims),
                                   affines(g, (n_sh,), [width] + dims),
                                   affines(g, (Dn,), [width, S + n_sh]), gs))
            width = dims[-1]
        tw = affines(g, (Dn,), [width] + towers)
        return out, tw, affines(g, (Dn,), [towers[-1] if towers else width, 1])[0]

    ali = ple_args(F, D, 2, 1, [EXPERT_DIMS], TOWER_DIMS)
    narrow = ple_args(42, 2, 2, 1, [[16, 8], [8]], [4])
    two = ple_args(F, D, 2, 1, [EXPERT_DIMS, EXPERT_DIMS], TOWER_DIMS)
    cases = shaped(ali, narrow, {"e_two_levels_b4096": ((emb4096, ids(4096)), two)})
    # the partition by domain at its edges, KuaiRand's ladder and B 65,536,
    # from a generator of its own: the shared one feeds every later phase's data
    pg = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 7)
    p_counted, p_rows = partial(counted, pg), partial(rows_of, pg)
    cases["f_skewed_b4096"] = ((p_rows(4096, F), p_counted(3700, 300, 96)), ali)  # 90 % in one
    # 33 / 32 / 1 rows: a tile and one row, a whole tile, one row (32-row tiles)
    cases["g_counts_astride_tiles_b66"] = ((p_rows(66, F), p_counted(33, 32, 1)), ali)
    # KuaiRand's PLE ladder (1 level, experts [64, 32], tower [16], 5 domains)
    # at MMOE's KuaiRand F 800
    cases["h_kuairand_b4096"] = (
        (p_rows(4096, 800), torch.randint(0, 5, (4096,), generator=pg, device="cuda")),
        ple_args(800, 5, 2, 1, [[64, 32]], [16], g=pg))
    cases["i_b65536"] = (
        (p_rows(65_536, F), torch.randint(0, D, (65_536,), generator=pg, device="cuda")), ali)
    unwritten_nan = nan_filled(k.ple_fused_infer)
    err = run_cases("ple_fused_infer", unwritten_nan, k.ple_fused_infer_ref, cases)
    for rows in PLE_BLOCK_ROWS:  # every tile: at the edges of the partition, KuaiRand's, 2 levels
        for name in ("f_skewed_b4096", "g_counts_astride_tiles_b66", "h_kuairand_b4096",
                     "e_two_levels_b4096"):
            inputs, args = cases[name]
            wide = PLE_TWO_LEVELS_TOO_WIDE if name.startswith("e_") else PLE_TOO_WIDE
            if rows in wide:
                try:
                    k.ple_fused_infer(*inputs, *args, block_rows=rows)
                except RuntimeError as e:
                    check("shared memory" in str(e), f"ple_fused_infer block_rows={rows}: {e}")
                    continue
                check(False, f"ple_fused_infer {name} block_rows={rows} ran past shared memory")
            got = unwritten_nan(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.ple_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"ple_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    log(f"  ple_fused_infer block_rows {PLE_TOO_WIDE} (at 2 levels {PLE_TWO_LEVELS_TOO_WIDE}): "
        f"raise, naming the shared memory")
    # int64 ids as they are, modulo 2^32 as int32, then clipped
    (emb, did), args = cases["d_domain_oob_b4096"]
    check(torch.equal(k.ple_fused_infer(emb, did, *args),
                      k.ple_fused_infer(emb, did.to(torch.int32), *args))
          and torch.equal(k.ple_fused_infer(emb, did + 2**32, *args),
                          k.ple_fused_infer(emb, did, *args)),
          "ple_fused_infer: int64 ids differ from the same ids as int32")
    two_ids = cases["e_two_levels_b4096"][0][1]
    two_ms = time_ms(lambda: k.ple_fused_infer(emb4096, two_ids, *two))
    flops, _ = ple_work(emb4096, two_ids, *two)
    log(f"  ple_fused_infer e_two_levels_b4096: kernel {two_ms:.4f} ms, {flops / 1e9:.3f} GFLOP, "
        f"{flops / two_ms / 1e9:.2f} TFLOP/s achieved")
    fits = tuple(r for r in PLE_BLOCK_ROWS if r not in PLE_TOO_WIDE)
    entry = time_entry("ple_fused_infer", "ple", k.ple_fused_infer, k.ple_fused_infer_ref,
                       *cases["a_alicpp_b4096"], ple_work, peak, err, sweep_rows=fits)
    entry["two_levels_ms"] = two_ms
    # the design's own bound: every product as three TF32 products on the
    # tensor cores, the mixes, the softmaxes and the head in f32
    inputs, args = cases["a_alicpp_b4096"]
    tc = 2.0 * inputs[0].shape[0] * ple_product_macs(args[0], args[1])
    entry.update(design_bound("ple_fused_infer ", *ple_work(*inputs, *args), tc, peak,
                              entry["ms"]))
    for name in ("e_two_levels_b4096", "h_kuairand_b4096", "i_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"ple_fused_infer {name}, step 0",
                            lambda: k.ple_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    inputs, args = cases["e_two_levels_b4096"]
    tc = 2.0 * inputs[0].shape[0] * ple_product_macs(args[0], args[1])
    design_bound("ple_fused_infer e_two_levels_b4096 ", *ple_work(*inputs, *args), tc, peak,
                 entry["e_two_levels_b4096_device_ms"])
    entries["ple"] = entry
    return entries


def sarnet_work(emb, did, dom_w, dom_b, shared, spec, gate, final, head):
    """(FLOPs, bytes): the scale and shift (2 per element), the shared
    experts, the row's own specific experts, the gate, the mixture and the
    final MLP (2 per multiply-add)."""
    B, F = emb.shape
    n_sh, n_sp, H = shared[0].shape[0], spec[0].shape[1], shared[0].shape[-1]
    per_row = 2.0 * F + 2.0 * ((n_sh + n_sp) * F * H + macs([gate]) + (n_sh + n_sp) * H
                               + macs(final) + macs([head]))
    return B * per_row, nbytes(emb, did, dom_w, dom_b, *flat(shared, spec, gate, final,
                                                             head)) + B * 4


def sarnet_product_macs(emb, did, dom_w, dom_b, shared, spec, gate, final, head):
    """Multiply-adds per row of sarnet_work's products (the shared experts,
    the row's own specific ones, the gate, the final MLP): what the kernel
    runs on the tensor cores."""
    F = emb.shape[1]
    n_sh, n_sp, H = shared[0].shape[0], spec[0].shape[1], shared[0].shape[-1]
    return (n_sh + n_sp) * F * H + macs([gate]) + macs(final)


def epnet_work(sce, agn, l1, l2, head, gemma):
    """(FLOPs, bytes): the gate's two layers and the head (2 per
    multiply-add), and the gating (2 per agnostic element)."""
    B, A = agn.shape
    per_row = 2.0 * macs([l1, l2, head]) + 2.0 * A
    return B * per_row, nbytes(sce, agn, *flat(l1, l2, head)) + B * 4


def ppnet_work(g, did, layers, g1s, g2s, final, gemma):
    """(FLOPs, bytes): the row's own tower: each layer, its gate's two
    layers (2 per multiply-add) and the gating (2 per element); the final
    stage."""
    B = g.shape[0]
    per_row = 2.0 * (macs(layers) + macs(g1s) + macs(g2s) + macs([final]))
    per_row += 2.0 * sum(w.shape[-1] for w, _ in layers)
    return B * per_row, nbytes(g, did, *flat(layers, g1s, g2s, final)) + B * 4


def adasparse_work(sce, agn, pruners, layers, final, form, eps, beta):
    """(FLOPs, bytes): every pruner and layer and the head (2 per
    multiply-add), and each pruned element (2 for its factor and product)."""
    B = sce.shape[0]
    per_row = 2.0 * (sum(p.shape[0] * p.shape[1] for p in pruners) + macs(layers)
                     + macs([final])) + 2.0 * sum(p.shape[1] for p in pruners)
    return B * per_row, nbytes(sce, agn, *pruners, *flat(layers, final)) + B * 4


def adasparse_both_signs(gen, B, S, A, dims):
    """Pruner inputs that are exact integers, -S/2 .. S/2: sce of +-1, the
    pruners' sce rows +-0.5 and their other rows 0. Every sum is exact in
    any order, far from every threshold, and a few percent of the factors
    are negative (v <= -5 for Binarization, v <= -6 for the others)."""
    sign = lambda *shape: torch.randint(0, 2, shape, generator=gen, device="cuda") * 2.0 - 1.0
    pw = [torch.cat([0.5 * sign(S, h), torch.zeros(h, h, device="cuda")]) for h in [A] + dims]
    lay = affines(gen, (), [S + A] + dims)
    return (sign(B, S), torch.randn(B, A, generator=gen, device="cuda")), \
        (pw, lay, affines(gen, (), [dims[-1] if dims else S + A, 1])[0])


def phase_gated_kernels(gen, peak):
    """``sarnet_fused_infer``, ``epnet_fused_infer``, ``ppnet_fused_infer``
    and ``adasparse_fused_infer`` against their plain versions at every
    case, then timed at their model's Ali-CCP shape."""
    from scenario_wise_rec_tpu_torch.ops import kernels as k

    D = DOMAINS
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    ids = lambda B, d=D: torch.randint(0, d, (B,), generator=gen, device="cuda")
    oob = torch.tensor([-1, D, D + 5, 0, 1, 2], device="cuda")
    entries = {}

    def shaped(F, args_ali, args_narrow, F_narrow=42, domains=True):
        """The cases (a)-(d) with the kernel's inputs: one [B, F] tensor
        and the domain ids, or (domains=False) sce [B, 16] and agn [B, F]."""
        def inputs(B, Fi, d=D):
            return (randn(B, Fi), ids(B, d)) if domains else (randn(B, 16), randn(B, Fi))
        a = inputs(4096, F)
        cases = {"a_alicpp_b4096": (a, args_ali),
                 "b_ragged_b4095": (inputs(4095, F), args_ali),
                 "b_ragged_b1": (inputs(1, F), args_ali),
                 "c_narrow_b1000": (inputs(1000, F_narrow, 2), args_narrow)}
        if domains:  # EPNet and AdaSparse have no domain ids
            cases["d_domain_oob_b4096"] = ((a[0], oob[ids(4096, len(oob))]), args_ali)
        return cases

    # SAR-Net: default loader, F = 23 x 16; 8 shared + 2 specific experts
    # of width 16, gate 368 -> 10, final [32, 32] and head
    def sarnet_args(F, Dn, n_sh, n_sp, final, g=gen):
        return (2 * torch.rand(Dn, F, generator=g, device="cuda") - 1,
                torch.rand(Dn, F, generator=g, device="cuda"),
                affines(g, (n_sh,), [F, 16])[0], affines(g, (Dn, n_sp), [F, 16])[0],
                affines(g, (), [F, n_sh + n_sp])[0], affines(g, (), [16] + final),
                affines(g, (), [final[-1] if final else 16, 1])[0])

    F = N_SPARSE * 16
    ali = sarnet_args(F, D, 8, 2, [32, 32])
    cases = shaped(F, ali, sarnet_args(42, 2, 3, 1, [8]))
    # the partition by domain at its edges, KuaiRand's widths and B 65,536,
    # from a generator of its own: the shared one feeds every later phase's data
    sg = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 13)
    s_counted, s_rows = partial(counted, sg), partial(rows_of, sg)
    cases["e_skewed_b4096"] = ((s_rows(4096, F), s_counted(3700, 300, 96)), ali)  # 90 % in one
    cases["f_one_domain_b4096"] = ((s_rows(4096, F), s_counted(0, 4096, 0)), ali)
    # 33 / 32 / 1 rows: a tile and one row, a whole tile, one row (32-row tiles)
    cases["g_counts_astride_tiles_b66"] = ((s_rows(66, F), s_counted(33, 32, 1)), ali)
    # KuaiRand's SAR-Net: its 796 sparse columns, 5 domains
    cases["h_kuairand_b4096"] = (
        (s_rows(4096, 796), torch.randint(0, 5, (4096,), generator=sg, device="cuda")),
        sarnet_args(796, 5, 8, 2, [32, 32], g=sg))
    cases["i_b65536"] = (
        (s_rows(65_536, F), torch.randint(0, D, (65_536,), generator=sg, device="cuda")), ali)
    unwritten_nan = nan_filled(k.sarnet_fused_infer)
    err = run_cases("sarnet_fused_infer", unwritten_nan, k.sarnet_fused_infer_ref, cases)
    for rows in SARNET_BLOCK_ROWS:  # every tile: Ali-CCP, the partition's edges, KuaiRand
        for name in ("a_alicpp_b4096", "e_skewed_b4096", "f_one_domain_b4096",
                     "g_counts_astride_tiles_b66", "h_kuairand_b4096"):
            inputs, args = cases[name]
            if rows in SARNET_KUAIRAND_TOO_WIDE and name.startswith("h_kuairand"):
                try:
                    k.sarnet_fused_infer(*inputs, *args, block_rows=rows)
                except RuntimeError as e:
                    check("shared memory" in str(e), f"sarnet_fused_infer block_rows={rows}: {e}")
                    continue
                check(False, f"sarnet_fused_infer {name} block_rows={rows} ran past shared memory")
            got = unwritten_nan(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.sarnet_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"sarnet_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    log(f"  sarnet_fused_infer every tile {SARNET_BLOCK_ROWS} at Ali-CCP's widths holds; "
        f"{SARNET_KUAIRAND_TOO_WIDE} at KuaiRand's raise, naming the shared memory")
    # int64 ids as they are, modulo 2^32 as int32, then clipped; a NaN stays in
    # its row; one launch a call on SAR-Net's counter and on no other
    (emb, did), args = cases["d_domain_oob_b4096"]
    check(torch.equal(k.sarnet_fused_infer(emb, did, *args),
                      k.sarnet_fused_infer(emb, did.to(torch.int32), *args))
          and torch.equal(k.sarnet_fused_infer(emb, did + 2**32, *args),
                          k.sarnet_fused_infer(emb, did, *args)),
          "sarnet_fused_infer: int64 ids differ from the same ids as int32")
    (emb, did), args = cases["a_alicpp_b4096"]
    bad = emb.clone()
    bad[50, 7] = float("nan")
    before = read_counts()
    got, want = k.sarnet_fused_infer(bad, did, *args), k.sarnet_fused_infer_ref(bad, did, *args)
    delta = {n: c - before[n] for n, c in read_counts().items() if c != before[n]}
    nan = torch.isnan(got)
    check(nan.nonzero().flatten().tolist() == [50] and bool(torch.isnan(want[50]))
          and kernel_gap(got[~nan], want[~nan], None) <= TOL,
          "sarnet_fused_infer: a NaN left its row")
    check(delta == {"sarnet_fused_infer": 1},
          f"sarnet_fused_infer: 1 call moved the counts by {delta}")
    fits = tuple(r for r in SARNET_BLOCK_ROWS if r is not None)
    entry = time_entry("sarnet_fused_infer", "sarnet", k.sarnet_fused_infer,
                       k.sarnet_fused_infer_ref, *cases["a_alicpp_b4096"], sarnet_work, peak,
                       err, sweep_rows=fits)
    # the design's own bound: the experts, the gate and the final MLP as three
    # TF32 products on the tensor cores; the scale and shift, the softmax,
    # the mix and the 1-wide head in f32
    inputs, args = cases["a_alicpp_b4096"]
    tc = 2.0 * inputs[0].shape[0] * sarnet_product_macs(*inputs, *args)
    entry.update(design_bound("sarnet_fused_infer ", *sarnet_work(*inputs, *args), tc, peak,
                              entry["ms"]))
    for name in ("h_kuairand_b4096", "i_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"sarnet_fused_infer {name}, step 0",
                            lambda: k.sarnet_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["sarnet"] = entry

    # EPNet: scenario loader, S = 16, A = 22 x 16 + 8 = 360; gate 376 -> 360
    # -> 360, head 360 -> 1 (AdaSparse's kernel on a list of two steps)
    def epnet_args(A, H, S=16, g=gen):
        return (*affines(g, (), [S + A, H]), *affines(g, (), [H, A]),
                affines(g, (), [A, 1])[0], 2.0)

    A = (N_SPARSE - 1) * 16 + N_DENSE
    ali = epnet_args(A, A)
    cases = shaped(A, ali, epnet_args(42, 24), domains=False)
    # the cases past (a)-(c), from a generator of their own: the shared one
    # feeds every later phase's data
    eg = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 10)
    e_rows = partial(rows_of, eg)
    # KuaiRand's EPNet: its scenario loader gives sce the scenario feature
    # (16) and agn the sparse and dense features, MMOE's KuaiRand F 800
    cases["d_kuairand_b4096"] = ((e_rows(4096, 16), e_rows(4096, 800)),
                                 epnet_args(800, 800, g=eg))
    cases["e_b65536"] = ((e_rows(65_536, 16), e_rows(65_536, A)), ali)
    cases["f_widths_off_8_b333"] = ((e_rows(333, 5), e_rows(333, 41)),
                                    epnet_args(41, 7, S=5, g=eg))
    unwritten_nan = nan_filled(k.epnet_fused_infer)
    err = run_cases("epnet_fused_infer", unwritten_nan, k.epnet_fused_infer_ref, cases)
    for rows in EPNET_BLOCK_ROWS:  # every tile: Ali-CCP, ragged, narrow, KuaiRand, off 8
        for name in ("a_alicpp_b4096", "b_ragged_b4095", "c_narrow_b1000", "d_kuairand_b4096",
                     "f_widths_off_8_b333"):
            inputs, args = cases[name]
            if rows in EPNET_KUAIRAND_TOO_WIDE and name.startswith("d_kuairand"):
                try:
                    k.epnet_fused_infer(*inputs, *args, block_rows=rows)
                except RuntimeError as e:
                    check("shared memory" in str(e), f"epnet_fused_infer block_rows={rows}: {e}")
                    continue
                check(False, f"epnet_fused_infer {name} block_rows={rows} ran past shared memory")
            got = unwritten_nan(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.epnet_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"epnet_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    log(f"  epnet_fused_infer every tile {EPNET_BLOCK_ROWS} at Ali-CCP's widths holds; "
        f"{EPNET_KUAIRAND_TOO_WIDE} at KuaiRand's raise, naming the shared memory")
    # a NaN stays in its row; one launch a call on EPNet's counter, none on
    # AdaSparse's, whose kernel it runs
    (sce, agn), args = cases["a_alicpp_b4096"]
    bad = agn.clone()
    bad[50, 7] = float("nan")
    before = read_counts()
    got, want = k.epnet_fused_infer(sce, bad, *args), k.epnet_fused_infer_ref(sce, bad, *args)
    delta = {n: c - before[n] for n, c in read_counts().items() if c != before[n]}
    nan = torch.isnan(got)
    check(nan.nonzero().flatten().tolist() == [50] and bool(torch.isnan(want[50]))
          and kernel_gap(got[~nan], want[~nan], None) <= TOL,
          "epnet_fused_infer: a NaN left its row")
    check(delta == {"epnet_fused_infer": 1},
          f"epnet_fused_infer: 1 call moved the counts by {delta}")
    entry = time_entry("epnet_fused_infer", "epnet", k.epnet_fused_infer,
                       k.epnet_fused_infer_ref, *cases["a_alicpp_b4096"], epnet_work, peak, err,
                       sweep_rows=EPNET_BLOCK_ROWS)
    # the design's own bound: the gate's two products as three TF32 products
    # on the tensor cores, the gating and the head in f32
    inputs, args = cases["a_alicpp_b4096"]
    tc = 2.0 * inputs[0].shape[0] * macs(args[:2])
    entry.update(design_bound("epnet_fused_infer ", *epnet_work(*inputs, *args), tc, peak,
                              entry["ms"]))
    for name in ("d_kuairand_b4096", "e_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"epnet_fused_infer {name}, step 0",
                            lambda: k.epnet_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["epnet"] = entry

    # PPNet: ppnet loader, G = 2 x 16 ids + 20 x 16 + 8 + 16 = 376; towers
    # [256, 128, 64, 32, 16, 8] with a GateNU per layer, 3 domains
    def ppnet_args(G, Dn, dims, g=gen):
        return (affines(g, (Dn,), [G] + dims),
                [affines(g, (Dn,), [G, o])[0] for o in dims],
                [affines(g, (Dn,), [o, o])[0] for o in dims],
                affines(g, (Dn,), [dims[-1], 1])[0], 2.0)

    G = 2 * 16 + (N_SPARSE - 3) * 16 + N_DENSE + 16
    ali = ppnet_args(G, D, EXPERT_DIMS)
    cases = shaped(G, ali, ppnet_args(42, 2, [16, 8]))
    absent = torch.tensor([0, 2], device="cuda")[ids(4096, 2)]  # domain 1 absent
    cases["e_domain_1_absent_b4096"] = ((cases["a_alicpp_b4096"][0][0], absent), ali)
    # the partition by domain at its edges, from a generator of its own: the
    # shared one feeds every later phase's data
    pg = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 4)

    p_counted, g_rows = partial(counted, pg), partial(rows_of, pg)
    cases["f_one_domain_b4096"] = ((g_rows(4096, G), p_counted(0, 4096, 0)), ali)
    # 33 / 32 / 1 rows: a tile and one row, a whole tile, one row (32-row tiles)
    cases["g_counts_astride_tiles_b66"] = ((g_rows(66, G), p_counted(33, 32, 1)), ali)
    # KuaiRand's PPNet ladder ([128, 64, 32], 5 domains): G = 832, MMOE's F 800
    # less user_id and video_id moved to the ids (2 x 16), plus the scenario
    # feature as a sparse feature and as itself (2 x 16)
    kuairand = ppnet_args(832, 5, [128, 64, 32], g=pg)
    cases["h_kuairand_b4096"] = (
        (g_rows(4096, 832), torch.randint(0, 5, (4096,), generator=pg, device="cuda")), kuairand)
    cases["i_b65536"] = (
        (g_rows(65_536, G), torch.randint(0, D, (65_536,), generator=pg, device="cuda")), ali)

    unwritten_nan = nan_filled(k.ppnet_fused_infer)
    err = run_cases("ppnet_fused_infer", unwritten_nan, k.ppnet_fused_infer_ref, cases)
    for rows in PPNET_BLOCK_ROWS:  # every tile at the edges of the partition too
        for name in ("f_one_domain_b4096", "g_counts_astride_tiles_b66"):
            inputs, args = cases[name]
            got = unwritten_nan(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.ppnet_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"ppnet_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    entry = time_entry("ppnet_fused_infer", "ppnet", k.ppnet_fused_infer,
                       k.ppnet_fused_infer_ref, *cases["a_alicpp_b4096"], ppnet_work, peak, err,
                       sweep_rows=PPNET_BLOCK_ROWS)
    # the design's own bound: every product as three TF32 products on the
    # tensor cores, the gating and the final in f32
    inputs, args = cases["a_alicpp_b4096"]
    tc = 2.0 * inputs[0].shape[0] * macs(args[0] + args[1] + args[2])
    entry.update(design_bound("ppnet_fused_infer ", *ppnet_work(*inputs, *args), tc, peak,
                              entry["ms"]))
    for name in ("h_kuairand_b4096", "i_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"ppnet_fused_infer {name}, step 0",
                            lambda: k.ppnet_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["ppnet"] = entry

    # AdaSparse: scenario loader, S = 16, A = 22 x 16 = 352; layers [256,
    # ..., 8], a pruner on [sce ‖ agn] and after each layer. Pruner weights at
    # 0.6 x a Linear's scale, times alpha = 1.37 folded: the pruner inputs have
    # a std near 0.6, and eps = 1e-2 lies 7 of them below 0, so rows near the
    # threshold stay rare; the negative factors are case (e)'s work.
    def adasparse_args(S, A, dims, form, alpha=1.37, g=gen):
        pw = [0.6 * alpha * (S + h) ** -0.5 * torch.randn(S + h, h, generator=g, device="cuda")
              for h in [A] + dims]
        return (pw, affines(g, (), [S + A] + dims),
                affines(g, (), [dims[-1] if dims else S + A, 1])[0], form, 1e-2, 2.0)

    # the cases past (a)-(e), from a generator of their own: the shared one
    # feeds every later phase's data
    ag = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 6)

    def sce_agn(B, S, Ai):
        return (torch.randn(B, S, generator=ag, device="cuda"),
                torch.randn(B, Ai, generator=ag, device="cuda"))

    # KuaiRand's AdaSparse ladder ([128, 64, 32]): its scenario loader gives
    # sce the scenario feature (16) and agn the sparse features only, MMOE's
    # KuaiRand F 800 less its 4 dense columns: A = 796
    A, A_kr = (N_SPARSE - 1) * 16, 796
    err = 0.0
    for form in ("Binarization", "Scaling", "Fusion"):
        ali = adasparse_args(16, A, EXPERT_DIMS, form)
        cases = shaped(A, ali, adasparse_args(16, 42, [16, 8], form, alpha=1.0), domains=False)
        inputs, args = adasparse_both_signs(gen, 4096, 16, A, EXPERT_DIMS)
        cases["e_both_signs_b4096"] = (inputs, args + (form, 1e-2, 2.0))
        v0 = inputs[0] @ args[0][0][:16]
        check(bool((v0 <= (-5 if form == "Binarization" else -6)).any()),
              "case e has no negative pruner factor")
        cases["f_no_layers_b4096"] = (sce_agn(4096, 16, A),
                                      adasparse_args(16, A, [], form, g=ag))
        cases["g_kuairand_b4096"] = (sce_agn(4096, 16, A_kr),
                                     adasparse_args(16, A_kr, [128, 64, 32], form, g=ag))
        cases["h_b65536"] = (sce_agn(65_536, 16, A), ali)
        cases["i_widths_off_8_b333"] = (sce_agn(333, 5, 41),
                                        adasparse_args(5, 41, [7, 3], form, alpha=1.0, g=ag))
        label = f"adasparse_fused_infer {form}"
        kernel = nan_filled(k.adasparse_fused_infer)
        err = max(err, run_cases(label, kernel, k.adasparse_fused_infer_ref, cases,
                                 margin_fn=k.adasparse_threshold_margin))
        for rows in ADASPARSE_BLOCK_ROWS:  # every tile at Ali-CCP, narrow and without layers
            for name in ("a_alicpp_b4096", "c_narrow_b1000", "f_no_layers_b4096"):
                inputs, args = cases[name]
                got = kernel(*inputs, *args, block_rows=rows)
                near = near_threshold(k.adasparse_threshold_margin, inputs, args)
                gap = kernel_gap(got, k.adasparse_fused_infer_ref(*inputs, *args), near)
                log(f"  {label} {name} block_rows={rows}: max_abs_err {gap:.3e}, "
                    f"{int(near.sum())} of {len(got)} rows at the threshold")
                check(bool(torch.isfinite(got).all()) and gap <= TOL
                      and int(near.sum()) <= THRESHOLD_ROWS * len(got),
                      f"{label} {name} block_rows={rows}: {gap}")
                err = max(err, gap)
    # the tile rule at KuaiRand's widths: the kernel's choice (16) fits, the
    # widest tiles raise naming the shared memory
    inputs, args = cases["g_kuairand_b4096"]
    for rows in ADASPARSE_KUAIRAND_TOO_WIDE:
        try:
            k.adasparse_fused_infer(*inputs, *args, block_rows=rows)
        except RuntimeError as e:
            check("shared memory" in str(e), f"adasparse_fused_infer block_rows={rows}: {e}")
        else:
            check(False, f"adasparse_fused_infer block_rows={rows} at KuaiRand did not raise")
    log(f"  adasparse_fused_infer block_rows {ADASPARSE_KUAIRAND_TOO_WIDE} at KuaiRand: raise, "
        f"naming the shared memory")
    # timed in the Fusion form (the loop's last), the Ali-CCP ladder's
    entry = time_entry(
        "adasparse_fused_infer Fusion", "adasparse", k.adasparse_fused_infer,
        k.adasparse_fused_infer_ref, *cases["a_alicpp_b4096"], adasparse_work, peak, err,
        margin_fn=k.adasparse_threshold_margin, sweep_rows=ADASPARSE_BLOCK_ROWS)
    # the design's own bound: every pruner and layer as three TF32 products
    # on the tensor cores, the pruning and the head in f32
    inputs, args = cases["a_alicpp_b4096"]
    tc = 2.0 * inputs[0].shape[0] * (sum(w.shape[0] * w.shape[1] for w in args[0])
                                     + macs(args[1]))
    entry.update(design_bound("adasparse_fused_infer ", *adasparse_work(*inputs, *args), tc,
                              peak, entry["ms"]))
    for name in ("g_kuairand_b4096", "h_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"adasparse_fused_infer {name}, step 0",
                            lambda: k.adasparse_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["adasparse"] = entry
    return entries


def hamur_adapter(gen, w, k, mid=32):
    """An adapter's weights: u/v from 0.1 N(0, 1), as the JAX package's
    tests draw them (at the model's all-ones init the sigmoid saturates and
    the norm divides near-zero variances), the rest random too."""
    shapes = {"u_down": (w, k), "v_down": (k, mid), "b_down": (mid,), "u_up": (mid, k),
              "v_up": (k, w), "b_up": (w,)}
    a = {n: 0.1 * torch.randn(*s, generator=gen, device="cuda") for n, s in shapes.items()}
    a["gamma"] = 0.5 + torch.rand(w, generator=gen, device="cuda")
    a["beta"] = 0.1 * torch.randn(w, generator=gen, device="cuda")
    return a


def hamur_args(gen, F, D, seg_dims, hyper_dims, k, w=None):
    """``hamur_fused_infer``'s arguments after ``(emb, domain_id)``: the
    hyper-network's stages, k, each segment's block stages, an adapter after
    every segment but the last, the final stage, eps and the mask ``w``."""
    hyper = affines(gen, (), [F] + hyper_dims + [k * k])
    segments, adapters, width = [], [], F
    for j, dims in enumerate(seg_dims):
        segments.append(affines(gen, (D,), [width] + dims))
        width = dims[-1] if dims else width
        if j < len(seg_dims) - 1:
            adapters.append(hamur_adapter(gen, width, k))
    return hyper, k, segments, adapters, affines(gen, (D,), [width, 1])[0], 1e-5, w


def hamur_segment_inputs(emb, did, hyper_stages, k, segments, adapters, final, eps, w):
    """Every segment's inputs, from the plain chain: ``[(x, stages, kwargs)]``."""
    from scenario_wise_rec_tpu_torch.ops import kernels as k_

    hyper = k_.hamur_hyper(emb, hyper_stages, k)
    out, x, t_pre, dn = [], emb, None, None
    for seg, a in zip(segments, adapters):
        kw = dict(hyper=hyper, adapter=a, dn_affine=dn, t_pre=t_pre)
        out.append((x, seg, kw))
        t_pre, x = k_.hamur_segment_ref(x, seg, **kw)
        dn = k_.adapter_norm_affine(t_pre, a["gamma"], a["beta"], eps, w)
    out.append((x, segments[-1], dict(dn_affine=dn, t_pre=t_pre, final=final, domain_id=did)))
    return out


def segment_work(x, stages, hyper=None, adapter=None, dn_affine=None, t_pre=None, final=None,
                 domain_id=None):
    """(FLOPs, bytes, tensor-core FLOPs) of one segment launch: 2 per
    multiply-add of every domain's blocks and adapter (the final form: the
    row's own domain's blocks and head), 4 per input element of the norm
    affine and residual; each input read once (H too), each output written
    once. The kernel runs the first and middle forms' blocks on the tensor
    cores (the third number, 3xTF32: three products each)."""
    B, F = x.shape[0], x.shape[-1]
    D = x.shape[1] if x.ndim == 3 else (stages[0][0].shape[0] if stages else final[0].shape[0])
    tensors = [x, *flat(stages)] + [t for t in (t_pre, hyper, domain_id, *(dn_affine or ()))
                                    if t is not None]
    if final is not None:
        per_row = 2.0 * (macs(stages) + macs([final])) + (4.0 * F if x.ndim == 3 else 0.0)
        return B * per_row, nbytes(*tensors, *final) + B * 4, 0.0
    w_out = stages[-1][0].shape[-1] if stages else F
    k, mid = adapter["u_down"].shape[1], adapter["v_down"].shape[1]
    ad_macs = w_out * k + k * k + k * mid + mid * k + k * k + k * w_out
    per_row = D * (2.0 * (macs(stages) + ad_macs) + (4.0 * F if x.ndim == 3 else 0.0))
    ad = [adapter[n] for n in ("u_down", "v_down", "b_down", "u_up", "v_up", "b_up")]
    return (B * per_row, nbytes(*tensors, *ad) + 2.0 * B * D * w_out * 4,
            2.0 * B * D * macs(stages))


def phase_hamur_kernels(gen, peak):
    """``hamur_segment`` (each form alone) and ``hamur_fused_infer`` (the
    chain), and ``adaptdhm_fused_infer``, against their plain versions at
    every case, then timed at their model's Ali-CCP shape."""
    from scenario_wise_rec_tpu_torch.ops import kernels as k

    D, F = DOMAINS, N_SPARSE * 16 + N_DENSE
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    ids = lambda B, d=D: torch.randint(0, d, (B,), generator=gen, device="cuda")
    oob = torch.tensor([-1, D, D + 5, 0, 1, 2], device="cuda")
    large_dims = [[256, 128, 64, 64, 32, 16], [8], []]
    emb4096 = randn(4096, F)
    large = hamur_args(gen, F, D, large_dims, [64], 65)
    small = hamur_args(gen, F, D, [[256, 128], []], [64], 35)
    real = 3000  # padded past row 3000 with copies of row 0 and weight 0
    padded = torch.cat([emb4096[:real], emb4096[:1].expand(4096 - real, F)]).contiguous()
    w = torch.cat([torch.ones(real, device="cuda"), torch.zeros(4096 - real, device="cuda")])
    pad_ids = ids(4096)
    cases = {"a_alicpp_large_b4096": ((emb4096, ids(4096)), large),
             "b_small_b4096": ((emb4096, ids(4096)), small),
             "c_ragged_b4095": ((randn(4095, F), ids(4095)), large),
             "c_ragged_b1": ((randn(1, F), ids(1)), large),
             "d_padded_rows_b4096": ((padded, pad_ids), large[:-1] + (w,)),
             "e_domain_oob_b4096": ((emb4096, oob[ids(4096, len(oob))]), large)}
    # HamurSmall at KuaiRand's width (F = 800, 5 domains, k = 35), from a
    # generator of its own: the shared one feeds every later phase's data
    kr = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 3)
    cases["f_kuairand_small_b4096"] = (
        (torch.randn(4096, 800, generator=kr, device="cuda"),
         torch.randint(0, 5, (4096,), generator=kr, device="cuda")),
        hamur_args(kr, 800, 5, [[256, 128], []], [64], 35))
    seg_err = 0.0
    for name, (inputs, args) in cases.items():
        errs = []
        for x, stages, kw in hamur_segment_inputs(*inputs, *args):
            got = k.hamur_segment(x, stages, **kw)
            torch.cuda.synchronize()
            want = k.hamur_segment_ref(x, stages, **kw)
            if kw.get("final") is None:
                got, want = torch.stack(got), torch.stack(want)
            check(bool(torch.isfinite(got).all()), f"hamur_segment {name}: not finite")
            errs.append(((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item())
        log(f"  hamur_segment {name}: each form alone, max_abs_err / scale "
            + ", ".join(f"{e:.3e}" for e in errs))
        check(max(errs) <= TOL, f"hamur_segment {name}: a segment disagrees with plain")
        seg_err = max(seg_err, *errs)
    err = run_cases("hamur_fused_infer", k.hamur_fused_infer, k.hamur_fused_infer_ref, cases)
    unpadded = k.hamur_fused_infer_ref(emb4096[:real].contiguous(), pad_ids[:real],
                                       *large[:-1], None)
    pad_err = (k.hamur_fused_infer(padded, pad_ids, *large[:-1], w)[:real]
               - unpadded).abs().max().item()
    log(f"  hamur_fused_infer d_padded_rows_b4096: real rows vs the unpadded batch, "
        f"max_abs_err {pad_err:.3e}")
    check(pad_err <= TOL, "HAMUR's padded rows move its real rows")

    # times at HamurLarge's Ali-CCP shape: the three launches of one batch,
    # each block_rows of the sweep held against the plain segments first
    inputs, args = cases["a_alicpp_large_b4096"]
    segs = hamur_segment_inputs(*inputs, *args)
    wants = [k.hamur_segment_ref(x, st, **kw) for x, st, kw in segs]
    run = lambda rows: [k.hamur_segment(x, st, block_rows=rows, **kw) for x, st, kw in segs]
    sweep, sweep_device = {}, {}
    log("  hamur_segment x3 a_alicpp_large_b4096 block_rows sweep: back to back, then step 0:")
    for rows in HAMUR_BLOCK_ROWS:
        for got, want in zip(run(rows), wants):
            got, want = (torch.stack(got), torch.stack(want)) if isinstance(got, tuple) else (got, want)
            gap = ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()
            check(gap <= TOL, f"hamur_segment block_rows={rows} disagrees ({gap})")
        sweep[rows] = time_ms(lambda: run(rows))
        sweep_device[rows] = wrapper_cost(
            f"hamur_segment x3 block_rows={rows} (back to back {sweep[rows]:.4f} ms)",
            lambda: run(rows))["device_ms"]
    seg_ms = [time_ms(lambda: k.hamur_segment(x, st, **kw)) for x, st, kw in segs]
    seg_plain = [time_ms(lambda: k.hamur_segment_ref(x, st, **kw)) for x, st, kw in segs]
    seg_device = [wrapper_cost(f"hamur_segment segment {i + 1} a_alicpp_large_b4096, step 0",
                               lambda: k.hamur_segment(x, st, **kw))["device_ms"]
                  for i, (x, st, kw) in enumerate(segs)]
    chain_ms = time_ms(lambda: k.hamur_fused_infer(*inputs, *args))
    chain_plain_ms = time_ms(lambda: k.hamur_fused_infer_ref(*inputs, *args))
    hyper_ms = time_ms(lambda: k.hamur_hyper(inputs[0], args[0], args[1]))
    cost = wrapper_cost("hamur_segment x3 a_alicpp_large_b4096, step 0",
                        lambda: [k.hamur_segment(x, st, **kw) for x, st, kw in segs])
    works = [segment_work(x, st, **kw) for x, st, kw in segs]
    flops, moved = sum(f for f, _, _ in works), sum(b for _, b, _ in works)
    # the design's own: three TF32 products a multiply-add of the first and
    # middle forms' blocks on the tensor cores, the rest in f32
    bounds = design_bound("", flops, moved, sum(t for _, _, t in works), peak)
    bound, f32_bound, kernel_ms = bounds["bound_ms"], bounds["f32_simt_bound_ms"], cost["device_ms"]
    log(f"  hamur_segment a_alicpp_large_b4096: segments, step 0 device "
        f"{', '.join(f'{t:.4f}' for t in seg_device)} ms (back to back "
        f"{', '.join(f'{t:.4f}' for t in seg_ms)}; plain {', '.join(f'{t:.4f}' for t in seg_plain)}"
        f"); 3 launches device {kernel_ms:.4f} ms, host {cost['host_us']:.1f} us (back to back "
        f"{sum(seg_ms):.4f}), plain {sum(seg_plain):.4f} ms, {flops / 1e9:.3f} GFLOP, "
        f"{moved / 1e6:.2f} MB, bound {bound:.4f} ms "
        f"({bounds['bound_by']}), "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s achieved ({100 * bound / kernel_ms:.1f}% of "
        f"bound, {100 * f32_bound / kernel_ms:.1f}% of the f32 one); whole hamur_fused_infer "
        f"{chain_ms:.4f} ms (plain {chain_plain_ms:.4f} ms; the hyper-network's two products "
        f"alone {hyper_ms:.4f} ms)")
    fn, source, replaces = EVAL_KERNELS["hamur"]
    entries = {"hamur": {
        "name": fn, "route": "cuda", "source": f"scenario_wise_rec_tpu_torch/csrc/{source}.cu",
        "replaces": replaces, "max_abs_err": max(err, pad_err), "segment_err_over_scale": seg_err,
        "ms": kernel_ms, "back_to_back_ms": sum(seg_ms), "host_us": cost["host_us"],
        "launches_per_call": cost["launches_per_call"], "plain_ms": sum(seg_plain),
        **bounds, "library_ms": None,
        "segment_ms": seg_device, "segment_back_to_back_ms": seg_ms,
        "segment_plain_ms": seg_plain, "chain_ms": chain_ms,
        "chain_plain_ms": chain_plain_ms, "hyper_ms": hyper_ms,
        "block_rows_sweep_ms": sweep, "block_rows_sweep_device_ms": sweep_device}}

    # AdaptDHM: scenario loader, F = 22 x 16 + 16 = 368; [256,...,8,1], 3 clusters
    def adaptdhm_args(Fi, C, dims):
        return ([w_ for w_, _ in affines(gen, (C,), [Fi] + dims + [1])],)

    def adaptdhm_work(emb, rid, stages):
        B = emb.shape[0]
        per_row = sum(w_.shape[1] * w_.shape[2] for w_ in stages)  # the own cluster's
        return 2.0 * B * per_row, nbytes(emb, rid, *stages) + B * 4

    Fa = (N_SPARSE - 1) * 16 + 16
    ali = adaptdhm_args(Fa, D, EXPERT_DIMS)
    emb_a = randn(4096, Fa)
    cases = {"a_alicpp_b4096": ((emb_a, ids(4096)), ali),
             "b_ragged_b4095": ((randn(4095, Fa), ids(4095)), ali),
             "b_ragged_b1": ((randn(1, Fa), ids(1)), ali),
             "c_narrow_b1000": ((randn(1000, 42), ids(1000, 2)), adaptdhm_args(42, 2, [16, 8])),
             "d_router_oob_b4096": ((emb_a, oob[ids(4096, len(oob))]), ali),
             "e_cluster_1_absent_b4096": (
                 (emb_a, torch.tensor([0, 2], device="cuda")[ids(4096, 2)]), ali)}
    # the partition by cluster at its edges, KuaiRand's ladder and B 65,536,
    # from a generator of its own: the shared one feeds every later phase's
    # data
    ag = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 9)
    a_counted, a_rows = partial(counted, ag), partial(rows_of, ag)
    cases["f_skewed_b4096"] = ((a_rows(4096, Fa), a_counted(3700, 300, 96)), ali)  # 90 % in one
    # 33 / 32 / 1 rows: a tile and one row, a whole tile, one row (32-row tiles)
    cases["g_counts_astride_tiles_b66"] = ((a_rows(66, Fa), a_counted(33, 32, 1)), ali)
    # KuaiRand's AdaptDHM ([64, 64], 3 clusters) at its 796 sparse columns
    # and the scenario feature's 16
    cases["h_kuairand_b4096"] = (
        (a_rows(4096, 812), torch.randint(0, D, (4096,), generator=ag, device="cuda")),
        ([w_ for w_, _ in affines(ag, (D,), [812, 64, 64, 1])],))
    cases["i_b65536"] = (
        (a_rows(65_536, Fa), torch.randint(0, D, (65_536,), generator=ag, device="cuda")), ali)
    unwritten_nan = nan_filled(k.adaptdhm_fused_infer)
    err = run_cases("adaptdhm_fused_infer", unwritten_nan, k.adaptdhm_fused_infer_ref, cases)
    for rows in ADAPTDHM_BLOCK_ROWS:  # every tile: at the edges of the partition, the ladder
        for name in ("b_ragged_b4095", "e_cluster_1_absent_b4096", "f_skewed_b4096",
                     "g_counts_astride_tiles_b66", "h_kuairand_b4096"):
            inputs, args = cases[name]
            if rows in ADAPTDHM_KUAIRAND_TOO_WIDE and name.startswith("h_kuairand"):
                try:
                    k.adaptdhm_fused_infer(*inputs, *args, block_rows=rows)
                except RuntimeError as e:
                    check("shared memory" in str(e), f"adaptdhm_fused_infer block_rows={rows}: {e}")
                    continue
                check(False, f"adaptdhm_fused_infer {name} block_rows={rows} ran past shared memory")
            got = unwritten_nan(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.adaptdhm_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"adaptdhm_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    log(f"  adaptdhm_fused_infer every tile {ADAPTDHM_BLOCK_ROWS} at Ali-CCP's widths holds; "
        f"{ADAPTDHM_KUAIRAND_TOO_WIDE} at KuaiRand's raises, naming the shared memory")
    # int64 ids (argmax's) as they are, modulo 2^32 as int32, then clipped;
    # one launch a call on AdaptDHM's counter, none on SharedBottom's
    (emb, rid), args = cases["d_router_oob_b4096"]
    before = read_counts()
    same = (torch.equal(k.adaptdhm_fused_infer(emb, rid, *args),
                        k.adaptdhm_fused_infer(emb, rid.to(torch.int32), *args))
            and torch.equal(k.adaptdhm_fused_infer(emb, rid + 2**32, *args),
                            k.adaptdhm_fused_infer(emb, rid, *args)))
    delta = {n: c - before[n] for n, c in read_counts().items() if c != before[n]}
    check(same, "adaptdhm_fused_infer: int64 ids differ from the same ids as int32")
    check(delta == {"adaptdhm_fused_infer": 4},
          f"adaptdhm_fused_infer: 4 calls moved the counts by {delta}")
    entry = time_entry("adaptdhm_fused_infer", "adaptdhm", k.adaptdhm_fused_infer,
                       k.adaptdhm_fused_infer_ref, *cases["a_alicpp_b4096"], adaptdhm_work,
                       peak, err, sweep_rows=ADAPTDHM_BLOCK_ROWS)
    # the design's own bound: every product (the stages and the width-1 last
    # one) as three TF32 products on the tensor cores
    inputs, args = cases["a_alicpp_b4096"]
    flops, moved = adaptdhm_work(*inputs, *args)
    entry.update(design_bound("adaptdhm_fused_infer ", flops, moved, flops, peak, entry["ms"]))
    for name in ("h_kuairand_b4096", "i_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"adaptdhm_fused_infer {name}, step 0",
                            lambda: k.adaptdhm_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["adaptdhm"] = entry
    return entries


def m2m_work(t_out, dom, experts, task, scen, vw, vb, tw, tb, v, out, head, E):
    """(FLOPs, bytes): 2 per multiply-add of the experts, the hyper-MLPs,
    the meta product of each expert's [expert | task] with the row's own
    [2E, 2E] matrix and its score, the mix, the meta-tower and the output
    MLP and head; each input read once, the output written once."""
    B, nE = t_out.shape[0], experts[0][0].shape[0]
    per_row = (nE * macs(experts) + macs(task) + macs(scen) + macs(vw) + macs(vb) + macs(tw)
               + macs(tb) + nE * (4 * E * E + 2 * E) + nE * E + E * E + macs(out)
               + macs([head]))
    return 2.0 * B * per_row, nbytes(t_out, dom, v, *flat(experts, task, scen, vw, vb, tw, tb,
                                                          out, head)) + B * 4


def m2m_product_macs(experts, task, scen, vw, vb, tw, tb, v, out, head, E):
    """Multiply-adds a row of the products with shared weights, which the
    kernel runs on the tensor cores: every expert, the hyper-MLPs and the
    output MLP (the meta-attention, the mix, the meta-tower and the 1-wide
    head are f32 row passes)."""
    return (experts[0][0].shape[0] * macs(experts) + macs(task) + macs(scen) + macs(vw)
            + macs(vb) + macs(tw) + macs(tb) + macs(out))


def m3oe_work(emb, did, star, skip, star_mlp, gates, experts, dom_experts, towers, w_exp,
              w_bal):
    """(FLOPs, bytes): 2 per multiply-add of the skip, the row's own star
    slot, the star MLP, every shared and every domain expert (the balance
    mix sums them all), the own gate and tower; 5 per element a LayerNorm
    normalises (sum, centred square, scale, shift); 2 per element of the
    mixes. Each input read once, the output written once."""
    B, D, E = emb.shape[0], star[0].shape[0], experts[0][0].shape[0]
    mac = lambda layers: sum(l[0].shape[-2] * l[0].shape[-1] for l in layers)
    width = lambda layers: sum(l[0].shape[-1] for l in layers)
    H = experts[-1][0].shape[-1]
    per_row = 2.0 * (star[0].shape[1] * star[0].shape[2] + mac(skip) + mac(star_mlp)
                     + E * mac(experts) + D * mac(dom_experts) + mac([gates]) + mac([towers])
                     + mac([towers[4:]]))
    per_row += 5.0 * (width(skip) + width(star_mlp) + E * width(experts) + D * width(dom_experts)
                      + towers[0].shape[-1])
    per_row += 2.0 * H * (E + D + 2)
    return B * per_row, nbytes(emb, did, w_exp, w_bal, *flat(star, skip, star_mlp, gates,
                                                            experts, dom_experts, towers)) + B * 4


def m3oe_product_macs(star, skip, star_mlp, gates, experts, dom_experts, towers, w_exp, w_bal):
    """Multiply-adds a row of the products the kernel runs on the tensor
    cores: the own star slot, the skip, the star MLP, every expert, the gate
    and the tower's first Linear (the 1-wide head is f32, a warp a row)."""
    E, D = experts[0][0].shape[0], star[0].shape[0]
    mac = lambda layers: sum(l[0].shape[-2] * l[0].shape[-1] for l in layers)
    return (star[0].shape[1] * star[0].shape[2] + mac(skip) + mac(star_mlp) + E * mac(experts)
            + D * mac(dom_experts) + mac([gates]) + mac([towers]))


def ln_layers(gen, lead, dims):
    """``Mlp_N`` layers (W, b, gamma, beta) between the widths ``dims``."""
    return [(w, b, 0.5 + torch.rand(*lead, w.shape[-1], generator=gen, device="cuda"),
             0.1 * torch.randn(*lead, w.shape[-1], generator=gen, device="cuda"))
            for w, b in affines(gen, lead, dims)]


def phase_meta_kernels(gen, peak):
    """``m2m_fused_infer`` and ``m3oe_fused_infer`` against their plain
    versions at every case, then timed at their model's Ali-CCP shape over
    the tiles that fit in shared memory."""
    from scenario_wise_rec_tpu_torch.ops import kernels as k

    D, F = DOMAINS, N_SPARSE * 16 + N_DENSE
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    ids = lambda B, d=D: torch.randint(0, d, (B,), generator=gen, device="cuda")
    oob = torch.tensor([-1, D, D + 5, 0, 1, 2], device="cuda")
    entries = {}

    # M2M after its transformer: scenario loader, F = 376 (22 x 16 + 8 + the
    # 16-wide domain embedding), the domain embedding 16, 4 experts of E = 16,
    # one-layer hyper-MLPs, output MLP [64, 32]; the last argument is E
    def m2m_args(Fi, Fd, E, nE, expert_hidden, hyper_hidden, out_dims, g=gen):
        hyper = lambda i, o: affines(g, (), [i] + hyper_hidden + [o])
        return (affines(g, (nE,), [Fi] + expert_hidden + [E]), hyper(Fd, E), hyper(Fd, E),
                hyper(E, 4 * E * E), hyper(E, 2 * E), hyper(E, E * E), hyper(E, E),
                torch.randn(2 * E, 1, generator=g, device="cuda"), affines(g, (), [E] + out_dims),
                affines(g, (), [(out_dims or [E])[-1], 1])[0], E)

    ali = m2m_args(F, 16, 16, 4, [], [], [64, 32])
    cases = {"a_alicpp_b4096": ((randn(4096, F), randn(4096, 16)), ali),
             "b_ragged_b4095": ((randn(4095, F), randn(4095, 16)), ali),
             "b_ragged_b1": ((randn(1, F), randn(1, 16)), ali),
             "c_narrow_b1000": ((randn(1000, 42), randn(1000, 8)),
                                m2m_args(42, 8, 8, 3, [24], [12], [16]))}
    # E 5 with hidden expert and hyper stages (widths off 8: a product an
    # expert, vw 100 wide), no output MLP, KuaiRand's widths (F 812: its 796
    # sparse columns and the scenario feature's 16) and B 65,536, from a
    # generator of its own: the shared one feeds every later phase's data
    m2 = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 12)
    m2_rows, own = partial(rows_of, m2), partial(m2m_args, g=m2)
    cases["d_e5_hidden_b333"] = ((m2_rows(333, 41), m2_rows(333, 7)),
                                 own(41, 7, 5, 3, [9], [6], [7]))
    cases["e_no_output_mlp_b300"] = ((m2_rows(300, 20), m2_rows(300, 8)),
                                     own(20, 8, 8, 2, [], [], []))
    cases["f_kuairand_b4096"] = ((m2_rows(4096, 812), m2_rows(4096, 16)),
                                 own(812, 16, 16, 4, [], [], [64, 32]))
    cases["g_b65536"] = ((m2_rows(65_536, F), m2_rows(65_536, 16)), ali)
    err = run_cases("m2m_fused_infer", nan_filled(k.m2m_fused_infer), k.m2m_fused_infer_ref,
                    cases)
    for rows in M2M_BLOCK_ROWS:  # every tile: ragged, narrow, E 5 and KuaiRand's widths
        for name in ("b_ragged_b4095", "c_narrow_b1000", "d_e5_hidden_b333",
                     "f_kuairand_b4096"):
            inputs, args = cases[name]
            if rows == 64 and name == "f_kuairand_b4096":  # F 812: 64 rows do not fit
                try:
                    k.m2m_fused_infer(*inputs, *args, block_rows=rows)
                except RuntimeError as e:
                    check("shared memory" in str(e), f"m2m_fused_infer block_rows={rows}: {e}")
                    continue
                check(False, f"m2m_fused_infer {name} block_rows={rows} ran past shared memory")
            got = nan_filled(k.m2m_fused_infer)(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.m2m_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"m2m_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    log(f"  m2m_fused_infer every tile {M2M_BLOCK_ROWS} holds; 64 rows at KuaiRand's widths "
        f"raise, naming the shared memory")
    # rows never mix: a NaN in one row of t_out and one of dom_emb stays there
    (t_out, dom), args = cases["a_alicpp_b4096"]
    t_nan, d_nan = t_out.clone(), dom.clone()
    t_nan[2049, 100], d_nan[3000, 5] = float("nan"), float("nan")
    got = k.m2m_fused_infer(t_nan, d_nan, *args)
    nan = torch.isnan(got)
    check(nan.nonzero().flatten().tolist() == [2049, 3000]
          and kernel_gap(got[~nan], k.m2m_fused_infer_ref(t_nan, d_nan, *args)[~nan], None) <= TOL,
          "m2m_fused_infer: a NaN left its row")
    entry = time_entry("m2m_fused_infer", "m2m", k.m2m_fused_infer, k.m2m_fused_infer_ref,
                       *cases["a_alicpp_b4096"], m2m_work, peak, err, sweep_rows=M2M_BLOCK_ROWS)
    # the design's own bound: every product with shared weights as three TF32
    # products on the tensor cores, the meta-attention, mix, meta-tower and
    # head in f32
    inputs, args = cases["a_alicpp_b4096"]
    tc = 2.0 * inputs[0].shape[0] * m2m_product_macs(*args)
    entry.update(design_bound("m2m_fused_infer ", *m2m_work(*inputs, *args), tc, peak,
                              entry["ms"]))
    for name in ("f_kuairand_b4096", "g_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"m2m_fused_infer {name}, step 0",
                            lambda: k.m2m_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["m2m"] = entry

    # M3oE: default loader, s0 = 376; star [512, 256] (slot_w ⊙ shared_w per
    # domain), skip 376 -> 256, 4 experts and 3 domain experts 256 -> 64,
    # gates 256 -> 4, towers 64 -> 64 -> 1, each layer but the star slot,
    # the gate and the tower head followed by a LayerNorm
    def m3oe_args(s0, s1, s2, Dn, E, fcn, skip_hidden=(), g=gen):
        l1 = ln_layers(g, (Dn,), [fcn[-1], fcn[-1]])[0]
        return (affines(g, (Dn,), [s0, s1])[0], ln_layers(g, (), [s0, *skip_hidden, s2]),
                ln_layers(g, (), [s1, s2]), affines(g, (Dn,), [s2, E])[0],
                ln_layers(g, (E,), [s2] + fcn), ln_layers(g, (Dn,), [s2] + fcn),
                (*l1, *affines(g, (Dn,), [fcn[-1], 1])[0]),
                torch.sigmoid(torch.randn(1, generator=g, device="cuda")),
                torch.sigmoid(torch.randn(1, generator=g, device="cuda")))

    ali = m3oe_args(F, 512, 256, D, 4, [64])
    emb4096 = randn(4096, F)
    cases = {"a_alicpp_b4096": ((emb4096, ids(4096)), ali),
             "b_ragged_b4095": ((randn(4095, F), ids(4095)), ali),
             "b_ragged_b1": ((randn(1, F), ids(1)), ali),
             "c_narrow_b1000": ((randn(1000, 42), ids(1000, 2)),
                                m3oe_args(42, 24, 16, 2, 3, [8, 4], (12,))),
             "d_domain_oob_b4096": ((emb4096, oob[ids(4096, len(oob))]), ali),
             "e_one_domain_b4096": ((emb4096, ids(4096, 1)), m3oe_args(F, 512, 256, 1, 4, [64]))}
    # the partition by domain at its edges, KuaiRand's width and B 65,536,
    # from a generator of its own: the shared one feeds every later phase's data
    mg = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 5)

    m_counted, e_rows = partial(counted, mg), partial(rows_of, mg)
    cases["f_skewed_b4096"] = ((e_rows(4096, F), m_counted(3700, 300, 96)), ali)  # 90 % in one
    # 33 / 32 / 1 rows: a tile and one row, a whole tile, one row (32-row tiles)
    cases["g_counts_astride_tiles_b66"] = ((e_rows(66, F), m_counted(33, 32, 1)), ali)
    # KuaiRand's M3oE ladder (fcn_dims [128, 64, 64, 32], 5 domains) at MMOE's
    # KuaiRand F 800
    cases["h_kuairand_b4096"] = (
        (e_rows(4096, 800), torch.randint(0, 5, (4096,), generator=mg, device="cuda")),
        m3oe_args(800, 128, 64, 5, 4, [32], g=mg))
    cases["i_b65536"] = (
        (e_rows(65_536, F), torch.randint(0, D, (65_536,), generator=mg, device="cuda")), ali)

    unwritten_nan = nan_filled(k.m3oe_fused_infer)
    err = run_cases("m3oe_fused_infer", unwritten_nan, k.m3oe_fused_infer_ref, cases)
    for rows in M3OE_BLOCK_ROWS:  # every tile: at the edges of the partition, at KuaiRand's
        for name in ("f_skewed_b4096", "g_counts_astride_tiles_b66", "h_kuairand_b4096"):
            inputs, args = cases[name]
            if rows == 64 and name == "h_kuairand_b4096":  # F 800: 64 rows do not fit
                continue
            if rows in M3OE_ALI_TOO_WIDE and name != "h_kuairand_b4096":
                try:
                    k.m3oe_fused_infer(*inputs, *args, block_rows=rows)
                except RuntimeError as e:
                    check("shared memory" in str(e), f"m3oe_fused_infer block_rows={rows}: {e}")
                    continue
                check(False, f"m3oe_fused_infer {name} block_rows={rows} ran past shared memory")
            got = unwritten_nan(*inputs, *args, block_rows=rows)
            gap = kernel_gap(got, k.m3oe_fused_infer_ref(*inputs, *args), None)
            check(bool(torch.isfinite(got).all()) and gap <= TOL,
                  f"m3oe_fused_infer {name} block_rows={rows}: {gap}")
            err = max(err, gap)
    log(f"  m3oe_fused_infer block_rows {M3OE_ALI_TOO_WIDE} at Ali-CCP: raise, naming the "
        f"shared memory")
    # int64 ids as they are, modulo 2^32 as int32, then clipped
    (emb, did), args = cases["d_domain_oob_b4096"]
    check(torch.equal(k.m3oe_fused_infer(emb, did, *args),
                      k.m3oe_fused_infer(emb, did.to(torch.int32), *args))
          and torch.equal(k.m3oe_fused_infer(emb, did + 2**32, *args),
                          k.m3oe_fused_infer(emb, did, *args)),
          "m3oe_fused_infer: int64 ids differ from the same ids as int32")
    fits = tuple(r for r in M3OE_BLOCK_ROWS if r not in M3OE_ALI_TOO_WIDE)
    entry = time_entry("m3oe_fused_infer", "m3oe", k.m3oe_fused_infer, k.m3oe_fused_infer_ref,
                       *cases["a_alicpp_b4096"], m3oe_work, peak, err, sweep_rows=fits)
    # the design's own bound: every product as three TF32 products on the
    # tensor cores, the norms, mixes and the head in f32
    inputs, args = cases["a_alicpp_b4096"]
    tc = 2.0 * inputs[0].shape[0] * m3oe_product_macs(*args)
    entry.update(design_bound("m3oe_fused_infer ", *m3oe_work(*inputs, *args), tc, peak,
                              entry["ms"]))
    for name in ("h_kuairand_b4096", "i_b65536"):
        inputs, args = cases[name]
        cost = wrapper_cost(f"m3oe_fused_infer {name}, step 0",
                            lambda: k.m3oe_fused_infer(*inputs, *args))
        entry[f"{name}_device_ms"] = cost["device_ms"]
    entries["m3oe"] = entry
    return entries


def kernel_counters():
    """``{name: (wrapper, counter attribute)}`` of every kernel and form."""
    from scenario_wise_rec_tpu_torch.ops import kernels

    out = {}
    for name in [k for k, _, _ in EVAL_KERNELS.values()] + list(UPDATE_KERNELS):
        fn, attr = FORM_COUNTERS.get(name, (name, "launches"))
        out[name] = (getattr(kernels, fn), attr)
    return out


def step_launches(mode, steps):
    """Each embedding-update kernel's launches over ``steps`` train steps
    of ``mode`` (None: the plain dense step)."""
    return {k: steps * STEP_LAUNCHES.get(mode, {}).get(k, 0) for k in UPDATE_KERNELS}


def reset_counts():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()}


# the Ali-CCP loader each model's script uses (scripts/run_ali_ccp.py)
LOADER = {"epnet": "scenario", "adasparse": "scenario", "ppnet": "ppnet",
          "adaptdhm": "scenario", "m2m": "scenario"}


def ali_data(loader="default", vocab=VOCAB):
    """The Ali-CCP feature set as ``build_model`` takes it, from one of the
    reference's three loaders: ``default``, 8 dense and 23 sparse features
    of width 16; ``scenario``, one sparse feature fewer (``301`` dropped) and
    the domain indicator embedded as the scenario feature; ``ppnet``, as
    ``scenario`` with two of the sparse features (``101``, ``205``) split
    out as id features."""
    from scenario_wise_rec_tpu_torch.core import DenseFeature, SparseFeature

    sparse = [SparseFeature(f"s{i}", vocab_size=vocab, embed_dim=16) for i in range(N_SPARSE)]
    data = {"dense_feas": [DenseFeature(f"d{i}") for i in range(N_DENSE)],
            "sparse_feas": sparse, "domain_num": DOMAINS}
    if loader != "default":
        data["sparse_feas"] = sparse[:-1]
        data["scenario_feas"] = [SparseFeature("domain_indicator", vocab_size=DOMAINS,
                                               embed_dim=16)]
    if loader == "ppnet":
        data["sparse_feas"], data["id_feas"] = sparse[:-3], sparse[-3:-1]
    return data


# each loader's packed tables: {collection: (rows, width)}
TABLES = {"default": {"embedding": (N_SPARSE * VOCAB, 16)},
          "scenario": {"sce_embedding": (DOMAINS, 16),
                       "agn_embedding": ((N_SPARSE - 1) * VOCAB, 16)},
          "ppnet": {"id_embedding": (2 * VOCAB, 16),
                    "agn_embedding": ((N_SPARSE - 3) * VOCAB + DOMAINS, 16)}}


# a model whose one collection packs its loader's tables together
MODEL_TABLES = {name: {"embedding": ((N_SPARSE - 1) * VOCAB + DOMAINS, 16)}
                for name in ("adaptdhm", "m2m")}


def packed_tables(model):
    from scenario_wise_rec_tpu_torch.ops.embedding import EmbeddingCollection

    return {n: m.packed for n, m in model.named_modules()
            if isinstance(m, EmbeddingCollection) and m.packed is not None}


def build_ali_model(seed, perturb=False, name="mmoe"):
    """``name`` at its Ali-CCP width with 467k ids per feature, on the card,
    through the ladder users build it with."""
    from scenario_wise_rec_tpu_torch.configs import build_model

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    loader = LOADER.get(name, "default")
    model = build_model("ali_ccp", name, ali_data(loader), device="cuda", generator=gen)
    if perturb and name == "star":
        settle_running_stats(model, seed)
        perturb_running_stats(model, gen, relative=True)
    elif perturb:
        perturb_running_stats(model, gen)
    if perturb and name in GATED_MODELS + HAMUR_MODELS + META_MODELS:
        spread_tables(model, gen)
    randomize_adapters(model, gen)
    torch.cuda.synchronize()
    tables = packed_tables(model)
    check({n: tuple(t.shape) for n, t in tables.items()}
          == MODEL_TABLES.get(name, TABLES[loader]), "table shapes")
    log(f"  {name} built on the card in {time.perf_counter() - t0:.2f} s: packed tables "
        + ", ".join(f"{n} {tuple(t.shape)}" for n, t in tables.items())
        + f", {sum(t.numel() for t in tables.values()) * 4 / 1e6:.1f} MB, "
        f"{sum(p.numel() for n, p in model.named_parameters() if 'embedding' not in n):,} "
        "dense parameters")
    return model


# narrow copies of each model, for the card against the CPU: these take
# (features, 2, **kwargs), the gated family narrow_kwargs
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
}


def narrow_kwargs(name, dense, sparse, sce, ids):
    """The narrow constructor arguments of the models that take no
    ``(features, domain_num)`` (AdaSparse without dropout, M2M with its
    transformer's at 0: the card and the CPU draw different masks)."""
    return {"sarnet": dict(features=dense + sparse, domain_num=2, domain_shared_expert_num=3,
                           domain_specific_expert_num=2),
            "epnet": dict(sce_features=sce, agn_features=sparse + dense, fcn_dims=[8]),
            "ppnet": dict(id_features=ids, agn_features=sparse + dense + sce, domain_num=2,
                          fcn_dims=[16, 8]),
            "adasparse": dict(sce_features=sce, agn_features=sparse,
                              mlp_params={"dims": [16, 8], "dropout": 0.0}),
            "adaptdhm": dict(features=sparse + sce, fcn_dims=[16, 8], cluster_num=3,
                             beta=0.9),
            "m2m": dict(features=sparse + sce, domain_feature=sce, domain_num=2,
                        num_experts=4, expert_output_size=4,
                        transformer_dims={"num_encoder_layers": 2, "num_decoder_layers": 2,
                                          "dim_feedforward": 16, "dropout": 0.0})}[name]


def narrow_model_and_data(seed, n=300, name="mmoe"):
    """A narrow ``name`` on the CPU and ``n`` labelled rows for it."""
    from scenario_wise_rec_tpu_torch.core import DenseFeature, SparseFeature
    from scenario_wise_rec_tpu_torch.models import get_model

    dense = [DenseFeature("d0")]
    sparse = [SparseFeature(f"s{i}", 100, embed_dim=8) for i in range(3)]
    sce = [SparseFeature("domain_indicator", 2, embed_dim=8)]
    ids = [SparseFeature("uid", 100, embed_dim=8)]
    cpu_gen = torch.Generator(device="cpu").manual_seed(seed)
    if name in NARROW:
        model = get_model(name)(dense + sparse, 2, device="cpu", generator=cpu_gen,
                                **NARROW[name])
    else:
        model = get_model(name)(**narrow_kwargs(name, dense, sparse, sce, ids), device="cpu",
                                generator=cpu_gen)
    perturb_running_stats(model, cpu_gen)
    if name in GATED_MODELS + HAMUR_MODELS + META_MODELS + ("hamur_small", "mlpn"):
        spread_tables(model, cpu_gen)
    randomize_adapters(model, cpu_gen)
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, 100, n) for i in range(3)}
    x["uid"] = r.integers(0, 100, n)
    x["d0"] = r.normal(size=n).astype(np.float32)
    x["domain_indicator"] = r.integers(0, 2, n)
    return model, x, (r.random(n) < 0.4).astype(np.float32)


def table_moments(t, table):
    """``(mu, nu, step)`` of a packed table: the embedding update's state
    for the table it owns (in the occurrence mode the columns of its combined
    store), torch.optim's for one the dense step trains."""
    if t._emb_mode is not None and table is t.model.embedding.packed:
        st, d = t.emb_opt_state, table.shape[1]
        if t._emb_mode == "occurrence":
            return st["comb"][:, d:2 * d], st["comb"][:, 2 * d:], st["step"]
        return st["mu"], st["nu"], st["step"]
    st = t.optimizer.state[table]
    return st["exp_avg"], st["exp_avg_sq"], int(st["step"])


def trainer_groups(t):
    """The tensors the trainer checks compare, by group of ``GROUP_TOL``:
    every packed table, the step its moments imply, and the rest."""
    from scenario_wise_rec_tpu_torch.ops.kernels.sorted_adam import adam_hparams

    sd = dict(t.model.state_dict())
    p = t._opt_params
    tables, implied, store = {}, {}, {}
    for name, table in packed_tables(t.model).items():
        key = f"{name}.packed"
        tables[key] = sd.pop(key)
        if t._emb_mode and t._bf16_store and table is t.model.embedding.packed:
            # the live table is the bf16 store's (the model's is a copy
            # refreshed only for eval and save)
            store = {f"{name}.{k}": t.emb_opt_state[k] for k in ("table", "mu", "nu")}
            del tables[key]
            continue
        mu, nu, step = table_moments(t, table)
        lr, _, _, _, bc1r, bc2r, eps = adam_hparams(
            step, t._lr_now, 0.0, p.get("b1", 0.9), p.get("b2", 0.999), p.get("eps", 1e-8))
        implied[key] = lr * (mu * bc1r) / (torch.sqrt(nu * bc2r) + eps)
    cancelled = lambda k: bn_cancelled(t.model, k)
    return {"table": tables, "table moments": implied, "bf16 store": store,
            "dense": {k: v for k, v in sd.items() if not cancelled(k)},
            "BN-cancelled": {k: v for k, v in sd.items() if cancelled(k)}}


def bn_cancelled(model, key):
    """``key`` of ``model`` has an exactly zero gradient, all noise
    (BN_BIAS; or the beta of a HAMUR adapter that a block follows)."""
    if BN_BIAS.search(key):
        return True
    m = re.fullmatch(r"adapters\.(\d+)\.beta", key)
    return bool(m) and model.adapter_after[int(m.group(1))] < len(model.blocks)


def bf16_ulps(got, want):
    """bf16 values between ``got`` and ``want``, elementwise (the bits in
    sign-magnitude order, so +0 and -0 are one value)."""
    def key(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(got) - key(want.to(got.device))).abs()


def bf16_store_gaps(tensors, want):
    """``(outside, elements, most ulps, {tensor: outside, "differing": n})``
    of a bf16 store against another (BF16_ROW_SCALE, NOISY_SHARE)."""
    outside, total, worst, where, differing = 0, 0, 0, {}, 0
    for k, va in tensors.items():
        vb = want[k].to(va.device)
        check(bool(torch.isfinite(va.float()).all()), f"{k} not finite")
        ulps = bf16_ulps(va, vb)
        row = vb.float().abs().amax(dim=1, keepdim=True)
        far = (ulps > 1) & ((va.float() - vb.float()).abs() > BF16_ROW_SCALE * row)
        n = int(far.sum())
        if n:
            where[k] = n
        outside, total = outside + n, total + ulps.numel()
        worst, differing = max(worst, int(ulps.max())), differing + int((ulps > 0).sum())
    if differing > NOISY_SHARE * total:
        outside += differing
    return outside, total, worst, {**where, "differing": differing}


def group_gaps(a, b, noisy=None):
    """``{group: (elements outside its tolerance, elements, max |a - b|,
    {tensor: elements outside})}`` of ``trainer_groups`` a against b.
    ``noisy``: ``{tensor: bool mask}`` of elements held to NOISE_ATOL."""
    out = {}
    for grp, tensors in a.items():
        if GROUP_TOL[grp] is None:
            if tensors:
                out[grp] = bf16_store_gaps(tensors, b[grp])
            continue
        atol, rtol = GROUP_TOL[grp]
        loose, total, worst, where = 0, 0, 0.0, {}
        for k, va in tensors.items():
            vb = b[grp][k].to(va.device)
            check(bool(torch.isfinite(va).all()), f"{k} not finite")
            gap = (va - vb).abs()
            tol = atol + rtol * vb.abs()
            if noisy and k in noisy:
                tol = torch.where(noisy[k].to(va.device), NOISE_ATOL + rtol * vb.abs(), tol)
            n = int((gap > tol).sum())
            if n:
                where[k] = n
            loose, total = loose + n, total + gap.numel()
            worst = max(worst, gap.max().item() if gap.numel() else 0.0)
        out[grp] = (loose, total, worst, where)
    return out


def gaps_line(gaps):
    return "; ".join(f"{g} {n}/{t} outside, max gap {w:.3e}" if GROUP_TOL[g] else
                     f"{g} {n}/{t} outside, {where['differing']} differ, most {w} ulp"
                     for g, (n, t, w, where) in gaps.items())


def outside(gaps):
    """The groups with an element outside its tolerance."""
    return [g for g, (n, _, _, _) in gaps.items() if n]


def noisy_elements(a, b):
    """``{tensor: bool mask}`` of the elements, dense parameters and packed
    tables alike, whose first moments in trainers a and b differ by more
    than NOISY_MOMENT of b's, and every attention's key bias (NOISY_MODELS);
    checks their share of all."""
    b_named, b_tables = dict(b._dense_named), packed_tables(b.model)
    moments = [(n, p, a.optimizer.state[p]["exp_avg"], b.optimizer.state[b_named[n]]["exp_avg"])
               for n, p in a._dense_named]
    moments += [(f"{n}.packed", t, table_moments(a, t)[0], table_moments(b, b_tables[n])[0])
                for n, t in packed_tables(a.model).items()]
    out = {}
    for n, p, ma, mb in moments:
        out[n] = (ma - mb.to(ma.device)).abs() > NOISY_MOMENT * mb.to(ma.device).abs()
        if n.endswith("attn.in_b"):
            out[n][p.shape[0] // 3:2 * p.shape[0] // 3] = True
    n_noisy = sum(int(m.sum()) for m in out.values())
    n_all = sum(p.numel() for _, p, _, _ in moments)
    check(n_noisy <= NOISY_SHARE * n_all, f"{n_noisy} of {n_all} elements are noisy")
    return out, n_noisy, n_all


def adopt_state(dst, src):
    """Hand trainer ``dst`` the weights and optimizer state of ``src``
    (sorted or dense mode, any device), so that their next steps start from
    one state."""
    src_sd = src.model.state_dict()
    src_opt = {n: src.optimizer.state[p] for n, p in src._dense_named}
    src_tables = packed_tables(src.model)
    with torch.no_grad():
        for k, v in dst.model.state_dict().items():
            v.copy_(src_sd[k])
        for n, p in dst._dense_named:
            if n in src_opt:
                for k in ("exp_avg", "exp_avg_sq"):
                    dst.optimizer.state[p][k].copy_(src_opt[n][k])
        for name, table in packed_tables(dst.model).items():
            for a, b in zip(table_moments(dst, table)[:2],
                            table_moments(src, src_tables[name])[:2]):
                a.copy_(b)
        if dst._emb_mode and dst._bf16_store:
            dst.emb_opt_state["table"].copy_(src.emb_opt_state["table"])


class AdamOrderRule:
    """The counted excuse rule of the dense-Adam gates (the same rule as
    ``tests/test_torch_port_cuda.py``'s ``_AdamOrderRule``). Two f32 sums of
    the same n gradients differ by at most 2 err, err = (n-1) 2^-24 sum|g|;
    where a row's G = sum g + wd w lies within that of zero, Adam's first step
    lr G / (|G| + eps) moves by up to 2 lr on the order alone. An element of
    the table, mu or nu is excused from SA_ATOL + SA_RTOL |v| from the step
    on where its row took at least 3 duplicate gradients and |G| <= ORDER err
    + EPS eps. An excused element is still held: the table to LR_STEPS lr
    more per step since (a step moves an element by about lr at most, so two
    sides by 2 lr); mu and nu to the gap the order can open in their own
    scale: with dG the most the two sides' G can differ (2 err, plus wd x the
    table's own slack), mu' = b1 mu + (1-b1) G gives b1 slack + (1-b1) dG,
    and nu' = b2 nu + (1-b2) G^2 gives b2 slack + (1-b2) dG (2 |G|max + dG),
    |G|max = sum|g| + wd |w|. Excused elements are counted, printed, and may
    be at most SHARE of the table's elements."""

    ORDER, EPS, LR_STEPS, SHARE = 2.0, 4.0, 4.0, 1e-4

    def __init__(self, table):
        self.excused = torch.zeros(table.shape, dtype=torch.bool, device=table.device)
        self.slack = {w: torch.zeros_like(table) for w in ("table", "mu", "nu")}

    def step(self, before, ids, g, hp):
        """One step's gradients ``g`` at ``ids`` (any order; ids outside
        [0, V) add nothing) on the plain version's table ``before`` it."""
        lr, wd, b1, b2, _, _, eps = hp
        ids = ids.long()
        keep = (ids >= 0) & (ids < before.shape[0])
        rows, inv, n = torch.unique(ids[keep], return_inverse=True, return_counts=True)
        g64 = g[keep].double()
        s = torch.zeros(rows.numel(), g.shape[1], dtype=torch.float64,
                        device=g.device).index_add_(0, inv, g64)
        a = torch.zeros_like(s).index_add_(0, inv, g64.abs())
        err = (n[:, None] - 1).double() * 2.0 ** -24 * a
        G = s + wd * before[rows].double()
        near = (n[:, None] >= 3) & (G.abs() <= self.ORDER * err + self.EPS * eps)
        self.excused[rows] = self.excused[rows] | near
        sl = self.slack
        dG = wd * sl["table"]
        dG[rows] += (2 * err).float()
        gmax = wd * before.abs()
        gmax[rows] += a.float()
        sl["mu"] = b1 * sl["mu"] + (1 - b1) * dG
        sl["nu"] = b2 * sl["nu"] + (1 - b2) * dG * (2 * gmax + dG)
        sl["table"] = torch.where(self.excused, sl["table"] + self.LR_STEPS * lr, 0.0)

    def close(self, got, want, what):
        """``got`` against ``want`` (what: "table", "mu" or "nu")."""
        slack = torch.where(self.excused, self.slack[what], 0.0)
        return bool(((got - want).abs() <= SA_ATOL + SA_RTOL * want.abs() + slack).all())

    def count(self, label):
        """The excused elements, printed and held to SHARE of the table's."""
        n, total = int(self.excused.sum()), self.excused.numel()
        log(f"    {label}: {n} of {total} elements excused by the order rule "
            f"({100 * n / total:.2e} %, at most {100 * self.SHARE:g} %)")
        check(n <= self.SHARE * total, f"{label}: {n} elements excused by the order rule")
        return n


def planted_adam_faults(label, apply_fn, table, mu, nu, ids, g, hp, hot):
    """The order rule against two planted faults, each on one step from one
    state: the kernel (``apply_fn(table, mu, nu, ids, g)``) given the
    gradients with one of the hot row's duplicates (position ``hot``) left
    out, and the kernel's step with one touched row's update undone. The
    plain version takes every gradient; the rule must fail both."""
    from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as fk

    ref = [t.clone() for t in (table, mu, nu)]
    rule = AdamOrderRule(table)
    rule.step(ref[0], ids, g, hp)
    fk.fused_dense_adam_ref(*ref, g, ids, hp)
    row = int(ids[hot + BATCH])  # a touched row of the next feature
    for fault in ("one duplicate of the hot row left out", "one touched row's update undone"):
        out = [t.clone() for t in (table, mu, nu)]
        gk = g.clone()
        if fault.startswith("one duplicate"):
            gk[hot] = 0.0
        apply_fn(*out, ids, gk)
        if fault.startswith("one touched"):
            for t, before in zip(out, (table, mu, nu)):
                t[row] = before[row]
        torch.cuda.synchronize()
        held = [rule.close(o, w, what) for o, w, what in zip(out, ref, ("table", "mu", "nu"))]
        log(f"  {label} planted fault, {fault}: table, mu, nu held {held} (must fail)")
        check(not all(held), f"{label}: the order rule let a planted fault pass ({fault})")
        del out
    del ref


def per_feature(draw):
    """Packed ids of the 23 Ali-CCP features, 4096 each: feature f's drawn
    by ``draw(f)`` into its own span of VOCAB rows."""
    return torch.as_tensor(np.concatenate([f * VOCAB + draw(f) for f in range(N_SPARSE)]))


def phase_sorted_adam(gen, peak):
    """``sorted_dense_adam_apply`` against its plain version over 3 steps at
    four shapes, then its time, bound and block_rows sweep at the Ali-CCP
    shape beside the plain version and the nearest PyTorch composition."""
    from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa

    V, D, K = N_SPARSE * VOCAB, 16, N_SPARSE * BATCH
    r = np.random.default_rng(1)
    zipf = lambda: np.minimum(r.zipf(1.2, BATCH) - 1, VOCAB - 1)
    v_odd = 1_000_003  # not a multiple of any tile
    cases = {
        "a_alicpp_uniform": (V, per_feature(lambda f: r.integers(0, VOCAB, BATCH))),
        "b_hot_row_zipf": (V, per_feature(
            lambda f: np.full(BATCH, 17) if f == 0 else zipf())),
        "c_odd_v_empty_tiles_oob": (v_odd, torch.cat([
            torch.as_tensor(r.integers(0, v_odd // 3, 20_000)),
            torch.tensor([-1, -7, v_odd, v_odd + 3])])),
        "d_no_ids": (v_odd, torch.zeros(0, dtype=torch.long)),
    }
    hps = [sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8) for t in (1, 2, 3)]
    max_err = 0.0
    for name, (v, ids) in cases.items():
        ids = ids.cuda()
        table = torch.randn(v, D, generator=gen, device="cuda")
        mu, nu = torch.zeros_like(table), torch.zeros_like(table)
        ref = [table.clone(), mu.clone(), nu.clone()]
        rule = AdamOrderRule(table)
        err = 0.0
        for t, hp in enumerate(hps, 1):
            g = 1e-3 * torch.randn(ids.shape[0], D, generator=gen, device="cuda")
            sid, gs = sa.owner_sorted_grads(ids, g)
            sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp)
            torch.cuda.synchronize()
            rule.step(ref[0], sid, gs, hp)
            sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
            for got, want, what in zip((table, mu, nu), ref, ("table", "mu", "nu")):
                check(bool(torch.isfinite(got).all()), f"{name}: {what} not finite")
                check(rule.close(got, want, what),
                      f"{name} step {t}: {what} disagrees with the plain version")
                err = max(err, (got - want).abs().max().item())
        log(f"  sorted_dense_adam_apply {name}: V {v}, K {ids.shape[0]}, 3 steps, "
            f"max_abs_err {err:.3e}")
        rule.count(f"sorted_dense_adam_apply {name}")
        max_err = max(max_err, err)
        del table, mu, nu, ref, rule

    # times at the Ali-CCP shape, with uniform ids (the main path's) and with
    # the hot row plus Zipf ids, where a few tiles hold thousands of positions
    table = torch.randn(V, D, generator=gen, device="cuda")
    mu, nu = torch.zeros_like(table), torch.zeros_like(table)
    hp = hps[0]
    sweep = {}
    for name in ("a_alicpp_uniform", "b_hot_row_zipf"):
        ids = cases[name][1].cuda()
        g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
        sid, gs = sa.owner_sorted_grads(ids, g)
        counts = torch.unique_consecutive(sid, return_counts=True)[1]
        tiles = torch.bincount(sid.long() // sa.DEFAULT_BLOCK_ROWS)
        log(f"  {name}: {counts.numel()} distinct ids, longest run {counts.max().item()}, "
            f"fullest {sa.DEFAULT_BLOCK_ROWS}-row tile {tiles.max().item()} positions")
        ref = [t.clone() for t in (table, mu, nu)]
        rule = AdamOrderRule(table)
        rule.step(ref[0], sid, gs, hp)
        sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
        rule.count(f"sorted_dense_adam_apply {name}, one step (the block_rows sweep)")
        sweep[name] = {}
        for rows in (64, 128, 256, 512, 1024, 2048):
            out = [t.clone() for t in (table, mu, nu)]
            sa.sorted_dense_adam_apply(*out, sid, gs, hp, block_rows=rows)
            check(all(rule.close(o, w, what) for o, w, what in zip(out, ref, ("table", "mu", "nu"))),
                  f"{name} block_rows={rows} disagrees")
            sweep[name][rows] = time_ms(lambda: sa.sorted_dense_adam_apply(
                *out, sid, gs, hp, block_rows=rows))
            del out
        log(f"  {name} block_rows sweep, ms: "
            + ", ".join(f"{r} -> {t:.4f}" for r, t in sweep[name].items()))
        del ref, rule
    hot_ms = time_ms(lambda: sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp))
    # the planted faults' gradients from a generator of their own: the shared
    # one feeds every later phase's data
    own = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 2)
    planted_adam_faults(
        "sorted_dense_adam_apply", lambda t, m, n, i, g_: sa.sorted_dense_adam_apply(
            t, m, n, *sa.owner_sorted_grads(i, g_), hp),
        table, mu, nu, cases["b_hot_row_zipf"][1].cuda(),
        1e-3 * torch.randn(K, D, generator=own, device="cuda"), hp, 0)
    ids = cases["a_alicpp_uniform"][1].cuda()
    g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(ids, g)
    kernel_ms = time_ms(lambda: sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp))
    plain_ms = time_ms(lambda: sa.sorted_dense_adam_apply_ref(table, mu, nu, sid, gs, hp),
                       reps=3, inner=5)
    sort_ms = time_ms(lambda: sa.owner_sorted_grads(ids, g))
    # the nearest PyTorch composition (timed here only; the port never calls it)
    param = torch.nn.Parameter(table.clone())
    param.grad = torch.zeros_like(table)
    opt = torch.optim.Adam([param], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=1e-5, fused=True)
    sid_long = sid.long()

    def library():
        param.grad.zero_()
        param.grad.index_add_(0, sid_long, gs)
        opt.step()

    library_ms = time_ms(library, reps=3, inner=10)
    del param, opt
    nbytes = 6.0 * V * D * 4 + K * 4 + K * D * 4  # table, mu, nu in and out; ids; grads
    flops = 16.0 * V * D + K * D                  # the Adam chain per element; the sums
    t_ops, t_bytes = flops / peak[0] * 1e3, nbytes / peak[1] * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  b_hot_row_zipf: kernel {hot_ms:.4f} ms")
    log(f"  a_alicpp_uniform: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"index_add_ + torch.optim.Adam(fused=True) {library_ms:.4f} ms, id sort + "
        f"row gather {sort_ms:.4f} ms; {nbytes / 1e9:.4f} GB, bound {bound:.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{nbytes / kernel_ms / 1e9:.3f} TB/s achieved ({100 * bound / kernel_ms:.1f}% of bound)")
    return {"name": "sorted_dense_adam_apply", "route": "cuda",
            "source": "scenario_wise_rec_tpu_torch/csrc/sorted_adam.cu",
            "replaces": "scenario_wise_rec_tpu/ops/pallas/sorted_adam.py:281",
            "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "hot_row_zipf_ms": hot_ms,
            "block_rows_sweep_ms": sweep}


def bf16_ulp(x):
    """The bf16 ulp at each element of bf16 ``x``: the gap to the next value
    away from zero."""
    mag = x.abs()
    up = (mag.view(torch.int16) + 1).view(torch.bfloat16)
    return up.float() - mag.float()


def bf16_held(got, want, rule, what):
    """``(held, differing, beyond one ulp, most ulps)`` of one step of the
    bf16 form (``got``) against its plain version's (``want``) from one
    state. Both round the same f32 chain to nearest even; their f32 values
    differ only by the order of the duplicate sums, at most ``rule``'s slack
    (``AdamOrderRule`` stepped once on that state: mu's and nu's for every
    element, the table's for its excused ones). Two f32 values s apart round
    at most s + one ulp apart, so an element is held if within one ulp or
    within its slack plus one ulp; the elements that differ at all may be at
    most AdamOrderRule.SHARE of the array, and those beyond one ulp are
    counted."""
    ulps = bf16_ulps(got, want)
    slack = rule.slack[what]
    if what == "table":
        slack = torch.where(rule.excused, slack, 0.0)
    gap = (got.float() - want.float()).abs()
    ok = (ulps <= 1) | (gap <= slack + bf16_ulp(torch.maximum(got.abs(), want.abs())))
    n, beyond, most = int((ulps > 0).sum()), int((ulps > 1).sum()), int(ulps.max())
    return bool(ok.all()) and n <= AdamOrderRule.SHARE * ulps.numel(), n, beyond, most


def phase_sorted_adam_bf16(seed, peak):
    """The bf16 form of ``sorted_dense_adam_apply`` (table, mu and nu bf16)
    against its plain version at the Ali-CCP shape (V = 10,741,000, D = 16,
    K = 94,208) with uniform ids and with the hot row plus Zipf ids, 3 steps,
    each from one state, under ``bf16_held``; two planted faults that rule
    must catch; a ``block_rows`` sweep; its time and Step 0 beside its
    bound, the plain version and index_add_ + fused torch.optim.Adam over
    bf16 tensors; and, in the same call, the Step 0 of the f32 form and of
    ``fused_dense_adam_apply``, which share ``csrc/embedding_adam.cuh``.
    Its data come from a generator of its own."""
    from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as fk
    from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa
    from scenario_wise_rec_tpu_torch.train.optim import segment_sorted_ids

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    V, D, K = N_SPARSE * VOCAB, 16, N_SPARSE * BATCH
    bf = torch.bfloat16
    r = np.random.default_rng(23)
    zipf = lambda: np.minimum(r.zipf(1.2, BATCH) - 1, VOCAB - 1)
    cases = {"a_alicpp_uniform": per_feature(lambda f: r.integers(0, VOCAB, BATCH)).cuda(),
             "b_hot_row_zipf": per_feature(
                 lambda f: np.full(BATCH, 17) if f == 0 else zipf()).cuda()}
    hps = [sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8) for t in (1, 2, 3)]
    start = torch.randn(V, D, generator=gen, device="cuda").to(bf)
    max_err, differing = 0.0, {}
    for name, ids in cases.items():
        state = [start.clone(), torch.zeros_like(start), torch.zeros_like(start)]
        differing[name] = []
        for t, hp in enumerate(hps, 1):
            ref = [x.clone() for x in state]
            g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
            sid, gs = sa.owner_sorted_grads(ids, g)
            rule = AdamOrderRule(ref[0].float())
            rule.step(ref[0].float(), sid, gs, hp)
            sa.sorted_dense_adam_apply(*state, sid, gs, hp)
            sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
            torch.cuda.synchronize()
            step = []
            for got, want, what in zip(state, ref, ("table", "mu", "nu")):
                check(got.dtype == bf and bool(torch.isfinite(got.float()).all()),
                      f"bf16 {name}: {what} not finite bf16")
                held, n, beyond, most = bf16_held(got, want, rule, what)
                check(held, f"bf16 {name} step {t}: {what} {n} elements differ, {beyond} by "
                      f"more than one ulp (at most {most})")
                max_err = max(max_err, (got.float() - want.float()).abs().max().item())
                step.append((n, beyond))
            differing[name].append(step)
            del ref, rule
        log(f"  sorted_dense_adam_apply bf16 {name}: V {V}, K {K}, 3 steps each from one "
            f"state; elements that differ (table, mu, nu), each as (any, beyond one ulp "
            f"within the order slack), per step {differing[name]} of {V * D} each (at most "
            f"{AdamOrderRule.SHARE * V * D:.0f} differ)")
    table, mu, nu = state

    # planted faults, one step from the state above
    hot = cases["b_hot_row_zipf"]
    g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(hot, g)
    hp = hps[2]
    ref = [x.clone() for x in (table, mu, nu)]
    rule = AdamOrderRule(table.float())
    rule.step(table.float(), sid, gs, hp)
    sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
    hit = torch.zeros(V, dtype=torch.bool, device="cuda")
    hit[sid.long()] = True
    row = int((~hit).nonzero()[0])  # a row no id reaches: it only decays
    for fault in ("results truncated instead of rounded", "one untouched row's decay left out"):
        out = [x.clone() for x in (table, mu, nu)]
        if fault.startswith("results"):
            # the f32 form on widened copies, truncated (rounded toward zero)
            wide = [x.float() for x in out]
            sa.sorted_dense_adam_apply(*wide, sid, gs, hp)
            for o, w in zip(out, wide):
                o.copy_((w.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16))
        else:
            sa.sorted_dense_adam_apply(*out, sid, gs, hp)
            for o, before in zip(out, (table, mu, nu)):
                o[row] = before[row]
        torch.cuda.synchronize()
        held = [bf16_held(o, w, rule, what)[0]
                for o, w, what in zip(out, ref, ("table", "mu", "nu"))]
        log(f"  sorted_dense_adam_apply bf16 planted fault, {fault}: table, mu, nu held "
            f"{held} (must fail)")
        check(not all(held), f"bf16: the one-ulp rule let a planted fault pass ({fault})")
        del out
    del ref, rule

    # block_rows sweep: each tile one step from one state, held and timed
    sweep = {}
    for name, ids in cases.items():
        g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
        sid, gs = sa.owner_sorted_grads(ids, g)
        ref = [x.clone() for x in (table, mu, nu)]
        rule = AdamOrderRule(table.float())
        rule.step(table.float(), sid, gs, hp)
        sa.sorted_dense_adam_apply_ref(*ref, sid, gs, hp)
        sweep[name] = {}
        for rows in (64, 128, 256, 512, 1024, 2048):
            out = [x.clone() for x in (table, mu, nu)]
            sa.sorted_dense_adam_apply(*out, sid, gs, hp, block_rows=rows)
            torch.cuda.synchronize()
            check(all(bf16_held(o, w, rule, what)[0]
                      for o, w, what in zip(out, ref, ("table", "mu", "nu"))),
                  f"bf16 {name} block_rows={rows} disagrees")
            sweep[name][rows] = time_ms(lambda: sa.sorted_dense_adam_apply(
                *out, sid, gs, hp, block_rows=rows))
            del out
        log(f"  sorted_dense_adam_apply bf16 {name} block_rows sweep, ms: "
            + ", ".join(f"{k} -> {t:.4f}" for k, t in sweep[name].items()))
        del ref, rule

    hot_ms = time_ms(lambda: sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp))
    ids = cases["a_alicpp_uniform"]
    g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(ids, g)
    kernel_ms = time_ms(lambda: sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp))
    log("  Step 0 at the Ali-CCP shape, uniform ids:")
    step0 = wrapper_cost("sorted_dense_adam_apply bf16",
                         lambda: sa.sorted_dense_adam_apply(table, mu, nu, sid, gs, hp))
    plain_ms = time_ms(lambda: sa.sorted_dense_adam_apply_ref(table, mu, nu, sid, gs, hp),
                       reps=3, inner=5)
    # the nearest PyTorch composition over the same bf16 tensors (timed here
    # only; the port never calls it): the gradient rows rounded to bf16, and
    # summed in bf16, before fused Adam
    param = torch.nn.Parameter(table.clone())
    param.grad = torch.zeros_like(param)
    opt = torch.optim.Adam([param], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=1e-5, fused=True)
    sid_long, gs_bf = sid.long(), gs.to(bf)

    def library():
        param.grad.zero_()
        param.grad.index_add_(0, sid_long, gs_bf)
        opt.step()

    library_ms = time_ms(library, reps=3, inner=10)
    del param, opt
    # the f32 form and fused_dense_adam_apply, Step 0 in the same call
    f32 = [torch.randn(V, D, generator=gen, device="cuda"), torch.zeros(V, D, device="cuda"),
           torch.zeros(V, D, device="cuda")]
    f32_step0 = wrapper_cost("sorted_dense_adam_apply f32",
                             lambda: sa.sorted_dense_adam_apply(*f32, sid, gs, hp))
    segs = tuple((f"s{f}", f * BATCH, BATCH) for f in range(N_SPARSE))
    fused_args = segment_sorted_ids(ids, segs)
    fused = lambda: fk.fused_dense_adam_apply(*f32, g, *fused_args, hp)
    # its segment offsets are a device row made once, so the call copies
    # nothing from the host and Step 0 reads its device time; back to back
    # beside it
    fused_step0, fused_ms = wrapper_cost("fused_dense_adam_apply", fused), time_ms(fused)
    # the form that reads hp from device memory (the graphed train step's):
    # one step of each storage type, and of row 14's kernel, from one state,
    # bit for bit the by-value form's and held against the plain version;
    # its Step 0 between two more of the by-value form's
    hp_dev = torch.tensor(hp, device="cuda")
    dev_step0 = {}
    forms = (("bf16", [table, mu, nu], lambda t, h: sa.sorted_dense_adam_apply(*t, sid, gs, h),
              lambda t: sa.sorted_dense_adam_apply_ref(*t, sid, gs, hp)),
             ("f32", f32, lambda t, h: sa.sorted_dense_adam_apply(*t, sid, gs, h),
              lambda t: sa.sorted_dense_adam_apply_ref(*t, sid, gs, hp)),
             ("fused", f32, lambda t, h: fk.fused_dense_adam_apply(*t, g, *fused_args, h),
              lambda t: fk.fused_dense_adam_ref(*t, g, ids, hp)))
    for form, trio, apply, plain in forms:
        ref, byval, dev = ([x.clone() for x in trio] for _ in range(3))
        rule = AdamOrderRule(ref[0].float())
        rule.step(ref[0].float(), sid, gs, hp)
        plain(ref)
        apply(byval, hp)
        apply(dev, hp_dev)
        torch.cuda.synchronize()
        for got, bv, want, what in zip(dev, byval, ref, ("table", "mu", "nu")):
            check(torch.equal(got, bv), f"{form}: the device-hp form differs from the "
                  f"by-value form in {what}")
            held = (bf16_held(got, want, rule, what)[0] if form == "bf16"
                    else rule.close(got, want, what))
            check(held, f"{form}: the device-hp form disagrees with the plain version in {what}")
        rule.count(f"{'fused_dense_adam_apply' if form == 'fused' else 'sorted_dense_adam_apply'}"
                   f" {form}, hp in device memory")
        del ref, byval, dev, rule
        # each reading from the same state: the Adam pass slows as repeated
        # calls shrink the moments (its divisions take a longer path)
        saved = [x.clone() for x in trio]
        dev_step0[form] = {"by value": [], "hp in device memory": []}
        for _ in range(3):
            for label, h in (("by value", hp), ("hp in device memory", hp_dev)):
                for x, x0 in zip(trio, saved):
                    x.copy_(x0)
                cost = wrapper_cost(f"{form}, {label}", lambda: apply(trio, h))
                dev_step0[form][label].append(cost["device_ms"])
                dev_step0[form].setdefault(f"{label} host us", []).append(cost["host_us"])
        del saved
    log("  sorted_dense_adam_apply and fused_dense_adam_apply, hp in device memory: one "
        "step of each form from one state equals the by-value form bit for bit and holds "
        "against the plain version; Step 0 device ms, three turns each from one state: "
        + "; ".join(f"{k} by value {v['by value']}, from device memory "
                    f"{v['hp in device memory']}" for k, v in dev_step0.items()))
    del f32
    nbytes = 6.0 * V * D * 2 + K * 4 + K * D * 4  # bf16 table, mu, nu in and out; ids; grads
    flops = 16.0 * V * D + K * D                  # the Adam chain per element; the sums
    t_ops, t_bytes = flops / peak[0] * 1e3, nbytes / peak[1] * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  sorted_dense_adam_apply bf16 b_hot_row_zipf: kernel {hot_ms:.4f} ms")
    fused_dev = ("not measurable, the call syncs" if fused_step0["device_ms"] is None
                 else f"{fused_step0['device_ms']:.4f} ms")
    log(f"  sorted_dense_adam_apply bf16 a_alicpp_uniform: kernel {kernel_ms:.4f} ms (Step 0 "
        f"device {step0['device_ms']:.4f} ms), plain {plain_ms:.4f} ms, index_add_ + "
        f"torch.optim.Adam(fused=True) on bf16 {library_ms:.4f} ms; {nbytes / 1e9:.4f} GB, "
        f"bound {bound:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{nbytes / kernel_ms / 1e9:.3f} TB/s achieved ({100 * bound / kernel_ms:.1f}% of "
        f"bound); Step 0 device: f32 form {f32_step0['device_ms']:.4f} ms, "
        f"fused_dense_adam_apply {fused_dev} (back to back {fused_ms:.4f} ms)")
    del table, mu, nu, state, start
    torch.cuda.empty_cache()
    return {"name": "sorted_dense_adam_apply_bf16", "route": "cuda",
            "source": "scenario_wise_rec_tpu_torch/csrc/sorted_adam.cu",
            "replaces": UPDATE_KERNELS["sorted_dense_adam_apply_bf16"][1],
            "form": "bf16 tiles (table, mu, nu bf16)",
            "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "library": "index_add_ + torch.optim.Adam(fused=True) "
            "on bf16 tensors (gradients rounded to bf16)",
            "step0_device_ms": step0["device_ms"], "step0_host_us": step0["host_us"],
            "hot_row_zipf_ms": hot_ms, "block_rows_sweep_ms": sweep,
            "differing_per_step": differing,
            "f32_step0_device_ms": f32_step0["device_ms"],
            "device_hp_step0_in_turns_ms": dev_step0,
            "fused_dense_adam_apply_step0_device_ms": fused_step0["device_ms"],
            "fused_dense_adam_apply_step0_host_us": fused_step0["host_us"],
            "fused_dense_adam_apply_ms": fused_ms}


def shard_boundary_ids(ids, V):
    """``ids`` with their first positions set to every shard boundary of E
    = 2 and 4 (``j V/E - 1`` and ``j V/E``), each 8 times."""
    bounds = sorted({j * V // e + o for e in (2, 4) for j in range(1, e) for o in (-1, 0)})
    out = ids.clone()
    out[:8 * len(bounds)] = torch.as_tensor(np.repeat(bounds, 8))
    return out


def phase_sorted_adam_sharded(seed, peak):
    """``sorted_dense_adam_apply_sharded`` alone at the Ali-CCP shape (V =
    10,741,000, D = 16, K = 94,208) with uniform ids and with the hot row
    plus Zipf ids, ids on every shard boundary: E = 2 and 4 shards in turn
    into row slices of one table, f32 and bf16, hp by value and in device
    memory, one step from one state each, held against the unsharded kernel
    on a copy (0 elements may differ: the shard's tiles are the table's) and
    against the plain version (the sharded one, shard by shard) at row 13's
    rule (``AdamOrderRule``; bf16 ``bf16_held``). Then each shard's Step 0
    beside the unsharded form's, in the same call, and each shard's bound
    (its table, mu and nu read and written once, and the ids and gradient
    rows that fall in it, over the card's rate). Its data come from a
    generator of its own."""
    from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa

    gen = torch.Generator(device="cuda").manual_seed(seed + 28)
    V, D, K = N_SPARSE * VOCAB, 16, N_SPARSE * BATCH
    r = np.random.default_rng(28)
    zipf = lambda: np.minimum(r.zipf(1.2, BATCH) - 1, VOCAB - 1)
    cases = {"a_alicpp_uniform": per_feature(lambda f: r.integers(0, VOCAB, BATCH)),
             "b_hot_row_zipf": per_feature(lambda f: np.full(BATCH, 17) if f == 0 else zipf())}
    cases = {k: shard_boundary_ids(v, V).cuda() for k, v in cases.items()}
    hp = sa.adam_hparams(3, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    hp_dev = torch.tensor(hp, device="cuda")
    start = [torch.randn(V, D, generator=gen, device="cuda"),
             0.01 * torch.randn(V, D, generator=gen, device="cuda"),
             1e-4 * torch.rand(V, D, generator=gen, device="cuda")]
    max_err, out = 0.0, {"step0": {}, "bound_ms": {}}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        state = [t.to(dt) for t in start]
        for case, ids in cases.items():
            g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
            sid, gs = sa.owner_sorted_grads(ids, g)
            whole = [t.clone() for t in state]
            sa.sorted_dense_adam_apply(*whole, sid, gs, hp)
            rule = AdamOrderRule(state[0].float())
            rule.step(state[0].float(), sid, gs, hp)
            seen = []
            for e in (2, 4):
                vl = V // e
                plain = [t.clone() for t in state]
                for j in range(e):
                    sa.sorted_dense_adam_apply_sharded_ref(*(t[j * vl:(j + 1) * vl] for t in plain),
                                                           sid, gs, hp, row0=j * vl)
                for form, h in (("by value", hp), ("hp in device memory", hp_dev)):
                    got = [t.clone() for t in state]
                    for j in range(e):
                        sa.sorted_dense_adam_apply_sharded(
                            *(t[j * vl:(j + 1) * vl] for t in got), sid, gs, h, row0=j * vl)
                    torch.cuda.synchronize()
                    differ = sum(int((a != b).sum()) for a, b in zip(got, whole))
                    largest = max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(got, whole))
                    check(differ == 0, f"sharded {name} {case} E={e} {form}: {differ} elements "
                          f"differ from the unsharded kernel, the largest by {largest:.3e}")
                    for a, b, what in zip(got, plain, ("table", "mu", "nu")):
                        held = (bf16_held(a, b, rule, what)[0] if dt == torch.bfloat16
                                else rule.close(a, b, what))
                        check(held, f"sharded {name} {case} E={e} {form}: {what} disagrees "
                              "with the plain version")
                        max_err = max(max_err, (a.float() - b.float()).abs().max().item())
                    seen.append(f"E={e} {form}: {differ} of {3 * V * D} elements differ")
                    del got
                del plain
            log(f"  sorted_dense_adam_apply_sharded {name} {case}: V {V}, K {K}, one step from one "
                f"state; against the unsharded kernel: " + "; ".join(seen)
                + f"; the plain version held, max_abs_err so far {max_err:.3e}")
            rule.count(f"sorted_dense_adam_apply_sharded {name} {case}")
            del whole, rule
        # Step 0, uniform ids: each shard's and the unsharded form's, each
        # reading from the same state (the pass slows as the moments shrink)
        ids = cases["a_alicpp_uniform"]
        g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
        sid, gs = sa.owner_sorted_grads(ids, g)
        saved = [t.clone() for t in state]

        def restore():
            for t, t0 in zip(state, saved):
                t.copy_(t0)

        restore()
        unsharded = wrapper_cost(f"sorted_dense_adam_apply {name} (unsharded)",
                                 lambda: sa.sorted_dense_adam_apply(*state, sid, gs, hp))
        out["step0"][f"{name} unsharded"] = unsharded
        for e in (2, 4):
            vl = V // e
            bounds = []
            for j in range(e):
                # the shard's table, mu and nu read and written once, and the
                # ids and gradient rows that fall in the shard (the rest it
                # only passes over in its binary search)
                n_in = int(((sid >= j * vl) & (sid < (j + 1) * vl)).sum())
                moved = 6.0 * vl * D * dt.itemsize + n_in * (4 + 4 * D)
                flops = 16.0 * vl * D + n_in * D  # the Adam chain per element; the sums
                check(moved / peak[1] >= flops / peak[0], "the sharded update bound by operations")
                out["bound_ms"][f"{name} E={e} shard {j}"] = moved / peak[1] * 1e3
                bounds.append((moved / peak[1] * 1e3, moved, n_in))
                restore()
                shard = [t[j * vl:(j + 1) * vl] for t in state]
                cost = wrapper_cost(f"sorted_dense_adam_apply_sharded {name} E={e} shard {j}",
                                    lambda: sa.sorted_dense_adam_apply_sharded(
                                        *shard, sid, gs, hp, row0=j * vl))
                out["step0"][f"{name} E={e} shard {j}"] = cost
            readings = [out["step0"][f"{name} E={e} shard {j}"]["device_ms"] for j in range(e)]
            log(f"  sorted_dense_adam_apply_sharded {name} E={e}: Step 0 device ms by shard "
                f"{[round(x, 4) for x in readings]}, bound by shard "
                f"{[round(b[0], 4) for b in bounds]} ms ({[round(b[1] / 1e9, 4) for b in bounds]} "
                f"GB over {peak[1] / 1e12:g} TB/s, the shard's ids {[b[2] for b in bounds]} of "
                f"{K}; the unsharded form's / E {unsharded['device_ms'] / e:.4f} ms)")
        del saved, state
    # the plain version and the nearest PyTorch composition on one shard of
    # E = 2, f32 (timed here only; the port never calls the composition)
    ids = cases["a_alicpp_uniform"]
    g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(ids, g)
    vl = V // 2
    shard = [start[0][:vl].clone(), start[1][:vl].clone(), start[2][:vl].clone()]
    plain_ms = time_ms(lambda: sa.sorted_dense_adam_apply_sharded_ref(*shard, sid, gs, hp, row0=0),
                       reps=3, inner=5)
    kernel_ms = time_ms(lambda: sa.sorted_dense_adam_apply_sharded(*shard, sid, gs, hp, row0=0))
    mine = sid < vl
    local_ids, local_g = sid[mine].long(), gs[mine]
    param = torch.nn.Parameter(shard[0].clone())
    param.grad = torch.zeros_like(param)
    opt = torch.optim.Adam([param], lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-5,
                           fused=True)

    def library():
        param.grad.zero_()
        param.grad.index_add_(0, local_ids, local_g)
        opt.step()

    library_ms = time_ms(library, reps=3, inner=10)
    del param, opt, shard, start
    torch.cuda.empty_cache()
    ms = out["step0"]["f32 E=2 shard 0"]["device_ms"]
    log(f"  sorted_dense_adam_apply_sharded f32 E=2 shard 0: Step 0 {ms:.4f} ms, back to back "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ + torch.optim.Adam(fused=True) "
        f"{library_ms:.4f} ms, bound {out['bound_ms']['f32 E=2 shard 0']:.4f} ms")
    return {"name": "sorted_dense_adam_apply_sharded", "route": "cuda",
            "source": "scenario_wise_rec_tpu_torch/csrc/sorted_adam.cu",
            "replaces": UPDATE_KERNELS["sorted_dense_adam_apply_sharded"][1],
            "form": "one shard of E = 2, f32 (the mesh path's); every E and type below",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": out["bound_ms"]["f32 E=2 shard 0"], "bound_by": "bytes",
            "library_ms": library_ms, "back_to_back_ms": kernel_ms,
            "step0_device_ms": {k: v["device_ms"] for k, v in out["step0"].items()},
            "step0_host_us": {k: v["host_us"] for k, v in out["step0"].items()},
            "bound_ms_by_form": out["bound_ms"]}


MESH_SHAPE = (2, 2)  # (data, embed): four ranks on the one card, over gloo
# Two correct runs of MMOE's fit part step by step: Adam moves an element
# whose gradient is cancellation noise by up to lr, whichever order summed
# it, and the next steps carry that on. So the (2, 2) mesh is gated to
# GROUP_TOL where both sides start from one state (its first step), and its
# later steps and metrics against one process padded with MESH_PAD weight-0
# rows a batch (exact zeros in every sum, other shapes for every product),
# which parts from one process the same way but less: the mesh's gaps may be
# at most MESH_GAP_RATIO times the padded run's (H100 80GB HBM3, 700 W: 10x
# on steps 2-9 and on the padded step 10, 6.4x on AUC, 4.8x on logloss), or
# MESH_GAP_FLOOR where the padded run's gap is near 0. That gate is loose:
# a fault that shows only on the padded step (every data rank taking rank
# 0's weights) stayed inside it. So a second fit of MESH_TAIL rows, one
# padded step from the common start in which data rank 1 holds no real row,
# is gated to GROUP_TOL as the first step is.
MESH_PAD = 512
MESH_GAP_RATIO = 30
MESH_GAP_FLOOR = {"loss": 1e-4, "auc": 1e-3, "logloss": 1e-3}
MESH_TAIL = 123
N_MESH = 9 * BATCH + MESH_TAIL  # 10 train steps, the last padded


def mesh_fit(seed, mesh, out_dir, pad_rows=0, first_step=True, n_rows=N_MESH, validate=True):
    """MMOE's ``fit`` at Ali-CCP width in the sorted f32 mode, one epoch of
    ``n_rows`` rows with validation (its checkpoint into ``out_dir``), then
    ``evaluate_multi_domain_loss`` (neither without ``validate``), on
    ``mesh`` or in one process (None):
    the losses of every step, the metrics, the update kernels' launches, the
    paths of a checkpoint saved after the first step (with ``first_step``)
    and of ``fit``'s, and the seconds. ``pad_rows``: each train batch padded
    with that many weight-0 copies of its first row (the same math: they add
    exact zeros to every sum; but every product and reduction has another
    shape, so the card sums in another order)."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    model = build_ali_model(seed + 1)
    x, y = synthetic_eval_set(seed + 4, n_rows)
    vx, vy = synthetic_eval_set(seed + 5, 2 * BATCH + 7)
    train = BatchIterable(ColumnarDataset(x, y), BATCH, shuffle=True, seed=seed)
    val = BatchIterable(ColumnarDataset(vx, vy), BATCH)
    t = CTRTrainer(model, sparse_embedding_updates=True, sparse_update_impl="sorted",
                   n_epoch=1, seed=seed, mesh=mesh, model_path=out_dir, data_set_type="mesh")
    del model
    losses, step, first = [], t._train_step, []

    def recorded(x, y, w, **kw):  # each step's global loss, read after the epoch
        if pad_rows:
            pad = lambda v: torch.cat([v, v[:1].expand(pad_rows, *v.shape[1:])])
            x, y, w = {k: pad(v) for k, v in x.items()}, pad(y), torch.cat(
                [w, w.new_zeros(pad_rows)])
        losses.append(step(x, y, w, **kw))
        if len(losses) == 1 and first_step:  # one step from the common start
            first.append(t.save(os.path.join(out_dir, "first_step")))
        return losses[-1]

    t._train_step = recorded
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    path = t.fit(train, val if validate else None)
    metrics = t.evaluate_multi_domain_loss(t.model, val, DOMAINS) if validate else []
    torch.cuda.synchronize()
    counts = read_counts()
    return {"losses": [float(l) for l in losses], "metrics": list(metrics), "counts": counts,
            "first_step": first[0] if first else None, "path": path,
            "seconds": time.perf_counter() - t0,
            "steps": len(train), "max_memory_mb": torch.cuda.max_memory_allocated() / 1e6}


def mesh_rank_main(args):
    """One rank of ``[4] training mmoe mesh``: join the gloo group, run
    :func:`mesh_fit` on the mesh (and, with more than one data rank, its
    one padded step of ``MESH_TAIL`` rows) and write its results as JSON."""
    from scenario_wise_rec_tpu_torch.parallel import init_distributed, make_mesh

    n, e = (int(v) for v in args.mesh_shape.split(","))
    init_distributed("gloo", f"file://{os.path.join(args.mesh_dir, 'rendezvous')}",
                     args.mesh_rank, n * e)
    mesh = make_mesh(n, e)
    log(f"  rank {args.mesh_rank}: {mesh}, device {torch.cuda.current_device()}")
    res = mesh_fit(args.seed, mesh, args.mesh_dir, first_step=n > 1)
    if n > 1:
        res["tail"] = mesh_fit(args.seed, mesh, os.path.join(args.mesh_dir, "tail"),
                               first_step=False, n_rows=MESH_TAIL, validate=False)
    with open(os.path.join(args.mesh_dir, f"rank{args.mesh_rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def checkpoint_groups(path):
    """A checkpoint's tensors on the card in ``trainer_groups``' groups (the
    packed table, the Adam step its moments imply, the dense parameters and
    BN buffers, the BN-cancelled ones), and the first moments by tensor
    name, for ``noisy_checkpoint_elements``."""
    from scenario_wise_rec_tpu_torch.ops.kernels.sorted_adam import adam_hparams

    with np.load(path, allow_pickle=False) as f:
        a = {k: torch.from_numpy(f[k]).cuda() for k in f.files if not k.startswith("__")}
    sd = {k[len("model/"):]: v for k, v in a.items() if k.startswith("model/")}
    table = sd.pop("embedding.packed")
    lr, _, _, _, bc1r, bc2r, eps = adam_hparams(int(a["opt/emb/step"]), 1e-3, 0.0, 0.9, 0.999,
                                                1e-8)
    implied = lr * (a["opt/emb/mu"] * bc1r) / (torch.sqrt(a["opt/emb/nu"] * bc2r) + eps)
    moments = {k[len("opt/base/"):-len("/exp_avg")]: v for k, v in a.items()
               if k.startswith("opt/base/") and k.endswith("/exp_avg")}
    moments["embedding.packed"] = a["opt/emb/mu"]
    cancelled = lambda k: BN_BIAS.search(k) is not None
    return ({"table": {"embedding.packed": table},
             "table moments": {"embedding.packed": implied}, "bf16 store": {},
             "dense": {k: v for k, v in sd.items() if not cancelled(k)},
             "BN-cancelled": {k: v for k, v in sd.items() if cancelled(k)}}, moments)


def spawn_mesh(seed, shape, out_dir):
    """Run :func:`mesh_fit` on a ``shape`` mesh of ranks, each this script
    (``--mesh-rank``) on the one card; every rank's results and the ranks'
    wall seconds with start-up. Prints rank 0's output."""
    n, e = shape
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--mesh-rank", str(r), "--mesh-shape", f"{n},{e}",
                               "--mesh-dir", out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
             for r in range(n * e)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for line in logs[0].splitlines():
        log(f"  [{n} x {e} rank 0] {line.strip()}")
    for r, (p, out) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"mesh {shape} rank {r} exited {p.returncode}:\n{out[-4000:]}")
    res = []
    for r in range(n * e):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res, seconds


def checkpoints_equal(a, b):
    """The keys of two checkpoints whose tensors differ in any bit."""
    with np.load(a, allow_pickle=False) as fa, np.load(b, allow_pickle=False) as fb:
        return [k for k in fa.files if not k.startswith("__")
                and fa[k].tobytes() != fb[k].tobytes()]


def phase_train_mesh(seed, card):
    """MMOE at Ali-CCP width trained by ``CTRTrainer(mesh=make_mesh(2, 2))``
    in four processes on the one card over gloo (the kernels built by this
    process first, so the ranks only load them), one epoch of 10 steps with
    validation and an evaluation, against the same ``fit`` in one process
    on the card from the same weights and batches: the first step's loss
    (one state, the sums in another order) within 1e-6 of it; the table,
    the Adam step its moments imply, the dense parameters and BN buffers
    one step from the common start (each side's checkpoint after its first
    step) within ``GROUP_TOL`` (elements whose first moments part by
    NOISY_MOMENT, their gradients cancellation noise, held to NOISE_ATOL,
    counted, at most NOISY_SHARE); the later losses (the largest relative
    gap over the full steps 2-9, and the padded step 10's) and the AUC and
    logloss gaps within MESH_GAP_RATIO times those of a third fit in this
    process with each batch padded by MESH_PAD weight-0 rows, or
    MESH_GAP_FLOOR; every rank's metrics the same and finite; a second fit
    of one padded step of MESH_TAIL rows (data rank 1 holds none of them)
    from the common start, its loss within 1e-6 and its state within
    ``GROUP_TOL`` as for the first step; the sharded kernel once a step a
    rank and nothing else launched there.
    Then a (1, 2) mesh, whose ranks see the whole batch and so run every
    product and reduction of one process at its shapes: its losses,
    metrics and checkpoint equal one process's bit for bit (the embed axis
    alone: the sharded lookup and update are exact)."""
    n, e = MESH_SHAPE
    world = n * e
    with tempfile.TemporaryDirectory() as tmp:
        res, ranks_s = spawn_mesh(seed, MESH_SHAPE, os.path.join(tmp, "mesh"))
        one = mesh_fit(seed, None, os.path.join(tmp, "single"))
        steps = one["steps"]
        # how far one process parts from itself when only the shapes of its
        # sums change
        control = mesh_fit(seed, None, os.path.join(tmp, "control"), pad_rows=MESH_PAD,
                           first_step=False)
        os.remove(control["path"])
        floor = [abs(a - b) / abs(b) for a, b in zip(control["losses"], one["losses"])]
        failed = []  # every gate's reading is printed before the first failure raises

        def gate(ok, what):
            if not ok:
                failed.append(what)

        def within_control(what, gap, control_gap, floor_key):
            limit = max(MESH_GAP_RATIO * control_gap, MESH_GAP_FLOOR[floor_key])
            gate(gap <= limit, f"mesh (2, 2) {what}: gap {gap:.3e} vs one process, above "
                 f"{limit:.3e} ({MESH_GAP_RATIO} x the padded run's {control_gap:.3e}, at least "
                 f"{MESH_GAP_FLOOR[floor_key]:g})")

        def launched_sharded(m, shape):
            gate(m["counts"]["sorted_dense_adam_apply_sharded"] == m["steps"]
                 and not any(v for k, v in m["counts"].items()
                             if k != "sorted_dense_adam_apply_sharded"),
                 f"mesh {shape}: launches {m['counts']} (want the sharded kernel "
                 f"{m['steps']})")

        def one_state_gate(what, mesh_path, one_path):
            """The state after one step from the common start: the
            card-vs-CPU gate's rule, its noise-dominated elements as for
            NOISY_MODELS."""
            mesh_groups, mesh_mu = checkpoint_groups(mesh_path)
            one_groups, one_mu = checkpoint_groups(one_path)
            noisy, n_noisy, n_all = {}, 0, 0
            for k, mb in one_mu.items():
                noisy[k] = (mesh_mu[k] - mb).abs() > NOISY_MOMENT * mb.abs()
                n_noisy, n_all = n_noisy + int(noisy[k].sum()), n_all + mb.numel()
            gaps_g = group_gaps(mesh_groups, one_groups, noisy)
            log(f"  mesh (2, 2) vs one process, {what}: {gaps_line(gaps_g)}; {n_noisy} of "
                f"{n_all} elements noise-dominated (first moments {NOISY_MOMENT:g} apart)")
            gate(not outside(gaps_g) and n_noisy <= NOISY_SHARE * n_all,
                 f"mesh vs one process, {what}: "
                 f"{ {g: gaps_g[g][3] for g in outside(gaps_g)} } outside their tolerance")
            del mesh_groups, one_groups, mesh_mu, one_mu, noisy
            torch.cuda.empty_cache()

        for r, m in enumerate(res):
            launched_sharded(m, MESH_SHAPE)
            gaps = [abs(a - b) / abs(b) for a, b in zip(m["losses"], one["losses"])]
            gate(len(gaps) == steps and gaps[0] <= 1e-6,
                 f"mesh rank {r}: first loss {m['losses'][0]} vs one process "
                 f"{one['losses'][0]}")
            if len(gaps) == steps:
                within_control(f"rank {r} losses of steps 2-{steps - 1}", max(gaps[1:-1]),
                               max(floor[1:-1]), "loss")
                within_control(f"rank {r} loss of the padded step {steps}", gaps[-1],
                               floor[-1], "loss")
            gate(m["metrics"] == res[0]["metrics"]
                 and all(np.isfinite(v) for v in m["metrics"][0] + m["metrics"][1]
                         + m["metrics"][2:]), f"rank {r}'s metrics {m['metrics']} differ from "
                 f"rank 0's or are not finite")
        gate(one["counts"]["sorted_dense_adam_apply"] == steps
             and one["counts"]["sorted_dense_adam_apply_sharded"] == 0,
             f"one process: launches {one['counts']}")
        ll1, auc1, tll1, tauc1 = one["metrics"]

        def metric_gaps(m):
            return (max(abs(a - b) for a, b in zip(m[1] + [m[3]], auc1 + [tauc1])),
                    max(abs(a - b) / b for a, b in zip(m[0] + [m[2]], ll1 + [tll1])))

        auc_gap, ll_gap = metric_gaps(res[0]["metrics"])
        auc_floor, ll_floor = metric_gaps(control["metrics"])
        within_control("AUC", auc_gap, auc_floor, "auc")
        within_control("logloss", ll_gap, ll_floor, "logloss")
        one_state_gate("one step from one state", res[0]["first_step"], one["first_step"])
        for key in ("first_step", "path"):  # every rank names rank 0's file
            os.remove(res[0][key])
        # one padded step from the common start, data rank 1 without a real row
        one_tail = mesh_fit(seed, None, os.path.join(tmp, "single_tail"), first_step=False,
                            n_rows=MESH_TAIL, validate=False)
        for r, m in enumerate(res):
            tail = m["tail"]
            launched_sharded(tail, MESH_SHAPE)
            tail_gap = (abs(tail["losses"][0] - one_tail["losses"][0])
                        / abs(one_tail["losses"][0]) if len(tail["losses"]) == 1 else None)
            gate(tail_gap is not None and tail_gap <= 1e-6,
                 f"mesh rank {r}: the padded step's loss {tail['losses']} vs one process "
                 f"{one_tail['losses']}")
        one_state_gate(f"one padded step ({MESH_TAIL} rows) from one state",
                       res[0]["tail"]["path"], one_tail["path"])
        os.remove(res[0]["tail"]["path"])
        os.remove(one_tail["path"])
        # the embed axis alone, bit for bit
        res12, ranks12_s = spawn_mesh(seed, (1, 2), os.path.join(tmp, "mesh12"))
        for r, m in enumerate(res12):
            launched_sharded(m, (1, 2))
            gate(m["losses"] == one["losses"] and m["metrics"] == one["metrics"],
                 f"mesh (1, 2) rank {r}: losses {m['losses']}, metrics {m['metrics']} vs one "
                 f"process {one['losses']}, {one['metrics']}")
        differ = checkpoints_equal(res12[0]["path"], one["path"])
        log(f"  mesh (1, 2) vs one process: losses and metrics "
            f"{'equal' if res12[0]['losses'] == one['losses'] else 'differ'}; checkpoint "
            f"tensors at the fit's end that differ in any bit: {differ}")
        gate(not differ, f"mesh (1, 2): checkpoint tensors {differ} differ from one process's")
    log(f"  against one process (gated at {MESH_GAP_RATIO} x the padded run's), relative "
        f"per-step loss gaps: the (2, 2) mesh "
        f"{[f'{g:.1e}' for g in gaps]}, one process with {MESH_PAD} weight-0 rows a batch "
        f"{[f'{g:.1e}' for g in floor]}; auc gap {auc_gap:.2e} (padded {auc_floor:.2e}), "
        f"logloss gap {ll_gap:.2e} (padded {ll_floor:.2e}); one padded step from one state "
        f"{tail_gap}")
    log(f"  mesh (2, 2): backend gloo, world size {world}, on {card}; losses "
        f"{[round(l, 6) for l in res[0]['losses']]} (one process "
        f"{[round(l, 6) for l in one['losses']]}); auc "
        f"{[round(a, 6) for a in res[0]['metrics'][1]]} total {res[0]['metrics'][3]:.6f} on "
        f"every rank (one process {tauc1:.6f}); rank memory peak MB "
        f"{[round(m['max_memory_mb'], 1) for m in res]}; fit + evaluation s by rank "
        f"{[round(m['seconds'], 2) for m in res]} (one process {one['seconds']:.2f}); the ranks' "
        f"processes {ranks_s:.1f} s with start-up, the (1, 2) mesh's {ranks12_s:.1f} s")
    check(not failed, "; ".join(failed))
    return {"launches": sum(m["counts"]["sorted_dense_adam_apply_sharded"] for m in res),
            "launches_by_rank": [m["counts"]["sorted_dense_adam_apply_sharded"] for m in res],
            "mesh": {"data": n, "embed": e, "backend": "gloo", "steps": steps,
                     "loss_gaps": gaps, "padded_control_loss_gaps": floor,
                     "rank_seconds": [m["seconds"] for m in res],
                     "rank_peak_memory_mb": [m["max_memory_mb"] for m in res],
                     "one_process_seconds": one["seconds"],
                     "padded_step_loss_gap": tail_gap,
                     "mesh_1x2_bit_for_bit": not differ}}


def update_entry(name, max_err, kernel_ms, plain_ms, flops, moved, peak, library_ms, **extra):
    """The kernels-line entry of an embedding-update kernel, its bound from
    ``flops`` (f32) and ``moved`` bytes."""
    t_ops, t_bytes = flops / peak[0] * 1e3, moved / peak[1] * 1e3
    bound = max(t_ops, t_bytes)
    source, replaces = UPDATE_KERNELS[name]
    log(f"  {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; {moved / 1e6:.2f} MB, "
        f"bound {bound:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{100 * bound / kernel_ms:.1f}% of bound")
    return {"name": name, "route": "cuda",
            "source": f"scenario_wise_rec_tpu_torch/csrc/{source}.cu", "replaces": replaces,
            "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, **extra}


def ali_id_cases(r):
    """The main path's ids (23 x 4096 uniform, each feature in its span), a
    hot row (feature 0's 4096 ids one row) with Zipf ids in the rest, and
    two alias segments of one owner (4096 ids each from one 2000-row span,
    so many ids recur across the two)."""
    zipf = lambda: np.minimum(r.zipf(1.2, BATCH) - 1, VOCAB - 1)
    return {"a_alicpp_uniform": per_feature(lambda f: r.integers(0, VOCAB, BATCH)),
            "b_hot_row_zipf": per_feature(lambda f: np.full(BATCH, 17) if f == 0 else zipf()),
            "c_alias_segments": torch.as_tensor(r.integers(0, 2000, 2 * BATCH))}


def run_length_line(ids):
    counts = torch.unique(ids, return_counts=True)[1]
    return f"{counts.numel()} distinct ids, longest run {counts.max().item()}"


def threshold_ids(gen, rows, n, long_run, vocab=VOCAB):
    """``[rows, n]`` uniform ids with, in row 0, a run of ``long_run`` (the
    longest run the lane groups sum) and one of ``long_run + 1`` (the
    shortest the whole block sums), scattered over the row."""
    i2 = torch.randint(0, vocab, (rows, n), generator=gen, device="cuda")
    at = torch.randperm(n, generator=gen, device="cuda")
    i2[0, at[:long_run]] = vocab + 1
    i2[0, at[long_run:2 * long_run + 1]] = vocab + 2
    return i2


def check_segsum(rk, name, i2, g):
    """One segment-sum call against its plain version: within n ulp of each
    run's sum of |g|, every duplicate's sum bit-identical, a second call
    equal. Returns (output, max |error|)."""
    got = rk.occurrence_segsum(i2, g)
    torch.cuda.synchronize()
    want = rk.occurrence_segsum_ref(i2, g)
    # two f32 sums of a run's n terms in other orders lie within n ulp of
    # the run's sum of |g| (the plain index_add_ adds with atomics); a
    # singleton is exact
    count = rk.occurrence_segsum_ref(i2, torch.ones_like(g[..., :1]))
    tol = count * 2.0 ** -23 * rk.occurrence_segsum_ref(i2, g.abs())
    err = (got - want).abs()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"segsum {name}")
    check(bool((err <= tol).all()), f"occurrence_segsum {name} disagrees with plain")
    for f in range(i2.shape[0]):
        sid, perm = torch.sort(i2[f].to(torch.int32), stable=True)
        o, same = got[f][perm], sid[1:] == sid[:-1]
        check(torch.equal(o[1:][same], o[:-1][same]),
              f"occurrence_segsum {name}: duplicates' sums differ")
    check(torch.equal(rk.occurrence_segsum(i2, g), got), f"segsum {name} not repeatable")
    err = err.max().item() if err.numel() else 0.0
    runs = run_length_line(i2) if i2.numel() else "no ids"
    log(f"  occurrence_segsum {name}: {runs}, max_abs_err {err:.3e}, duplicates' sums "
        "bit-identical, a second call equal")
    return got, err


@contextlib.contextmanager
def blocks_per_row(rk, splits):
    """The shared-memory segment sum's blocks a row set to ``splits`` for
    the checks and the sweep (the result does not depend on it)."""
    default, rk._splits = rk._splits, lambda rows, device: splits
    try:
        yield
    finally:
        rk._splits = default


def phase_row_update(gen, peak):
    """``occurrence_segsum`` and ``scatter_rows`` against their plain
    versions. The segment sum at the Ali-CCP ids as the trainer passes them
    (int64, one ``[23, 4096]`` launch) and as int32; a hot row (one
    feature's 4096 ids one row) with Zipf ids; two alias segments of one
    owner; sentinel ids (negative, and at and above the vocabulary); runs
    just below and just above the long-run threshold; ragged N with D = 3;
    rows at the shared-memory route's limit (16384) and past it (the sorted
    route, also at ``[1, 94208]``); K = 0; and bit-equal sums for every
    ``splits``. The scatter into the occurrence mode's combined store
    ``[10,741,000, 48]`` (its bulk copies) with the same ids as int64 and
    int32, sentinel ids (-1, -V and negative twins wrap once; -V-1, >= V
    drop), and K = 0, and rows of 5 and 1024 floats (its lanes) with the
    same sentinels, and the winner update's write-back into ``[V, 16]``
    (:func:`winner_write_back_cases`): exact. Then each kernel's time beside its bound, its plain
    version and (the scatter) ``index_copy_``, and step 0's readings: device
    ms with the host kept out, host µs and launches per call, for the
    kernels, their plain versions, ``index_copy_`` and the whole occurrence
    update."""
    from scenario_wise_rec_tpu_torch.ops.kernels import row_update as rk
    from scenario_wise_rec_tpu_torch.train import optim

    V, D, W, K = N_SPARSE * VOCAB, 16, 48, N_SPARSE * BATCH
    limit, long_run = rk.ROW_LIMIT, rk.LONG_RUN
    r = np.random.default_rng(2)
    ids = {k: v.cuda() for k, v in ali_id_cases(r).items()}
    ali, hot = ids["a_alicpp_uniform"], ids["b_hot_row_zipf"]
    sentinels = torch.tensor([-1, -7, V, V + 3, 2 ** 31 - 1, -2 ** 31], device="cuda")
    seg_cases = {
        "a_alicpp_uniform_23x4096": ali.view(N_SPARSE, BATCH),
        "a_alicpp_uniform_23x4096_int32": ali.view(N_SPARSE, BATCH).to(torch.int32),
        "b_hot_row_zipf_23x4096": hot.view(N_SPARSE, BATCH),
        "c_alias_segments_1x8192": ids["c_alias_segments"][None],
        "d_ragged_d3_3x4097": torch.randint(0, 50, (3, 4097), generator=gen, device="cuda"),
        "e_sentinels_2x4096": torch.cat([ali[:2 * BATCH - 24], sentinels.repeat(4)]).view(2, -1),
        f"f_runs_{long_run}_and_{long_run + 1}_4x4096": threshold_ids(gen, 4, BATCH, long_run),
        f"g_at_the_limit_2x{limit}": torch.randint(0, 3000, (2, limit), generator=gen,
                                                   device="cuda"),
        f"h_past_the_limit_2x{limit + 1}": torch.randint(0, 3000, (2, limit + 1),
                                                         generator=gen, device="cuda"),
        "i_alicpp_uniform_1x94208_sorted_route": ali[None],
        "j_hot_row_zipf_1x94208_sorted_route": hot[None],
        "k_no_ids": torch.zeros(1, 0, dtype=torch.long, device="cuda"),
    }
    seg_err = 0.0
    for name, i2 in seg_cases.items():
        d = 3 if "d3" in name else D
        g = torch.randn(*i2.shape, d, generator=gen, device="cuda")
        got, err = check_segsum(rk, name, i2, g)
        seg_err = max(seg_err, err)
        if name.startswith(("a_", "b_", "f_")):
            for splits in (1, 2, 5, 12):
                with blocks_per_row(rk, splits):
                    check(torch.equal(rk.occurrence_segsum(i2, g), got),
                          f"occurrence_segsum {name}: splits {splits} changes the sums")
    log(f"  occurrence_segsum: splits 1, 2, 5 and 12 give the same bits (cases a, b, f)")

    # the trainer's call: 23 segments of 4096 int64 ids, one owner each
    segments = tuple((f"f{f}", f * BATCH, BATCH) for f in range(N_SPARSE))
    g = torch.randn(K, D, generator=gen, device="cuda")
    trainer_call = lambda i1: lambda: optim._grouped_occurrence_segsum(g, i1, segments)
    seg_ms = time_ms(trainer_call(ali))
    seg_hot_ms = time_ms(trainer_call(hot))
    seg_plain_ms = time_ms(lambda: rk.occurrence_segsum_ref(ali.view(N_SPARSE, BATCH),
                                                            g.view(N_SPARSE, BATCH, D)),
                           reps=3, inner=5)
    log(f"  occurrence_segsum as the trainer calls it: {seg_ms:.4f} ms, hot row "
        f"{seg_hot_ms:.4f} ms (back-to-back wrapper calls); step 0, per call:")
    seg_cost = wrapper_cost("occurrence_segsum, the trainer's call", trainer_call(ali))
    seg_hot = wrapper_cost("occurrence_segsum, the trainer's call, hot row", trainer_call(hot))
    seg_plain = wrapper_cost("occurrence_segsum_ref [23, 4096]", lambda: rk.occurrence_segsum_ref(
        ali.view(N_SPARSE, BATCH), g.view(N_SPARSE, BATCH, D)))
    i2, g2 = ali.view(N_SPARSE, BATCH), g.view(N_SPARSE, BATCH, D)
    sweep = {}
    for s in (1, 2, 3, 5, 6, 12):
        with blocks_per_row(rk, s):
            sweep[s] = device_and_host(lambda: rk.occurrence_segsum(i2, g2))[0]
    log(f"  occurrence_segsum [23, 4096] device ms by splits (default "
        f"{rk._splits(N_SPARSE, torch.cuda.current_device())}): "
        + ", ".join(f"{s}: {t:.4f}" for s, t in sweep.items()))
    big = torch.randint(0, VOCAB, (N_SPARSE, limit), generator=gen, device="cuda")
    gbig = torch.randn(N_SPARSE, limit, D, generator=gen, device="cuda")
    at_limit = device_and_host(lambda: rk.occurrence_segsum(big, gbig))[0]
    # one row of limit + 1 ids, read from the first limit + 1 of the 23 rows
    big, gbig = big.view(1, -1)[:, :limit + 1], gbig.view(1, -1, D)[:, :limit + 1]
    past = device_and_host(lambda: rk.occurrence_segsum(big, gbig))[0]
    sorted_route = device_and_host(lambda: rk.occurrence_segsum(ali[None], g[None]))[0]
    log(f"  occurrence_segsum device ms: [23, {limit}] {at_limit:.4f} (the bench's batch); "
        f"[1, {limit + 1}] {past:.4f} and [1, 94208] {sorted_route:.4f} (the sorted route)")
    del big, gbig
    segsum = update_entry("occurrence_segsum", seg_err, seg_ms, seg_plain_ms,
                          float(K * D), K * (8.0 + 2 * D * 4), peak, None,
                          hot_row_zipf_ms=seg_hot_ms, device_ms=seg_cost["device_ms"],
                          host_us=seg_cost["host_us"],
                          launches_per_call=seg_cost["launches_per_call"],
                          hot_row_device_ms=seg_hot["device_ms"],
                          plain_device_busy_ms=seg_plain["profiled_busy_ms"],
                          splits_device_ms=sweep, row_limit_23x16384_device_ms=at_limit,
                          sorted_route_1x94208_device_ms=sorted_route)

    dst = torch.randn(V, W, generator=gen, device="cuda")
    narrow = torch.randn(100_003, 5, generator=gen, device="cuda")  # W % 4 != 0: the lanes
    wide = torch.randn(3000, 1024, generator=gen, device="cuda")  # past the bulk copies' 896
    def negatives(i1, v):
        """``i1`` with -1, -7, -v, -v-1, v, v+3, +-2^31 and the wrapped
        twins of its first 100 ids: a negative id wraps once, as the XLA
        form of the reference does, and what is still outside [0, v) drops."""
        return torch.cat([torch.tensor([-1, -7, -v, -v - 1, v, v + 3, 2 ** 31 - 1, -2 ** 31],
                                       device="cuda"), i1[:100] - v, i1])

    sc_cases = {**ids, "d_sentinels": negatives(ali[:20_000], V),
                "e_no_ids": torch.zeros(0, dtype=torch.long, device="cuda"),
                "f_lanes_w5": negatives(torch.randint(0, 100_003, (50_000,), generator=gen,
                                                      device="cuda"), 100_003),
                "g_lanes_w1024": negatives(torch.randint(0, 3000, (5000,), generator=gen,
                                                         device="cuda"), 3000)}
    for name, i1 in sc_cases.items():
        into = {"f_lanes_w5": narrow, "g_lanes_w1024": wide}.get(name, dst)
        # duplicates carry identical rows, as the segsum makes them: a
        # negative id and its wrapped twin too
        _, inv = torch.unique(torch.where(i1 < 0, i1 + into.shape[0], i1), return_inverse=True)
        rows = torch.randn(i1.numel(), into.shape[1], generator=gen, device="cuda")[inv]
        want = rk.scatter_rows_ref(into.clone(), i1, rows)
        for dtype in (torch.int64, torch.int32):
            got = into.clone()
            rk.scatter_rows(got, i1.to(dtype), rows)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"scatter_rows {name} ({dtype}) disagrees with plain")
            del got
        log(f"  scatter_rows {name}: K {i1.numel()} into {tuple(into.shape)}"
            f"{', negative ids wrapped once' if bool((i1 < 0).any()) else ''}, equal to the "
            "plain version with int64 and int32 ids")
        del want
    del narrow, wide
    winner_ms = winner_write_back_cases(rk, {k: ids[k] for k in ("a_alicpp_uniform",
                                                                 "b_hot_row_zipf")}, gen, V)
    _, inv = torch.unique(ali, return_inverse=True)
    rows = torch.randn(K, W, generator=gen, device="cuda")[inv]
    i32 = ali.to(torch.int32)
    # int64 ids, as the trainer passes them
    sc_ms = time_ms(lambda: rk.scatter_rows(dst, ali, rows))
    sc_plain_ms = time_ms(lambda: rk.scatter_rows_ref(dst, ali, rows))
    # one PyTorch call computing the same (timed here only; the port never calls it)
    sc_lib_ms = time_ms(lambda: dst.index_copy_(0, ali, rows))
    log("  scatter_rows, step 0, per call:")
    sc_lib = wrapper_cost("index_copy_, int64 ids", lambda: dst.index_copy_(0, ali, rows))
    sc_cost = wrapper_cost("scatter_rows, int64 ids", lambda: rk.scatter_rows(dst, ali, rows))
    sc_cost32 = wrapper_cost("scatter_rows, int32 ids", lambda: rk.scatter_rows(dst, i32, rows))
    sc_plain = wrapper_cost("scatter_rows_ref, int64 ids",
                            lambda: rk.scatter_rows_ref(dst, ali, rows))
    sc_lib2 = wrapper_cost("index_copy_, int64 ids, again", lambda: dst.index_copy_(0, ali, rows))
    scatter = update_entry("scatter_rows", 0.0, sc_ms, sc_plain_ms, 0.0,
                           K * (8.0 + 2 * W * 4), peak, sc_lib_ms,
                           device_ms=sc_cost["device_ms"], host_us=sc_cost["host_us"],
                           launches_per_call=sc_cost["launches_per_call"],
                           int32_ids_device_ms=sc_cost32["device_ms"],
                           library_device_ms=[sc_lib["device_ms"], sc_lib2["device_ms"]],
                           library_host_us=sc_lib["host_us"],
                           plain_device_busy_ms=sc_plain["profiled_busy_ms"],
                           winner_write_back_ms=winner_ms)
    # the whole occurrence update of one train step at Ali-CCP: its launches
    state, r3 = {"comb": dst, "step": 0}, dst[ali]
    log("  the occurrence update of one train step (sparse_adam_occurrence_update):")
    step = wrapper_cost("sparse_adam_occurrence_update", lambda: optim.sparse_adam_occurrence_update(
        state, g, ali, segments, r3))
    segsum["occurrence_step_launches"] = step["launches_per_call"]
    del dst, state, r3, g
    torch.cuda.empty_cache()
    return {"occurrence_segsum": segsum, "scatter_rows": scatter}


def winner_write_back_cases(rk, id_cases, gen, V):
    """``scatter_rows`` at the winner update's shape against its plain
    version: into ``[V, 16]`` f32, the K ids of each case with every
    duplicate but the elected occurrence set to V, and feature 1's span
    frozen (set to V), as ``sparse_adam_rowgrads_update`` builds them.
    Exact with int64 and int32 ids. Returns each case's time (ms, int64
    ids)."""
    from scenario_wise_rec_tpu_torch.train.freeze import frozen_ids_mask

    dst = torch.randn(V, 16, generator=gen, device="cuda")
    times = {}
    for name, i1 in id_cases.items():
        occ = torch.arange(i1.numel(), device="cuda")
        won = torch.zeros(V, dtype=torch.int32, device="cuda")
        won[i1] = occ.to(torch.int32)
        uid = torch.where(won[i1].long() == occ, i1, V)
        uid = torch.where(frozen_ids_mask(uid, ((VOCAB, VOCAB),)), V, uid)
        rows = torch.randn(i1.numel(), 16, generator=gen, device="cuda")
        want = rk.scatter_rows_ref(dst.clone(), uid, rows)
        for dtype in (torch.int64, torch.int32):
            got = dst.clone()
            rk.scatter_rows(got, uid.to(dtype), rows)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"scatter_rows winner {name} ({dtype}) disagrees with plain")
            del got
        times[name] = time_ms(lambda: rk.scatter_rows(dst, uid, rows))
        log(f"  scatter_rows winner {name}: K {uid.numel()} into {tuple(dst.shape)}, "
            f"{int((uid == V).sum())} ids set to V (duplicates, frozen span), equal to the "
            f"plain version with int64 and int32 ids; {times[name]:.4f} ms")
        del want, won
    del dst
    torch.cuda.empty_cache()
    return times


def phase_fused_adam(gen, peak):
    """``fused_dense_adam_apply`` against its plain version over 3 steps:
    the Ali-CCP table (V = 10,741,000, D = 16) with 23 segments of 4096
    uniform ids, a hot row with Zipf ids, two alias segments of one owner,
    V not a multiple of the tile with an empty segment and ids -1, -7, V,
    V+3, and K = 0. Then its time beside its bound, the plain version and
    index_add_ + fused torch.optim.Adam, with a ``block_rows`` sweep."""
    from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as fk
    from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa
    from scenario_wise_rec_tpu_torch.train.optim import segment_sorted_ids

    V, D, K = N_SPARSE * VOCAB, 16, N_SPARSE * BATCH
    r = np.random.default_rng(3)
    v_odd = 1_000_003
    per_feature_segs = tuple((f"s{f}", f * BATCH, BATCH) for f in range(N_SPARSE))
    ids = ali_id_cases(r)
    cases = {
        "a_alicpp_uniform": (V, ids["a_alicpp_uniform"], per_feature_segs),
        "b_hot_row_zipf": (V, ids["b_hot_row_zipf"], per_feature_segs),
        "c_alias_segments": (V, ids["c_alias_segments"], (("s0", 0, BATCH), ("s0", BATCH, BATCH))),
        "d_odd_v_empty_segment_oob": (v_odd, torch.cat([
            torch.as_tensor(r.integers(0, v_odd // 3, 20_000)),
            torch.tensor([-1, -7, v_odd, v_odd + 3])]),
            (("a", 0, 0), ("b", 0, 10_000), ("c", 10_000, 10_004))),
        "e_no_ids": (v_odd, torch.zeros(0, dtype=torch.long), ()),
    }
    hps = [sa.adam_hparams(t, 1e-3, 1e-5, 0.9, 0.999, 1e-8) for t in (1, 2, 3)]
    max_err = 0.0
    for name, (v, i1, segs) in cases.items():
        i1 = i1.cuda()
        sid, pos, sizes = segment_sorted_ids(i1, segs)
        table = torch.randn(v, D, generator=gen, device="cuda")
        mu, nu = torch.zeros_like(table), torch.zeros_like(table)
        ref = [table.clone(), mu.clone(), nu.clone()]
        rule = AdamOrderRule(table)
        err = 0.0
        for t, hp in enumerate(hps, 1):
            g = 1e-3 * torch.randn(i1.shape[0], D, generator=gen, device="cuda")
            fk.fused_dense_adam_apply(table, mu, nu, g, sid, pos, sizes, hp)
            torch.cuda.synchronize()
            rule.step(ref[0], i1, g, hp)
            fk.fused_dense_adam_ref(*ref, g, i1, hp)
            for got, want, what in zip((table, mu, nu), ref, ("table", "mu", "nu")):
                check(bool(torch.isfinite(got).all()), f"{name}: {what} not finite")
                check(rule.close(got, want, what),
                      f"fused_dense_adam_apply {name} step {t}: {what} disagrees with plain")
                err = max(err, (got - want).abs().max().item())
        log(f"  fused_dense_adam_apply {name}: V {v}, K {i1.shape[0]} in {len(sizes)} "
            f"segments, 3 steps, max_abs_err {err:.3e}")
        rule.count(f"fused_dense_adam_apply {name}")
        max_err = max(max_err, err)
        del table, mu, nu, ref, rule

    table = torch.randn(V, D, generator=gen, device="cuda")
    mu, nu = torch.zeros_like(table), torch.zeros_like(table)
    hp, segs = hps[0], per_feature_segs
    g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
    hot = segment_sorted_ids(ids["b_hot_row_zipf"].cuda(), segs)
    hot_ms = time_ms(lambda: fk.fused_dense_adam_apply(table, mu, nu, g, *hot, hp))
    planted_adam_faults(
        "fused_dense_adam_apply", lambda t, m, n, i, g_: fk.fused_dense_adam_apply(
            t, m, n, g_, *segment_sorted_ids(i, segs), hp),
        table, mu, nu, ids["b_hot_row_zipf"].cuda(), g, hp, 0)
    i1 = ids["a_alicpp_uniform"].cuda()
    sid, pos, sizes = segment_sorted_ids(i1, segs)
    sweep = {rows: time_ms(lambda: fk.fused_dense_adam_apply(table, mu, nu, g, sid, pos, sizes,
                                                             hp, block_rows=rows))
             for rows in (64, 128, 256, 512, 1024)}
    log("  fused_dense_adam_apply a_alicpp_uniform block_rows sweep, ms: "
        + ", ".join(f"{k} -> {t:.4f}" for k, t in sweep.items()))
    kernel_ms = time_ms(lambda: fk.fused_dense_adam_apply(table, mu, nu, g, sid, pos, sizes, hp))
    i32 = i1.to(torch.int32)
    plain_ms = time_ms(lambda: fk.fused_dense_adam_ref(table, mu, nu, g, i32, hp),
                       reps=3, inner=5)
    sort_ms = time_ms(lambda: segment_sorted_ids(i1, segs))
    # the nearest PyTorch composition (timed here only; the port never calls it)
    param = torch.nn.Parameter(table.clone())
    param.grad = torch.zeros_like(table)
    opt = torch.optim.Adam([param], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=1e-5, fused=True)

    def library():
        param.grad.zero_()
        param.grad.index_add_(0, i1, g)
        opt.step()

    library_ms = time_ms(library, reps=3, inner=10)
    del param, opt
    log(f"  fused_dense_adam_apply b_hot_row_zipf: {hot_ms:.4f} ms; per-segment id sort "
        f"{sort_ms:.4f} ms")
    entry = update_entry("fused_dense_adam_apply", max_err, kernel_ms, plain_ms,
                         16.0 * V * D + K * D, 6.0 * V * D * 4 + K * 4 * 2 + K * D * 4, peak,
                         library_ms, hot_row_zipf_ms=hot_ms, sort_ms=sort_ms,
                         block_rows_sweep_ms=sweep)
    del table, mu, nu
    torch.cuda.empty_cache()
    return entry


def phase_train(seed, card):
    """The training path at Ali-CCP width: fit (one epoch, validation,
    checkpoint), evaluate_multi_domain_loss, examples/s, a profile, the
    sorted trainer against the plain dense trainer, and the card against
    the CPU on a narrow model."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    model = build_ali_model(seed + 1)
    x, y = synthetic_eval_set(seed + 2, N_TRAIN)
    vx, vy = synthetic_eval_set(seed + 3, 2 * BATCH + 7)
    train_loader = BatchIterable(ColumnarDataset(x, y), BATCH, shuffle=True, seed=seed)
    val_loader = BatchIterable(ColumnarDataset(vx, vy), BATCH)
    n_steps, n_val = len(train_loader), len(val_loader)
    trainer = CTRTrainer(model, sparse_embedding_updates=True,
                         sparse_update_impl="sorted", fused_inference=True,
                         n_epoch=1, data_set_type="smoke", seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainer.model_path = tmp
        reset_counts()
        t0 = time.perf_counter()
        path = trainer.fit(train_loader, val_loader)
        t1 = time.perf_counter()
        ll, auc, tll, tauc = trainer.evaluate_multi_domain_loss(model, val_loader, DOMAINS)
        torch.cuda.synchronize()
        counts = read_counts()
        ckpt_mb = os.path.getsize(path) / 1e6
    log(f"  training path launches {counts}: {n_steps} train steps, {n_val} eval "
        f"batches x 2 passes; fit {t1 - t0:.2f} s (one epoch, validation, "
        f"{ckpt_mb:.1f} MB checkpoint)")
    check(all(counts[k] == n for k, n in step_launches("sorted", n_steps).items()),
          "the sorted kernel did not launch once per train step, or another update kernel did")
    check(counts["mmoe_fused_infer"] == 2 * n_val,
          "the eval kernel did not launch once per eval batch")
    check(trainer.emb_opt_state["step"] == n_steps, "sorted step count")
    check(all(v is not None and np.isfinite(v) for v in ll + auc + [tll, tauc]),
          "eval metrics not finite")
    log(f"  after one epoch: per-domain auc {[round(a, 6) for a in auc]}, total auc "
        f"{tauc:.6f}, total logloss {tll:.6f}")

    batches = list(train_loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer.train_one_epoch(train_loader)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check(loss is not None and np.isfinite(loss), f"train loss {loss}")
    for k, v in list(model.state_dict().items()) + list(trainer.emb_opt_state.items()):
        if torch.is_tensor(v):
            check(bool(torch.isfinite(v).all()), f"{k} not finite after training")
    log(f"  train examples/s on {card}: {N_TRAIN / (t1 - t0):,.0f} (second epoch, "
        f"{n_steps} steps of {BATCH}, {1e3 * (t1 - t0) / n_steps:.2f} ms per step, "
        f"host clock, synchronised); last loss {loss:.5f}")
    profile_device(lambda: [trainer._train_step(*trainer._device_batch(*b))
                            for b in batches[:5]], "5 sorted train steps")

    sorted_vs_dense(model, batches[:2])
    del trainer, model
    torch.cuda.empty_cache()

    narrow_train_card_vs_cpu(seed, "mmoe")
    return counts


def clone_trainer(t):
    """A trainer on a copy of ``t``'s model holding all of ``t``'s training
    state: weights, torch.optim's moments and steps, the embedding update's
    moments and step, the lr and the dropout generator's state."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    c = CTRTrainer(copy.deepcopy(t.model), sparse_embedding_updates=t._sparse_emb,
                   sparse_update_impl=t._sparse_impl, fused_inference=t._fused_inference)
    # load_state_dict keeps tensors already on the right device: copy them
    c.optimizer.load_state_dict(copy.deepcopy(t.optimizer.state_dict()))
    with torch.no_grad():
        for k, v in t.emb_opt_state.items():
            if torch.is_tensor(v):
                c.emb_opt_state[k].copy_(v)
    c.emb_opt_state["step"] = t.emb_opt_state["step"]
    c.generator.set_state(t.generator.get_state())
    c._lr_now = t._lr_now
    return c


def rolled_by_one(loader):
    """Plant a fault in a resident loader: each epoch's permutation rolled by
    one row (every batch but its rows' order shifted one place)."""
    right = loader.epoch_perm

    def rolled():
        ids, w = right()
        return np.roll(ids, 1), w

    loader.epoch_perm = rolled
    return loader


N_FINDINGS = 2 ** 18 + 123  # rows of the resident-against-host findings epoch


def phase_train_resident(seed, card):
    """MMOE's training path over a DeviceResidentLoader at Ali-CCP width:
    (a) ``fit`` in the sorted mode with validation and on-device
    evaluation, launches counted; (b) a host epoch against a resident epoch
    from one state, and a resident epoch on a rolled permutation that must
    fail; (c) on-device against host metrics, and a planted NaN score that
    both must refuse; (d) examples/s, stream syncs and device busy share of
    both paths, no gate."""
    from scenario_wise_rec_tpu_torch.data import (BatchIterable, ColumnarDataset,
                                                  DeviceResidentLoader)
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    model = build_ali_model(seed + 1)
    x, y = synthetic_eval_set(seed + 2, N_TRAIN)
    vx, vy = synthetic_eval_set(seed + 3, 2 * BATCH + 7)
    ds = ColumnarDataset(x, y)
    val_loader = BatchIterable(ColumnarDataset(vx, vy), BATCH)
    resident = DeviceResidentLoader(ds, BATCH, seed=seed)
    n_steps, n_val = len(resident), len(val_loader)
    trainer = CTRTrainer(model, sparse_embedding_updates=True,
                         sparse_update_impl="sorted", fused_inference=True,
                         n_epoch=1, data_set_type="smoke", seed=seed)
    log(f"  resident loader: {N_TRAIN} rows, int {tuple(resident.int_mat.shape)} "
        f"{resident.int_mat.dtype}, float {tuple(resident.float_mat.shape)}, "
        f"{resident.nbytes() / 1e6:.1f} MB on the card")
    with tempfile.TemporaryDirectory() as tmp:
        trainer.model_path = tmp
        reset_counts()
        t0 = time.perf_counter()
        trainer.fit(resident, val_loader)
        t1 = time.perf_counter()
        ll, auc, tll, tauc = trainer.evaluate_multi_domain_loss(model, val_loader, DOMAINS,
                                                                on_device=True)
        torch.cuda.synchronize()
        counts = read_counts()
    log(f"  (a) resident training path launches {counts}: {n_steps} train steps, {n_val} "
        f"eval batches x 2 passes (validation, on-device); fit {t1 - t0:.2f} s")
    check(all(counts[k] == n for k, n in step_launches("sorted", n_steps).items()),
          "resident fit: the sorted kernel did not launch once per train step, or another "
          "update kernel did")
    check(counts["mmoe_fused_infer"] == 2 * n_val,
          "resident fit: the eval kernel did not launch once per eval batch")
    check(trainer.emb_opt_state["step"] == n_steps, "sorted step count")
    check(all(v is not None and np.isfinite(v) for v in ll + auc + [tll, tauc]),
          "on-device eval metrics not finite")
    log(f"  on-device after one resident epoch: per-domain auc "
        f"{[round(a, 6) for a in auc]}, total auc {tauc:.6f}, total logloss {tll:.6f}")

    # (b) one state, one host epoch and one resident epoch over the same rows
    host_t, res_t, fault_t = (clone_trainer(trainer) for _ in range(3))
    host_t.train_one_epoch(BatchIterable(ds, BATCH, shuffle=True, seed=seed + 5))
    res_t.train_one_epoch(DeviceResidentLoader(ds, BATCH, seed=seed + 5))
    fault_t.train_one_epoch(rolled_by_one(DeviceResidentLoader(ds, BATCH, seed=seed + 5)))
    res_t.barrier()
    fault_t.barrier()
    want = trainer_groups(host_t)
    for name, t in (("resident", res_t), ("fault: permutation rolled by one row", fault_t)):
        got = trainer_groups(t)
        gaps = group_gaps(got, want)
        differing = sum(int((v != want[g][k]).sum()) for g in got for k, v in got[g].items())
        log(f"  (b) {name} vs host epoch from one state, {n_steps} steps: {differing} "
            f"elements differ; {gaps_line(gaps)}")
        if name == "resident":
            check(not outside(gaps), f"resident vs host epoch: {outside(gaps)} outside "
                  "their tolerance")
        else:
            check(outside(gaps), "the host-vs-resident check does not see a rolled "
                  "permutation")
    del host_t, fault_t
    torch.cuda.empty_cache()

    # (c) on-device against host metrics, and a NaN score
    h, d = (res_t.evaluate_multi_domain_loss(res_t.model, val_loader, DOMAINS, on_device=o)
            for o in (False, True))
    h1, d1 = (res_t.evaluate(res_t.model, val_loader, on_device=o) for o in (False, True))
    auc_gap = max(abs(a - b) for a, b in zip(h[1] + [h[3], h1[0]], d[1] + [d[3], d1[0]]))
    ll_gap = max(abs(a - b) for a, b in zip(h[0] + [h[2], h1[1]], d[0] + [d[2], d1[1]]))
    log(f"  (c) on-device vs host metrics over {len(vy)} rows: auc gap {auc_gap:.3e} "
        f"(gate 1e-4), logloss gap {ll_gap:.3e} (gate 1e-5)")
    check(auc_gap <= 1e-4 and ll_gap <= 1e-5, "on-device and host metrics disagree")
    bad = dict(vx, d0=vx["d0"].copy())
    bad["d0"][5] = np.nan
    nan_loader = BatchIterable(ColumnarDataset(bad, vy), BATCH)
    for on_device in (False, True):
        try:
            res_t.evaluate_multi_domain_loss(res_t.model, nan_loader, DOMAINS,
                                             on_device=on_device)
        except ValueError as e:
            check("NaN" in str(e), f"a NaN score raised {e!r}")
        else:
            check(False, f"a NaN score did not raise (on_device={on_device})")
    log("  (c) a NaN planted in one score raises on the host and on-device paths")
    del res_t
    torch.cuda.empty_cache()

    # (d) findings, no gate: examples/s, syncs and busy share of both paths
    fx, fy = synthetic_eval_set(seed + 4, N_FINDINGS)
    big = ColumnarDataset(fx, fy)
    loaders = {"host": BatchIterable(big, BATCH, shuffle=True, seed=seed),
               "resident": DeviceResidentLoader(big, BATCH, seed=seed)}
    log(f"  (d) {N_FINDINGS} rows, {len(loaders['host'])} steps an epoch; resident "
        f"matrices {loaders['resident'].nbytes() / 1e6:.1f} MB on the card; {card}")
    rates = {}
    for name in ("host", "resident", "resident", "host"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_one_epoch(loaders[name], log_interval=10**9)
        trainer.barrier()
        dt = time.perf_counter() - t0
        rates.setdefault(name, []).append(N_FINDINGS / dt)
        log(f"  (d) {name} epoch: {N_FINDINGS / dt:,.0f} examples/s, "
            f"{1e3 * dt / len(loaders[name]):.3f} ms a step (host clock, synchronised)")
    head = ColumnarDataset({k: v[:5 * BATCH] for k, v in fx.items()}, fy[:5 * BATCH])
    few = {"host": BatchIterable(head, BATCH),
           "resident": DeviceResidentLoader(head, BATCH, shuffle=False)}
    prof = {}
    for name, loader in few.items():
        prof[name] = profile_device(
            lambda: (trainer.train_one_epoch(loader, log_interval=10**9), trainer.barrier()),
            f"5 sorted train steps, {name} epoch")
        if prof[name]:
            p = prof[name]
            log(f"  (d) {name}: {p['stream_syncs'] / 5:.1f} cudaStreamSynchronize a step, "
                f"device busy {100 * p['busy_ms'] / p['wall_ms']:.1f} % ({card})")
    del trainer, model, loaders, few
    torch.cuda.empty_cache()
    return {"launches": counts["sorted_dense_adam_apply"],
            "examples_per_s": {k: [round(r) for r in v] for k, v in rates.items()},
            "stream_syncs_per_step": {k: (None if p is None else p["stream_syncs"] / 5)
                                      for k, p in prof.items()},
            "busy_share": {k: (None if p is None else p["busy_ms"] / p["wall_ms"])
                           for k, p in prof.items()}}


GRAPH_STEPS = 64  # bench.py's scan_steps


def state_differing(a, b):
    """Elements of every weight, buffer, moment, step count and store that
    differ between trainers a and b."""
    def tensors(t):
        out = {f"model/{k}": v for k, v in t.model.state_dict().items()}
        for name, p in t._dense_named:
            for k, v in t.optimizer.state[p].items():
                out[f"opt/{name}/{k}"] = v
        for k, v in (t.emb_opt_state or {}).items():
            out[f"emb/{k}"] = v if torch.is_tensor(v) else torch.tensor(v)
        return out

    ta, tb = tensors(a), tensors(b)
    check(sorted(ta) == sorted(tb), "two trainers hold different state")
    return sum(int((v.to(tb[k].device) != tb[k]).sum()) for k, v in ta.items())


# the cases of phase_train_graphed: label -> (CTRTrainer keywords, the
# update's kernels as (wrapper, launch counter, capture counter, the names of
# its device kernels in a profile), the trainer's row helper whose rows the
# planted fault freezes, whether the host path is timed too)
def graphed_cases():
    from scenario_wise_rec_tpu_torch.ops.kernels import fused_adam as fk
    from scenario_wise_rec_tpu_torch.ops.kernels import row_update as rk
    from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa

    sorted_kw = dict(sparse_embedding_updates=True, sparse_update_impl="sorted")
    return {
        "float32": (dict(sorted_kw, sorted_dtype="float32"),
                    {"sorted_dense_adam_apply": (sa.sorted_dense_adam_apply, "launches",
                                                 "captured", ("dense_adam_kernel",))},
                    "adam_hparams_rows", True),
        "bf16": (dict(sorted_kw, sorted_dtype="bf16"),
                 {"sorted_dense_adam_apply_bf16": (sa.sorted_dense_adam_apply,
                                                   "launches_bf16", "captured_bf16",
                                                   ("dense_adam_kernel",))},
                 "adam_hparams_rows", False),
        "occurrence": (mode_kw("occurrence"),
                       {"occurrence_segsum": (rk.occurrence_segsum, "launches", "captured",
                                              ("segsum_rows_kernel", "segsum_sorted_kernel")),
                        "scatter_rows": (rk.scatter_rows, "launches", "captured",
                                         ("scatter_bulk_kernel", "scatter_lanes_kernel"))},
                       "occurrence_hparams_rows", False),
        "dense": (mode_kw("dense"),
                  {"fused_dense_adam_apply": (fk.fused_dense_adam_apply, "launches",
                                              "captured", ("dense_adam_kernel",))},
                  "adam_hparams_rows", False),
        "winner": (mode_kw("winner"),
                   {"scatter_rows": (rk.scatter_rows, "launches", "captured",
                                     ("scatter_bulk_kernel", "scatter_lanes_kernel"))},
                   "occurrence_hparams_rows", False),
    }


def graph_mode(case):
    """The STEP_LAUNCHES key of a graphed case."""
    return {"float32": "sorted", "bf16": "sorted_bf16"}.get(case, case)


def kernel_runs(kernels):
    """Each kernel's launches plus captures so far: ``{name: (launches,
    captured)}``."""
    return {k: (getattr(fn, a), getattr(fn, c)) for k, (fn, a, c, _) in kernels.items()}


PROFILE_ATTEMPTS = 3  # profiles of one epoch, at most, where the profiler loses records


def profile_records(prof):
    """The raw device records of a profile, the ``cudaGraphLaunch`` calls'
    record counts, and what the profile lost by its own bookkeeping: every
    replay of the one captured step runs the same nodes and every kernel
    launch one kernel, so a graph launch with fewer device records than the
    most any launch had, a kernel launch with none, or a device record whose
    launching call is missing, is a record the profiler dropped (no capture
    may run under the profile: a launch inside one has no record; our
    counters do not come into this test). The pad of
    :func:`settled_profile`, its kernels and the calls in its range, is
    left out. Returns ``(device records, graph launches' record counts, losses)``,
    ``losses`` an empty string for a whole profile."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    pads = [(e.start_ns(), e.end_ns()) for e in raw if e.name() == PAD]
    dev = [e for e in raw if e.device_type() != DeviceType.CPU and not e.is_user_annotation()
           and PAD_KERNEL not in e.name()]
    host = [e for e in raw if e.device_type() == DeviceType.CPU and e.correlation_id()
            and not any(a <= e.start_ns() <= b for a, b in pads)]
    per_call = {}
    for e in dev:
        per_call[e.correlation_id()] = per_call.get(e.correlation_id(), 0) + 1
    calls = {e.correlation_id() for e in host}
    graph = [per_call.get(e.correlation_id(), 0) for e in host if e.name() == "cudaGraphLaunch"]
    launches = [per_call.get(e.correlation_id(), 0)
                for e in sorted(host, key=lambda e: e.start_ns())
                if re.match(r"cu(da)?LaunchKernel|cudaGraphLaunch", e.name())]
    short = sum(max(graph) - n for n in graph) if graph else 0
    bare = [i for i, n in enumerate(launches) if n == 0]  # places in launch order
    orphans = sum(1 for e in dev if e.correlation_id() not in calls)
    losses = [f"{short} records short in graph launches (counts {sorted(set(graph))})"] * bool(
        short) + [f"{len(bare)} launches without a record, at " + (
            f"{bare}" if len(bare) <= 8 else f"{bare[:4]}...{bare[-4:]}")
        + f" of {len(launches)}"] * bool(bare) + [
        f"{orphans} device records without their launching call"] * bool(orphans)
    return dev, graph, "; ".join(losses)


def phase_train_graphed(seed, card, step0):
    """MMOE's training path at ``scan_steps=64`` (CUDA graphs) at Ali-CCP
    width, for the sorted update with each store (f32, bf16) and for the
    occurrence, dense and winner updates: (a) from one state, a resident
    epoch of 2^18+123 rows (one dispatch of 64 steps and a remainder of one) graphed
    against the eager S = 1 trainer (torch.optim.Adam capturable on both):
    0 elements may differ, and the train-step gate; a graphed epoch whose
    replays keep the dispatch's first row of Adam numbers, which must fail
    it; each update kernel's eager launches (the warm-up steps) and captured
    ones (STEP_LAUNCHES a step: winner's scatter 3), and its runs in a
    profile of the next graphed epoch against the replays; (b) no gate:
    examples/s of resident epochs in turns eager, graphed, graphed, eager
    (and of host epochs for the f32 store), host µs a step and a replay's,
    stream syncs and device busy share from a profile of 5 eager steps and
    of a graphed epoch, capture seconds and the graph's pool; and rows 13's
    and 14's Step 0 in both forms (``step0``, measured in ``[2]
    sorted_dense_adam_apply bf16``)."""
    from scenario_wise_rec_tpu_torch.data import (BatchIterable, ColumnarDataset,
                                                  DeviceResidentLoader)
    from scenario_wise_rec_tpu_torch.train import CTRTrainer
    from scenario_wise_rec_tpu_torch.train import trainer as ptrainer

    fx, fy = synthetic_eval_set(seed + 4, N_FINDINGS)
    big = ColumnarDataset(fx, fy)
    n_steps = -(-N_FINDINGS // BATCH)
    resident = lambda: DeviceResidentLoader(big, BATCH, seed=seed + 5)
    out = {}
    for case, (kw, kernels, rows_helper, host_path) in graphed_cases().items():
        model = build_ali_model(seed + 1)
        eager = CTRTrainer(model, **kw, seed=seed)
        for group in eager.optimizer.param_groups:  # as the graphed trainers' is
            group["capturable"] = True
        graphed, fault = (CTRTrainer(copy.deepcopy(model), scan_steps=GRAPH_STEPS, **kw,
                                     seed=seed) for _ in range(2))
        del model
        check(graphed.graphed and not eager.graphed, f"{case}: graphed flags")

        # (a) one state: graphed, eager and the planted fault over one epoch
        runs0 = kernel_runs(kernels)
        graphed.train_one_epoch(resident(), log_interval=10**9)
        graphed.barrier()
        runs = {k: (a - runs0[k][0], c - runs0[k][1]) for k, (a, c) in kernel_runs(kernels).items()}
        replays = graphed.graph_replays
        per_step = {k: STEP_LAUNCHES[graph_mode(case)][k] for k in kernels}
        check(graphed.graph_captures == 1 and all(
            r == (ptrainer.WARMUP_STEPS * per_step[k], per_step[k]) for k, r in runs.items())
            and ptrainer.WARMUP_STEPS + replays == n_steps,
            f"{case}: (eager launches, captured) {runs}, {replays} replays for {n_steps} steps")
        eager.train_one_epoch(resident(), log_interval=10**9)
        eager.barrier()
        right = getattr(ptrainer, rows_helper)
        undo = patched(ptrainer, rows_helper, lambda f: lambda step0, n, *a: np.repeat(
            f(step0, 1, *a), n, axis=0))
        try:
            fault.train_one_epoch(resident(), log_interval=10**9)
            fault.barrier()
        finally:
            undo()
        check(getattr(ptrainer, rows_helper) is right, "patch undone")
        want = trainer_groups(eager)
        for name, t in (("graphed", graphed), ("fault: replays keep the first row", fault)):
            gaps, n_diff = group_gaps(trainer_groups(t), want), state_differing(t, eager)
            log(f"  (a) {case} {name} vs eager epoch from one state, {n_steps} steps: "
                f"{n_diff} elements differ; {gaps_line(gaps)}")
            if name == "graphed":
                check(n_diff == 0 and not outside(gaps), f"{case}: graphed vs eager epoch: "
                      f"{n_diff} elements differ, {outside(gaps)} outside their tolerance")
                differing = n_diff
            else:
                check(outside(gaps), f"{case}: the graphed-vs-eager check does not see "
                      "replays that keep the first row")
        del fault
        torch.cuda.empty_cache()
        log(f"  (a) {case}: the update's kernels (eager launches, captured) {runs} (warm-up "
            f"steps), {replays} replays of {per_step} a step: {ptrainer.WARMUP_STEPS + replays} "
            f"steps for {n_steps}; capture {graphed.graph_capture_s:.3f} s, graph pool "
            f"{graphed.graph_pool_bytes / 1e6:.1f} MB")

        # (b) findings, no gate (the host path, held by its loader thread, for
        # the f32 store only, timed first, so that the resident plan that the
        # profile below replays is captured before the profiler starts)
        loaders = {"host": BatchIterable(big, BATCH, shuffle=True, seed=seed)} if host_path else {}
        loaders["resident"] = DeviceResidentLoader(big, BATCH, seed=seed)
        rates, host_us, turns = {}, {}, (("eager", eager), ("graphed", graphed),
                                         ("graphed", graphed), ("eager", eager))
        for lname, loader in loaders.items():
            for tname, t in turns:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.train_one_epoch(loader, log_interval=10**9)
                t1 = time.perf_counter()
                t.barrier()
                dt = time.perf_counter() - t0
                key = f"{lname} {tname}"
                rates.setdefault(key, []).append(N_FINDINGS / dt)
                host_us.setdefault(key, []).append(1e6 * (t1 - t0) / n_steps)
            log(f"  (b) {case} {lname} epochs, examples/s in turns eager, graphed, graphed, "
                f"eager: " + ", ".join(f"{r:,.0f}" for r in (
                    rates[f"{lname} eager"][0], rates[f"{lname} graphed"][0],
                    rates[f"{lname} graphed"][1], rates[f"{lname} eager"][1]))
                + f"; host us a step (to the epoch's return): eager "
                f"{[round(u, 1) for u in host_us[f'{lname} eager']]}, graphed "
                f"{[round(u, 1) for u in host_us[f'{lname} graphed']]} ({card})")
        # the eager epoch profiled over 5 steps (its ~680 launches a step
        # make a long profile), the graphed one over the whole epoch
        head = ColumnarDataset({k: v[:5 * BATCH] for k, v in fx.items()}, fy[:5 * BATCH])
        prof = {}
        # No capture may run in a profile (its launches leave no records).
        # The counters are held to the profiler's runs; a profile that
        # disagrees and lost records by its own bookkeeping (profile_records)
        # is logged and the epoch profiled again, at most PROFILE_ATTEMPTS
        # times
        for tname, t, loader in (("eager", eager, DeviceResidentLoader(head, BATCH)),
                                 ("graphed", graphed, loaders["resident"])):
            steps = len(loader)
            for attempt in range(1, PROFILE_ATTEMPTS + 1):
                runs0, replays0, captures0 = kernel_runs(kernels), t.graph_replays, t.graph_captures
                torch.cuda.synchronize()
                with settled_profile() as pr:
                    t0 = time.perf_counter()
                    t.train_one_epoch(loader, log_interval=10**9)
                    t.barrier()
                    wall = (time.perf_counter() - t0) * 1e3
                check(t.graph_captures == captures0, f"{case} {tname}: a capture ran under "
                      "the profiler")
                averages = pr.key_averages()
                found = device_events(averages)
                records, graph_launches, losses = profile_records(pr)
                replays = t.graph_replays - replays0
                seen, expected = {}, {}
                for k, (a, c) in kernel_runs(kernels).items():
                    expected[k] = a - runs0[k][0] + replays * per_step[k]
                    seen[k] = sum(1 for e in records
                                  if any(name in e.name() for name in kernels[k][3]))
                agree = seen == expected and len(graph_launches) == replays
                if agree or not losses or not found:
                    break
                log(f"  (b) {case} profile of a resident epoch, {tname}, attempt {attempt}: "
                    f"the profiler saw {seen} update kernel runs and {len(graph_launches)} "
                    f"graph launches, the counters {expected} and {replays} replays, in a "
                    f"profile that lost device records ({losses}); profiled again")
            busy = sum(device_ms(e) for e in found)
            syncs = sum(e.count for e in averages if e.key == "cudaStreamSynchronize")
            prof[tname] = {"steps": steps, "wall_ms": wall, "busy_ms": busy,
                           "stream_syncs": syncs, "runs_seen": seen, "runs_expected": expected,
                           "profile_attempts": attempt, "profile_losses": losses}
            log(f"  (b) {case} profile of a resident epoch ({steps} steps), {tname}: wall "
                f"{wall:.2f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f} %), "
                f"{syncs / steps:.2f} cudaStreamSynchronize a step; update kernel runs seen "
                f"{seen}, launches + replays {expected}; {len(graph_launches)} graph launches "
                f"of {sorted(set(graph_launches))} device records; records lost: "
                f"{losses or 'none'} ({card})")
            if not found:
                log("  (b) the profiler saw no device time (not measured)")
            else:
                check(agree, f"{case} {tname}: the profiler saw {seen} update kernel runs and "
                      f"{len(graph_launches)} graph launches, the counters {expected} and "
                      f"{replays} replays (records lost: {losses or 'none'})")
        # the host's own cost of a graphed step: one replay (its counter set
        # to 0 first, as a dispatch does) while the stream is held, so that
        # the launch queue does not fill and pace the host by the card
        plan = graphed._plan
        replay_ms, replay_us = device_and_host(
            lambda: (plan.counter.zero_(), plan.graph.replay()), inner=8)
        log(f"  (b) {case} one replay of the captured step: device "
            f"{'not measurable' if replay_ms is None else f'{replay_ms:.4f} ms'}, host "
            f"{replay_us:.1f} us ({card})")
        out[case] = {"replay_device_ms": replay_ms, "replay_host_us": replay_us,
                     "differing": differing, "eager_launches_captured": runs,
                     "replays": replays, "capture_s": graphed.graph_capture_s,
                     "graph_pool_mb": graphed.graph_pool_bytes / 1e6,
                     "examples_per_s": {k: [round(r) for r in v] for k, v in rates.items()},
                     "host_us_per_step": {k: [round(u, 1) for u in v]
                                          for k, v in host_us.items()},
                     "profile": prof}
        del eager, graphed, loaders, plan
        torch.cuda.empty_cache()

    med = lambda v: statistics.median(x for x in v if x is not None)
    log(f"  (d) rows 13's and 14's Step 0 device ms ([2] sorted_dense_adam_apply bf16), medians "
        "of three turns by value / from device memory: " + "; ".join(
            f"{k} {med(step0[k]['by value']):.4f} / {med(step0[k]['hp in device memory']):.4f}"
            for k in ("f32", "bf16", "fused")) + f" ({card})")
    return out


def narrow_train_card_vs_cpu(seed, name, impl="sorted"):
    """A narrow ``name``: 3 train steps with ``sparse_embedding_updates=True``
    in update mode ``impl`` (``mode_kw``; or the dense step for a model
    without an ``embedding`` collection) on the card and on the CPU, the card
    handed the CPU's state before each. Every buffer is compared too (HAMUR's D-fold
    hyper-network running stats, AdaptDHM's refined centers); each update
    kernel launches as many times as its mode says a step (STEP_LAUNCHES),
    and never in the dense step; AdaptDHM's unused biases and M3oE's
    unused ``w_exp_t``/``w_bal_t`` move by weight decay alone; M2M's and
    M3oE's noise-dominated elements are held to NOISE_ATOL (NOISY_MODELS)."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    small, sx, sy = narrow_model_and_data(seed, n=3 * 128, name=name)
    kw = mode_kw(impl)
    cpu_t = CTRTrainer(small, device="cpu", **kw)
    gpu_t = CTRTrainer(copy.deepcopy(small), **kw)
    unused = {n: p.detach().clone() for n, p in gpu_t.model.named_parameters()
              if (name == "adaptdhm" and n.startswith("b."))
              or (name == "m3oe" and n in ("w_exp_t", "w_bal_t"))}
    reset_counts()
    for step, b in enumerate(BatchIterable(ColumnarDataset(sx, sy), 128), 1):
        if step > 1:
            adopt_state(gpu_t, cpu_t)
        lc = float(cpu_t._train_step(*cpu_t._device_batch(*b)))
        lg = float(gpu_t._train_step(*gpu_t._device_batch(*b)))
        noisy, note = None, ""
        if name in NOISY_MODELS:
            noisy, n_noisy, n_dense = noisy_elements(gpu_t, cpu_t)
            note = f"; {n_noisy} of {n_dense} elements (tables too) noise-dominated"
        gaps = group_gaps(trainer_groups(gpu_t), trainer_groups(cpu_t), noisy)
        mode = impl if gpu_t._emb_mode else "plain dense"
        log(f"  narrow {name}, {mode} train step {step}, card vs CPU: loss {lg:.7f} vs "
            f"{lc:.7f}; {gaps_line(gaps)}{note}")
        check(abs(lc - lg) <= 1e-5 * abs(lc), f"{name}: card loss {lg} vs CPU {lc}")
        check(not outside(gaps), f"narrow {name}, step {step}, card vs CPU: "
              f"{ {g: gaps[g][3] for g in outside(gaps)} } outside their tolerance")
    counts = read_counts()
    check(all(counts[k] == n for k, n in step_launches(gpu_t._emb_mode and impl, 3).items()),
          f"narrow {name}, {mode}: update kernel launches {counts}")
    params = dict(gpu_t.model.named_parameters())
    for n, before in unused.items():
        moved = (params[n].detach() - before).abs()
        check(bool((moved > 0).all()) and moved.max().item() <= 3 * 1e-3,
              f"narrow {name}: the unused {n} did not take its weight-decay steps")
    if unused:
        log(f"  narrow {name}: the {len(unused)} unused tensors moved by weight decay, "
            f"at most {max((params[n].detach() - b).abs().max().item() for n, b in unused.items()):.3e}")


def phase_train_model(seed, card, name):
    """``name``'s training path at Ali-CCP width: fit for one epoch with
    ``sparse_embedding_updates=True`` (the sorted update for a model with
    one ``embedding`` collection; EPNet, PPNet and AdaSparse have none and
    take the dense step, as the JAX trainer does) and fused validation,
    evaluate_multi_domain_loss, a timed second epoch, and a narrow copy on
    the card against the CPU. Returns the launch counts of the fit and the
    evaluation."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    kernel = EVAL_KERNELS[name][0]
    per_batch = LAUNCHES_PER_BATCH.get(name, 1)
    model = build_ali_model(seed + 1, name=name)
    x, y = synthetic_eval_set(seed + 2, N_TRAIN_NEW)
    vx, vy = synthetic_eval_set(seed + 3, 2 * BATCH + 7)
    train_loader = BatchIterable(ColumnarDataset(x, y), BATCH, shuffle=True, seed=seed)
    val_loader = BatchIterable(ColumnarDataset(vx, vy), BATCH)
    n_steps, n_val = len(train_loader), len(val_loader)
    trainer = CTRTrainer(model, sparse_embedding_updates=True,
                         sparse_update_impl="sorted", fused_inference=True,
                         n_epoch=1, data_set_type="smoke", seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainer.model_path = tmp
        reset_counts()
        t0 = time.perf_counter()
        trainer.fit(train_loader, val_loader)
        t1 = time.perf_counter()
        ll, auc, tll, tauc = trainer.evaluate_multi_domain_loss(model, val_loader, DOMAINS)
        torch.cuda.synchronize()
        counts = read_counts()
    log(f"  {name} training path launches {counts}: {n_steps} train steps, {n_val} eval "
        f"batches x 2 passes; fit {t1 - t0:.2f} s (one epoch, validation, checkpoint)")
    sorted_steps = n_steps if getattr(model, "embedding", None) is not None else 0
    check(trainer._sorted_mode == bool(sorted_steps), f"{name}: update mode")
    check(counts["sorted_dense_adam_apply"] == sorted_steps,
          f"{name}: the sorted kernel did not launch {sorted_steps} times, once per sorted "
          "train step")
    check(counts[kernel] == per_batch * 2 * n_val, f"{name}: the eval kernel did not launch "
          f"{per_batch} time(s) per eval batch")
    check(all(v == 0 for k, v in counts.items() if k not in (kernel, "sorted_dense_adam_apply")),
          f"{name}: another model's kernel launched")
    check(all(v is not None and np.isfinite(v) for v in ll + auc + [tll, tauc]),
          f"{name}: eval metrics not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer.train_one_epoch(train_loader)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check(loss is not None and np.isfinite(loss), f"{name}: train loss {loss}")
    for k, v in list(model.state_dict().items()) + list((trainer.emb_opt_state or {}).items()):
        if torch.is_tensor(v):
            check(bool(torch.isfinite(v).all()), f"{name}: {k} not finite after training")
    log(f"  {name} after one epoch: total auc {tauc:.6f}, total logloss {tll:.6f}; train "
        f"examples/s on {card}: {N_TRAIN_NEW / (t1 - t0):,.0f} (second epoch, {n_steps} "
        f"steps, {1e3 * (t1 - t0) / n_steps:.2f} ms per step, host clock, synchronised); "
        f"last loss {loss:.5f}")
    del trainer, model
    torch.cuda.empty_cache()
    narrow_train_card_vs_cpu(seed, name)
    return counts


def drop_duplicate_sums(update):
    """A planted fault for the trainer checks: a dense-Adam update (sorted
    or dense) receives only the first occurrence's gradient row of each
    id."""
    def faulty(table, state, g_rows, ids, *args, **kw):
        s, perm = torch.sort(ids, stable=True)
        later = torch.zeros_like(ids, dtype=torch.bool)
        later[perm[1:]] = s[1:] == s[:-1]
        return update(table, state, g_rows.masked_fill(later[:, None], 0.0), ids, *args, **kw)

    return faulty


RESYNCED = "sorted, handed the dense state after step 1"


def sorted_vs_dense(model, batches):
    """Train copies of ``model`` two steps on ``batches``: the plain dense
    trainer; the sorted trainer; a sorted trainer handed the dense one's
    whole state after step 1, so that its step 2 starts from the dense
    trainer's state; two sorted trainers with a planted fault (duplicate
    gradient rows dropped; the table stored in bf16); and a second copy of
    the sorted and of the dense trainer (run-to-run noise). Gates: the
    sorted trainer's step 1 and the handed-over trainer's step 2 lie within
    ``GROUP_TOL`` everywhere, each fault does not at step 1, the sorted
    trainer's own step 2 lies within NOISE_ATOL, and the second sorted copy
    is bit-identical."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer
    from scenario_wise_rec_tpu_torch.train import trainer as trainer_mod

    sparse = dict(sparse_embedding_updates=True, sparse_update_impl="sorted")
    against = {"sorted": "dense", RESYNCED: "dense",
               "fault: duplicate sums dropped": "dense", "fault: bf16 table": "dense",
               "sorted, second copy": "sorted", "dense, second copy": "dense"}
    ts = {name: CTRTrainer(copy.deepcopy(model),
                           **({} if name.startswith("dense") else sparse))
          for name in ["dense"] + list(against)}
    update, gaps, loss = trainer_mod.sorted_dense_adam_update, {}, {}
    for step, b in enumerate(batches, 1):
        xb = ts["sorted"]._device_batch(*b)[0]
        touched = torch.unique(ts["sorted"].model.embedding.touched_ids(xb))
        for name, t in ts.items():
            if name == "fault: duplicate sums dropped":
                trainer_mod.sorted_dense_adam_update = drop_duplicate_sums(update)
            try:
                loss[name, step] = float(t._train_step(*t._device_batch(*b)))
            finally:
                trainer_mod.sorted_dense_adam_update = update
            if name == "fault: bf16 table":
                with torch.no_grad():
                    p = t.model.embedding.packed
                    p.copy_(p.bfloat16().float())
        for name, ref in against.items():
            if name == RESYNCED and step == 1:
                continue
            want = trainer_groups(ts[ref])
            gaps[name, step] = g = group_gaps(trainer_groups(ts[name]), want)
            log(f"  {name} vs {ref} trainer, step {step} at full width: loss "
                f"{loss[name, step]:.7f} vs {loss[ref, step]:.7f}; {gaps_line(g)}")
            if name == "sorted":
                table = want["table"]["embedding.packed"]
                rows = ((ts[name].model.embedding.packed.detach() - table).abs()
                        > STEP_ATOL + STEP_RTOL * table.abs()).any(1)
                hit = torch.zeros_like(rows)
                hit[touched] = True
                top = sorted(g["dense"][3].items(), key=lambda kv: -kv[1])[:4]
                log(f"    outside: table rows {int(rows.sum())} ({int((rows & hit).sum())} "
                    f"touched by this step's batch); dense, most: {top}")
        if step == 1:
            adopt_state(ts[RESYNCED], ts["dense"])
    for name, step in (("sorted", 1), (RESYNCED, 2), ("sorted", 2)):
        ls, ld = loss[name, step], loss["dense", step]
        check(abs(ls - ld) <= 1e-5 * abs(ld), f"{name}, step {step}: loss {ls} vs dense {ld}")
    for name, step in (("sorted", 1), (RESYNCED, 2)):
        check(not outside(gaps[name, step]), f"{name} vs dense trainer, step {step}: "
              f"{outside(gaps[name, step])} outside their tolerance")
    check(all(w <= NOISE_ATOL for _, _, w, _ in gaps["sorted", 2].values()),
          f"sorted vs dense trainer, step 2: a gap above {NOISE_ATOL}")
    for name in ("fault: duplicate sums dropped", "fault: bf16 table"):
        check(outside(gaps[name, 1]), f"the trainer check does not see the planted {name}")
    check(all(w == 0 for step in (1, 2)
              for _, _, w, _ in gaps["sorted, second copy", step].values()),
          "two copies of the sorted trainer differ")


def old_rows_written_back(update):
    """A planted fault for the trainer checks: after a dense-Adam update the
    batch's rows of the table and its moments are written back as they were
    before it."""
    def faulty(table, state, g_rows, ids, *args, **kw):
        rows = torch.unique(ids)
        tensors = (table.detach(), state["mu"], state["nu"])
        old = [t[rows].clone() for t in tensors]
        out = update(table, state, g_rows, ids, *args, **kw)
        for t, o in zip(tensors, old):
            t[rows] = o
        return out

    return faulty


def patched(module, name, replacement):
    """Set ``module.name`` to ``replacement(original)``; returns the undo."""
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    return lambda: setattr(module, name, original)


def mode_gate(model, batches, mode, ref, faults):
    """Train copies of ``model`` two steps on ``batches`` in update modes
    ``mode`` and ``ref`` (both fresh, so step 1 starts from one state), a
    ``mode`` trainer handed the ``ref`` one's whole state after step 1 (its
    step 2 starts from that state), and one ``mode`` trainer per planted
    fault (``faults``: name -> a function that plants it and returns the
    undo). Gates: ``mode``'s step 1 and the handed-over trainer's step 2
    lie within ``GROUP_TOL`` of ``ref`` everywhere and their losses within
    1e-5; each fault does not at step 1; ``mode``'s own step 2 lies within
    NOISE_ATOL."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    resynced = f"{mode}, handed the {ref} state after step 1"
    ts = {name: CTRTrainer(copy.deepcopy(model), sparse_embedding_updates=True,
                           sparse_update_impl=ref if name == ref else mode)
          for name in [ref, mode, resynced] + list(faults)}
    gaps, loss = {}, {}
    for step, b in enumerate(batches, 1):
        for name, t in ts.items():
            if step == 2 and name in faults:
                continue
            undo = faults[name]() if name in faults else None
            try:
                loss[name, step] = float(t._train_step(*t._device_batch(*b)))
            finally:
                if undo is not None:
                    undo()
        want = trainer_groups(ts[ref])
        for name in ts:
            if name == ref or (step, name) == (1, resynced) or (step == 2 and name in faults):
                continue
            gaps[name, step] = g = group_gaps(trainer_groups(ts[name]), want)
            log(f"  {name} vs {ref} trainer, step {step} at full width: loss "
                f"{loss[name, step]:.7f} vs {loss[ref, step]:.7f}; {gaps_line(g)}")
        if step == 1:
            adopt_state(ts[resynced], ts[ref])
    for name, step in ((mode, 1), (resynced, 2), (mode, 2)):
        check(abs(loss[name, step] - loss[ref, step]) <= 1e-5 * abs(loss[ref, step]),
              f"{name}, step {step}: loss {loss[name, step]} vs {ref} {loss[ref, step]}")
    for name, step in ((mode, 1), (resynced, 2)):
        check(not outside(gaps[name, step]), f"{name} vs {ref} trainer, step {step}: "
              f"{outside(gaps[name, step])} outside their tolerance")
    check(all(w <= NOISE_ATOL for _, _, w, _ in gaps[mode, 2].values()),
          f"{mode} vs {ref} trainer, step 2: a gap above {NOISE_ATOL}")
    for name in faults:
        check(outside(gaps[name, 1]), f"the {mode} vs {ref} check does not see the {name}")


def phase_train_modes(seed, card):
    """MMOE's training path at Ali-CCP width in the sorted mode with bf16
    storage, the occurrence, dense and winner modes, and the f32 sorted one
    again beside them (the same rows and epoch length, for step times
    alike): fit (one epoch, validation, checkpoint; for bf16 a round trip of
    that checkpoint, ``bf16_round_trip``) and
    evaluate_multi_domain_loss with every launch counter read exactly (each
    mode's update kernels STEP_LAUNCHES a step, the eval kernel once an eval
    batch, nothing else), a timed second epoch and a profile of 3 steps;
    then the gates occurrence vs winner and dense vs sorted with their
    planted faults, a narrow model on the card against the CPU in each mode,
    and frozen tables in all five modes. Returns each mode's launch
    counts."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.train import CTRTrainer
    from scenario_wise_rec_tpu_torch.train import optim as optim_mod
    from scenario_wise_rec_tpu_torch.train import trainer as trainer_mod

    x, y = synthetic_eval_set(seed + 2, N_TRAIN_NEW)
    vx, vy = synthetic_eval_set(seed + 3, 2 * BATCH + 7)
    train_loader = BatchIterable(ColumnarDataset(x, y), BATCH, shuffle=True, seed=seed)
    val_loader = BatchIterable(ColumnarDataset(vx, vy), BATCH)
    n_steps, n_val = len(train_loader), len(val_loader)
    out = {}
    # sorted (f32): beside the others, alike
    for mode in ("sorted", "sorted_bf16", "occurrence", "dense", "winner"):
        model = build_ali_model(seed + 1)
        trainer = CTRTrainer(model, **mode_kw(mode), fused_inference=True, n_epoch=1,
                             data_set_type="smoke", seed=seed)
        with tempfile.TemporaryDirectory() as tmp:
            trainer.model_path = tmp
            reset_counts()
            t0 = time.perf_counter()
            path = trainer.fit(train_loader, val_loader)
            t1 = time.perf_counter()
            ll, auc, tll, tauc = trainer.evaluate_multi_domain_loss(model, val_loader, DOMAINS)
            torch.cuda.synchronize()
            counts = read_counts()
            saved = np.load(path)["model/embedding.packed"]
            if mode == "sorted_bf16":
                bf16_round_trip(trainer, path)
        log(f"  {mode}: training path launches {counts}: {n_steps} train steps, {n_val} eval "
            f"batches x 2 passes; fit {t1 - t0:.2f} s (one epoch, validation, checkpoint)")
        want = {**{k: 0 for k in counts}, **step_launches(mode, n_steps),
                "mmoe_fused_infer": 2 * n_val}
        check(counts == want, f"{mode}: launches {counts}, expected {want}")
        check(trainer.emb_opt_state["step"] == n_steps, f"{mode}: update step count")
        check(all(v is not None and np.isfinite(v) for v in ll + auc + [tll, tauc]),
              f"{mode}: eval metrics not finite")
        live = model.embedding.packed.detach()
        check(np.array_equal(saved, live.cpu().numpy()), f"{mode}: the checkpoint's table "
              "is not the live one")
        if mode == "occurrence":
            check(live.data_ptr() == trainer.emb_opt_state["comb"].data_ptr(),
                  "occurrence: the model's table is not the combined store's view")
        batches = list(train_loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_one_epoch(train_loader)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        check(loss is not None and np.isfinite(loss), f"{mode}: train loss {loss}")
        for k, v in list(model.state_dict().items()) + list(trainer.emb_opt_state.items()):
            if torch.is_tensor(v):
                check(bool(torch.isfinite(v).all()), f"{mode}: {k} not finite after training")
        log(f"  {mode} after one epoch: total auc {tauc:.6f}, total logloss {tll:.6f}; train "
            f"examples/s on {card}: {N_TRAIN_NEW / (t1 - t0):,.0f} (second epoch, {n_steps} "
            f"steps of {BATCH}, {1e3 * (t1 - t0) / n_steps:.2f} ms per step, host clock, "
            f"synchronised); last loss {loss:.5f}")
        profile_device(lambda: [trainer._train_step(*trainer._device_batch(*b))
                                for b in batches[:3]], f"3 {mode} train steps")
        out[mode] = counts
        del trainer, model
        torch.cuda.empty_cache()

    out["sorted_step_ms"] = sorted_step_ab(seed, batches)
    model = build_ali_model(seed + 4)
    gate_batches = batches[:2]
    segsum = lambda: patched(optim_mod, "occurrence_segsum", lambda f: lambda ids, g: g)
    no_write = lambda: patched(optim_mod, "scatter_rows", lambda f: lambda dst, ids, rows: dst)
    mode_gate(model, gate_batches, "occurrence", "winner",
              {"fault: a segsum that drops duplicate sums": segsum,
               "fault: the old row written back": no_write})
    dense = "fused_dense_adam_update"
    mode_gate(model, gate_batches, "dense", "sorted",
              {"fault: the old row written back":
                   lambda: patched(trainer_mod, dense, old_rows_written_back),
               "fault: duplicate sums dropped":
                   lambda: patched(trainer_mod, dense, drop_duplicate_sums)})
    del model
    torch.cuda.empty_cache()
    for mode in ("sorted_bf16", "occurrence", "dense", "winner"):
        narrow_train_card_vs_cpu(seed, "mmoe", impl=mode)
    narrow_frozen_all_modes(seed)
    return out


def sorted_step_ab(seed, batches):
    """MMOE's sorted train step at Ali-CCP width with f32 and with bf16
    storage, host clock around 5 synchronised steps a turn, in turns f32,
    bf16, bf16, f32 after 2 warm-up steps each (the epochs timed above run
    one mode after another and move by more than the difference). Returns
    each kind's two turns, ms a step."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    trainers = {}
    for mode in ("sorted", "sorted_bf16"):
        trainers[mode] = t = CTRTrainer(build_ali_model(seed + 1), **mode_kw(mode), seed=seed)
        for b in batches[:2]:
            t._train_step(*t._device_batch(*b))
    ms = {mode: [] for mode in trainers}
    for mode in ("sorted", "sorted_bf16", "sorted_bf16", "sorted"):
        t = trainers[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[2:7]:
            t._train_step(*t._device_batch(*b))
        torch.cuda.synchronize()
        ms[mode].append((time.perf_counter() - t0) * 1e3 / 5)
    log(f"  sorted train step, host clock, in turns f32, bf16, bf16, f32 (5 steps of {BATCH} "
        f"a turn): f32 {[round(v, 2) for v in ms['sorted']]} ms, bf16 "
        f"{[round(v, 2) for v in ms['sorted_bf16']]} ms")
    del trainers
    torch.cuda.empty_cache()
    return ms


def bf16_round_trip(trainer, path):
    """``load`` of ``path`` (just saved by ``trainer``, sorted_dtype="bf16")
    into the same trainer after its store and its model's table are zeroed:
    the store comes back bit for bit and the model's table is its copy."""
    st, packed = trainer.emb_opt_state, trainer.model.embedding.packed
    before = {k: st[k].clone() for k in ("table", "mu", "nu")}
    with torch.no_grad():
        for t in (st["table"], st["mu"], st["nu"], packed):
            t.zero_()
    t0 = time.perf_counter()
    trainer.load(path)
    torch.cuda.synchronize()
    same = {k: torch.equal(st[k].view(torch.int16), v.view(torch.int16))
            for k, v in before.items()}
    log(f"  sorted_bf16: save/load round trip on the card ({os.path.getsize(path) / 1e6:.1f} "
        f"MB, load {time.perf_counter() - t0:.2f} s): store equal bit for bit {same}")
    check(all(same.values()), f"sorted_bf16: the store did not round-trip: {same}")
    check(torch.equal(packed.detach(), st["table"].float()),
          "sorted_bf16: the model's table is not the store's after load")


def narrow_frozen_all_modes(seed):
    """A narrow MMOE with a frozen pretrained table inside its packed table
    and a frozen loose one (width 4), 3 train steps on the card in each of
    the five modes: both stay bit-identical, the trainable rows move, and
    the update kernels launch as the mode says."""
    from scenario_wise_rec_tpu_torch.core import DenseFeature, SparseFeature
    from scenario_wise_rec_tpu_torch.core.init import pretrained
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.models import get_model
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    r = np.random.default_rng(seed)
    w_packed = r.normal(size=(40, 8)).astype(np.float32)
    w_loose = r.normal(size=(10, 4)).astype(np.float32)
    feats = ([DenseFeature("d0")] + [SparseFeature(f"s{i}", 100, embed_dim=8) for i in range(3)]
             + [SparseFeature("pre", 40, embed_dim=8, initializer=pretrained(w_packed)),
                SparseFeature("loose", 10, embed_dim=4, initializer=pretrained(w_loose))])
    n = 3 * 128
    x = {f"s{i}": r.integers(0, 100, n) for i in range(3)}
    x.update(pre=r.integers(0, 40, n), loose=r.integers(0, 10, n),
             d0=r.normal(size=n).astype(np.float32), domain_indicator=r.integers(0, 2, n))
    y = (r.random(n) < 0.4).astype(np.float32)
    for mode in (None, "sorted", "dense", "occurrence", "winner"):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = get_model("mmoe")(feats, 2, device="cuda", generator=gen, **NARROW["mmoe"])
        kw = {} if mode is None else dict(sparse_embedding_updates=True, sparse_update_impl=mode)
        t = CTRTrainer(model, **kw)
        col = model.embedding
        (off, span), = col.frozen_spans
        before = col.packed.detach().clone()
        reset_counts()
        for b in BatchIterable(ColumnarDataset(x, y), 128):
            t._train_step(*t._device_batch(*b))
        torch.cuda.synchronize()
        counts = read_counts()
        after = col.packed.detach()
        trainable = torch.ones(after.shape[0], dtype=torch.bool, device="cuda")
        trainable[off:off + span] = False
        check(torch.equal(after[off:off + span].cpu(), torch.as_tensor(w_packed)),
              f"frozen, {mode or 'plain'}: the frozen packed span moved")
        check(torch.equal(col.tables["loose"].detach().cpu(), torch.as_tensor(w_loose)),
              f"frozen, {mode or 'plain'}: the frozen loose table moved")
        check(bool((after[trainable] != before[trainable]).any()),
              f"frozen, {mode or 'plain'}: the trainable rows did not move")
        check(all(counts[k] == c for k, c in step_launches(mode, 3).items()),
              f"frozen, {mode or 'plain'}: update kernel launches {counts}")
        log(f"  narrow MMOE with frozen tables, {mode or 'plain dense'} step, 3 steps on the "
            "card: the frozen span and loose table bit-identical, the trainable rows moved")


def synthetic_eval_set(seed, n):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, VOCAB, n).astype(np.int64) for i in range(N_SPARSE)}
    x.update({f"d{i}": r.normal(size=n).astype(np.float32) for i in range(N_DENSE)})
    x["domain_indicator"] = r.integers(0, DOMAINS, n).astype(np.int64)
    y = (r.random(n) < 0.3).astype(np.float32)
    for d in range(DOMAINS):
        m = x["domain_indicator"] == d
        check(0 < y[m].sum() < m.sum(), f"domain {d} lacks a class")
    return x, y


def perturb_running_stats(model, gen, relative=False):
    """Random BatchNorm running stats, and AdaSparse's alpha at 1.37, so the
    eval folding does real work; ``relative``: moved by a tenth of their own
    std and scaled by U(0.5, 1.5) instead of replaced."""
    bufs = dict(model.named_buffers())
    with torch.no_grad():
        for name, buf in bufs.items():
            noise = lambda f: f(buf.shape, generator=gen, device=buf.device)
            if name == "alpha":
                buf.fill_(1.37)
            elif name.endswith(".mean"):
                if relative:
                    buf.add_(0.1 * bufs[name[:-len("mean")] + "var"].sqrt() * noise(torch.randn))
                else:
                    buf.copy_(0.1 * noise(torch.randn))
            elif name.endswith(".var"):
                buf.copy_((buf if relative else 1.0) * (0.5 + noise(torch.rand)))


def randomize_adapters(model, gen):
    """HAMUR's adapters' u/v from 0.1 N(0, 1) instead of ones, as the JAX
    package's tests draw them: at ones the adapter's sigmoid saturates and
    its norm divides near-zero variances, and the paths' rounding shows."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if re.fullmatch(r"adapters\.\d+\.[uv]_(down|up)", name):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen, device=p.device))


def spread_tables(model, gen, std=0.5):
    """Embedding tables drawn from N(0, std) instead of the initial N(0,
    1e-4). At 1e-4, SAR-Net's and AdaSparse's random models give every row
    nearly the same probability, so the fused and the op-by-op paths'
    last-ulp differences reorder near-ties and move the AUC by up to 2e-3;
    and a train-mode BatchNorm right after the embedding (SAR-Net's debias
    experts) divides row differences of 1e-4 by sqrt(eps), which turns the
    card's and the CPU's rounding into gradient gaps that Adam makes ~lr
    steps (14 parameters of a narrow SAR-Net on an H100). Spread out, both
    measure the paths."""
    with torch.no_grad():
        for table in packed_tables(model).values():
            table.normal_(0.0, std, generator=gen)


def settle_running_stats(model, seed, passes=30):
    """Train-mode forwards over one synthetic batch, so that each BatchNorm's
    running stats are its own activations' (momentum 0.1: 0.9^30, 4 %, of
    the initial ones left), as a trained model's are. STAR needs it: its
    kaiming weights (fan from the output width, bound sqrt(6) at the width-1
    layer), U(0, 1) biases and a relu after every layer make its random
    activations grow layer by layer, and with running stats that do not
    match them every eval probability rounds to 1.0 in f32."""
    x, _ = synthetic_eval_set(seed + 7, BATCH)
    xb = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()}
    with torch.no_grad():
        for _ in range(passes):
            model.apply(xb, train=True)


def serving_near_threshold(model, x):
    """The rows ``x`` of a serving pass that a near-tie excuses: ``[n]``
    bools, True where some AdaSparse pruner element lies within
    THRESHOLD_GAP of epsilon, or where AdaptDHM's top two routing logits lie
    within ROUTE_GAP (by the plain path); None for another model."""
    from scenario_wise_rec_tpu_torch.ops.kernels import (adaptdhm_route_margin,
                                                         adasparse_threshold_margin)

    if not hasattr(model, "pruners") and not hasattr(model, "center"):
        return None
    device = next(model.buffers()).device
    n = len(x["domain_indicator"])
    margins = []
    with torch.inference_mode():
        folded = model.fold_eval()
        for i in range(0, n, BATCH):
            xb = {k: torch.as_tensor(np.asarray(v)[i:i + BATCH], device=device)
                  for k, v in x.items()}
            if hasattr(model, "center"):
                emb = model.embedding(xb, model.features, squeeze_dim=True)
                margins.append(adaptdhm_route_margin(emb, model.center).cpu() - ROUTE_GAP)
                continue
            p = model.pruners[0]
            margins.append(adasparse_threshold_margin(
                *model._embed(xb), *folded, p.form, p.epsilon, p.beta).cpu() - THRESHOLD_GAP)
    return (torch.cat(margins) <= 0).numpy()


def held_gap(label, got, want, near, tol=(TOL, 0.0)):
    """The largest ``|got - want| / (atol + rtol |want|)`` over the rows not
    ``near`` a threshold or a routing tie, with ``tol = (atol, rtol)``: at
    most 1 passes. The excused rows are counted, printed and held to
    THRESHOLD_ROWS."""
    keep = np.ones(len(got), bool) if near is None else ~near
    gap = np.abs(got - want)[keep]
    err = float(gap.max()) if keep.any() else 0.0
    ratio = float((gap / (tol[0] + tol[1] * np.abs(want[keep]))).max()) if keep.any() else 0.0
    rule = "" if near is None else f", {int(near.sum())} of {len(got)} rows excused"
    log(f"  {label}: max_abs_err {err:.3e}, {ratio:.3f} of the limit "
        f"{tol[0]:g} + {tol[1]:g} |want|{rule}")
    if near is not None:
        check(int(near.sum()) <= THRESHOLD_ROWS * len(got), f"{label}: excused rows")
    return ratio


def narrow_serve_card_vs_cpu(seed, name):
    """A narrow ``name`` served by ``CTRTrainer(fused_inference=True)`` on
    the card against the same model on the CPU (the kernels' plain
    versions); returns the launch counts of the card's pass."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    small, sx, _ = narrow_model_and_data(seed, name=name)
    sl = BatchIterable(ColumnarDataset(sx, None), 128)
    want = np.asarray(CTRTrainer(small, device="cpu", fused_inference=True).predict(small, sl))
    small_gpu = copy.deepcopy(small)
    reset_counts()
    got = np.asarray(CTRTrainer(small_gpu, fused_inference=True).predict(small_gpu, sl))
    counts = read_counts()
    ratio = held_gap(f"narrow {name}, card vs CPU", got, want,
                     serving_near_threshold(small, sx), SERVE_TOL.get(name, (TOL, 0.0)))
    check(got.shape == (300,) and ratio <= 1, f"{name}: card disagrees with the CPU")
    return counts


def drop_norm_mask(model):
    """A planted fault for the serving check: HAMUR's adapter norms take
    their statistics over every row, the padded ones included. Returns the
    undo."""
    from scenario_wise_rec_tpu_torch.ops.kernels import hamur_infer

    affine = hamur_infer.adapter_norm_affine
    hamur_infer.adapter_norm_affine = (
        lambda t_pre, gamma, beta, eps, w: affine(t_pre, gamma, beta, eps, None))
    return lambda: setattr(hamur_infer, "adapter_norm_affine", affine)


def drop_key_mask(model):
    """A planted fault for the serving check: M2M's transformer attends to
    the padded rows too (its key mask dropped). Returns the undo."""
    forward = model.transformer.forward
    model.transformer.forward = (
        lambda src, tgt, train=False, generator=None, w=None: forward(src, tgt, train,
                                                                       generator, None))
    return lambda: delattr(model.transformer, "forward")


# each model's planted serving fault, which the check must catch on the
# ragged last batch (123 real rows, 3,973 padded ones)
PLANTED = {"hamur": ("mask dropped from the norm statistics", drop_norm_mask),
           "m2m": ("key mask dropped from the transformer", drop_key_mask)}


def m2m_transformer_ms(model, trainer, x):
    """M2M's transformer alone on the first batch of ``x`` (device time,
    CUDA events), the stage the fused kernel follows."""
    xb, _, wb = trainer._device_batch({k: np.asarray(v)[:BATCH] for k, v in x.items()}, None,
                                      np.ones(BATCH, np.float32))
    with torch.inference_mode():
        emb = model.embedding(xb, model.features, squeeze_dim=True)
        return time_ms(lambda: model.transformer(emb, emb, w=wb), reps=3, inner=5)


def phase_main_path(seed, card, name="mmoe"):
    """``name``'s serving path at Ali-CCP width, fused and op by op, and a
    narrow copy on the card against the CPU; returns the launch counts of
    the fused passes and the kernels-line fields it measured beside them."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    kernel = EVAL_KERNELS[name][0]
    per_batch = LAUNCHES_PER_BATCH.get(name, 1)
    tol = SERVE_TOL.get(name, (TOL, 0.0))
    small_counts = narrow_serve_card_vs_cpu(seed, name)
    check(small_counts[kernel] == per_batch * 3, f"narrow {name}: launches {small_counts}")

    model = build_ali_model(seed, perturb=True, name=name)
    n = 8 * BATCH + 123
    x, y = synthetic_eval_set(seed, n)
    loader = BatchIterable(ColumnarDataset(x, y), batch_size=BATCH)
    n_batches = len(loader)
    fused = CTRTrainer(model, fused_inference=True)
    plain = CTRTrainer(model, fused_inference=False)

    reset_counts()
    t0 = time.perf_counter()
    f_ll, f_auc, f_tll, f_tauc = fused.evaluate_multi_domain_loss(model, loader, DOMAINS)
    t1 = time.perf_counter()
    p_fused = np.asarray(fused.predict(model, loader))
    t2 = time.perf_counter()
    counts = read_counts()
    launches = counts[kernel]
    log(f"  {name} serving path launches {counts} over {2 * n_batches} batches")
    check(launches == per_batch * 2 * n_batches, f"{name}: the main path did not launch the "
          f"kernel {per_batch} time(s) per batch")
    check(all(v == 0 for k, v in counts.items() if k != kernel),
          f"{name}: serving launched another kernel")

    t3 = time.perf_counter()
    o_ll, o_auc, o_tll, o_tauc = plain.evaluate_multi_domain_loss(model, loader, DOMAINS)
    t4 = time.perf_counter()
    p_plain = np.asarray(plain.predict(model, loader))
    t5 = time.perf_counter()
    check(read_counts()[kernel] == launches, "the op-by-op path launched the kernel")

    check(p_fused.shape == p_plain.shape == (n,), "prediction shape")
    check(bool(np.isfinite(p_fused).all()) and 0 < p_fused.min() and p_fused.max() < 1,
          "predictions not finite probabilities")
    near = serving_near_threshold(model, x)
    ratio = held_gap(f"{name} fused vs op-by-op", p_fused, p_plain, near, tol)
    auc_gap = max(abs(a - b) for a, b in zip(f_auc + [f_tauc], o_auc + [o_tauc]))
    ll_gap = max(abs(a - b) for a, b in zip(f_ll + [f_tll], o_ll + [o_tll]))
    log(f"  fused vs op-by-op: auc gap {auc_gap:.3e}, logloss gap {ll_gap:.3e}")
    log(f"  per-domain auc {[round(a, 6) for a in f_auc]}, total auc {f_tauc:.6f}, "
        f"total logloss {f_tll:.6f}")
    check(ratio <= 1, f"fused and op-by-op predictions differ beyond {tol}")
    check(auc_gap <= 1e-4, f"AUC differs by {auc_gap}")
    fuses = auto_resolves(model)
    log(f"  fused_inference='auto' resolves to {'fused' if fuses else 'op by op'} "
        "(the measured set)")
    if fuses and not AUTO_PASSED:
        auto_pass(model, loader, kernel, per_batch * n_batches, p_fused, tol)
        AUTO_PASSED.append(name)
    log(f"  {name} eval examples/s on {card}: fused predict {n / (t2 - t1):,.0f}, "
        f"op-by-op predict {n / (t5 - t4):,.0f}; evaluate_multi_domain_loss "
        f"fused {n / (t1 - t0):,.0f}, op-by-op {n / (t4 - t3):,.0f}")
    if name in PLANTED:
        what, plant = PLANTED[name]
        undo = plant(model)
        try:
            p_fault = np.asarray(fused.predict(model, loader))
        finally:
            undo()
        last = slice(n - 123, n)
        fault = held_gap(f"planted fault ({what}), the ragged last batch, fused vs op-by-op",
                         p_fault[last], p_plain[last], None if near is None else near[last], tol)
        check(fault > 1, f"the serving check does not see the planted fault ({what})")
    extra = {}
    if name == "m2m":
        extra["transformer_ms"] = m2m_transformer_ms(model, fused, x)
        log(f"  m2m transformer alone, one batch of {BATCH}: {extra['transformer_ms']:.4f} ms "
            "(device time)")
    profile_device(lambda: fused.predict(model, loader),
                   f"one fused {name} predict pass ({n_batches} batches)")
    del fused, plain, model
    torch.cuda.empty_cache()
    return counts, extra


def auto_resolves(model) -> bool:
    """``CTRTrainer(model, fused_inference="auto")`` resolved as the port's
    measured set says (checked); returns whether it fuses."""
    from scenario_wise_rec_tpu_torch.ops.kernels import FUSED_INFERENCE_WINS
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    device = next(model.parameters()).device.type
    fuses = CTRTrainer(model, fused_inference="auto", device=device)._fused_inference
    name = type(model).__name__
    check(fuses == (name in FUSED_INFERENCE_WINS and hasattr(model, "apply_fused_eval")),
          f"{name}: fused_inference='auto' resolved to {fuses}")
    return fuses


# the served model whose "auto" predict pass ran: the first one in the set
# (the side outside it is MlpN's, in narrow_auto)
AUTO_PASSED = []


def auto_pass(model, loader, kernel, fused_launches, want, tol):
    """One ``"auto"`` predict pass of a model in the set: the kernel
    launched ``fused_launches`` times and nothing else, the predictions
    within ``tol`` of the fused path's (``want``)."""
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    reset_counts()
    got = np.asarray(CTRTrainer(model, fused_inference="auto").predict(model, loader))
    counts = read_counts()
    gap = float(np.abs(got - want).max())
    log(f"  {type(model).__name__} fused_inference='auto': fused (the measured set), "
        f"{counts[kernel]} {kernel} launches, predictions within {gap:.3e} of the fused path's")
    check(counts[kernel] == fused_launches and sum(counts.values()) == counts[kernel],
          f"{type(model).__name__}: the 'auto' pass launched {counts}")
    check(gap <= tol[0] + tol[1] * float(np.abs(want).max()),
          f"{type(model).__name__}: the 'auto' predictions differ from its path's by {gap}")


def narrow_auto(seed):
    """``fused_inference="auto"`` for the narrow HamurSmall and MlpN: each
    resolves to its class's membership in the set, MlpN to op by op, and
    MlpN's ``"auto"`` pass on the card launches no kernel."""
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    for name in ("hamur_small", "mlpn"):
        small, sx, _ = narrow_model_and_data(seed, name=name)
        fuses = auto_resolves(small)
        log(f"  narrow {name}: fused_inference='auto' resolves to "
            f"{'fused' if fuses else 'op by op'}")
    check(not fuses, "MlpN resolved 'auto' to a fused eval")
    small = small.to("cuda")
    reset_counts()
    p = CTRTrainer(small, fused_inference="auto").predict(
        small, BatchIterable(ColumnarDataset(sx, None), 128))
    counts = read_counts()
    check(len(p) == 300 and not any(counts.values()), f"narrow MlpN's 'auto' pass: {counts}")
    log("  narrow mlpn: one 'auto' predict pass on the card, no kernel launched")


def profile_device(fn, what):
    """Device time by kernel over ``fn()`` and the host ops that cost the
    most, under torch.profiler (which adds host overhead, so the busy share
    is a lower bound). Only device-side events count as busy time
    (:func:`device_events`). Returns ``{"wall_ms", "busy_ms",
    "stream_syncs"}`` (``cudaStreamSynchronize`` calls; the closing
    ``torch.cuda.synchronize`` is a device sync, not counted), or None when
    the profiler saw no device time."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with settled_profile() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels = device_events(averages)
    if not kernels:
        log("  profile: the profiler saw no device time (not measured)")
        return None
    busy_ms = sum(device_ms(e) for e in kernels)
    syncs = sum(e.count for e in averages if e.key == "cudaStreamSynchronize")
    log(f"  profile of {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernels "
        f"and copies, {syncs} cudaStreamSynchronize calls; top device time:")
    for e in sorted(kernels, key=device_ms, reverse=True)[:8]:
        log(f"    {device_ms(e):8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    log("   top host self time:")
    host = [e for e in averages if e.device_type == DeviceType.CPU  # ranges, not host work
            and not getattr(e, "is_user_annotation", False)
            and e.key != PAD and not e.key.startswith("ProfilerStep")]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        log(f"    {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "stream_syncs": syncs}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of [4] training mmoe mesh, which this script spawns itself
    ap.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-shape", default="2,2", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.mesh_rank is not None:
        return mesh_rank_main(args)

    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}")
    with phase("[1] build"):
        seconds = _build.build()
    for name, s in seconds.items():
        log(f"  built {name} in {s:.2f} s")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    peak_name, peak = peaks(kind)
    log(f"  bounds from the published {peak_name} peaks: "
        f"{peak[0] / 1e12:g} TFLOP/s f32, {peak[2] / 1e12:g} TFLOP/s TF32, {peak[1] / 1e12:g} TB/s")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    log("[2] kernels vs plain versions on the card")
    with phase("[2] mmoe_fused_infer"):
        infer = phase_kernels(gen, peak)
    with phase("[2] sorted_dense_adam_apply"):
        sorted_adam = phase_sorted_adam(gen, peak)
    with phase("[2] sorted_dense_adam_apply bf16"):
        sorted_bf16 = phase_sorted_adam_bf16(args.seed, peak)
    with phase("[2] sorted_dense_adam_apply_sharded"):
        sorted_sharded = phase_sorted_adam_sharded(args.seed, peak)
    with phase("[2] occurrence_segsum, scatter_rows"):
        updates = phase_row_update(gen, peak)
    with phase("[2] fused_dense_adam_apply"):
        updates["fused_dense_adam_apply"] = phase_fused_adam(gen, peak)
    with phase("[2] tower, star, ple kernels"):
        new = phase_new_kernels(gen, peak)
    with phase("[2] sarnet, epnet, ppnet, adasparse kernels"):
        new.update(phase_gated_kernels(gen, peak))
    with phase("[2] hamur, adaptdhm kernels"):
        new.update(phase_hamur_kernels(gen, peak))
    with phase("[2] m2m, m3oe kernels"):
        new.update(phase_meta_kernels(gen, peak))
    models = NEW_MODELS + GATED_MODELS + HAMUR_MODELS + META_MODELS

    log("[3] serving path: MMOE eval at Ali-CCP width, 467k ids per feature")
    with phase("[3] serving mmoe"):
        infer["launches"] = phase_main_path(args.seed, card)[0]["mmoe_fused_infer"]
    for name in models:
        log(f"[3] serving path: {name} eval at Ali-CCP width, 467k ids per feature")
        with phase(f"[3] serving {name}"):
            counts, extra = phase_main_path(args.seed, card, name)
        new[name]["launches"] = counts[EVAL_KERNELS[name][0]]
        new[name].update(extra)
    log("[3] serving path: narrow HamurSmall and MlpN (op by op), card vs CPU")
    with phase("[3] serving narrow hamur_small, mlpn"):
        counts = narrow_serve_card_vs_cpu(args.seed, "hamur_small")
        check(counts["hamur_segment"] == 2 * 3 and sum(counts.values()) == 6,
              f"narrow HamurSmall: launches {counts}")
        counts = narrow_serve_card_vs_cpu(args.seed, "mlpn")
        check(not any(counts.values()), f"narrow MlpN launched a kernel: {counts}")
        narrow_auto(args.seed)
        from scenario_wise_rec_tpu_torch.ops.kernels import FUSED_INFERENCE_WINS
        check(bool(AUTO_PASSED) == bool(FUSED_INFERENCE_WINS),
              f"'auto' predict pass in the set: {AUTO_PASSED}")
        log(f"  'auto' predict passes: {AUTO_PASSED or 'none'} in the set, narrow mlpn outside")
    log("[4] training path: MMOE fit at Ali-CCP width, 467k ids per feature")
    with phase("[4] training mmoe"):
        sorted_adam["launches"] = phase_train(args.seed, card)["sorted_dense_adam_apply"]
    log("[4] training path: MMOE fit over a DeviceResidentLoader at Ali-CCP width, "
        "on-device evaluation, 467k ids per feature")
    with phase("[4] training mmoe resident"):
        resident = phase_train_resident(args.seed, card)
    sorted_adam["resident_launches"] = resident.pop("launches")
    sorted_adam["resident_findings"] = resident
    for name in models:
        log(f"[4] training path: {name} fit at Ali-CCP width, 467k ids per feature")
        with phase(f"[4] training {name}"):
            counts = phase_train_model(args.seed, card, name)
        new[name]["train_path_launches"] = {k: v for k, v in counts.items() if v}
    log("[4] training path: narrow MlpN, the plain dense step, card vs CPU")
    with phase("[4] training narrow mlpn"):
        narrow_train_card_vs_cpu(args.seed, "mlpn")
    log("[4] training path: MMOE fit at Ali-CCP width in the sorted mode with bf16 storage, "
        "the occurrence, dense and winner modes, 467k ids per feature")
    with phase("[4] training mmoe modes"):
        mode_counts = phase_train_modes(args.seed, card)
    updates["occurrence_segsum"]["launches"] = mode_counts["occurrence"]["occurrence_segsum"]
    # the scatter's launches in the two modes that write back through it
    by_mode = {m: mode_counts[m]["scatter_rows"] for m in ("occurrence", "winner")}
    updates["scatter_rows"]["launches"] = sum(by_mode.values())
    updates["scatter_rows"]["launches_by_mode"] = by_mode
    updates["fused_dense_adam_apply"]["launches"] = mode_counts["dense"]["fused_dense_adam_apply"]
    sorted_bf16["launches"] = mode_counts["sorted_bf16"]["sorted_dense_adam_apply_bf16"]
    sorted_bf16["train_step_ms_f32_bf16_in_turns"] = mode_counts["sorted_step_ms"]
    log(f"[4] training path: MMOE at scan_steps={GRAPH_STEPS} (CUDA graphs) at Ali-CCP "
        "width, sorted with f32 and bf16 stores, occurrence, dense and winner, resident and "
        "host epochs; 467k ids per feature")
    with phase("[4] training mmoe graphed"):
        graphed = phase_train_graphed(args.seed, card,
                                      sorted_bf16["device_hp_step0_in_turns_ms"])
    log(f"[4] training path: MMOE fit on a {MESH_SHAPE[0]} x {MESH_SHAPE[1]} (data, embed) "
        "mesh of processes on the one card over gloo, sorted f32, against one process; "
        "Ali-CCP width, 467k ids per feature")
    with phase("[4] training mmoe mesh"):
        mesh = phase_train_mesh(args.seed, card)
    sorted_sharded["launches"] = mesh.pop("launches")
    sorted_sharded.update(mesh)
    sorted_adam["graphed_path"] = graphed["float32"]
    sorted_bf16["graphed_path"] = graphed["bf16"]
    updates["fused_dense_adam_apply"]["graphed_path"] = graphed["dense"]
    for name in ("occurrence_segsum", "scatter_rows"):
        updates[name]["graphed_path"] = graphed["occurrence"]
    updates["scatter_rows"]["winner_graphed_path"] = graphed["winner"]
    updates["fused_dense_adam_apply"]["device_hp_step0_in_turns_ms"] = (
        sorted_bf16["device_hp_step0_in_turns_ms"]["fused"])
    for k in ("step0_device_ms", "step0_host_us"):
        updates["fused_dense_adam_apply"][k] = sorted_bf16[f"fused_dense_adam_apply_{k}"]
    total = time.perf_counter() - t_start
    log(f"[5] done in {total:.1f} s; by phase (s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_S.items())
        + f"; outside the phases {total - sum(PHASE_S.values()):.1f}")
    print(card)
    print(json.dumps({"kernels": [infer, sorted_adam, sorted_bf16, sorted_sharded]
                      + [new[n] for n in models]
                      + [updates[k] for k in ("fused_dense_adam_apply", "occurrence_segsum",
                                              "scatter_rows")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
