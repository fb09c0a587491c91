#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rmm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each (several for the kernel phase); any failed
check exits non-zero before the last line is printed. Every run goes
through all of them:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — compiles every kernel and the host graph engine from the
             checkout's sources, all compilers started together.
3. kernel  — each CUDA kernel against its plain PyTorch version on the
             card: the forward at the serving shapes (edge tokens at the
             edge capacity, node tokens at the node capacity, both read
             from the fixture), at the same shapes with the training
             keep-mask (dropout 0.083), and more (node tokens at the edge
             capacity, C = 128, a ragged batch, a keep-mask at 0.3); the
             backward (and its reduce) against ``torch.autograd.grad`` of
             the plain version at the training shapes with the keep-mask,
             the same unmasked, C = 128 and a ragged batch; both
             directions at the SSL path's C = 128 shapes (131072x6x128/8
             edge tokens, 13000x6x128/8 target rows) and at the narrow
             shapes (32768x6x126/6 and 131072x6x30/6: C not a multiple of
             4, the split routes' narrow GEMMs), each with a 0.5 keep-mask
             and without it, and the split forward's attention core alone
             there against its plain twin; both directions at the
             transfer path's C = 128 shapes (130872x6x128/8 context edge
             tokens, 200x6x128/8 target rows, with the 0.083 keep-mask and
             without it); the families' shapes (131072x5x32/8, cpnatab's
             row attention, with its 0.1 keep-mask and without it;
             131072x7x32/8 and 16384x3x32/8 with the 0.083 keep-mask and
             without it; 131072x8x32/8, ``--ports``' edge rows, with the
             Ethereum run's 0.123 keep-mask and without it, one warm
             repetition). Each record names the route it took (tiled or
             split, by width and S, held to ``route(c, s)``), and two
             calls of each direction at the main path's masked edge shape,
             at the SSL and the transfer masked edge shapes and at the
             masked 32768x6x126/6 are bitwise equal. Max error (the
             backward's relative to each reference tensor's largest
             entry), kernel / plain / library times (CUDA events, warm,
             the median of 5 windows of 10 calls, the plain and library
             calls' of 2) and the bound.
4. serve   — the port's predict CLI (``rmm_tpu_torch.cli.predict.main``)
             at the config of record: 131,072-row synthetic AML, tabgnn,
             C = 32, 2 layers, fanouts 100/100, batch 200, test split, on
             weights converted from the committed JAX fixture
             (``tests/fixtures/torch_port/aml_record.npz``, written by
             ``tools/make_torch_port_fixture.py``). Checks 4 kernel
             launches per batch, all through the tiled forward, finite
             scores, and the first rows against the JAX results.
5. train   — the port's training CLI (``rmm_tpu_torch.cli.main.main``) at
             the config of record (dropout 0.083), one epoch on the same
             data, ``--testing --sampler_threads 4 --save_model``: finite
             loss; per train step 4 forward, 4 backward and 4 reduce
             launches, per evaluated batch 4 forward, every forward and
             backward through the tiled kernels; the checkpoint it
             wrote serves through the predict CLI. Train rows/s, the median
             step on the device's clock, epoch seconds, val/test f1 and AUC.
6. train_parity — three train steps on the card with dropout 0 from the
             fixture's weights against the JAX CPU record of the same
             steps (``tests/fixtures/torch_port/aml_train_record.npz``,
             written by ``tools/make_torch_port_train_fixture.py`` at the
             config's widths on 16,384 rows): the three losses and every
             parameter after step 3 (every launch tiled).
7. ssl_train — SSL pretraining (``PretrainTrainer``, mcm-lp) at the SSL
             config of record (C = 128, 3 layers, 8 heads, 64 negatives,
             batch 200, fanouts 100/100, dropout 0.5, lr 2e-4) on the same
             data: the first 24 train batches, then 24 val batches. Checks
             10 forward, 10 backward and 10 reduce launches a step and 10
             forwards an evaluated batch (C = 128: every forward and
             backward through the split routes), a finite
             loss, 0 < MRR <= 1, a finite RMSE, 0 <= accuracy <= 1. The
             median step on the device's clock, train rows/s, host
             sampling ms a batch and the peak memory.
8. ssl_parity — three mcm-lp steps on the card (dropout 0) against the JAX
             CPU record ``tests/fixtures/torch_port/ssl_record.npz``
             (``tools/make_torch_port_ssl_fixture.py``, the SSL widths on a
             4,096-row cut): the first batch's negatives equal, each loss
             term of each step (total, LP, MCM categorical, MCM numerical),
             and the recorded entries, norms and sums of every variable
             with each component's median (``convert.check_record``).
9. ssl_cli — the SSL CLI (``rmm_tpu_torch.cli.fused.main``) for one epoch
             on that cut with ``--save_model``, then a resume from its
             checkpoint.
10. transfer — SSL → supervised transfer (``cli/main.py --load_model``'s
             ``load_components``) at the SSL widths on the config of
             record's data: ``tabgnnfused`` (C = 128, 8 heads, 3 layers,
             fanouts 100/100, batch 200, dropout 0.083, float32) takes the
             encoders of ``ssl_train``'s checkpoint (only its edge encoder
             exists: all of it grafts, no BatchNorm statistic), trains on
             the first 24 train batches and is evaluated on the first 24
             val batches (cut from 395 and 130), is saved and serves the
             test split through the predict CLI. Checks 5 split forwards,
             backwards and reduces a step and 5 split forwards a batch, a
             finite loss and scores. Grafted and kept leaves, train rows/s,
             the median step, val f1, served rows/s, peak memory.
11. transfer_parity — three ``--freeze`` steps of ``tabgnnfused`` on the
             card after a transfer from the committed JAX checkpoint
             (``tests/fixtures/torch_port/transfer_ssl_ckpt``, read by the
             port's msgpack reader) against the JAX CPU record
             ``transfer_record.npz`` (``tools/make_torch_port_transfer_
             fixture.py``: C = 16, 2 layers, a 1,000-row cut; the tiled
             kernels): the grafted leaves, each loss and the sampled
             variables (``convert.check_record``), the unmoved parameters.
12. node_train — Elliptic node classification (the reference's
             ``elliptic`` config: tabgnn, C = 32, 8 heads, 2 layers,
             fanouts 100/100, batch 200, dropout 0.083) on the port's
             synthetic Elliptic at its published size (203,769
             transactions with 166 feature columns, 234,355 edges; written
             and read as CSV, the ``node_data`` seconds): the first 24 train
             and 24 val batches (the transfer phase's cut), saved. Each step
             and batch launches 2 split calls (the node tokens, S = 167:
             the long attention cores) and 2 tiled (the edge tokens, S = 2)
             each way. Train rows/s, the median step, peak memory, val f1.
13. kernel_long — both directions at S > 16 against the plain twin: the
             node path's [node capacity, 167, 32/8], 4096x17x32/8,
             4096x65x32/8, 4096x40x128/8 and the longest S the cores take
             two blocks an SM at C = 32 and at C = 128 (4096x195x32/8,
             4096x54x128/8), each with the 0.083 keep-mask and without it
             (records as the kernel phase's; two calls bitwise equal at the
             node shape); the node families' 4096x129x32/8 and
             4096x130x32/8, with the 0.083 keep-mask and without it, one
             warm repetition.
14. node_serve — the predict CLI on node_train's checkpoint over the whole
             test split: every labelled test node's id once (no unknown
             class), finite scores, 2 split and 2 tiled forwards a batch.
15. node_parity — the test split served and three steps (dropout 0) on a
             2,000-node cut at the slice's widths, from the JAX CPU record
             ``node_record.npz`` (``tools/make_torch_port_node_fixture.py``)
             and against it: the same node ids, scores within 1e-3, and
             ``convert.check_record``'s float32 limits.
16. family_train — the other model families at the supervised launcher's
             flags (C = 32, 8 heads, 2 layers, fanouts 100/100, batch 200,
             dropout 0.083, float32) on the config of record's data:
             ``pna`` (the launcher's default) for one epoch through the
             training CLI (``--testing --sampler_threads 4 --save_model``),
             its checkpoint serving the test split through the predict
             CLI; ``fttransformer``, ``gin``, ``cpna``, ``cpnatab`` and
             ``tabgnninterleaved`` through the trainer the CLI builds, 24
             train, 24 val and 24 served test batches each. Finite losses,
             the median step on the device's clock, train and served
             rows/s, and the launches a step and a batch: 4, 3 and 2 tiled
             forwards, backwards and reduces for fttransformer,
             tabgnninterleaved and cpnatab, none for the GNN baselines.
17. family_parity — each family from the JAX CPU record
             ``family_record.npz`` (``tools/make_torch_port_family_
             fixture.py``: the launcher's widths with ``--emlps``, dropout
             0, the 16,384-row cut): the first served test batch (the same
             ids, scores within 1e-3) and three steps by
             ``convert.check_record``'s float32 limits (those of
             ``CPNA_MODELS`` for cpna and cpnatab), the same parameters
             unmoved.
18. tabular_mcm — the tabular MCM CLI (``rmm_tpu_torch.cli.fttransformer``)
             at its defaults (C = 128, 8 heads, 3 layers, dropout 0.5,
             batch 200, AdamW lr 2e-4) on the config of record's data: an
             epoch plain, an epoch with ``--mask_vector --save_model``, a
             resume from that epoch. Finite losses, accuracies in [0, 1],
             3 split forwards, backwards and reduces a step (the edge rows
             with their CLS token, 200x6x128/8) and 3 split forwards a val
             batch. Train rows/s and the median step on the device's clock.
19. mcm_edge — ``--task mcm_edge_table``: tabgnn at the config of record
             through the training CLI for an epoch (``--save_model``) on
             the MCM record's 16,384-row cut (4 tiled calls each way a
             step, 4 forwards a val and test batch; ``best_m.json`` the
             epoch's val ``[rmse, accuracy]``), and tabgnnfused at
             C = 128, 3 layers (5 split) through the trainer the training
             CLI builds, 24 train and 24 val batches; finite losses and
             RMSEs, accuracies in [0, 1], the launches by route.
20. ssl_moco — ssl_train with ``--moo moco``: λ on the simplex, 10 split
             forwards a step and one backward a call for the loss whose
             graph reaches it (10 a step: each view's 5 calls reach its
             own loss), and at the SSL target rows two
             ``torch.autograd.grad`` pulls from one forward bitwise equal
             to one ``backward()`` of each loss alone on that graph.
21. mcm_parity — the three objectives against the JAX CPU record
             ``mcm_record.npz`` (``tools/make_torch_port_mcm_fixture.py``):
             the tabular trainer plain and with the mask vector at the
             CLI's widths, ``mcm_edge_table`` for tabgnn, pna, cpna and
             tabgnnfused at the launcher's, MoCo mcm-lp at the SSL
             widths: the first validation batch's outputs, three steps by
             ``convert.check_record`` (MoCo at its own limits, below), the
             launches by route.
22. eth_node — Ethereum phishing node classification (``tabgnn``, the
             launcher's widths with the dataset's overrides: lr 8e-4,
             dropout 0.123, w_ce2 1.16) on the port's synthetic Ethereum
             phishing (57,521 accounts, 262,144 transactions, written as
             CSV with the node families: the ``node_family_data``
             seconds): an epoch through the training CLI (``--epochs 1
             --save_model``: 187 steps, the val and test splits
             evaluated; ``best_m.json`` its val f1, ``-1/`` saved), then
             the predict CLI on ``-1/`` over the test split (the served
             ids are its nodes). 4 tiled calls each way a step.
23. node_menu — the other seven models and ``tabgnn`` with ``--ports``
             and with ``--ego``, an epoch each through the training CLI
             on a cut of 3,700 accounts and 16,862 transactions (13
             steps); the launches by model (``NODE_MENU_CALLS``).
24. eth_ssl — the SSL CLI (``fused.main``, its own ``eth`` dispatch) for
             an epoch with ``--save_model`` on that cut at the SSL config
             of record: 10 split calls each way a step, MRR and Hits@k in
             range, an MCM accuracy of 0 (no categorical column), the
             checkpoint's ``best_m.json`` and ``best_*`` snapshots.
25. node_families — ``tabgnn`` node classification on ogbn-arxiv (8,192
             papers, 56,418 citations), MUSAE GitHub (8,192, 62,799) and
             LastFM Asia (7,624, 27,806) at 128 features (node tokens
             S = 130, 129, 129: the long cores), an epoch each through the
             training CLI (23-25 steps; 40 and 18 classes take the
             weighted f1); ogbn-arxiv's test split served from its
             ``-1/`` checkpoint through the predict CLI.
26. node_family_parity — every run of the JAX CPU record
             ``node_family_record.npz``
             (``tools/make_torch_port_node_family_fixture.py``) on the
             card: the first served batch (ids, logits within 1e-3) and
             three steps by ``convert.check_record`` (``cpna``/``cpnatab``
             at the default limits with ``--ego``, ``CPNA_*`` without;
             ogbn-arxiv's steps 8 more times from the start, each
             component's median over its limit reported), three mcm-lp
             steps on the Ethereum data; the launches by route.
27. device_sampler — the device sampler (``graph/device_sampler.py``)
             alone at the config of record, capacities calibrated (the
             frontier buffer too): 50 train batches sampled on the card
             (CUDA events, ms a batch) beside the host sampler's (the C++
             engine on 4 threads); on every batch the seed edges first in
             input order, each kept edge one of the train split's, nodes
             sorted-unique, the local edge index mapping back; one batch
             under ``torch.cuda.set_sync_debug_mode("error")`` (no host
             sync); drops counted at a tight edge buffer; on the device
             record's cut (every in-degree at most the fanout) the host
             sampler's edge sets and node order.
28. device_train — the training CLI with ``--sampler device`` at the
             config of record for an epoch (``--save_model``), then the
             predict CLI with ``--sampler device`` over the test split:
             train's launch counts, train and served rows/s, the median
             step and the drop rate beside the host sampler's.
29. device_ssl — eth_ssl with ``--sampler device`` (subgraph and
             negatives on the card; run after eth_ssl): the SSL CLI for an
             epoch with ``--save_model`` on the Ethereum cut, the frontier
             buffer calibrated, eth_ssl's batches and checks; its
             launches, MRR, the negatives' residual, the median step
             beside eth_ssl's.
30. device_node — Elliptic node classification through the training CLI
             for an epoch on a cut of 16,384 nodes and 18,843 edges,
             with the host sampler and with ``--sampler device`` (the
             frontier buffer calibrated), then the predict CLI with
             ``--sampler device`` from the device run's ``-1/``: 2 split
             (S = 167, the long cores) and 2 tiled calls each way a step.
31. device_parity — ``device_record.npz`` (the JAX package's device path
             on the CPU, ``tools/make_torch_port_device_fixture.py``: edge,
             node and mcm-lp parts, C = 16, fanouts 64/64 over cuts whose
             in-degrees are at most 64): every sampled array and drop count
             equal to the record's, the port's negatives outside the
             banned set, three steps each by ``convert.check_record`` (the
             mcm-lp steps fed the record's negatives).
32. rel_hm — Rel-H&M on a synthetic cut of 65,536 transactions, 2,829
             customers and 218 articles (S = 15 edge tokens): ``cli/main.py
             --model tabgnn --task mcm_edge_table`` at the config of
             record's widths for an epoch (``--save_model``; 4 tiled calls
             each way a step), the pretrainer's mcm-lp at the SSL widths
             for 12 train and 12 val batches (10 split calls each way a
             step), both directions at those runs' token shapes (the edge
             capacity x 15 x 32/8, tiled, p = 0.083 and 0; the SSL context
             tokens x 15 x 128/8, split, p = 0.5 and 0) and three steps of
             each against ``rel_hm_record.npz`` (its 800-row cut).
33. data_tools — ``prepare_aml`` on a raw CSV in the Kaggle layout and
             ``export_eth`` on a networkx ``MultiDiGraph`` pickle (both
             committed under ``tests/fixtures/torch_port/data_tools``) in
             a child process where importing pandas or networkx fails,
             each output byte for byte the JAX package's, read back by the
             port's datasets.

34. kernel_text — both directions at the text paths' shapes, with the
             LMs' 0.1 keep-mask (two calls bitwise equal) and without it,
             timed once: 256x8x64/8 (the FTTransformer's review tokens,
             tiled), 256x64x64/4 (the downstream LM's 64 token positions)
             and 128x64x128/4 (``finetune_llm``'s; split, the long cores).
             First the cores' shared-memory budget
             (``column_attention.core_budget``): rows within half an SM
             on their old plan, ``finetune_llm``'s backward rows one
             block an SM.
35. text_frozen, text_finetune — ``cli/downstream_llm.py`` for an epoch
             each at its defaults (C = 64, 2 layers, batch 256) on a
             synthetic Amazon Fashion of 32,768 reviews, 8,192 reviewers
             and 1,024 items (seed 0): 2 tiled calls each way a step, and
             under ``finetune`` 2 split ones (the LM's layer, once a text
             column), forwards alone an evaluated batch; a finite loss
             falling from the first ten steps to the last ten; val and test
             RMSE beside a constant prediction's; the materialization
             seconds, the step ms and rows/s.
36. finetune_llm — ``cli/finetune_llm.py`` for an epoch at its defaults
             (hidden 128, 2 layers, 4 heads, 64 tokens, batch 128) on the
             same reviews with ``--save_model``: 2 split calls each way a
             step at 128x64x128/4, finite MSEs, the export read back to the
             same eval MSE.
37. text_parity — ``text_record.npz``
             (``tools/make_torch_port_text_fixture.py``): three steps each
             of both downstream paths and of ``finetune_llm`` at dropout 0
             and C = 16 within ``convert.check_record``'s float32 limits.

And at ``--precision bf16`` (the reference's scheme: float32 masters,
bf16 parameters and tables in each step; under it the AML edge tokens are
float32, their timestamp block being so, and the node tokens bf16):

3b. kernel_bf16 — both directions' bf16 builds (tiled and split) against
             their plain twin on bf16 x, do and weights at the main path's
             edge and node shapes (unmasked and with the training
             keep-mask), the SSL pair (0.5 keep-mask and unmasked),
             32768x6x100/4 (bf16 rows of C % 8 = 4), the narrow shapes
             (0.5 keep-mask and unmasked) and, past S = 16 (the long
             cores; Elliptic's node tokens are bf16 under bf16),
             4096x167x32/8, 4096x40x128/8, 4096x17x32/8, 4096x65x32/8,
             4096x195x32/8 and 4096x54x128/8 (the node keep-mask and
             unmasked), and the shapes bf16 puts on the paths across the
             menu, timed once: the node families' node tokens
             4096x129x32/8 and 4096x130x32/8 (the node keep-mask) and the
             downstream LM's 256x64x64/4 (0.1), each unmasked too; the
             split route's GEMMs on the tensor cores at
             every C % 4 = 0 (csrc/gemm_mma.cuh): out and dx within one
             bf16 rounding, the float32 weight gradients at the float32
             tolerance, bitwise repeats, kernel / plain / library times
             and the bound from bf16 bytes.
4b. serve_bf16 — the predict CLI at bf16 over the test split (2 of the 4
             forwards a batch bf16), the first rows against the JAX bf16
             record ``aml_serve_bf16_record.npz``.
6b. train_parity_bf16 — three bf16 steps against
             ``aml_train_bf16_record.npz`` (``convert.check_record``'s
             bf16 limits).
7b. ssl_train_bf16 — the ssl_train phase at bf16 (its attention float32:
             the split float32 kernels, no bf16 launch).
8b. ssl_parity_bf16 — three bf16 mcm-lp steps against
             ``ssl_bf16_record.npz``.
(the bf16 records: ``tools/make_torch_port_bf16_fixture.py``), and across
the model menu, the launches counted by route and dtype (``read_routes``):
16b. family_bf16 — each family at the launcher's flags, 12 train, val and
             served batches through the training CLI's trainer (only
             fttransformer's node tokens run bf16 calls: 2 tiled each way
             a step); pna's bf16-trained checkpoint (float32 masters, the
             precision in its meta) served by the predict CLI at
             ``--precision bf16``; each beside family_train's float32 step,
             rows/s and launches.
18b. tabular_bf16 — the tabular MCM trainer at C = 128, 12 steps (its rows
             hold the float32 timestamp block: 3 float32 split calls each
             way a step); float32 masters and AdamW state.
26b. node_bf16 — tabgnn on ogbn-arxiv (2 bf16 long-core calls, S = 130,
             and 2 bf16 tiled ones each way a step) and pna on the
             Ethereum cut, 12 train, val and served batches each.
37b. text_bf16 — the downstream text trainer, frozen and finetune, 12
             steps each (finetune: the LM's rows through the bf16 long
             cores, 2 calls each way a step).
37c. bf16_family_parity — every part of ``bf16_family_record.npz``
             (``tools/make_torch_port_bf16_family_fixture.py``: each
             family, tabgnn and pna on Ethereum and MUSAE (S = 129),
             mcm_edge_table, the tabular and text trainers, C = 16) by
             ``replay_bf16_part``: the start's outputs and three steps
             within ``convert.check_record``'s bf16 limits for the part.

And at the widths and row lengths past the kernels' old limits (C > 128;
rows past ``max_s``, which the long cores walk in device memory, their
direct form), and through the profiling and sweep CLIs:

38. wide_paths — at C = 256, 8 heads: ``cli/main.py``'s tabgnn on the
             config of record's data (24 train and 24 val batches float32,
             12 + 12 at ``--precision bf16``: 4 split calls each way a
             step, 2 of them bf16), ``cli/fused.py --mode mcm-lp
             --channels 256`` (12 + 12: 10 split calls each way a step)
             and tabgnn on device_node's Elliptic cut (12 + 12: 2 of its 4
             split calls each way through the direct form, S = 167); each
             a step at a time, finite losses, the loss's (mcm-lp: the LP
             loss's) last third's mean below the first third's, each
             step's loss terms (mcm-lp: beside the same run at C = 128),
             the launches by route, the shapes the runs gave the kernels.
39. kernel_wide — both directions, float32 and bf16, with the runs'
             keep-mask and without it, against the plain twin and the
             library call, each timed once: every shape that wide_paths
             gave the kernels (the AML edge and node tokens, the SSL edge
             lanes and target rows, Elliptic's node rows, 167 tokens past
             the old ``max_s``, and edge tokens at its calibrated
             capacities), then 200x6x512/8, 32768x6x130/10 (the narrow
             GEMMs at 10 heads), and through the direct form
             4096x167x256/8, 4096x130x256/8 (Elliptic's and ogbn-arxiv's
             node tokens at ``--n_hidden 256``, p = 0.083) and
             256x600x32/8; the direct counters move exactly where S passes
             ``max_s``; two calls each way bitwise equal at the masked SSL
             lanes and Elliptic rows.
40. bench_cli — ``cli/benchmark.py`` at the config of record, ``--iters
             20 --profile`` (the phase table; the Chrome trace's CUDA
             events name the column-attention kernels), then ``--loop
             mcm-lp`` at the SSL widths for 10 iterations; launches as the
             iterations make them.
41. sweep — ``cli/sweep.py --kind supervised --trials 2 --epochs 1`` and
             ``--kind fused --trials 1`` on the 16,384-row cut: a JSONL
             line a trial with the reference's keys and the params its
             seed draws.

Then the seconds each phase took, a ``{"kernels": [...]}`` line (an entry
per kernel, each with its ``path``: the main path's tiled kernels at C = 32
(with the node path's edge tokens and the families' calls, their launches
by path and their times at the families' shapes beside), the SSL and
transfer paths' split forward and backward at C = 128 (their launches by
path), with their times at the transfer and the narrow shapes beside, the split routes at S > 16
(the node path's node tokens: their times at the node shape and at the
other long shapes), and the bf16 builds of the tiled and split kernels,
likewise; the masked-cell paths' launches in the tiled and split
entries; the device-sampled paths' and Rel-H&M's launches in the tiled,
split and long entries, Rel-H&M's shapes beside them; the text paths'
launches in the tiled and long entries, their shapes and the cores'
budget beside them; the bf16 phases' launches in the bf16 entries by
route, the long cores' by path, the bf16 path shapes' times beside; the
wide entries (the split routes at C = 256) and the direct form's, with
wide_paths' launches by path and kernel_wide's shapes beside),
the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside it, the script fails and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                       "aml_record.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                             "aml_train_record.npz")
SSL_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                           "ssl_record.npz")
# the bf16 records of tools/make_torch_port_bf16_fixture.py
SERVE_BF16_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                                  "aml_serve_bf16_record.npz")
TRAIN_BF16_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                                  "aml_train_bf16_record.npz")
SSL_BF16_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                                "ssl_bf16_record.npz")
WORK = os.path.join(ROOT, "rmm_tpu_torch", "_build", "smoke")
# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12     # HBM3
PEAK_F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
PEAK_BF16_FLOP_PER_S = 989e12  # bf16 operands, float32 sums (tensor cores)
# The exps of the long attention cores run on the SMs' MUFU units: 16 a
# clock an SM (NVIDIA's Hopper tuning guide), at the H100 SXM's 1,980 MHz
# boost clock
MUFU_PER_CLOCK_PER_SM = 16
SM_CLOCK_HZ = 1.98e9
KERNEL_TOL = 1e-4              # abs: f32, sums in another order
GRAD_TOL = 1e-4                # relative to the reference's largest entry:
#                                the weight gradients sum ~786k tokens
SCORE_TOL = 1e-3               # served score vs the JAX CPU fixture
# bf16: the library call keeps its intermediates in bf16 (the kernels and
# their plain twin in float32), so it is held to a bf16 step of its own
# at the largest entry's scale
LIBRARY_BF16_TOL = 2.0 ** -5
# (bf16 three-step parity: the limits of convert.check_record under bf16)
TRAIN_DROPOUT = 0.083          # the config of record's
# Train parity against the JAX CPU record: the losses move apart as the
# sums' order differs. Adam moves a parameter by at most ~lr a step (its
# m̂/√v̂ is at most 1, 1.0014 and 1.0036 at steps 1-3), so where two runs'
# near-zero gradients differ in sign their parameters part by up to ~2·lr
# a step: 3 steps bound the largest error by 6.01·lr. The median error
# (0.003·lr on the CPU) is what a wrong gradient would move.
LOSS1_RTOL, LOSS_RTOL = 1e-4, 1e-3
PARAM_MAX_LR, PARAM_MEDIAN_LR = 6.05, 0.05
# The SSL config of record (the JAX fused CLI's defaults): C = 128, 3 layers,
# 8 heads, 64 negatives, batch 200, fanouts 100/100, dropout 0.5, lr 2e-4.
SSL_ARGV = ["--mode", "mcm-lp", "--channels", "128", "--num_layers", "3",
            "--num_neg_samples", "64", "--batch_size", "200",
            "--khop_neighbors", "100", "100", "--dropout", "0.5",
            "--lr", "2e-4"]
SSL_DROPOUT = 0.5
SSL_BATCHES = 24      # train and val batches of the ssl_train phase
TRANSFER_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                                "transfer_record.npz")
# The transfer phase's fine-tune: tabgnnfused at the SSL widths on the
# supervised config of record's data and flags (dropout 0.083), its train
# and val splits cut to the first TRANSFER_BATCHES batches as ssl_train's
# are (a step is about one SSL view over the edge tokens, ~0.1 s)
TRANSFER_BATCHES = 24
TRANSFER_ARGV = ["--model", "tabgnnfused", "--n_hidden", "128",
                 "--n_gnn_layers", "3"]

# The node path (Elliptic node classification, the reference's elliptic
# config: tabgnn, C = 32, 8 heads, 2 layers, fanouts 100/100, batch 200,
# dropout 0.083) on the port's synthetic Elliptic at its published size:
# 203,769 transactions with 166 feature columns (node tokens S = 167: the
# split routes' long cores) and 234,355 edges (one dummy attribute: edge
# tokens S = 2, the tiled kernels). Its train and val splits are cut to the
# first NODE_BATCHES batches, as the transfer phase's are.
ELLIPTIC_NODES, ELLIPTIC_EDGES, ELLIPTIC_FEATS = 203769, 234355, 166
NODE_S = ELLIPTIC_FEATS + 1
NODE_BATCHES = 24
# device_node's cut of it for an epoch through the CLIs: 16,384 nodes at
# the published 1.15 edges a node (~12.4x; 50 train steps an epoch)
ELLIPTIC_CUT_NODES, ELLIPTIC_CUT_EDGES = 16384, 18843
NODE_ARGV = ["--model", "tabgnn", "--n_hidden", "32", "--n_gnn_layers", "2",
             "--num_neighs", "100", "100", "--batch_size", "200"]
NODE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                            "node_record.npz")

# The other model families of the supervised launcher
# (launchers/supervised/supervised.sh: --model "${MODEL:-pna}", C = 32, 8
# heads, 2 layers, fanouts 100/100, batch 200, dropout 0.083, float32) on
# the config of record's data: pna, the launcher's default, through the
# training and predict CLIs for an epoch; the others through the trainer
# the training CLI builds, cut to FAMILY_BATCHES train, val and test
# batches (the node_train cut).
FAMILIES = ("fttransformer", "gin", "pna", "cpna", "cpnatab",
            "tabgnninterleaved")
FAMILY_ARGV = ["--n_hidden", "32", "--n_gnn_layers", "2", "--num_neighs",
               "100", "100", "--batch_size", "200"]
FAMILY_BATCHES = 24
FAMILY_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                              "family_record.npz")
#: column-attention calls a step or batch of each family makes, each
#: direction, all tiled (C = 32, S <= 16): fttransformer 2 layers x node
#: (S = 2) and edge (S = 6) tokens; tabgnninterleaved the stem and 2 layers
#: on the edge tokens (S = 6); cpnatab 2 row-attention layers over the 5
#: column states (S = 5; the reference's fixed dropout 0.1 in training);
#: the GNN baselines none
FAMILY_CALLS = {"fttransformer": 4, "gin": 0, "pna": 0, "cpna": 0,
                "cpnatab": 2, "tabgnninterleaved": 3}
CPNATAB_ROW_DROPOUT = 0.1

# Node classification on Ethereum phishing (the reference's phishing task):
# the supervised launcher's widths (C = 32, 8 heads, fanouts 100/100, batch
# 200) with the dataset's overrides (lr 8e-4, dropout 0.123, w_ce2 1.16, 2
# layers), on the port's synthetic Ethereum phishing: 262,144 transactions
# over 57,521 accounts, the published network's ~4.56 transactions an
# account (13.6M over 3.0M), cut ~52x. Every token is tiled: the node's
# one constant token and CLS (S = 2), the edges' four numerical columns,
# the timestamp and CLS (S = 6; 8 with --ports). Each run is one epoch
# through the training CLI: tabgnn's on that data (187 steps), the other
# models' and the SSL CLI's on a cut of 3,700 accounts at the same ratio
# (16,862 transactions: 13 node steps, 51 SSL steps an epoch).
ETH_NODES, ETH_EDGES = 57521, 262144
ETH_CUT_NODES, ETH_CUT_EDGES = 3700, 16862
ETH_DROPOUT = 0.123
#: column-attention calls (forwards, backwards) a node-classification
#: step of each model makes on Ethereum phishing, all tiled; an evaluated
#: or served batch makes the forwards: fttransformer 2 layers on the node
#: tokens; cpnatab 2 row-attention layers over the 5 edge column states,
#: whose output no node head reads (as in the reference), so no gradient
#: reaches them; tabgnn a layer each on the node and the edge tokens, 2
#: layers; tabgnninterleaved the stem and 2 layers on the edge tokens;
#: tabgnnfused the top-level layer on the context edge tokens and on the
#: targets, and one a fused layer; the GNN baselines none
NODE_MENU_CALLS = {"fttransformer": (2, 2), "gin": (0, 0), "pna": (0, 0),
                   "cpna": (0, 0), "cpnatab": (2, 0), "tabgnn": (4, 4),
                   "tabgnninterleaved": (3, 3), "tabgnnfused": (4, 4)}
# The three feature-node families at 128 features (ogbn-arxiv's published
# width; the width of PyTorch Geometric's GitHub and LastFMAsia versions):
# node tokens S = 129, and 130 for ogbn-arxiv, whose year is a feature too
# (the long cores); their edges one dummy column (S = 2, tiled). Each trains
# an epoch through the training CLI. Family → (directory, nodes, edges,
# classes): LastFM Asia at its published size; ogbn-arxiv and MUSAE GitHub
# at 8,192 nodes and their published edges a node (ogbn-arxiv 1,166,243
# citations over 169,343 papers, cut ~21x; MUSAE 289,003 over 37,700, cut
# ~4.6x), so that an epoch fits the time limit.
FAMILY_FEATS = 128
NODE_FAMILIES = {"ogbn": ("ogbn-arxiv", 8192, 56418, 40),
                 "musae": ("musae-github", 8192, 62799, 2),
                 "lastfm": ("lastfm-asia", 7624, 27806, 18)}
NODE_FAMILY_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                                   "node_family_record.npz")
#: record runs whose three steps node_family_parity takes again from the
#: record's start, to read how far from its limits each lands: ogbn-arxiv's
#: ``model`` median sits at 0.93 of its limit on the CPU, one of two modes
#: (first-step gradients at rounding level that Adam turns into full steps
#: of either sign), and the card's float atomics round each run anew. The
#: first run is held to the limits; a repeat's faults are reported (its
#: launches are checked)
NODE_FAMILY_REPEATS = {"ogbn": 8}


def route_counts(fwd: int, bwd: int, route: str = "split") -> dict:
    """The float32 launch counts of ``fwd`` forwards and ``bwd`` backwards
    (a reduce each), all through ``route``."""
    other = "tiled" if route == "split" else "split"
    return {"fwd": fwd, f"fwd_{route}": fwd, f"fwd_{other}": 0,
            "bwd": bwd, f"bwd_{route}": bwd, f"bwd_{other}": 0,
            "reduce": bwd, **NO_BF16}


def family_counts(model: str, fwd: int, bwd: int) -> dict:
    """The launches of ``fwd`` forwards and ``bwd`` backwards of a family,
    every one tiled, float32."""
    k = FAMILY_CALLS[model]
    return route_counts(k * fwd, k * bwd, "tiled")


# column attention launches an mcm-lp step makes, each direction: two views
# x (the top-level encoder layer on the edge tokens and on the target rows,
# plus one a fused layer on the target rows)
SSL_LAUNCHES = 2 * (2 + 3)


def fused_launches(layers: int) -> int:
    """Column-attention calls a tabgnnfused step makes, each direction: the
    top-level encoder layer on the context edge tokens and on the target
    rows, and one a fused layer on the target rows."""
    return 2 + layers


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_floor(b, s, c, h, masked, elem: int = 4,
                    peak: float = PEAK_F32_FLOP_PER_S) -> tuple[float, float]:
    """Least times (ms) for the work, by bytes and by operations: x read +
    o written + weights (+ the keep-mask) over HBM bandwidth, at ``elem``
    bytes an element, and the FMAs (2 flops each) of the two projections,
    the scores and the context over ``peak`` (the float32 one; bf16
    operands with float32 sums: the tensor cores' bf16 peak)."""
    hd = c // h
    nbytes = elem * (2 * b * s * c + 4 * c * c + 4 * c)
    if masked:
        nbytes += b * h * s * s
    flops = 2 * b * s * (3 * c * c + c * c) + 2 * 2 * b * h * s * s * hd
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return t_bytes, t_ops


def attention_bwd_floor(b, s, c, h, masked, elem: int = 4,
                        peak: float = PEAK_F32_FLOP_PER_S
                        ) -> tuple[float, float]:
    """The backward's least times (ms) for its work, whatever route does
    it: x and do read and dx written (``elem`` bytes an element), the
    keep-mask, the weights read (``elem`` bytes) and their gradients
    written (float32); operations: about 11·C² FMAs a token (qkv again,
    dctx, dx, dWqkv, dWout) and 6·S·C for the attention (scores, ctx, dP,
    dq, dk, dv), over ``peak``."""
    total = 4 * c * c + 4 * c
    nbytes = elem * (3 * b * s * c + total) + 4 * total
    if masked:
        nbytes += b * h * s * s
    flops = 2 * b * s * (11 * c * c + 6 * s * c)
    return (nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3)


def exp_floor_ms(b, s, h, walks: int) -> float | None:
    """Past S = 16 the least time of the long cores' exps: ``walks`` exps
    a (query, key) pair of a head (1 forward, 3 backward: each walk
    recomputes them) over the card's MUFU rate; None at S <= 16. The bound
    of :func:`attention_floor` counts only bytes and FMAs."""
    import torch

    if s <= 16:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (walks * b * h * s * s
            / (MUFU_PER_CLOCK_PER_SM * sms * SM_CLOCK_HZ) * 1e3)


def bound(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def fixture_settings() -> dict:
    import numpy as np

    return json.loads(str(np.load(FIXTURE)["settings"]))


def random_inputs(rng, b, s, c, device):
    import numpy as np
    import torch

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(device)

    return (t(b, s, c), t(c, 3 * c, scale=c ** -0.5), t(3 * c, scale=0.1),
            t(c, c, scale=c ** -0.5), t(c, scale=0.1))


def card_inputs(rng, b, s, c, device):
    """:func:`random_inputs`' tensors, drawn on the card from a generator
    that ``rng`` seeds (numpy's host draws of ~200M entries took most of
    kernel_wide's time)."""
    import torch

    gen = torch.Generator(device).manual_seed(int(rng.randint(2 ** 31)))

    def t(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    return (t(b, s, c), t(c, 3 * c, scale=c ** -0.5), t(3 * c, scale=0.1),
            t(c, c, scale=c ** -0.5), t(c, scale=0.1))


def keep_mask(rng, b: int, h: int, s: int, rate: float, dev):
    """A keep-mask [b, h, s, s], each entry kept with probability 1 -
    ``rate``, drawn on the card from a generator that ``rng`` seeds (drawn
    by numpy on the host, the masks of the long rows, up to 1.25 billion
    entries each, took most of the long kernel phases' time)."""
    import torch

    gen = torch.Generator(dev).manual_seed(int(rng.randint(2 ** 31)))
    return torch.rand((b, h, s, s), generator=gen, device=dev) >= rate


# The CUDA grid's y limit: PyTorch's flash attention lays the batch out
# along y, so on bf16 it refuses to launch past 65,535 rows ("invalid
# configuration argument"), and the library call takes its math backend
# there (library_backend).
GRID_Y_MAX = 65535


def library_backend(x) -> str:
    import torch

    return ("math" if x.dtype == torch.bfloat16 and x.shape[0] > GRID_Y_MAX
            else "default")


def library_attention(x, wqkv, bqkv, wout, bout, h):
    """One ``torch.nn.functional.multi_head_attention_forward`` call with
    the same weights (a yardstick only: the port never calls it), on the
    backend of :func:`library_backend`."""
    import contextlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q = x.transpose(0, 1)
    c = x.shape[-1]
    with (sdpa_kernel(SDPBackend.MATH) if library_backend(x) == "math"
          else contextlib.nullcontext()):
        return F.multi_head_attention_forward(
            q, q, q, c, h, wqkv.t(), bqkv, None, None, False, 0.0,
            wout.t(), bout, training=False,
            need_weights=False)[0].transpose(0, 1)


# The SSL path's shapes at C = 128 (the split forward and backward): the
# edge tokens at the edge capacity and the target rows (200 seeds x 65),
# with the SSL keep-mask and without it (where the library call times them).
SSL_SHAPES = [(131072, 6, 128, 8, SSL_DROPOUT),
              (13000, 6, 128, 8, SSL_DROPOUT),
              (131072, 6, 128, 8, 0.0), (13000, 6, 128, 8, 0.0)]
# The transfer path's shapes at C = 128 (supervised tabgnnfused, batch 200,
# the split routes): the context edge tokens (the edge capacity less the
# 200 seed lanes) and the 200 target rows, with the training keep-mask and
# without it (evaluation and serving, where the library call times them).
def transfer_shapes(edges: int, batch: int) -> list:
    return [(edges - batch, 6, 128, 8, TRAIN_DROPOUT),
            (batch, 6, 128, 8, TRAIN_DROPOUT),
            (edges - batch, 6, 128, 8, 0.0), (batch, 6, 128, 8, 0.0)]


# Widths that are not a multiple of 4 (the split routes' narrow GEMMs),
# each with the 0.5 keep-mask and without it
NARROW_SHAPES = [(b, s, c, h, rate) for b, s, c, h in
                 [(32768, 6, 126, 6), (131072, 6, 30, 6)]
                 for rate in (SSL_DROPOUT, 0.0)]


#: ``time_ms``' (reps, windows) of a record: (10, 5), or one warm
#: repetition at the kernel phases' shapes off every path (PERF.md §4,
#: "Widths off the paths"; every check still runs), which keeps the run
#: inside its time limit
PATH_TIMING, OFF_PATH_TIMING = (10, 5), (1, 1)


def ref_timing(timing: tuple) -> tuple:
    """A record's ``timing`` for its plain and library calls: at most 2
    windows (3-70 ms a call, against the kernel's 0.04-10: five windows of
    each would take ~80 s of the run's time limit, and three kept the
    whole run past 1,000 s of its 1,200)."""
    reps, windows = timing
    return reps, min(windows, 2)


def off_path(b: int, s: int, c: int, h: int) -> bool:
    """A float32 shape that no path runs: C % 4 ≠ 0, 32768x6x100/4,
    131072x7x32/8 and 16384x3x32/8, and past S = 16 every row but
    Elliptic's 167 (17, 65, 40x128 and the longest rows at C = 32 and
    128; the node families' 129 and 130 run on their paths at other
    batch sizes and are timed once too)."""
    if s > 16:
        return s != NODE_S
    return (b, s, c, h) in {(32768, 6, 126, 6), (131072, 6, 30, 6),
                            (32768, 6, 100, 4), (131072, 7, 32, 8),
                            (16384, 3, 32, 8)}


def timing_of(b: int, s: int, c: int, h: int, *_) -> tuple:
    return OFF_PATH_TIMING if off_path(b, s, c, h) else PATH_TIMING


def fwd_record(rng, dev, b, s, c, h, rate, card, repeat=False,
               timing=PATH_TIMING, phase: str = "kernel",
               draw=random_inputs) -> dict:
    """The forward at one shape (seeded inputs, a keep-mask where ``rate``
    > 0) against its plain version on the card: the route it took (held to
    ``route(c, s)``), two calls bitwise equal where ``repeat``, the split
    forward's core alone against its twin, kernel / plain / library times
    (``time_ms``'s ``(reps, windows)`` = ``timing``) and the bound."""
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    x, wqkv, bqkv, wout, bout = draw(rng, b, s, c, dev)
    mask = None
    if rate > 0:
        mask = keep_mask(rng, b, h, s, rate, dev)
    args = (x, wqkv, bqkv, wout, bout, h, mask, rate)
    with torch.inference_mode():
        before = (ca.fwd_tiled_launches, ca.fwd_split_launches)
        out = ca.fused_column_attention(*args)
        route = ("tiled" if ca.fwd_tiled_launches > before[0] else
                 "split" if ca.fwd_split_launches > before[1] else None)
        check(route == ca.route(c, s),
              f"forward {b}x{s}x{c}/{h} took the {route} route, not "
              f"{ca.route(c, s)}")
        repeat_equal = None
        if repeat:
            repeat_equal = torch.equal(out, ca.fused_column_attention(*args))
            check(repeat_equal, f"forward {b}x{s}x{c}/{h}: two calls on "
                  "the same inputs differ")
        ref = ca.reference_column_attention(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(math.isfinite(err) and err <= KERNEL_TOL,
              f"column attention {b}x{s}x{c}/{h} p={rate}: "
              f"max_abs_err {err} > {KERNEL_TOL}")
        core_err = None
        if route == "split":   # the attention core alone, on the qkv
            tok = torch.matmul(x, wqkv) + bqkv
            core_err = float((ca.attention_core_fwd(tok, h, mask, rate)
                              - ca.reference_attention_core(
                                  tok, h, mask, rate)).abs().max())
            check(math.isfinite(core_err) and core_err <= KERNEL_TOL,
                  f"split forward's core {b}x{s}x{c}/{h} p={rate}: "
                  f"max_abs_err {core_err} > {KERNEL_TOL}")
            del tok
        k_ms = time_ms(lambda: ca.fused_column_attention(*args), *timing)
        p_ms = time_ms(lambda: ca.reference_column_attention(*args),
                       *ref_timing(timing))
        lib_ms = None
        if mask is None:   # no library call takes an explicit keep-mask
            lib = (x, wqkv, bqkv, wout, bout, h)
            lib_err = float((library_attention(*lib) - ref).abs().max())
            check(lib_err <= KERNEL_TOL,
                  f"library attention disagrees: {lib_err}")
            lib_ms = time_ms(lambda: library_attention(*lib),
                             *ref_timing(timing))
    t_bytes, t_ops = attention_floor(b, s, c, h, mask is not None)
    bound_ms, by = bound(t_bytes, t_ops)
    plan = ca.fwd_plan(b, s, c, h)
    rec = {"phase": phase, "kernel": "column_attention_fwd",
           "B": b, "S": s, "C": c, "H": h, "dropout": rate,
           "route": route, "rows": plan.rows,
           "blocks": ca.core_blocks(plan, h),
           "direct": plan.direct,
           "repeat_bitwise_equal": repeat_equal, "max_abs_err": err,
           "core_max_abs_err": core_err,
           "tol": KERNEL_TOL, "kernel_ms": k_ms,
           "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": by, "bytes_ms": t_bytes, "ops_ms": t_ops,
           "exp_floor_ms": exp_floor_ms(b, s, h, 1), "card": card,
           "ok": True}
    emit(rec)
    del x, out, ref, mask, args
    torch.cuda.empty_cache()
    return rec


def bwd_record(rng, dev, b, s, c, h, rate, card, repeat=False,
               timing=PATH_TIMING, phase: str = "kernel",
               draw=random_inputs) -> dict:
    """The backward (and its reduce) at one shape against
    ``torch.autograd.grad`` of the plain version: the route (held to
    ``route(c, s)``), two calls bitwise equal where ``repeat``, each
    gradient's error relative to its largest entry, kernel / plain /
    library times and the bound."""
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    inputs = draw(rng, b, s, c, dev)
    do = draw(rng, b, s, c, dev)[0]
    mask = None
    if rate > 0:
        mask = keep_mask(rng, b, h, s, rate, dev)
    x, wqkv, bqkv, wout, _ = inputs
    args = (x, do, wqkv, bqkv, wout, h, mask, rate)
    before = (ca.bwd_tiled_launches, ca.bwd_split_launches)
    got = ca.column_attention_bwd(*args)
    route = ("tiled" if ca.bwd_tiled_launches > before[0] else
             "split" if ca.bwd_split_launches > before[1] else None)
    check(route == ca.route(c, s),
          f"backward {b}x{s}x{c}/{h} took the {route} route, not "
          f"{ca.route(c, s)}")
    repeat_equal = None
    if repeat:   # the weight gradients are deterministic
        again = ca.column_attention_bwd(*args)
        repeat_equal = all(torch.equal(g, a) for g, a in zip(got, again))
        check(repeat_equal, f"backward {b}x{s}x{c}/{h}: two calls on "
              "the same inputs differ")
        del again
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = ca.reference_column_attention(*leaves, h, mask, rate)
    want = torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    names = ("dx", "dwqkv", "dbqkv", "dwout", "dbout")
    errs = {n: float((g - w).abs().max() / w.abs().max().clamp(
        min=1e-30)) for n, g, w in zip(names, got, want)}
    check(all(math.isfinite(e) and e <= GRAD_TOL for e in errs.values()),
          f"column attention backward {b}x{s}x{c}/{h} p={rate}: "
          f"relative errors {errs} > {GRAD_TOL}")
    k_ms = time_ms(lambda: ca.column_attention_bwd(*args), *timing)
    p_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True),
                   *ref_timing(timing))
    lib_ms = None
    if mask is None:   # the backward alone of the library call
        lib_out = library_attention(*leaves, h)
        lib_dx = torch.autograd.grad(lib_out, leaves[0], do,
                                     retain_graph=True)[0]
        lib_err = float((lib_dx - want[0]).abs().max()
                        / want[0].abs().max())
        check(lib_err <= GRAD_TOL,
              f"library attention backward disagrees: {lib_err}")
        lib_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), *ref_timing(timing))
        del lib_out, lib_dx
    plan = ca.bwd_plan(b, s, c, h)
    t_bytes, t_ops = attention_bwd_floor(b, s, c, h, mask is not None)
    bound_ms, by = bound(t_bytes, t_ops)
    rec = {"phase": phase, "kernel": "column_attention_bwd",
           "B": b, "S": s, "C": c, "H": h, "dropout": rate,
           "route": route, "rows": plan.rows,
           "blocks": ca.core_blocks(plan, h), "slices": plan.slices,
           "direct": plan.direct,
           "repeat_bitwise_equal": repeat_equal,
           "max_rel_err": errs, "tol": GRAD_TOL,
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, want)),
           "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": by, "bytes_ms": t_bytes,
           "ops_ms": t_ops, "exp_floor_ms": exp_floor_ms(b, s, h, 3),
           "card": card, "ok": True}
    emit(rec)
    del inputs, do, mask, args, got, leaves, out, want
    torch.cuda.empty_cache()
    return rec


def kernel_phase(card: str) -> dict:
    """Column attention on the card against its plain version. Returns the
    records of the main path's shapes: ``fwd``/``fwd_masked``/``bwd`` pairs
    (edge tokens at the edge capacity, node tokens at the node capacity)
    and ``bwd_unmasked`` (where the library call times the backward)."""
    import numpy as np
    import torch

    st = fixture_settings()
    edges, nodes, c = st["edge_capacity"], st["node_capacity"], st["n_hidden"]
    p = TRAIN_DROPOUT
    transfer = transfer_shapes(edges, st["batch_size"])
    # the families' shapes, then 32768x6x100/4 (C % 8 = 4, which the bf16
    # phase times too)
    extra = family_shapes(edges, nodes, c) + [(32768, 6, 100, 4, 0.0)]
    fwd_shapes = [  # (B, S, C, H, dropout)
        (edges, 6, c, 8, 0.0),       # serving path: edge tokens
        (nodes, 2, c, 8, 0.0),       # serving path: node tokens
        (edges, 6, c, 8, p),         # training path: edge tokens
        (nodes, 2, c, 8, p),         # training path: node tokens
        (edges, 2, c, 8, 0.0),       # node tokens at the edge capacity
        (32768, 6, 128, 8, 0.0),     # SSL width, the split route
        (100003, 6, 32, 8, 0.0),     # ragged batch
        (4099, 6, 64, 4, 0.3),       # a keep-mask at dropout 0.3
    ] + NARROW_SHAPES + transfer + SSL_SHAPES + extra
    bwd_shapes = [
        (edges, 6, c, 8, p),         # training path: edge tokens
        (nodes, 2, c, 8, p),         # training path: node tokens
        (edges, 6, c, 8, 0.0),       # the same unmasked (library time)
        (nodes, 2, c, 8, 0.0),
        (32768, 6, 128, 8, 0.0),     # SSL width, the split route
        (100003, 6, 32, 8, p),       # ragged batch
    ] + NARROW_SHAPES + transfer + SSL_SHAPES + extra
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    # two calls of each direction are held bitwise equal at the masked edge
    # shapes of the main path, of the SSL path and of the transfer path,
    # and at the first narrow shape
    repeat = (SSL_SHAPES[0], NARROW_SHAPES[0], transfer[0])
    fwd = [fwd_record(rng, dev, *shape, card,
                      repeat=i == 2 or shape in repeat,
                      timing=timing_of(*shape))
           for i, shape in enumerate(fwd_shapes)]
    bwd = [bwd_record(rng, dev, *shape, card,
                      repeat=i == 0 or shape in repeat,
                      timing=timing_of(*shape))
           for i, shape in enumerate(bwd_shapes)]
    f = len(extra)
    fwd, fam_fwd = fwd[:-f], fwd[-f:]
    bwd, fam_bwd = bwd[:-f], bwd[-f:]
    # --ports: the edge tokens two columns longer (S = 8, the Ethereum
    # run's dropout), beside the S = 7 family shape; one warm repetition
    ports = [(edges, 8, c, 8, ETH_DROPOUT), (edges, 8, c, 8, 0.0)]
    ports_fwd = [fwd_record(rng, dev, *shape, card, timing=OFF_PATH_TIMING)
                 for shape in ports]
    ports_bwd = [bwd_record(rng, dev, *shape, card, timing=OFF_PATH_TIMING)
                 for shape in ports]
    n, m = len(SSL_SHAPES), len(transfer)
    narrow = [r for r in fwd + bwd
              if (r["B"], r["S"], r["C"], r["H"], r["dropout"])
              in NARROW_SHAPES]
    check(all(r["route"] == "split" for r in narrow),
          "a narrow shape did not take the split route")
    return {"fwd": fwd[:2], "fwd_masked": fwd[2:4], "bwd": bwd[:2],
            "bwd_unmasked": bwd[2:4], "ssl_fwd": fwd[-n:][:2],
            "ssl_fwd_unmasked": fwd[-n:][2:], "ssl_bwd": bwd[-n:][:2],
            "ssl_bwd_unmasked": bwd[-n:][2:],
            "transfer_fwd": fwd[-n - m:-n], "transfer_bwd": bwd[-n - m:-n],
            "family_fwd": fam_fwd[:-1], "family_bwd": fam_bwd[:-1],
            "c100_fwd": fam_fwd[-1], "c100_bwd": fam_bwd[-1],
            "ports_fwd": ports_fwd, "ports_bwd": ports_bwd,
            "narrow_fwd": [r for r in narrow
                           if r["kernel"] == "column_attention_fwd"],
            "narrow_bwd": [r for r in narrow
                           if r["kernel"] == "column_attention_bwd"]}


def family_shapes(edges: int, nodes: int, c: int) -> list:
    """The families' shapes at the config of record's capacities, each with
    a keep-mask and without it: cpnatab's row attention over the 5 edge
    column states (its fixed dropout 0.1), and the edge and node tokens
    with one token more than tabgnn's (S = 7 and 3, the training dropout;
    fttransformer and tabgnninterleaved run tabgnn's S = 6 and 2, their CLS
    token included)."""
    return [(edges, 5, c, 8, CPNATAB_ROW_DROPOUT), (edges, 5, c, 8, 0.0),
            (edges, 7, c, 8, TRAIN_DROPOUT), (edges, 7, c, 8, 0.0),
            (nodes, 3, c, 8, TRAIN_DROPOUT), (nodes, 3, c, 8, 0.0)]


def long_shapes(node_capacity: int) -> list:
    """Rows past S = 16 (the split routes' long attention cores), each with
    the node path's 0.083 keep-mask and without it: the node path's
    [node capacity, 167, 32/8], 4096x17x32/8, 4096x65x32/8 (a lane's third
    query, a third chunk of keys), 4096x40x128/8 and the longest S the
    cores take at C = 32 and at C = 128 (8 heads) two blocks an SM
    (``column_attention.core_max_s`` with the library's bytes a row at
    half an SM: 195 and 54 on an H100; longer rows, up to ``max_s``, run
    one block an SM: ``kernel_text``'s 128x64x128/4)."""
    from rmm_tpu_torch.ops import column_attention as ca

    block, sm = ca._card_smem()
    half = min(block, sm // 2 - 1024)
    longest = {c: ca.core_max_s(c, 8, half, sm, ca.core_row_bytes)
               for c in (32, 128)}
    shapes = [(node_capacity, NODE_S, 32, 8), (4096, 17, 32, 8),
              (4096, 65, 32, 8), (4096, 40, 128, 8),
              (4096, longest[32], 32, 8), (4096, longest[128], 128, 8)]
    return [(*shape, rate) for shape in shapes
            for rate in (TRAIN_DROPOUT, 0.0)]


def kernel_long_phase(card: str, node_capacity: int) -> dict:
    """Both directions at S > 16 against the plain twin on the card
    (:func:`long_shapes`), each through the split route; two calls of each
    direction bitwise equal at the node shape. Then the node families'
    rows at 128 features, 4096x129x32/8 (MUSAE GitHub, LastFM Asia) and
    4096x130x32/8 (ogbn-arxiv: its ``year`` is a feature too), with the
    runs' 0.083 keep-mask and without it, one warm repetition each.
    Returns the records of the node shape (masked, then unmasked), of the
    other shapes and of the families'."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    shapes = long_shapes(node_capacity)
    fwd = [fwd_record(rng, dev, *shape, card, repeat=i < 2,
                      timing=timing_of(*shape))
           for i, shape in enumerate(shapes)]
    bwd = [bwd_record(rng, dev, *shape, card, repeat=i < 2,
                      timing=timing_of(*shape))
           for i, shape in enumerate(shapes)]
    fam = [(4096, FAMILY_FEATS + k, 32, 8, rate) for k in (1, 2)
           for rate in (TRAIN_DROPOUT, 0.0)]
    fam_fwd = [fwd_record(rng, dev, *shape, card, timing=OFF_PATH_TIMING)
               for shape in fam]
    fam_bwd = [bwd_record(rng, dev, *shape, card, timing=OFF_PATH_TIMING)
               for shape in fam]
    check(all(r["route"] == "split" for r in fwd + bwd + fam_fwd + fam_bwd),
          "a row past 16 tokens did not take the split route")
    return {"node_fwd": fwd[:2], "node_bwd": bwd[:2], "fwd": fwd[2:],
            "bwd": bwd[2:], "family_fwd": fam_fwd, "family_bwd": fam_bwd}


def bf16_close(got, want) -> float:
    """How far ``got`` lies past one bf16 rounding of ``want`` (2^-7 of
    the value, plus 1e-5 of the largest entry, as the sums of the two
    sides run in another order): <= 0 where it holds."""
    g, w = got.float(), want.float()
    bound_ = 2.0 ** -7 * g.abs().maximum(w.abs()) + 1e-5 * float(
        w.abs().max())
    return float(((g - w).abs() - bound_).max())


def bf16_shapes(edges: int, nodes: int, c: int) -> list:
    """(B, S, C, H, dropout) of the bf16 kernel phase: the main path's edge
    and node tokens unmasked and with the training keep-mask (the path
    runs its node tokens in bf16: its edge tokens hold the float32
    timestamp block), the SSL path's pair with and without its 0.5
    keep-mask (the split route), C = 100, rows of C % 8 = 4 bf16 values,
    and the narrow shapes (the split route's narrow GEMMs)."""
    p = TRAIN_DROPOUT
    return [(edges, 6, c, 8, 0.0), (nodes, 2, c, 8, 0.0),
            (edges, 6, c, 8, p), (nodes, 2, c, 8, p),
            (131072, 6, 128, 8, SSL_DROPOUT), (13000, 6, 128, 8, SSL_DROPOUT),
            (131072, 6, 128, 8, 0.0), (13000, 6, 128, 8, 0.0),
            (32768, 6, 100, 4, 0.0)] + NARROW_SHAPES


def bf16_long_shapes() -> list:
    """(B, S, C, H, dropout) of the bf16 kernel phase past S = 16 (the
    split routes' long cores, which the bf16 build holds too: Elliptic's
    node tokens are bf16 under --precision bf16): the node path's
    4096x167x32/8, 4096x40x128/8, 4096x17x32/8, 4096x65x32/8 and the
    longest rows of ``kernel_long`` (4096x195x32/8, 4096x54x128/8), each
    with the node path's keep-mask and without it."""
    return [(4096, s, c, 8, rate)
            for s, c in ((NODE_S, 32), (40, 128), (17, 32), (65, 32),
                         (195, 32), (54, 128))
            for rate in (TRAIN_DROPOUT, 0.0)]


def bf16_pair(rng, dev, b, s, c, h, rate, card, repeat=False,
              timing=PATH_TIMING, phase: str = "kernel_bf16",
              draw=random_inputs) -> tuple:
    """Both directions at one shape on bf16 x, do and weights (seeded, a
    keep-mask where ``rate`` > 0) against their plain twin on the same
    values: out and dx within one bf16 rounding, the float32 weight and
    bias gradients at GRAD_TOL, through the bf16 build of ``route(c, s)``;
    two calls of each direction bitwise equal where ``repeat``; kernel /
    plain / library times (``timing``) and the bound from bf16 bytes.
    Returns the (forward, backward) records."""
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    x, *weights = (t.bfloat16() for t in draw(rng, b, s, c, dev))
    do = draw(rng, b, s, c, dev)[0].bfloat16()
    masters = [w.float() for w in weights]   # the weights' values
    mask = None
    if rate > 0:
        mask = keep_mask(rng, b, h, s, rate, dev)
    args = (x, *weights, h, mask, rate)
    kind = ca.route(c, s)
    with torch.inference_mode():
        before = (ca.fwd_bf16_launches, ca.fwd_tiled_launches,
                  ca.fwd_split_launches)
        out = ca.fused_column_attention(*args)
        check((ca.fwd_bf16_launches - before[0],
               ca.fwd_tiled_launches - before[1],
               ca.fwd_split_launches - before[2])
              == (1, int(kind == "tiled"), int(kind == "split")),
              f"bf16 forward {b}x{s}x{c}/{h} did not take the bf16 "
              f"{kind} kernel")
        repeat_equal = None
        if repeat:
            repeat_equal = torch.equal(out, ca.fused_column_attention(
                *args))
            check(repeat_equal, f"bf16 forward {b}x{s}x{c}/{h}: two "
                  "calls on the same inputs differ")
        ref = ca.reference_column_attention(x, *masters, h, mask, rate)
        torch.cuda.synchronize()
        excess = bf16_close(out, ref)
        err = float((out.float() - ref.float()).abs().max())
        check(out.dtype == torch.bfloat16 and excess <= 0,
              f"bf16 forward {b}x{s}x{c}/{h} p={rate}: {excess} past "
              "one bf16 rounding of the plain twin")
        k_ms = time_ms(lambda: ca.fused_column_attention(*args), *timing)
        p_ms = time_ms(lambda: ca.reference_column_attention(
            x, *masters, h, mask, rate), *ref_timing(timing))
        lib_ms = None
        if mask is None:
            lib = (x, *weights, h)
            lib_err = float((library_attention(*lib).float()
                             - ref.float()).abs().max())
            check(lib_err <= LIBRARY_BF16_TOL * float(
                ref.float().abs().max()),
                  f"bf16 library attention disagrees: {lib_err}")
            lib_ms = time_ms(lambda: library_attention(*lib),
                             *ref_timing(timing))
    t_bytes, t_ops = attention_floor(b, s, c, h, mask is not None, 2,
                                     PEAK_BF16_FLOP_PER_S)
    bound_ms, by = bound(t_bytes, t_ops)
    rec = {"phase": phase, "kernel": "column_attention_fwd",
           "dtype": "bf16", "B": b, "S": s, "C": c, "H": h,
           "dropout": rate, "route": kind,
           "library_backend": library_backend(x),
           "repeat_bitwise_equal": repeat_equal, "max_abs_err": err,
           "past_one_bf16_rounding": excess, "kernel_ms": k_ms,
           "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": by, "bytes_ms": t_bytes, "ops_ms": t_ops,
           "exp_floor_ms": exp_floor_ms(b, s, h, 1), "card": card,
           "ok": True}
    emit(rec)
    fwd = rec
    del out, ref

    before = (ca.bwd_bf16_launches, ca.bwd_tiled_launches,
              ca.bwd_split_launches)
    bargs = (x, do, weights[0], weights[1], weights[2], h, mask, rate)
    got = ca.column_attention_bwd(*bargs)
    check((ca.bwd_bf16_launches - before[0],
           ca.bwd_tiled_launches - before[1],
           ca.bwd_split_launches - before[2])
          == (1, int(kind == "tiled"), int(kind == "split")),
          f"bf16 backward {b}x{s}x{c}/{h} did not take the bf16 {kind} "
          "kernel")
    repeat_equal = None
    if repeat:
        again = ca.column_attention_bwd(*bargs)
        repeat_equal = all(torch.equal(g, a) for g, a in zip(got, again))
        check(repeat_equal, f"bf16 backward {b}x{s}x{c}/{h}: two calls "
              "on the same inputs differ")
        del again
    leaves = [x.detach().requires_grad_()] + [
        m.detach().requires_grad_() for m in masters]
    ref = ca.reference_column_attention(*leaves, h, mask, rate)
    want = torch.autograd.grad(ref, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    excess = bf16_close(got[0], want[0])
    errs = {n: float((g - w).abs().max() / w.abs().max().clamp(
        min=1e-30)) for n, g, w in zip(
            ("dwqkv", "dbqkv", "dwout", "dbout"), got[1:], want[1:])}
    check(got[0].dtype == torch.bfloat16 and excess <= 0,
          f"bf16 backward {b}x{s}x{c}/{h} p={rate}: dx {excess} past "
          "one bf16 rounding of the plain twin")
    check(all(g.dtype == torch.float32 for g in got[1:])
          and all(math.isfinite(e) and e <= GRAD_TOL
                  for e in errs.values()),
          f"bf16 backward {b}x{s}x{c}/{h} p={rate}: weight gradients' "
          f"relative errors {errs} > {GRAD_TOL}")
    k_ms = time_ms(lambda: ca.column_attention_bwd(*bargs), *timing)
    p_ms = time_ms(lambda: torch.autograd.grad(ref, leaves, do,
                                               retain_graph=True),
                   *ref_timing(timing))
    lib_ms = None
    if mask is None:
        lib_leaves = [x.detach().requires_grad_()] + [
            w.detach().requires_grad_() for w in weights]
        lib_out = library_attention(*lib_leaves, h)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, do, retain_graph=True),
            *ref_timing(timing))
        del lib_out, lib_leaves
    t_bytes, t_ops = attention_bwd_floor(b, s, c, h, mask is not None, 2,
                                         PEAK_BF16_FLOP_PER_S)
    bound_ms, by = bound(t_bytes, t_ops)
    rec = {"phase": phase, "kernel": "column_attention_bwd",
           "dtype": "bf16", "B": b, "S": s, "C": c, "H": h,
           "dropout": rate, "route": kind,
           "library_backend": library_backend(x),
           "repeat_bitwise_equal": repeat_equal,
           "dx_past_one_bf16_rounding": excess, "max_rel_err": errs,
           "tol": GRAD_TOL,
           "max_abs_err": max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want)),
           "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": by, "bytes_ms": t_bytes,
           "ops_ms": t_ops, "exp_floor_ms": exp_floor_ms(b, s, h, 3),
           "card": card, "ok": True}
    emit(rec)
    del x, do, weights, masters, mask, got, leaves, ref, want
    torch.cuda.empty_cache()
    return fwd, rec


def kernel_bf16_phase(card: str) -> dict:
    """Both directions on bf16 x, do and weights against their plain twin
    on the same values: out and dx within one bf16 rounding, the float32
    weight and bias gradients at GRAD_TOL; two calls of each direction
    bitwise equal at the masked edge shapes, at C = 100, at the masked
    node shape past S = 16 and at the masked ``BF16_PATH_SHAPES`` (the node
    families' and the text LM's rows, returned under ``path_fwd`` and
    ``path_bwd``); kernel / plain / library
    (``F.multi_head_attention_forward`` on bf16) times and the bound from
    bf16 bytes. Returns the records by direction, in the order of
    :func:`bf16_shapes`, and those of :func:`bf16_long_shapes` by
    direction under ``long_fwd`` and ``long_bwd``; every narrow and every
    long shape takes the split route."""
    import numpy as np
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    st = fixture_settings()
    shapes = bf16_shapes(st["edge_capacity"], st["node_capacity"],
                         st["n_hidden"])
    long = bf16_long_shapes()
    repeat_at = {shapes[2], shapes[4], shapes[8], NARROW_SHAPES[0], long[0],
                 BF16_PATH_SHAPES[0], BF16_PATH_SHAPES[4]}
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    recs = {"fwd": [], "bwd": [], "long_fwd": [], "long_bwd": [],
            "path_fwd": [], "path_bwd": []}
    for b, s, c, h, rate in shapes + long + BF16_PATH_SHAPES:
        key = ("path_" if (b, s, c, h, rate) in BF16_PATH_SHAPES
               else "long_" if s > 16 else "")
        kind = ca.route(c, s)
        # every bf16 split shape but the node path's is timed once: off
        # the paths (the SSL path's tokens are float32 under bf16), or the
        # node families' and the text LM's rows (BF16_PATH_SHAPES)
        timing = (PATH_TIMING if kind == "tiled" or s == NODE_S
                  else OFF_PATH_TIMING)
        check(kind == "split" or ((b, s, c, h, rate) not in NARROW_SHAPES
                                  and s <= 16),
              f"bf16 {b}x{s}x{c}/{h} does not take the split route")
        fwd, bwd = bf16_pair(rng, dev, b, s, c, h, rate, card,
                             (b, s, c, h, rate) in repeat_at, timing)
        recs[key + "fwd"].append(fwd)
        recs[key + "bwd"].append(bwd)
    return recs


def prepare_data() -> str:
    """The config of record's synthetic AML CSV, under the build dir."""
    from rmm_tpu_torch.datasets import write_synthetic_aml_csv

    st = fixture_settings()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    return write_synthetic_aml_csv(os.path.join(WORK, "aml.csv"),
                                   num_rows=st["rows"],
                                   num_accounts=st["num_accounts"],
                                   seed=st["data_seed"])


def record_argv(st: dict, csv: str) -> list[str]:
    return ["--data", csv, "--model", st["model"],
            "--n_hidden", str(st["n_hidden"]),
            "--n_gnn_layers", str(st["n_gnn_layers"]),
            "--num_neighs", *map(str, st["num_neighs"]),
            "--batch_size", str(st["batch_size"]), "--seed", str(st["seed"])]


def reset_counts():
    from rmm_tpu_torch.ops import column_attention as ca

    ca.launches = ca.fwd_tiled_launches = ca.fwd_split_launches = 0
    ca.bwd_launches = ca.bwd_tiled_launches = ca.bwd_split_launches = 0
    ca.fwd_bf16_launches = ca.bwd_bf16_launches = ca.reduce_launches = 0
    ca.fwd_tiled_bf16_launches = ca.fwd_long_bf16_launches = 0
    ca.bwd_tiled_bf16_launches = ca.bwd_long_bf16_launches = 0
    ca.fwd_direct_launches = ca.bwd_direct_launches = 0


def read_counts() -> dict:
    from rmm_tpu_torch.ops import column_attention as ca

    return {"fwd": ca.launches, "fwd_tiled": ca.fwd_tiled_launches,
            "fwd_split": ca.fwd_split_launches, "bwd": ca.bwd_launches,
            "bwd_tiled": ca.bwd_tiled_launches,
            "bwd_split": ca.bwd_split_launches, "reduce": ca.reduce_launches,
            "fwd_bf16": ca.fwd_bf16_launches,
            "bwd_bf16": ca.bwd_bf16_launches}


#: float32 paths launch no bf16 kernel, and neither does the SSL path under
#: --precision bf16 (its tokens hold the float32 timestamp block)
NO_BF16 = {"fwd_bf16": 0, "bwd_bf16": 0}


def serve(argv: list[str], stats: dict):
    """The predict CLI with the launch counts set to 0 just before it and
    read just after: (output, counts, wall seconds)."""
    import torch

    from rmm_tpu_torch.cli import predict

    reset_counts()
    t0 = time.perf_counter()
    out = predict.main(argv, stats)
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - t0


def serve_phase(card: str, csv: str) -> dict:
    """The port's predict CLI at the config of record, on the card."""
    import numpy as np

    from rmm_tpu_torch.convert import from_jax
    from rmm_tpu_torch.utils.checkpoint import save_checkpoint

    fx = np.load(FIXTURE)
    st = fixture_settings()
    prefix = "variables/"
    state = from_jax({k[len(prefix):]: fx[k] for k in fx.files
                      if k.startswith(prefix)})
    ckpt = save_checkpoint(os.path.join(WORK, "ckpt"), state,
                           {"model": st["model"]})
    argv = record_argv(st, csv) + [
        "--sampler_threads", "4", "--load_model", ckpt, "--split", "test",
        "--output", os.path.join(WORK, "preds.csv"), "--device", "cuda"]
    run: dict = {}
    out, counts, wall = serve(argv, run)

    rows = len(out["id"])
    batches = -(-rows // st["batch_size"])
    launches = counts["fwd"]
    check(rows == st["test_rows"], f"served {rows} rows, test split has "
          f"{st['test_rows']}")
    check(launches == 4 * batches and counts["fwd_tiled"] == launches
          and counts["bwd"] == 0,
          f"{counts} kernel launches for {batches} batches (expected 4 "
          "forwards per batch, all tiled: 2 layers x node and edge tokens)")
    check((run["edge_capacity"], run["node_capacity"])
          == (st["edge_capacity"], st["node_capacity"]),
          f"capacities {run['edge_capacity']}/{run['node_capacity']} vs "
          f"the fixture's {st['edge_capacity']}/{st['node_capacity']}")
    check(np.isfinite(out["score"]).all(), "non-finite scores")
    k = len(fx["id"])
    check(np.array_equal(out["id"][:k], fx["id"]),
          "served ids differ from the JAX fixture")
    score_err = float(np.abs(out["score"][:k] - fx["score"]).max())
    check(score_err <= SCORE_TOL, f"score error {score_err} > {SCORE_TOL}")
    clear = np.abs(fx["score"] - 0.5) > SCORE_TOL
    check(np.array_equal(out["pred"][:k][clear], fx["pred"][clear]),
          "predicted classes differ from the JAX fixture")
    rec = {"phase": "serve", "rows": rows, "batches": batches,
           "launches": launches, "tiled_launches": counts["fwd_tiled"],
           "counts": counts, "launches_per_batch": launches / batches,
           "edge_capacity": run["edge_capacity"],
           "node_capacity": run["node_capacity"],
           "fixture_rows": k, "max_score_err": score_err,
           "score_tol": SCORE_TOL, "wall_s": wall, "setup_s": run["setup_s"],
           "predict_s": run["predict_s"], "rows_per_s_wall": rows / wall,
           "rows_per_s_predict": rows / run["predict_s"],
           "pred_mean": float(out["pred"].mean()), "card": card, "ok": True}
    emit(rec)
    return rec


def train_phase(card: str, csv: str) -> dict:
    """One epoch of the port's training CLI at the config of record, then
    its checkpoint through the predict CLI."""
    import numpy as np
    import torch

    from rmm_tpu_torch.cli import main as train_cli

    st = fixture_settings()
    argv = record_argv(st, csv) + [
        "--epochs", "1", "--testing", "--sampler_threads", "4",
        "--save_model", "--wandb_dir", os.path.join(WORK, "runs"),
        "--device", "cuda"]
    stats: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    history, _ = train_cli.main(argv, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    (ep,) = history
    b = st["batch_size"]
    train_rows, val_rows, test_rows = stats["split_rows"]
    steps = -(-train_rows // b)
    evals = -(-val_rows // b) + -(-test_rows // b)
    check(math.isfinite(ep["loss"]), f"train loss {ep['loss']}")
    check(counts == {"fwd": 4 * (steps + evals),
                     "fwd_tiled": 4 * (steps + evals), "fwd_split": 0,
                     "bwd": 4 * steps,
                     "bwd_tiled": 4 * steps, "bwd_split": 0,
                     "reduce": 4 * steps, **NO_BF16},
          f"launches {counts} for {steps} train steps and {evals} evaluated "
          "batches (expected 4 forwards per batch, 4 backwards and 4 "
          "reduces per step, forwards and backwards all tiled: 2 layers x "
          "node and edge tokens)")
    check((stats["edge_capacity"], stats["node_capacity"])
          == (st["edge_capacity"], st["node_capacity"]),
          "training capacities differ from the fixture's")
    for key in ("val_f1", "test_f1", "val_auc", "test_auc"):
        check(math.isfinite(ep[key]), f"{key} = {ep[key]}")

    ckpt = os.path.join(stats["run_dir"], "0")
    out, serve_counts, _ = serve(record_argv(st, csv) + [
        "--sampler_threads", "4", "--load_model", ckpt, "--split", "test",
        "--output", os.path.join(WORK, "trained.csv"), "--device", "cuda"],
        {})
    check(len(out["id"]) == test_rows and np.isfinite(out["score"]).all(),
          "the trained checkpoint did not serve the test split")
    rec = {"phase": "train", "train_rows": train_rows, "steps": steps,
           "evaluated_batches": evals, "launches": counts,
           "launches_per_step": {k: counts[k] / steps
                                 for k in ("bwd", "bwd_tiled", "reduce")},
           "loss": ep["loss"], "train_f1": ep["f1"], "train_auc": ep["auc"],
           "val_f1": ep["val_f1"], "val_auc": ep["val_auc"],
           "test_f1": ep["test_f1"], "test_auc": ep["test_auc"],
           "drop_rate": ep["drop_rate"], "epoch_s": ep["sec"],
           "train_rows_per_s": train_rows / ep["sec"],
           "step_ms_median": ep["step_ms"], "setup_s": stats["setup_s"],
           "fit_s": stats["fit_s"], "wall_s": wall,
           "served_trained_rows": len(out["id"]),
           "served_trained_launches": serve_counts["fwd"], "card": card,
           "ok": True}
    emit(rec)
    return rec


def train_parity_phase(card: str) -> dict:
    """Three train steps on the card (dropout 0) from the fixture's
    weights, against the JAX CPU record of the same steps."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.convert import from_jax
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = np.load(TRAIN_FIXTURE)
    st = json.loads(str(rec["settings"]))
    csv = write_synthetic_aml_csv(os.path.join(WORK, "aml_parity.csv"),
                                  num_rows=st["rows"],
                                  num_accounts=st["num_accounts"],
                                  seed=st["data_seed"])
    cfg = config_from_args(create_parser().parse_args(record_argv(st, csv) + [
        "--dropout", "0", "--edge_capacity", str(st["edge_capacity"]),
        "--node_capacity", str(st["node_capacity"]), "--device", "cuda"]))
    tr = Trainer(cfg, build_dataset(cfg))
    fx = np.load(FIXTURE)
    tr.model.load_state_dict(from_jax(
        {k[len("variables/"):]: fx[k] for k in fx.files
         if k.startswith("variables/")}, tr.model))
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", st["epoch"]),
        st["steps"]))
    reset_counts()
    tr.model.train()
    losses = [float(tr._step(gb.to(tr.device))[0]) for gb in batches]
    counts = read_counts()
    want_losses = [float(v) for v in rec["losses"]]
    want = from_jax({k[len("after/"):]: rec[k] for k in rec.files
                     if k.startswith("after/")}, tr.model)
    state = tr.model.state_dict()
    errs = torch.cat([(state[k].cpu() - v).abs().flatten()
                      for k, v in want.items()])
    param_err, param_median = float(errs.max()), float(errs.median())
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
    n = st["steps"]
    check(counts == {"fwd": 4 * n, "fwd_tiled": 4 * n, "fwd_split": 0,
                     "bwd": 4 * n, "bwd_tiled": 4 * n, "bwd_split": 0,
                     "reduce": 4 * n, **NO_BF16},
          f"launches {counts} for {n} train steps")
    check(loss_rel[0] <= LOSS1_RTOL and max(loss_rel) <= LOSS_RTOL,
          f"losses {losses} vs the JAX record's {want_losses}")
    param_tol = PARAM_MAX_LR * st["lr"]
    median_tol = PARAM_MEDIAN_LR * st["lr"]
    check(param_err <= param_tol and param_median <= median_tol,
          f"parameters after {n} steps off the JAX record by {param_err} "
          f"at most (> {param_tol}?) and {param_median} in the median "
          f"(> {median_tol}?)")
    out = {"phase": "train_parity", "rows": st["rows"], "steps": n,
           "edge_capacity": st["edge_capacity"],
           "node_capacity": st["node_capacity"], "losses": losses,
           "jax_losses": want_losses, "loss_rel_err": loss_rel,
           "loss_rtol": [LOSS1_RTOL, LOSS_RTOL], "param_max_abs_err":
           param_err, "param_tol": param_tol,
           "param_median_abs_err": param_median, "param_median_tol":
           median_tol, "launches": counts,
           "card": card, "ok": True}
    emit(out)
    return out


def train_parity_bf16_phase(card: str) -> dict:
    """Three bf16 train steps on the card (dropout 0) from the record's
    start against the JAX CPU record of the same steps
    (``aml_train_bf16_record.npz``, the config's widths on the 16,384-row
    cut), by ``convert.check_record`` at its bf16 limits.
    Per step 2 of the 4 forwards and backwards are bf16 (the node tokens;
    the edge tokens are float32, as in the reference), all tiled."""
    import itertools

    from rmm_tpu_torch.convert import check_record, from_jax, load_record, \
        loss_terms, random_variables
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = load_record(TRAIN_BF16_FIXTURE)
    top = json.loads(str(rec["settings"]))
    st = {**top, **top["sup"]}
    csv = write_synthetic_aml_csv(os.path.join(WORK, "aml_parity.csv"),
                                  num_rows=st["rows"],
                                  num_accounts=st["num_accounts"],
                                  seed=st["data_seed"])
    cfg = config_from_args(create_parser().parse_args([
        "--data", csv, "--model", "tabgnn", "--n_hidden",
        str(st["n_hidden"]), "--n_gnn_layers", str(st["n_gnn_layers"]),
        "--num_neighs", *map(str, st["num_neighs"]), "--batch_size",
        str(st["batch_size"]), "--seed", str(st["seed"]), "--dropout", "0",
        "--edge_capacity", str(st["edge_capacity"]), "--node_capacity",
        str(st["node_capacity"]), "--precision", "bf16",
        "--device", "cuda"]))
    tr = Trainer(cfg, build_dataset(cfg))
    tr.model.load_state_dict(from_jax(
        random_variables(st["shapes"], st["var_seed"]), tr.model))
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", st["epoch"]),
        st["steps"]))
    reset_counts()
    tr.model.train()
    terms = [loss_terms(tr._step(gb.to(tr.device))[0], {})
             for gb in batches]
    counts = read_counts()
    n = st["steps"]
    check(counts == {"fwd": 4 * n, "fwd_tiled": 4 * n, "fwd_split": 0,
                     "bwd": 4 * n, "bwd_tiled": 4 * n, "bwd_split": 0,
                     "reduce": 4 * n, "fwd_bf16": 2 * n, "bwd_bf16": 2 * n},
          f"launches {counts} for {n} bf16 train steps (expected 4 tiled "
          "forwards and backwards a step, 2 each of them bf16)")
    faults, summary = check_record(tr.model.state_dict(), terms, rec, "sup/",
                                   cfg.lr, n, st["n_hidden"], "bf16")
    check(not faults, "bf16 train steps off the JAX record: "
          + "; ".join(faults))
    out = {"phase": "train_parity_bf16", "rows": st["rows"], "steps": n,
           "edge_capacity": st["edge_capacity"],
           "node_capacity": st["node_capacity"], "terms": terms,
           "jax_terms": rec["sup/term/loss"].tolist(),
           "jax_f32_terms": rec["f32/sup/term/loss"].tolist(), **summary,
           "launches": counts, "card": card, "ok": True}
    emit(out)
    return out


def serve_bf16_phase(card: str, csv: str) -> dict:
    """The predict CLI at ``--precision bf16`` over the test split on the
    serving fixture's weights (the checkpoint the serve phase wrote): 4
    tiled forwards a batch, 2 of them bf16 (the node tokens); finite
    scores; the first rows' ids, and their scores within SCORE_TOL,
    against the JAX CPU record of the same bf16 predictions
    (``aml_serve_bf16_record.npz``)."""
    import numpy as np

    fx = np.load(SERVE_BF16_FIXTURE)
    st = fixture_settings()
    argv = record_argv(st, csv) + [
        "--sampler_threads", "4", "--load_model", os.path.join(WORK, "ckpt"),
        "--split", "test", "--output", os.path.join(WORK, "preds_bf16.csv"),
        "--precision", "bf16", "--device", "cuda"]
    run: dict = {}
    out, counts, wall = serve(argv, run)
    rows = len(out["id"])
    batches = -(-rows // st["batch_size"])
    check(rows == st["test_rows"] and np.isfinite(out["score"]).all(),
          f"bf16 serve: {rows} rows (test split {st['test_rows']}) or "
          "non-finite scores")
    check(counts == {"fwd": 4 * batches, "fwd_tiled": 4 * batches,
                     "fwd_split": 0, "bwd": 0, "bwd_tiled": 0,
                     "bwd_split": 0, "reduce": 0, "fwd_bf16": 2 * batches,
                     "bwd_bf16": 0},
          f"bf16 serve launches {counts} for {batches} batches (expected 4 "
          "tiled forwards a batch, 2 of them bf16)")
    k = len(fx["id"])
    check(np.array_equal(out["id"][:k], fx["id"]),
          "bf16 served ids differ from the JAX record")
    score_err = float(np.abs(out["score"][:k] - fx["score"]).max())
    check(score_err <= SCORE_TOL, f"bf16 score error {score_err} > "
          f"{SCORE_TOL}")
    clear = np.abs(fx["score"] - 0.5) > SCORE_TOL
    check(np.array_equal(out["pred"][:k][clear], fx["pred"][clear]),
          "bf16 predicted classes differ from the JAX record")
    rec = {"phase": "serve_bf16", "rows": rows, "batches": batches,
           "launches": counts, "fixture_rows": k, "max_score_err": score_err,
           "score_tol": SCORE_TOL,
           "jax_bf16_vs_f32_score_gap": float(np.abs(
               fx["score"] - np.load(FIXTURE)["score"]).max()),
           "wall_s": wall, "setup_s": run["setup_s"],
           "predict_s": run["predict_s"], "rows_per_s_wall": rows / wall,
           "rows_per_s_predict": rows / run["predict_s"], "card": card,
           "ok": True}
    emit(rec)
    return rec


def ssl_record(path: str = SSL_FIXTURE) -> tuple:
    """A JAX SSL record and its settings (a bf16 record keeps them under
    ``ssl``)."""
    from rmm_tpu_torch.convert import load_record

    rec = load_record(path)
    st = json.loads(str(rec["settings"]))
    return rec, {**st, **st["ssl"]} if "ssl" in st else st


def ssl_trainer(csv: str, argv: list[str], edge_capacity: int,
                node_capacity: int, seed: int = 1):
    """The port's PretrainTrainer on the card, configured by the SSL CLI's
    parser from ``argv`` (the SSL config of record's flags) on the SSL
    CLI's dataset (``fused.build_ssl_dataset``); capacities 0 are
    calibrated."""
    from rmm_tpu_torch.cli import fused
    from rmm_tpu_torch.train.pretrain import PretrainTrainer

    cfg = fused.config_from_args(fused.build_parser().parse_args(
        ["--dataset", csv, *argv, "--device", "cuda"])).replace(
        edge_capacity=edge_capacity, node_capacity=node_capacity, seed=seed)
    return PretrainTrainer(cfg, fused.build_ssl_dataset(cfg), "mcm-lp")


def ssl_train_phase(card: str, csv: str, precision: str = "f32") -> dict:
    """SSL pretraining (mcm-lp) at the SSL config of record on the config
    of record's data, at ``precision``: the first SSL_BATCHES train
    batches (a sub-view of the train split), then SSL_BATCHES val
    batches. The model after them is saved (``save_epoch``) to
    ``<WORK>/ssl_<precision>/0``, the record's ``checkpoint``."""
    import torch

    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.utils.checkpoint import save_epoch

    st = fixture_settings()
    t0 = time.perf_counter()
    tr = ssl_trainer(csv, SSL_ARGV + ["--sampler_threads", "4",
                                      "--precision", precision],
                     st["edge_capacity"], st["node_capacity"])
    setup_s = time.perf_counter() - t0
    n = SSL_BATCHES
    b = tr.cfg.batch_size
    train, val, _ = tr.dataset.edges.split()
    train = DatasetView(train.parent, train.indices[:n * b])
    val = DatasetView(val.parent, val.indices[:n * b])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tm = tr.train_epoch(train, 0)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    vm = tr.evaluate(val, "val")
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    eval_counts = read_counts()

    k = SSL_LAUNCHES
    check(train_counts == {"fwd": k * n, "fwd_tiled": 0, "fwd_split": k * n,
                           "bwd": k * n, "bwd_tiled": 0, "bwd_split": k * n,
                           "reduce": k * n, **NO_BF16},
          f"launches {train_counts} for {n} SSL train steps (expected "
          f"{k} forwards, backwards and reduces a step, the forwards and "
          "backwards all through the split routes)")
    check(eval_counts == {"fwd": k * n, "fwd_tiled": 0, "fwd_split": k * n,
                          "bwd": 0, "bwd_tiled": 0, "bwd_split": 0,
                          "reduce": 0, **NO_BF16},
          f"launches {eval_counts} for {n} evaluated SSL batches (expected "
          f"{k} split forwards a batch)")
    check(math.isfinite(tm["loss"]), f"SSL train loss {tm['loss']}")
    check(0 < vm["mrr"] <= 1, f"SSL val MRR {vm['mrr']}")
    check(math.isfinite(vm["rmse"]), f"SSL val RMSE {vm['rmse']}")
    check(0 <= vm["accuracy"] <= 1, f"SSL val accuracy {vm['accuracy']}")
    rows = train.tensor_frame.num_rows
    rec = {"phase": "ssl_train" if precision == "f32" else
           f"ssl_train_{precision}", "mode": "mcm-lp", "precision": precision,
           "channels": tr.cfg.n_hidden, "layers": tr.cfg.n_gnn_layers,
           "heads": 8, "num_neg": tr.cfg.num_neg_samples, "batch": b,
           "fanouts": list(tr.cfg.num_neighs), "dropout": tr.cfg.dropout,
           "lr": tr.cfg.lr, "edge_capacity": tr.cfg.edge_capacity,
           "node_capacity": tr.cfg.node_capacity, "steps": n,
           "eval_batches": n, "train_launches": train_counts,
           "eval_launches": eval_counts, "loss": tm["loss"],
           "train_loss_c": tm["train_loss_c"],
           "train_loss_n": tm["train_loss_n"], **{
               f"val_{key}": v for key, v in vm.items()},
           "step_ms_median": tm.get("step_ms"), "sample_ms": tm["sample_ms"],
           "train_wall_s": train_wall, "train_rows_per_s": rows / train_wall,
           "eval_wall_s": eval_wall,
           "eval_rows_per_s": val.tensor_frame.num_rows / eval_wall,
           "peak_memory_gb": peak / 1e9, "setup_s": setup_s,
           "drop_rate": tm["drop_rate"], "checkpoint": save_epoch(
               os.path.join(WORK, f"ssl_{precision}"), 0, tr.model,
               precision=precision), "card": card, "ok": True}
    emit(rec)
    del tr
    torch.cuda.empty_cache()
    return rec


def transfer_phase(card: str, csv: str, ssl_ck: str) -> dict:
    """SSL → supervised transfer at the SSL widths on the config of
    record's data, on the card: ``tabgnnfused`` (C = 128, 8 heads, 3
    layers, fanouts 100/100, batch 200, dropout 0.083, float32, the config
    of record's capacities) takes the ``node_encoder`` and
    ``edge_encoder`` of ``ssl_train``'s checkpoint, as ``cli/main.py
    --load_model`` does (the SSL model has no node encoder: only the edge
    encoder grafts, all of it, and no BatchNorm statistic); trains on the
    first TRANSFER_BATCHES train batches, is evaluated on the first
    TRANSFER_BATCHES val batches, is saved, and serves the test split
    through the predict CLI. Every column-attention call is split (C =
    128): ``fused_launches(3)`` forwards, backwards and reduces a step, as
    many forwards an evaluated or served batch."""
    import numpy as np
    import torch

    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.checkpoint import (load_components, read_state,
                                                save_epoch)
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    st = fixture_settings()
    argv = ["--data", csv, *TRANSFER_ARGV, "--num_neighs",
            *map(str, st["num_neighs"]), "--batch_size",
            str(st["batch_size"]), "--seed", str(st["seed"]),
            "--sampler_threads", "4", "--edge_capacity",
            str(st["edge_capacity"]), "--node_capacity",
            str(st["node_capacity"]), "--device", "cuda"]
    t0 = time.perf_counter()
    cfg = config_from_args(create_parser().parse_args(argv))
    tr = Trainer(cfg, build_dataset(cfg))
    loaded = load_components(ssl_ck, tr.model, ["node_encoder",
                                                "edge_encoder"])
    setup_s = time.perf_counter() - t0
    src, state = read_state(ssl_ck), tr.model.state_dict()
    encoder = [k for k in state if k.startswith("edge_encoder.")]
    check(loaded["grafted"] == encoder
          and all(torch.equal(state[k].cpu(), src[k]) for k in encoder),
          f"grafted {loaded['grafted']}, not the edge encoder {encoder}")
    n, b = TRANSFER_BATCHES, cfg.batch_size
    train, val, test = tr.dataset.edges.split()
    train = DatasetView(train.parent, train.indices[:n * b])
    val = DatasetView(val.parent, val.indices[:n * b])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tm = tr.train_epoch(train, 0)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    vm = tr.evaluate(val, "val")
    eval_counts = read_counts()
    ck = save_epoch(os.path.join(WORK, "transfer_run"), 0, tr.model,
                    tr.optimizer)
    del tr
    torch.cuda.empty_cache()
    run: dict = {}
    out, serve_counts, wall = serve([*argv, "--load_model", ck, "--split",
                                     "test", "--output",
                                     os.path.join(WORK, "transfer.csv")],
                                    run)
    rows = len(out["id"])
    batches = -(-rows // b)
    k = fused_launches(cfg.n_gnn_layers)

    def split_only(fwd, bwd):
        return {"fwd": fwd, "fwd_tiled": 0, "fwd_split": fwd, "bwd": bwd,
                "bwd_tiled": 0, "bwd_split": bwd, "reduce": bwd, **NO_BF16}

    check(train_counts == split_only(k * n, k * n),
          f"launches {train_counts} for {n} transfer steps (expected {k} "
          "split forwards, backwards and reduces a step)")
    check(eval_counts == split_only(k * n, 0)
          and serve_counts == split_only(k * batches, 0),
          f"launches {eval_counts} for {n} evaluated and {serve_counts} "
          f"for {batches} served batches (expected {k} split forwards a "
          "batch)")
    check(math.isfinite(tm["loss"]) and 0 <= vm["f1"] <= 1,
          f"transfer loss {tm['loss']}, val f1 {vm['f1']}")
    check(rows == len(test.indices) and np.isfinite(out["score"]).all(),
          f"the transferred model served {rows} rows of "
          f"{len(test.indices)}, or non-finite scores")
    rec = {"phase": "transfer", "checkpoint_from": "ssl_train",
           "channels": cfg.n_hidden, "layers": cfg.n_gnn_layers,
           "heads": 8, "batch": b, "fanouts": list(cfg.num_neighs),
           "dropout": cfg.dropout, "lr": cfg.lr,
           "edge_capacity": cfg.edge_capacity,
           "node_capacity": cfg.node_capacity,
           "grafted": len(loaded["grafted"]), "kept": len(loaded["kept"]),
           "steps": n, "eval_batches": n, "train_launches": train_counts,
           "eval_launches": eval_counts, "serve_launches": serve_counts,
           "loss": tm["loss"], "train_f1": tm["f1"], "val_f1": vm["f1"],
           "val_auc": vm["auc"], "step_ms_median": tm.get("step_ms"),
           "train_wall_s": train_wall,
           "train_rows_per_s": train.tensor_frame.num_rows / train_wall,
           "peak_memory_gb": peak / 1e9, "setup_s": setup_s,
           "served_rows": rows, "served_batches": batches,
           "serve_wall_s": wall, "serve_setup_s": run["setup_s"],
           "rows_per_s_predict": rows / run["predict_s"],
           "rows_per_s_wall": rows / wall, "drop_rate": tm["drop_rate"],
           "card": card, "ok": True}
    emit(rec)
    return rec


def transfer_parity_phase(card: str) -> dict:
    """Three supervised ``tabgnnfused`` steps on the card after a transfer
    from the committed JAX checkpoint, read by the port's msgpack reader,
    against the JAX CPU record of the same steps
    (``transfer_record.npz``, ``tools/make_torch_port_transfer_fixture.py``:
    C = 16, 2 layers, 8 heads, batch 32 on a 1,000-row cut, dropout 0,
    ``--freeze``): the same leaves grafted, each loss and the sampled
    variables by ``convert.check_record``'s float32 limits, and the
    parameters no step moved. C = 16: every launch tiled."""
    import itertools

    import torch

    from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                       loss_terms, random_variables,
                                       torch_key)
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.checkpoint import load_components
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = load_record(TRANSFER_FIXTURE)
    st = json.loads(str(rec["settings"]))
    csv = write_synthetic_aml_csv(os.path.join(WORK, "aml_transfer.csv"),
                                  num_rows=st["rows"],
                                  num_accounts=st["num_accounts"],
                                  seed=st["data_seed"])
    cfg = config_from_args(create_parser().parse_args([
        "--data", csv, "--model", "tabgnnfused", "--n_hidden",
        str(st["channels"]), "--n_gnn_layers", str(st["num_layers"]),
        "--num_neighs", *map(str, st["khop_neighbors"]), "--batch_size",
        str(st["batch_size"]), "--seed", str(st["seed"]), "--dropout", "0",
        "--lr", str(st["lr"]), "--freeze", "--edge_capacity",
        str(st["edge_capacity"]), "--node_capacity",
        str(st["node_capacity"]), "--device", "cuda"]))
    tr = Trainer(cfg, build_dataset(cfg))
    tr.model.load_state_dict(from_jax(
        random_variables(st["shapes"], st["var_seed"]), tr.model))
    ck = os.path.join(os.path.dirname(TRANSFER_FIXTURE), st["checkpoint"])
    loaded = load_components(ck, tr.model, st["transfer"])
    want = {torch_key(k)[0] for k in st["grafted"]}
    check(set(loaded["grafted"]) == want,
          f"grafted {loaded['grafted']}, the reference {sorted(want)}")
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", st["epoch"]),
        st["steps"]))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    reset_counts()
    tr.model.train()
    terms = [loss_terms(tr._step(gb.to(tr.device))[0], {})
             for gb in batches]
    counts = read_counts()
    n, k = st["steps"], fused_launches(st["num_layers"])
    check(counts == {"fwd": k * n, "fwd_tiled": k * n, "fwd_split": 0,
                     "bwd": k * n, "bwd_tiled": k * n, "bwd_split": 0,
                     "reduce": k * n, **NO_BF16},
          f"launches {counts} for {n} transfer parity steps")
    state = tr.model.state_dict()
    faults, summary = check_record(state, terms, rec, "sup/", st["lr"], n,
                                   st["channels"])
    unmoved = {name for name, _ in tr.model.named_parameters()
               if torch.equal(state[name], before[name])}
    if unmoved != {torch_key(k)[0] for k in st["unmoved"]}:
        faults.append(f"unmoved parameters {sorted(unmoved)}, the "
                      f"reference's {st['unmoved']}")
    check(not faults, "transfer steps off the JAX record: "
          + "; ".join(faults))
    out = {"phase": "transfer_parity", "rows": st["rows"], "steps": n,
           "channels": st["channels"], "layers": st["num_layers"],
           "grafted": len(loaded["grafted"]), "kept": len(loaded["kept"]),
           "terms": terms, "jax_terms": rec["sup/term/loss"].tolist(),
           **summary, "launches": counts, "card": card, "ok": True}
    emit(out)
    return out


def node_counts(fwd: int, bwd: int, layers: int = 2) -> dict:
    """The launches of ``fwd`` node-path forwards and ``bwd`` backwards of
    ``tabgnn`` at ``layers`` layers: each layer one column-attention call
    on the node tokens (split: S = 167) and one on the edge tokens (tiled:
    S = 2) each way, float32."""
    return {"fwd": 2 * layers * fwd, "fwd_tiled": layers * fwd,
            "fwd_split": layers * fwd, "bwd": 2 * layers * bwd,
            "bwd_tiled": layers * bwd, "bwd_split": layers * bwd,
            "reduce": 2 * layers * bwd, **NO_BF16}


def prepare_node_data() -> str:
    """The port's synthetic Elliptic directory at its published size."""
    from rmm_tpu_torch.datasets import write_synthetic_node_dataset

    return write_synthetic_node_dataset(
        os.path.join(WORK, "elliptic"), num_nodes=ELLIPTIC_NODES,
        num_edges=ELLIPTIC_EDGES, num_feats=ELLIPTIC_FEATS, seed=0)


def node_train_phase(card: str, root: str) -> dict:
    """Elliptic node classification on the card, through the training
    CLI's pieces (``config_from_args``, whose ``elliptic`` override sets
    the task; ``build_dataset``; the ``Trainer``; ``--save_model``'s
    checkpoint): the first NODE_BATCHES train batches, then the first
    NODE_BATCHES val batches. Each step and each evaluated batch launches
    2 split calls (the node tokens, S = 167) and 2 tiled (the edge tokens)
    each way; no launch at S > 16 takes the tiled route. Train rows/s, the
    median step on the device's clock, peak memory, val f1 on the labelled
    rows."""
    import numpy as np
    import torch

    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.checkpoint import save_epoch
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    argv = ["--data", root, *NODE_ARGV, "--sampler_threads", "4",
            "--save_model", "--device", "cuda"]
    t0 = time.perf_counter()
    cfg = config_from_args(create_parser().parse_args(argv))
    check(cfg.task == "node_classification", f"task {cfg.task}")
    dataset = build_dataset(cfg)
    t_data = time.perf_counter() - t0
    tr = Trainer(cfg.replace(n_classes=dataset.n_classes), dataset)
    setup_s = time.perf_counter() - t0
    n, b = NODE_BATCHES, cfg.batch_size
    train, val, test = dataset.nodes.split()
    train = DatasetView(train.parent, train.indices[:n * b])
    val = DatasetView(val.parent, val.indices[:n * b])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tm = tr.train_epoch(train, 0)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    vm = tr.evaluate(val, "val")
    eval_counts = read_counts()
    ck = save_epoch(os.path.join(WORK, "node_run"), 0, tr.model,
                    tr.optimizer)
    layers = cfg.n_gnn_layers
    check(train_counts == node_counts(n, n, layers),
          f"launches {train_counts} for {n} node steps (expected {layers} "
          f"split (node tokens) and {layers} tiled (edge tokens) calls each "
          "way a step)")
    check(eval_counts == node_counts(n, 0, layers),
          f"launches {eval_counts} for {n} evaluated node batches")
    check(math.isfinite(tm["loss"]) and 0 <= vm["f1"] <= 1,
          f"node loss {tm['loss']}, val f1 {vm['f1']}")
    y = dataset.nodes.tensor_frame.y
    labelled = y[test.indices][y[test.indices, 0] != dataset.ignore_label]
    rec = {"phase": "node_train", "nodes": dataset.nodes.num_rows,
           "edges": dataset.graph.num_edges,
           "feature_columns": dataset.nodes.tensor_frame.num_cols,
           "node_tokens": NODE_S, "channels": cfg.n_hidden,
           "layers": cfg.n_gnn_layers, "heads": 8, "batch": b,
           "fanouts": list(cfg.num_neighs), "dropout": cfg.dropout,
           "edge_capacity": tr.cfg.edge_capacity,
           "node_capacity": tr.cfg.node_capacity,
           "split_rows": [len(v.indices) for v in dataset.nodes.split()],
           "steps": n, "eval_batches": n, "train_launches": train_counts,
           "eval_launches": eval_counts, "loss": tm["loss"],
           "train_f1": tm["f1"], "val_f1": vm["f1"], "val_auc": vm["auc"],
           "step_ms_median": tm.get("step_ms"), "train_wall_s": train_wall,
           "train_rows_per_s": train.tensor_frame.num_rows / train_wall,
           "peak_memory_gb": peak / 1e9, "data_s": t_data,
           "setup_s": setup_s, "drop_rate": tm["drop_rate"],
           "card": card, "ok": True}
    emit(rec)
    return {**rec, "checkpoint": ck,
            "test_ids": labelled[:, 1].astype(np.int64), "dataset": dataset}


def node_serve_phase(card: str, root: str, trained: dict) -> dict:
    """The predict CLI on ``node_train``'s checkpoint over the whole test
    split: node ids (every labelled test node once; no row of the unknown
    class), finite scores, 2 split and 2 tiled forwards a batch; served
    rows/s."""
    import numpy as np

    argv = ["--data", root, *NODE_ARGV, "--sampler_threads", "4",
            "--load_model", trained["checkpoint"], "--split", "test",
            "--output", os.path.join(WORK, "node_preds.csv"),
            "--edge_capacity", str(trained["edge_capacity"]),
            "--node_capacity", str(trained["node_capacity"]),
            "--device", "cuda"]
    run: dict = {}
    out, counts, wall = serve(argv, run)
    rows = len(out["id"])
    batches = -(-trained["split_rows"][2] // 200)
    check(np.array_equal(np.sort(out["id"]), np.sort(trained["test_ids"])),
          f"served {rows} node ids, not the {len(trained['test_ids'])} "
          "labelled test nodes")
    check(np.isfinite(out["score"]).all(), "non-finite node scores")
    check(counts == node_counts(batches, 0),
          f"launches {counts} for {batches} served node batches")
    rec = {"phase": "node_serve", "rows": rows, "batches": batches,
           "launches": counts, "wall_s": wall, "setup_s": run["setup_s"],
           "predict_s": run["predict_s"],
           "rows_per_s_predict": rows / run["predict_s"],
           "rows_per_s_wall": rows / wall,
           "pred_mean": float(out["pred"].mean()), "card": card, "ok": True}
    emit(rec)
    return rec


def node_parity_phase(card: str) -> dict:
    """Elliptic on the card against the JAX CPU record
    ``node_record.npz`` (``tools/make_torch_port_node_fixture.py``: the
    slice's widths, S = 167, on a 2,000-node cut, dropout 0, the
    reference's scatter PNA path): from the record's start, the test split
    served (the same node ids, scores within SCORE_TOL), then three steps
    (each loss and the sampled variables by ``convert.check_record``'s
    float32 limits, the same parameters unmoved)."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                       loss_terms, random_variables,
                                       torch_key)
    from rmm_tpu_torch.datasets import (build_dataset,
                                        write_synthetic_node_dataset)
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = load_record(NODE_FIXTURE)
    st = json.loads(str(rec["settings"]))
    root = write_synthetic_node_dataset(
        os.path.join(WORK, f"elliptic_{st['nodes']}"),
        num_nodes=st["nodes"], num_edges=st["edges"],
        num_feats=st["num_feats"], seed=st["data_seed"])
    cfg = config_from_args(create_parser().parse_args([
        "--data", root, "--model", "tabgnn", "--n_hidden",
        str(st["n_hidden"]), "--n_gnn_layers", str(st["n_gnn_layers"]),
        "--num_neighs", *map(str, st["num_neighs"]), "--batch_size",
        str(st["batch_size"]), "--seed", str(st["seed"]), "--lr",
        str(st["lr"]), "--dropout", "0", "--edge_capacity",
        str(st["edge_capacity"]), "--node_capacity",
        str(st["node_capacity"]), "--device", "cuda"]))
    tr = Trainer(cfg, build_dataset(cfg))
    tr.model.load_state_dict(from_jax(
        random_variables(st["shapes"], st["var_seed"]), tr.model))
    train, _, test = tr.dataset.nodes.split()
    reset_counts()
    served = tr.predict(test, "test")
    serve_counts = read_counts()
    batches = -(-len(test.indices) // st["batch_size"])
    layers = st["n_gnn_layers"]
    check(serve_counts == node_counts(batches, 0, layers),
          f"launches {serve_counts} serving {batches} node batches")
    check(np.array_equal(served["id"], rec["serve/id"]),
          "served node ids differ from the JAX record")
    score_err = float(np.abs(served["score"] - rec["serve/score"]).max())
    check(score_err <= SCORE_TOL,
          f"node score error {score_err} > {SCORE_TOL}")
    batches = list(itertools.islice(tr._batches(train, "train", st["epoch"]),
                                    st["steps"]))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    reset_counts()
    tr.model.train()
    terms = [loss_terms(tr._step(gb.to(tr.device))[0], {})
             for gb in batches]
    counts = read_counts()
    n = st["steps"]
    check(counts == node_counts(n, n, layers), f"launches {counts} for {n} "
          "node parity steps")
    state = tr.model.state_dict()
    faults, summary = check_record(state, terms, rec, "sup/", st["lr"], n,
                                   st["n_hidden"])
    unmoved = {name for name, _ in tr.model.named_parameters()
               if torch.equal(state[name], before[name])}
    if unmoved != {torch_key(k)[0] for k in st["unmoved"]}:
        faults.append(f"unmoved parameters {sorted(unmoved)}, the "
                      f"reference's {st['unmoved']}")
    check(not faults, "node steps off the JAX record: " + "; ".join(faults))
    out = {"phase": "node_parity", "nodes": st["nodes"], "steps": n,
           "node_tokens": st["num_feats"] + 1,
           "edge_capacity": st["edge_capacity"],
           "node_capacity": st["node_capacity"],
           "served_rows": len(served["id"]), "max_score_err": score_err,
           "score_tol": SCORE_TOL, "terms": terms,
           "jax_terms": rec["sup/term/loss"].tolist(), **summary,
           "serve_launches": serve_counts, "launches": counts,
           "card": card, "ok": True}
    emit(out)
    return out


def menu_counts(model: str, fwd: int, bwd: int) -> dict:
    """The launches of ``fwd`` node-classification forwards and ``bwd``
    steps' backwards of ``model`` on Ethereum phishing, every one
    tiled."""
    kf, kb = NODE_MENU_CALLS[model]
    return route_counts(kf * fwd, kb * bwd, "tiled")


def prepare_node_family_data() -> dict:
    """The port's synthetic Ethereum phishing, its cut
    (``ethereum-phishing-cut``: the SSL CLI's ``eth`` and the training
    CLI's ``ethereum-phishing`` dispatch both take it) and the three
    feature-node families (:data:`NODE_FAMILIES`), each written once."""
    from rmm_tpu_torch.datasets import write_synthetic_node_dataset

    roots = {
        "eth": write_synthetic_node_dataset(
            os.path.join(WORK, "ethereum-phishing"), family="eth",
            num_nodes=ETH_NODES, num_edges=ETH_EDGES, seed=0),
        "eth_cut": write_synthetic_node_dataset(
            os.path.join(WORK, "ethereum-phishing-cut"), family="eth",
            num_nodes=ETH_CUT_NODES, num_edges=ETH_CUT_EDGES, seed=0)}
    for family, (name, nodes, edges, classes) in NODE_FAMILIES.items():
        roots[family] = write_synthetic_node_dataset(
            os.path.join(WORK, name), family=family, num_nodes=nodes,
            num_edges=edges, num_feats=FAMILY_FEATS, n_classes=classes,
            seed=0)
    return roots


def node_argv(root: str, *extra) -> list:
    return ["--data", root, *NODE_ARGV, "--task", "node_classification",
            "--sampler_threads", "4", "--device", "cuda", *extra]


def node_cli(root: str, model: str, expect, *flags) -> dict:
    """One epoch of node classification through the training CLI
    (``cli/main.py --epochs 1 --save_model``) on the card, the launch
    counts set to 0 just before it and read just after: ``expect(fwd,
    bwd)`` of the epoch's steps and its evaluated val and test batches. A
    finite loss; f1 in [0, 1] on train, val and test; AUC in [0, 1] where
    the dataset has 2 classes and none otherwise; ``config.json`` holding
    the dataset's ``n_classes``, as the CLI adopts it; the epoch's
    checkpoint with ``best_m.json`` its val f1, and ``-1/`` (the first
    epoch improves on -1)."""
    import torch

    from rmm_tpu_torch.cli import main as train_cli
    from rmm_tpu_torch.utils.checkpoint import load_best_m

    name = f"{model} on {os.path.basename(root)} {' '.join(flags)}".strip()
    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    (ep,), best = train_cli.main(node_argv(
        root, "--model", model, *flags, "--epochs", "1", "--save_model",
        "--testing", "--wandb_dir", os.path.join(WORK, "node_runs")), stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    b = 200
    train_rows, val_rows, test_rows = stats["split_rows"]
    steps = -(-train_rows // b)
    evals = -(-val_rows // b) + -(-test_rows // b)
    check(counts == expect(steps + evals, steps),
          f"{name}: launches {counts} for {steps} steps and {evals} "
          f"evaluated batches, not {expect(steps + evals, steps)}")
    with open(os.path.join(stats["run_dir"], "config.json")) as f:
        cfg = json.load(f)
    binary = cfg["n_classes"] == 2
    check(math.isfinite(ep["loss"])
          and all(0 <= ep[k] <= 1 for k in ("f1", "val_f1", "test_f1"))
          and all((0 <= ep[k] <= 1) if binary else k not in ep
                  for k in ("auc", "val_auc", "test_auc")),
          f"{name}: epoch {ep}")
    ck = os.path.join(stats["run_dir"], "-1")
    saved = load_best_m(os.path.join(stats["run_dir"], "0"))
    check(ep["best"] and saved == best == ep["val_f1"]
          and os.path.exists(os.path.join(ck, "model.pt")),
          f"{name}: best_m.json {saved}, fit's {best}, the epoch's val f1 "
          f"{ep['val_f1']}, no {ck}/model.pt")
    return {"model": model, "flags": list(flags), "lr": cfg["lr"],
            "dropout": cfg["dropout"], "w_ce2": cfg["w_ce2"],
            "n_gnn_layers": cfg["n_gnn_layers"],
            "n_classes": cfg["n_classes"],
            "edge_capacity": stats["edge_capacity"],
            "node_capacity": stats["node_capacity"],
            "frontier_capacity": stats["frontier_capacity"],
            "split_rows": stats["split_rows"], "steps": steps,
            "evaluated_batches": evals, "loss": ep["loss"],
            "train_f1": ep["f1"], "val_f1": ep["val_f1"],
            "test_f1": ep["test_f1"],
            **{k: ep[k] for k in ("val_auc", "test_auc") if k in ep},
            "best_m": saved, "step_ms_median": ep.get("step_ms"),
            "epoch_s": ep["sec"], "train_rows_per_s": train_rows / ep["sec"],
            "drop_rate": ep["drop_rate"], "setup_s": stats["setup_s"],
            "wall_s": wall,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "checkpoint": ck}


def node_serve(root: str, run: dict) -> dict:
    """The predict CLI on a node run's ``-1/`` checkpoint (its flags and
    capacities, the frontier buffer's too) over the whole test split: the
    served ids are the test split's nodes but those of the dataset's
    ``ignore_label`` class, once each and in order; finite scores (where
    the head is binary). The launches, the batches (the whole split's)
    and rows/s."""
    import numpy as np

    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    argv = node_argv(root, "--model", run["model"], *run["flags"],
                     "--load_model", run["checkpoint"], "--split", "test",
                     "--output", os.path.join(WORK, "node_family_preds.csv"),
                     "--edge_capacity", str(run["edge_capacity"]),
                     "--node_capacity", str(run["node_capacity"]),
                     "--frontier_capacity", str(run["frontier_capacity"]))
    stats: dict = {}
    out, counts, wall = serve(argv, stats)
    ds = build_dataset(config_from_args(create_parser().parse_args(
        node_argv(root, "--model", run["model"], *run["flags"]))))
    y = ds.nodes.tensor_frame.y[ds.nodes.split()[2].indices]
    batches = -(-len(y) // 200)
    if getattr(ds, "ignore_label", None) is not None:
        y = y[y[:, 0] != ds.ignore_label]
    want = y[:, 1].astype(np.int64)
    check(np.array_equal(out["id"], want),
          f"served {len(out['id'])} node ids, not the {len(want)} labelled "
          "test nodes in order")
    if "score" in out:
        check(np.isfinite(out["score"]).all(), "non-finite node scores")
    rows = len(out["id"])
    return {"rows": rows, "batches": batches, "launches": counts,
            "wall_s": wall, "setup_s": stats["setup_s"],
            "predict_s": stats["predict_s"],
            "rows_per_s_predict": rows / stats["predict_s"],
            "rows_per_s_wall": rows / wall,
            "pred_mean": float(out["pred"].mean())}


def eth_node_phase(card: str, root: str) -> dict:
    """Ethereum phishing node classification on the card: ``tabgnn`` at
    the launcher's widths for an epoch through the training CLI, whose
    ``ethereum-phishing`` override sets lr 8e-4, dropout 0.123, w_ce2 1.16
    and 2 layers (``node_cli``); then the predict CLI on its ``-1/``
    checkpoint over the whole test split (the served ids are the test
    split's nodes). 4 tiled calls each way a step and 4 tiled forwards an
    evaluated or served batch."""
    run = node_cli(root, "tabgnn", lambda f, b: menu_counts("tabgnn", f, b))
    check((run["lr"], run["dropout"], run["w_ce2"], run["n_gnn_layers"],
           run["n_classes"]) == (8e-4, ETH_DROPOUT, 1.16, 2, 2),
          f"the Ethereum overrides did not apply: {run}")
    served = node_serve(root, run)
    check(served["launches"] == menu_counts("tabgnn", served["batches"], 0),
          f"launches {served['launches']} serving {served['batches']} "
          "node batches")
    out = {"phase": "eth_node", "nodes": ETH_NODES, "edges": ETH_EDGES,
           "channels": 32, "layers": 2, "heads": 8, "batch": 200,
           "fanouts": [100, 100], **run, "serve": served, "card": card,
           "ok": True}
    emit(out)
    return out


def node_menu_phase(card: str, root: str) -> dict:
    """The other seven models (``fttransformer``, ``gin``, ``pna``,
    ``cpna``, ``cpnatab``, ``tabgnninterleaved``, ``tabgnnfused``), then
    ``tabgnn`` with ``--ports`` and with ``--ego``, each for an epoch
    through the training CLI (``node_cli``) on the Ethereum cut:
    ``menu_counts``' launches a step and a batch; ``--ports`` adds the two
    port columns to the edges (S = 8) and ``--ego`` makes the node token
    ``EgoID``."""
    import torch

    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.frame.stype import Stype
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    runs = {}
    for model in NODE_MENU_CALLS:
        if model != "tabgnn":
            runs[model] = node_cli(
                root, model, lambda f, b, m=model: menu_counts(m, f, b))
            torch.cuda.empty_cache()
    for flag in ("--ports", "--ego"):
        runs[f"tabgnn {flag}"] = node_cli(
            root, "tabgnn", lambda f, b: menu_counts("tabgnn", f, b), flag)
        torch.cuda.empty_cache()
    ds = build_dataset(config_from_args(create_parser().parse_args(
        node_argv(root, "--model", "tabgnn", "--ports", "--ego"))))
    edge_tokens = ds.edges.tensor_frame.num_cols + 1
    check(edge_tokens == 8 and ds.nodes.tensor_frame.col_names == {
        Stype.relation: ["EgoID"]},
        f"--ports --ego: {edge_tokens} edge tokens, node columns "
        f"{ds.nodes.tensor_frame.col_names}")
    out = {"phase": "node_menu", "nodes": ETH_CUT_NODES,
           "edges": ETH_CUT_EDGES, "ports_edge_tokens": edge_tokens,
           "runs": runs, "card": card, "ok": True}
    emit(out)
    return out


def ssl_cli_epoch(root: str, runs: str, *flags) -> dict:
    """The SSL CLI (``fused.main``: a path holding ``eth`` is Ethereum
    phishing, split by ``--split_type``) for an epoch with
    ``--save_model`` on the Ethereum cut at the SSL config of record
    (C = 128, 3 layers, 64 negatives, batch 200, fanouts 100/100; the
    capacities calibrated), the launch counts set to 0 just before it and
    read just after: 10 split calls each way a step and 10 split forwards
    an evaluated val batch; a finite loss and RMSE, MRR and Hits@k in
    (0, 1], an MCM accuracy and a categorical loss of 0 (no categorical
    masked column, as the reference reports it), a drop rate in [0, 1];
    the epoch's checkpoint with ``best_m.json`` and a ``best_*`` snapshot
    for each metric (each improves on its first value)."""
    import torch

    from rmm_tpu_torch.cli import fused
    from rmm_tpu_torch.utils.checkpoint import load_best_m

    name = f"Ethereum SSL CLI {' '.join(flags)}".strip()
    stats: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    (ep,), best = fused.main(
        ["--dataset", root, *SSL_ARGV, "--epochs", "1", "--testing",
         "--sampler_threads", "4", "--wandb_dir", os.path.join(WORK, runs),
         "--device", "cuda", "--save_model", *flags], stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    b = 200
    train_rows, val_rows, _ = stats["split_rows"]
    steps, evals = -(-train_rows // b), -(-val_rows // b)
    k = SSL_LAUNCHES
    check(counts == route_counts(k * (steps + evals), k * steps),
          f"{name}: launches {counts} for {steps} steps and {evals} "
          f"evaluated batches (expected {k} split calls each way a step)")
    check(math.isfinite(ep["loss"]) and math.isfinite(ep["val_rmse"])
          and 0 < ep["val_mrr"] <= 1 and 0 <= ep["drop_rate"] <= 1
          and all(0 <= ep[f"val_hits@{n}"] <= 1 for n in (1, 2, 5, 10)),
          f"{name}: epoch {ep}")
    check(ep["val_accuracy"] == 0.0 and ep["train_loss_c"] == 0.0,
          f"{name}: an MCM accuracy or categorical loss without a "
          f"categorical column: {ep['val_accuracy']}, {ep['train_loss_c']}")
    run_dir = stats["run_dir"]
    saved = load_best_m(os.path.join(run_dir, "0"))
    want = {"accuracy": ep["val_accuracy"], "rmse": ep["val_rmse"],
            "mrr": ep["val_mrr"]}
    check(saved == best == want and all(
        os.path.exists(os.path.join(run_dir, f"best_{t}", "model.pt"))
        for t in ("acc", "rmse", "mrr")),
        f"{name}: best_m.json {saved}, fit's {best}, the epoch's {want}")
    out = {"mode": "mcm-lp", "flags": list(flags), "nodes": ETH_CUT_NODES,
           "edges": ETH_CUT_EDGES, "channels": 128, "layers": 3,
           "num_neg": 64, "batch": b, "split_type": "temporal_daily",
           "split_rows": stats["split_rows"],
           "edge_capacity": stats["edge_capacity"],
           "node_capacity": stats["node_capacity"],
           "frontier_capacity": stats["frontier_capacity"], "steps": steps,
           "evaluated_batches": evals, "loss": ep["loss"],
           "train_loss_n": ep["train_loss_n"],
           "neg_residual": ep["neg_residual"], "drop_rate": ep["drop_rate"],
           **{key: v for key, v in ep.items() if key.startswith("val_")},
           "best_m": saved, "step_ms_median": ep.get("step_ms"),
           "sample_ms": ep.get("sample_ms"), "epoch_s": ep["sec"],
           "train_rows_per_s": train_rows / ep["sec"],
           "setup_s": stats["setup_s"], "wall_s": wall, "launches": counts}
    torch.cuda.empty_cache()
    return out


def eth_ssl_phase(card: str, root: str) -> dict:
    """The SSL CLI for an epoch on the Ethereum cut with the host sampler
    (``ssl_cli_epoch``)."""
    out = {"phase": "eth_ssl", **ssl_cli_epoch(root, "eth_ssl_runs"),
           "card": card, "ok": True}
    emit(out)
    return out


def node_families_phase(card: str, roots: dict) -> dict:
    """``tabgnn`` node classification on ogbn-arxiv, MUSAE GitHub and
    LastFM Asia at 128 features (node tokens S = 130, 129 and 129: the
    split route's long cores; edge tokens S = 2, tiled), each for an epoch
    through the training CLI (``node_cli``: ogbn-arxiv's 40 and LastFM
    Asia's 18 classes take the weighted f1 and no AUC), ``node_counts``'
    launches; ogbn-arxiv's test split served from its ``-1/``
    checkpoint through the predict CLI."""
    import torch

    out = {}
    for family in NODE_FAMILIES:
        run = node_cli(roots[family], "tabgnn", node_counts)
        check(run["n_classes"] == NODE_FAMILIES[family][3],
              f"{family}: {run['n_classes']} classes")
        if family == "ogbn":
            run["serve"] = node_serve(roots[family], run)
            check(run["serve"]["launches"] == node_counts(
                run["serve"]["batches"], 0),
                f"launches {run['serve']['launches']} serving ogbn-arxiv")
        name, nodes, edges, _ = NODE_FAMILIES[family]
        out[family] = {"data": name, "nodes": nodes, "edges": edges,
                       "node_tokens": FAMILY_FEATS + 1 + (family == "ogbn"),
                       **run}
        torch.cuda.empty_cache()
    emit({"phase": "node_families", "families": out, "card": card,
          "ok": True})
    return out


def parity_counts(st: dict, run: dict) -> tuple[dict, dict]:
    """The launches of a record run's served batch and of its steps: on
    Ethereum phishing ``menu_counts``; ``tabgnn`` on a family through the
    long cores where its node tokens pass 16 (``node_counts``), else all
    tiled."""
    n = st["steps"]
    if run["data"] == "eth":
        return (menu_counts(run["model"], 1, 0),
                menu_counts(run["model"], n, n))
    d = st["data"][run["data"]]
    s = d["num_feats"] + 1 + (d["family"] == "ogbn")
    if s > 16:
        return node_counts(1, 0), node_counts(n, n)
    return menu_counts("tabgnn", 1, 0), menu_counts("tabgnn", n, n)


def node_family_parity_phase(card: str) -> dict:
    """Every run of the JAX CPU record ``node_family_record.npz``
    (``tools/make_torch_port_node_family_fixture.py``) on the card, from
    its start: the first test batch served (the same node ids, logits
    within SCORE_TOL), three steps (dropout 0) by ``convert.check_record``
    (``cpna`` and ``cpnatab`` at the default float32 limits with
    ``--ego``, at ``CPNA_*`` without it), the same parameters unmoved;
    then three mcm-lp steps on the Ethereum data at the SSL widths (batch
    64; the first batch's negatives equal). The runs of
    :data:`NODE_FAMILY_REPEATS` take their three steps again from the
    record's start and report each component's median over its limit and
    the faults ``check_record`` finds. The launches of each run by
    route."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                       loss_terms, random_variables,
                                       torch_key)
    from rmm_tpu_torch.datasets import (build_dataset,
                                        write_synthetic_node_dataset)
    from rmm_tpu_torch.nn.dropout import set_rate
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = load_record(NODE_FAMILY_FIXTURE)
    st = json.loads(str(rec["settings"]))
    roots = {name: write_synthetic_node_dataset(
        os.path.join(WORK, "parity", f"{d['dir']}_{d['nodes']}"),
        family=d["family"], num_nodes=d["nodes"], num_edges=d["edges"],
        num_feats=d["num_feats"], n_classes=d["n_classes"],
        seed=st["data_seed"]) for name, d in st["data"].items()}
    out, faults = {}, []
    for name, run in st["runs"].items():
        argv = ["--data", roots[run["data"]], "--model", run["model"],
                "--task", "node_classification", "--n_hidden",
                str(st["n_hidden"]), "--n_gnn_layers",
                str(st["n_gnn_layers"]), "--num_neighs",
                *map(str, st["num_neighs"]), "--batch_size",
                str(st["batch_size"]), "--seed", str(st["seed"]),
                *run["flags"], "--device", "cuda"]
        cfg = config_from_args(create_parser().parse_args(argv)).replace(
            dropout=0.0, **st["capacities"][run["data"]])
        ds = build_dataset(cfg)
        tr = Trainer(cfg.replace(n_classes=ds.n_classes), ds)
        tr.model.load_state_dict(from_jax(
            random_variables(run["shapes"], st["var_seed"]), tr.model))
        set_rate(tr.model, 0.0)
        train, _, test = ds.nodes.split()
        gb = next(tr._batches(test, "test"))
        reset_counts()
        with torch.inference_mode():
            logits = tr._logits(gb.to(tr.device)).cpu().numpy()
        serve_counts = read_counts()
        keep = gb.seed_mask
        ids_equal = bool(np.array_equal(gb.node_gather[:cfg.batch_size][keep],
                                        rec[f"{name}/serve/id"]))
        err = float(np.abs(logits[keep] - rec[f"{name}/serve/logits"]).max())
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        batches = list(itertools.islice(
            tr._batches(train, "train", st["epoch"]), st["steps"]))
        reset_counts()
        tr.model.train()
        terms = [loss_terms(tr._step(b.to(tr.device))[0], {})
                 for b in batches]
        counts = read_counts()
        state = tr.model.state_dict()
        limits = "" if "--ego" in run["flags"] else run["model"]
        run_faults, summary = check_record(
            state, terms, rec, f"{name}/", cfg.lr, st["steps"],
            st["n_hidden"], model=limits)
        unmoved = {k for k, _ in tr.model.named_parameters()
                   if torch.equal(state[k], before[k])}
        if unmoved != {torch_key(k)[0] for k in run["unmoved"]}:
            run_faults.append(f"unmoved {sorted(unmoved)}, the "
                              f"reference's {run['unmoved']}")
        if not ids_equal:
            run_faults.append("served node ids differ")
        if not err <= SCORE_TOL:
            run_faults.append(f"logit error {err} > {SCORE_TOL}")
        want = parity_counts(st, run)
        if (serve_counts, counts) != (want[0], want[1]):
            run_faults.append(f"launches {serve_counts} serving a batch, "
                              f"{counts} for the steps, not {want}")
        medians = [summary["param_median_abs_err"]]
        repeat_launches, repeat_faults = [], []
        for r in range(NODE_FAMILY_REPEATS.get(name, 0)):
            tr = Trainer(cfg.replace(n_classes=ds.n_classes), ds)
            tr.model.load_state_dict(from_jax(
                random_variables(run["shapes"], st["var_seed"]), tr.model))
            set_rate(tr.model, 0.0)
            reset_counts()
            tr.model.train()
            again = [loss_terms(tr._step(b.to(tr.device))[0], {})
                     for b in batches]
            repeat_launches.append(read_counts())
            rep_faults, rep = check_record(
                tr.model.state_dict(), again, rec, f"{name}/", cfg.lr,
                st["steps"], st["n_hidden"], model=limits)
            repeat_faults += [f"repeat {r + 1}: {f}" for f in rep_faults]
            if repeat_launches[-1] != want[1]:
                run_faults.append(f"repeat {r + 1}: launches "
                                  f"{repeat_launches[-1]}, not {want[1]}")
            medians.append(rep["param_median_abs_err"])
        faults += [f"{name}: {f}" for f in run_faults]
        out[name] = {"model": run["model"], "flags": run["flags"],
                     "limits": "default" if "--ego" in run["flags"]
                     or run["model"] not in ("cpna", "cpnatab") else "cpna",
                     "max_logit_err": err, "terms": terms,
                     "jax_terms": run["losses"], **summary,
                     "serve_launches": serve_counts, "launches": counts}
        if repeat_launches:
            tol = summary["param_median_tol"]
            out[name].update(
                median_over_limit={c: [m[c] / tol for m in medians]
                                   for c in medians[0]},
                repeat_faults=repeat_faults,
                repeat_launches=repeat_launches)
        del tr, ds
        torch.cuda.empty_cache()
    ssl = st["ssl"]
    tr = ssl_trainer(roots["eth"], [
        "--mode", "mcm-lp", "--channels", str(ssl["channels"]),
        "--num_layers", str(ssl["num_layers"]), "--num_neg_samples",
        str(ssl["num_neg_samples"]), "--batch_size", str(ssl["batch_size"]),
        "--khop_neighbors", *map(str, ssl["khop_neighbors"]), "--dropout",
        "0", "--lr", str(ssl["lr"])], ssl["edge_capacity"],
        ssl["node_capacity"], seed=st["seed"])
    tr.model.load_state_dict(from_jax(
        random_variables(ssl["shapes"], st["var_seed"]), tr.model))
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", st["epoch"]),
        st["steps"]))
    if not np.array_equal(batches[0].neg_edge_index, rec["ssl/neg0"]):
        faults.append("ssl: the first batch's negatives differ")
    reset_counts()
    tr.model.train()
    terms = [loss_terms(*tr._step(gb.to(tr.device))) for gb in batches]
    counts = read_counts()
    ssl_faults, summary = check_record(tr.model.state_dict(), terms, rec,
                                       "ssl/", ssl["lr"], 2 * st["steps"],
                                       ssl["channels"])
    faults += [f"ssl: {f}" for f in ssl_faults]
    n, k = st["steps"], SSL_LAUNCHES
    if counts != route_counts(k * n, k * n):
        faults.append(f"ssl: launches {counts} for {n} steps")
    out["ssl"] = {"terms": terms, "jax_terms": ssl["terms"], **summary,
                  "launches": counts}
    del tr
    torch.cuda.empty_cache()
    check(not faults, "node-family runs off the JAX record: "
          + "; ".join(faults))
    res = {"phase": "node_family_parity", "runs": out, "steps": st["steps"],
           "score_tol": SCORE_TOL, "card": card, "ok": True}
    emit(res)
    return res


def family_train_phase(card: str, csv: str) -> dict:
    """The other model families on the card at the supervised launcher's
    flags. ``pna`` (its default) trains one epoch through the training CLI
    (``--testing --sampler_threads 4 --save_model``), whose checkpoint then
    serves the whole test split through the predict CLI. The other five
    train through the trainer the training CLI builds (``config_from_args``,
    ``build_dataset`` once, ``Trainer``) on the first FAMILY_BATCHES train
    batches, are evaluated on the first FAMILY_BATCHES val batches and
    serve the first FAMILY_BATCHES test batches through ``Trainer.predict``
    (the predict CLI's path). Each: finite losses, the median step on the
    device's clock, train and served rows/s, and ``family_counts``'
    launches a step, an evaluated and a served batch, every one tiled."""
    import numpy as np
    import torch

    from rmm_tpu_torch.cli import main as train_cli
    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    st = fixture_settings()
    argv = ["--data", csv, *FAMILY_ARGV, "--seed", str(st["seed"]),
            "--sampler_threads", "4", "--device", "cuda"]
    out = {}

    # pna: the training CLI for an epoch, then the predict CLI
    stats: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    history, _ = train_cli.main(argv + [
        "--model", "pna", "--epochs", "1", "--testing", "--save_model",
        "--wandb_dir", os.path.join(WORK, "family_runs")], stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    (ep,) = history
    b = st["batch_size"]
    train_rows, val_rows, test_rows = stats["split_rows"]
    steps = -(-train_rows // b)
    evals = -(-val_rows // b) + -(-test_rows // b)
    check(math.isfinite(ep["loss"]), f"pna train loss {ep['loss']}")
    check(counts == family_counts("pna", steps + evals, steps),
          f"pna launched column attention: {counts}")
    run: dict = {}
    served, serve_counts, serve_wall = serve(argv + [
        "--model", "pna", "--load_model", os.path.join(stats["run_dir"], "0"),
        "--split", "test", "--output", os.path.join(WORK, "pna.csv")], run)
    rows = len(served["id"])
    check(rows == test_rows and np.isfinite(served["score"]).all(),
          f"pna served {rows} of {test_rows} rows, or non-finite scores")
    check(serve_counts == family_counts("pna", -(-rows // b), 0),
          f"pna serving launched column attention: {serve_counts}")
    out["pna"] = {
        "through": "cli/main.py, cli/predict.py", "steps": steps,
        "evaluated_batches": evals, "loss": ep["loss"],
        "val_f1": ep["val_f1"], "test_f1": ep["test_f1"],
        "step_ms_median": ep.get("step_ms"), "epoch_s": ep["sec"],
        "train_rows_per_s": train_rows / ep["sec"], "train_wall_s": wall,
        "setup_s": stats["setup_s"], "train_launches": counts,
        "served_rows": rows, "served_batches": -(-rows // b),
        "serve_launches": serve_counts,
        "rows_per_s_predict": rows / run["predict_s"],
        "rows_per_s_wall": rows / serve_wall,
        "launches_per_step": {"fwd": 0, "bwd": 0, "reduce": 0},
        "launches_per_served_batch": 0, "routes": []}

    # the other five: the CLI's trainer on one loaded dataset, cut
    t0 = time.perf_counter()
    dataset = build_dataset(config_from_args(create_parser().parse_args(
        argv + ["--model", "pna"])))
    data_s = time.perf_counter() - t0
    n = FAMILY_BATCHES
    for model in FAMILIES:
        if model == "pna":
            continue
        t0 = time.perf_counter()
        cfg = config_from_args(create_parser().parse_args(
            argv + ["--model", model, "--edge_capacity",
                    str(st["edge_capacity"]), "--node_capacity",
                    str(st["node_capacity"])]))
        tr = Trainer(cfg, dataset)
        setup_s = time.perf_counter() - t0
        train, val, test = (DatasetView(v.parent, v.indices[:n * b])
                            for v in dataset.edges.split())
        reset_counts()
        t0 = time.perf_counter()
        tm = tr.train_epoch(train, 0)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_counts = read_counts()
        reset_counts()
        vm = tr.evaluate(val, "val")
        eval_counts = read_counts()
        reset_counts()
        t0 = time.perf_counter()
        served = tr.predict(test, "test")
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_counts = read_counts()
        k = FAMILY_CALLS[model]
        check(math.isfinite(tm["loss"]) and 0 <= vm["f1"] <= 1,
              f"{model}: loss {tm['loss']}, val f1 {vm['f1']}")
        check(train_counts == family_counts(model, n, n),
              f"{model}: launches {train_counts} for {n} steps (expected "
              f"{k} tiled forwards, backwards and reduces a step)")
        check(eval_counts == family_counts(model, n, 0)
              and serve_counts == family_counts(model, n, 0),
              f"{model}: launches {eval_counts} for {n} evaluated and "
              f"{serve_counts} for {n} served batches (expected {k} tiled "
              "forwards a batch)")
        check(len(served["id"]) == n * b
              and np.isfinite(served["score"]).all(),
              f"{model} served {len(served['id'])} rows of {n * b}, or "
              "non-finite scores")
        out[model] = {
            "through": "the training CLI's Trainer, Trainer.predict",
            "steps": n, "evaluated_batches": n, "served_batches": n,
            "loss": tm["loss"], "val_f1": vm["f1"],
            "step_ms_median": tm.get("step_ms"), "train_wall_s": train_wall,
            "train_rows_per_s": n * b / train_wall, "setup_s": setup_s,
            "train_launches": train_counts, "eval_launches": eval_counts,
            "serve_launches": serve_counts, "served_rows": n * b,
            "rows_per_s_predict": n * b / serve_s,
            "launches_per_step": {key: train_counts[key] / n
                                  for key in ("fwd", "bwd", "reduce")},
            "launches_per_served_batch": serve_counts["fwd"] / n,
            "routes": ["tiled"] if k else []}
        del tr
        torch.cuda.empty_cache()
    rec = {"phase": "family_train", "channels": 32, "layers": 2, "heads": 8,
           "batch": b, "dropout": TRAIN_DROPOUT,
           "cpnatab_row_dropout": CPNATAB_ROW_DROPOUT,
           "edge_capacity": st["edge_capacity"],
           "node_capacity": st["node_capacity"], "data_s": data_s,
           "models": out, "card": card, "ok": True}
    emit(rec)
    rec["dataset"] = dataset   # family_bf16 trains on it again
    return rec


def family_parity_phase(card: str) -> dict:
    """Each family on the card against the JAX CPU record
    ``family_record.npz`` (``tools/make_torch_port_family_fixture.py``: the
    launcher's widths with ``--emlps``, dropout 0, cpnatab's row attention
    at 0 too, on the 16,384-row cut of ``train_parity``, the reference's
    scatter PNA path): from the record's start, the first test batch served
    (the same ids, scores within SCORE_TOL), then three steps (each loss
    and the sampled variables by ``convert.check_record``'s float32
    limits, the same parameters unmoved); the launches of both."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                       loss_terms, random_variables,
                                       torch_key)
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.nn.dropout import set_rate
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = load_record(FAMILY_FIXTURE)
    st = json.loads(str(rec["settings"]))
    csv = write_synthetic_aml_csv(os.path.join(WORK, "aml_family.csv"),
                                  num_rows=st["rows"],
                                  num_accounts=st["num_accounts"],
                                  seed=st["data_seed"])
    dataset, out = None, {}
    n, b = st["steps"], st["batch_size"]
    for model in FAMILIES:
        cfg = config_from_args(create_parser().parse_args([
            "--data", csv, "--model", model, "--n_hidden",
            str(st["n_hidden"]), "--n_gnn_layers", str(st["n_gnn_layers"]),
            "--num_neighs", *map(str, st["num_neighs"]), "--batch_size",
            str(b), "--seed", str(st["seed"]), "--lr", str(st["lr"]),
            "--dropout", "0", "--edge_capacity", str(st["edge_capacity"]),
            "--node_capacity", str(st["node_capacity"]), "--device", "cuda",
            *(["--emlps"] if st["emlps"] else [])]))
        dataset = dataset or build_dataset(cfg)
        tr = Trainer(cfg, dataset)
        run = st["models"][model]
        tr.model.load_state_dict(from_jax(
            random_variables(run["shapes"], st["var_seed"]), tr.model))
        set_rate(tr.model, 0.0)
        train, _, test = dataset.edges.split()
        gb = next(tr._batches(test, "test"))
        reset_counts()
        score = tr._forward_eval(gb.to(tr.device))["score"].cpu().numpy()
        serve_counts = read_counts()
        ids = gb.edge_gather[:b][gb.seed_mask]
        check(np.array_equal(ids, rec[f"{model}/serve/id"]),
              f"{model}: served ids differ from the JAX record")
        score_err = float(np.abs(score[gb.seed_mask]
                                 - rec[f"{model}/serve/score"]).max())
        check(score_err <= SCORE_TOL,
              f"{model}: score error {score_err} > {SCORE_TOL}")
        batches = list(itertools.islice(
            tr._batches(train, "train", st["epoch"]), n))
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        reset_counts()
        tr.model.train()
        terms = [loss_terms(tr._step(g.to(tr.device))[0], {})
                 for g in batches]
        counts = read_counts()
        check(serve_counts == family_counts(model, 1, 0)
              and counts == family_counts(model, n, n),
              f"{model}: launches {serve_counts} serving a batch and "
              f"{counts} in {n} parity steps")
        state = tr.model.state_dict()
        faults, summary = check_record(state, terms, rec, f"{model}/",
                                       st["lr"], n, st["n_hidden"],
                                       model=model)
        unmoved = {name for name, _ in tr.model.named_parameters()
                   if torch.equal(state[name], before[name])}
        if unmoved != {torch_key(k)[0] for k in run["unmoved"]}:
            faults.append(f"unmoved parameters {sorted(unmoved)}, the "
                          f"reference's {run['unmoved']}")
        check(not faults, f"{model} steps off the JAX record: "
              + "; ".join(faults))
        out[model] = {"terms": terms,
                      "jax_terms": rec[f"{model}/term/loss"].tolist(),
                      "served_rows": len(ids), "max_score_err": score_err,
                      **summary, "serve_launches": serve_counts,
                      "launches": counts}
        del tr
        torch.cuda.empty_cache()
    res = {"phase": "family_parity", "rows": st["rows"], "steps": n,
           "edge_capacity": st["edge_capacity"],
           "node_capacity": st["node_capacity"], "emlps": st["emlps"],
           "score_tol": SCORE_TOL, "models": out, "card": card, "ok": True}
    emit(res)
    return res


def ssl_parity_csv() -> str:
    from rmm_tpu_torch.datasets import write_synthetic_aml_csv

    _, st = ssl_record()
    return write_synthetic_aml_csv(os.path.join(WORK, "aml_ssl.csv"),
                                   num_rows=st["rows"],
                                   num_accounts=st["num_accounts"],
                                   seed=st["data_seed"])


def ssl_parity_phase(card: str, csv: str, path: str = SSL_FIXTURE,
                     precision: str = "f32") -> dict:
    """Three mcm-lp steps on the card (dropout 0, at ``precision``) from
    the record's start against the JAX CPU record of the same steps at the
    SSL widths: each loss term and the sampled variables, by the limits of
    ``rmm_tpu_torch.convert.check_record`` (a bf16 record's at its bf16
    limits)."""
    import itertools

    import numpy as np

    from rmm_tpu_torch.convert import check_record, from_jax, loss_terms, \
        random_variables

    rec, st = ssl_record(path)
    ms = st["modes"]["mcm-lp"]
    argv = ["--mode", "mcm-lp", "--channels", str(st["channels"]),
            "--num_layers", str(st["num_layers"]),
            "--num_neg_samples", str(st["num_neg_samples"]),
            "--batch_size", str(st["batch_size"]), "--khop_neighbors",
            *map(str, st["khop_neighbors"]), "--dropout", "0",
            "--lr", str(st["lr"]), "--precision", precision]
    tr = ssl_trainer(csv, argv, ms["edge_capacity"], ms["node_capacity"],
                     seed=st["seed"])
    tr.model.load_state_dict(from_jax(
        random_variables(ms["shapes"], st["var_seed"]), tr.model))
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", st["epoch"]),
        st["steps"]))
    check(np.array_equal(batches[0].neg_edge_index, rec["mcm-lp/neg0"]),
          "the first batch's negatives differ from the JAX record's")
    reset_counts()
    tr.model.train()
    terms = [loss_terms(*tr._step(gb.to(tr.device))) for gb in batches]
    counts = read_counts()
    n, k = st["steps"], SSL_LAUNCHES
    check(counts == {"fwd": k * n, "fwd_tiled": 0, "fwd_split": k * n,
                     "bwd": k * n, "bwd_tiled": 0, "bwd_split": k * n,
                     "reduce": k * n, **NO_BF16},
          f"launches {counts} for {n} SSL steps")
    faults, summary = check_record(tr.model.state_dict(), terms, rec,
                                   "mcm-lp/", st["lr"], 2 * n,
                                   st["channels"], precision)
    check(not faults, "SSL steps off the JAX record: " + "; ".join(faults))
    out = {"phase": "ssl_parity" if precision == "f32" else
           f"ssl_parity_{precision}", "rows": st["rows"], "steps": n,
           "channels": st["channels"], "layers": st["num_layers"],
           "num_neg": st["num_neg_samples"],
           "edge_capacity": ms["edge_capacity"],
           "node_capacity": ms["node_capacity"], "terms": terms,
           "jax_terms": {key[len("mcm-lp/term/"):]: rec[key].tolist()
                         for key in rec.files
                         if key.startswith("mcm-lp/term/")},
           # a bf16 record's float32 run of the same steps: how far bf16
           # moves the reference
           "jax_f32_terms": {key[len("f32/mcm-lp/term/"):]: rec[key].tolist()
                             for key in rec.files
                             if key.startswith("f32/mcm-lp/term/")},
           **summary, "negatives_equal": True, "launches": counts,
           "card": card, "ok": True}
    emit(out)
    return out


def ssl_cli_phase(card: str, csv: str) -> dict:
    """The SSL CLI for one epoch on the record's cut, on the card, with
    ``--save_model``; then a resume from its checkpoint."""
    import torch

    from rmm_tpu_torch.cli import fused

    runs = os.path.join(WORK, "ssl_runs")
    argv = ["--dataset", csv, *SSL_ARGV, "--epochs", "1", "--testing",
            "--sampler_threads", "4", "--wandb_dir", runs,
            "--device", "cuda"]
    stats: dict = {}
    reset_counts()
    history, best = fused.main(argv + ["--save_model"], stats)
    torch.cuda.synchronize()
    counts = read_counts()
    (ep,) = history
    b = 200
    train_rows, val_rows, _ = stats["split_rows"]
    steps, evals = -(-train_rows // b), -(-val_rows // b)
    k = SSL_LAUNCHES
    check(counts == {"fwd": k * (steps + evals), "fwd_tiled": 0,
                     "fwd_split": k * (steps + evals),
                     "bwd": k * steps, "bwd_tiled": 0,
                     "bwd_split": k * steps, "reduce": k * steps, **NO_BF16},
          f"SSL CLI launches {counts} for {steps} steps and {evals} "
          "evaluated batches")
    check(math.isfinite(ep["loss"]) and 0 < ep["val_mrr"] <= 1,
          f"SSL CLI epoch {ep}")
    ck = os.path.join(stats["run_dir"], "0")
    check(all(os.path.exists(os.path.join(ck, f)) for f in
              ("model.pt", "optimizer.pt", "best_m.json", "meta.json")),
          f"no checkpoint in {ck}")
    resumed, best2 = fused.main(argv + ["--checkpoint", ck])
    check([h["epoch"] for h in resumed] == [1]
          and os.path.isdir(os.path.join(stats["run_dir"], "1")),
          "the SSL checkpoint did not resume at epoch 1")
    rec = {"phase": "ssl_cli", "rows": sum(stats["split_rows"]),
           "train_rows": train_rows, "steps": steps,
           "evaluated_batches": evals, "launches": counts,
           "loss": ep["loss"], "val_mrr": ep["val_mrr"],
           "val_hits@10": ep["val_hits@10"],
           "val_accuracy": ep["val_accuracy"], "val_rmse": ep["val_rmse"],
           "best": best, "resumed_epoch": resumed[0]["epoch"],
           "resumed_val_mrr": resumed[0]["val_mrr"],
           "epoch_s": ep["sec"], "setup_s": stats["setup_s"],
           "edge_capacity": stats["edge_capacity"],
           "node_capacity": stats["node_capacity"], "card": card, "ok": True}
    emit(rec)
    return rec


# The masked-cell objectives. The tabular MCM entry point
# (cli/fttransformer.py at its defaults: C = 128, 8 heads, 3 layers,
# dropout 0.5, batch 200, AdamW lr 2e-4): one column-attention call a layer
# on the edge rows with their CLS token, [200, 6, 128/8], through the split
# routes.
TABULAR_LAYERS = 3
# --task mcm_edge_table: tabgnn at the config of record (tiled, 4 calls
# each way a step) through the training CLI for an epoch on the MCM
# record's cut, and tabgnnfused at the SSL widths (split, fused_launches(3)
# each way) through the training CLI's trainer, cut to MCM_EDGE_BATCHES
# train and val batches (the node_train cut)
MCM_EDGE_BATCHES = 24
MCM_EDGE_RUNS = {"tabgnn": FAMILY_ARGV, "tabgnnfused": TRANSFER_ARGV[2:] + [
    "--num_neighs", "100", "100", "--batch_size", "200"]}
MCM_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                           "mcm_record.npz")
# The record's limits: outputs 1e-4 (relative to the largest entry where
# that exceeds 1); the loss terms and parameters by convert.check_record
# (MoCo's at model="moco"). MoCo's λ after each step: where the
# reference's has an entry of 0 (its softmax underflowed: step 1 of the
# record), each entry within 1e-5; else each entry within half of the
# reference's smaller entry, λ_mcm (5.7e-7 after step 2, 3.8e-3 after
# step 3), so a λ that collapsed to [1, 0] fails after step 2. An absolute
# limit cannot be both tight and stable there: after step 3 λ is the
# softmax of differences of y yᵀ entries of ~1e4 at the SSL widths, and
# the cross term y_lp·y_mcm (cosine ~0.04) moves with each gradient's
# direction, so the port's own runs over 1-3 CPU threads (only the
# summation order differs) land λ_mcm at 0.0027-0.0040 (up to 29% off the
# reference's 0.0038). The norms of y's rows: 5e-3 relative (the same runs
# land within 1e-3 of the reference's).
MCM_OUT_TOL, MOCO_LAMBDA_TOL, MOCO_LAMBDA_RTOL = 1e-4, 1e-5, 0.5
MOCO_Y_NORM_RTOL = 5e-3
SIMPLEX_TOL = 1e-5


def mcm_cuts(st: dict, root: str) -> dict:
    """The MCM record's two synthetic AML cuts, as CSVs under ``root``."""
    from rmm_tpu_torch.datasets import write_synthetic_aml_csv

    out = {}
    for name, spec in (("cut", st["cut"]), ("moco", st["moco"])):
        out[name] = write_synthetic_aml_csv(
            os.path.join(root, f"aml_mcm_{name}.csv"),
            num_rows=spec["rows"], num_accounts=spec["num_accounts"],
            seed=spec["data_seed"])
    return out


def mcm_tabular_trainer(st: dict, csv: str, mask_vector: bool, device: str,
                        edges=None):
    """The tabular CLI's trainer at the record's flags (dropout 0), from the
    record's start (``edges``: the MASK dataset's table, when loaded)."""
    from rmm_tpu_torch.cli import fttransformer
    from rmm_tpu_torch.convert import from_jax, random_variables
    from rmm_tpu_torch.datasets import IBMTransactionsAML
    from rmm_tpu_torch.datasets.base import PretrainType
    from rmm_tpu_torch.train.tabular import TabularMCMTrainer

    t = st["tabular"]
    cfg = fttransformer.config_from_args(fttransformer.build_parser(
    ).parse_args([
        "--dataset", csv, "--channels", str(t["channels"]), "--num_layers",
        str(t["num_layers"]), "--batch_size", str(t["batch_size"]), "--lr",
        str(t["lr"]), "--weight_decay", str(t["weight_decay"]), "--eps",
        str(t["adam_eps"]), "--dropout", "0", "--device", device])).replace(
        seed=st["seed"])
    if edges is None:
        edges = IBMTransactionsAML(root=csv,
                                   pretrain={PretrainType.MASK}).edges
    tr = TabularMCMTrainer(cfg, edges, mask_vector)
    run = st["runs"]["tabular_mv" if mask_vector else "tabular"]
    tr.model.load_state_dict(from_jax(random_variables(
        run["shapes"], st["var_seed"]), tr.model))
    return tr


def mcm_edge_trainer(st: dict, csv: str, model: str, device: str,
                     dataset=None):
    """The training CLI's trainer under ``--task mcm_edge_table`` at the
    record's flags (dropout 0), from the record's start."""
    from rmm_tpu_torch.convert import from_jax, random_variables
    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.nn.dropout import set_rate
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    e = st["edge"]
    cfg = config_from_args(create_parser().parse_args([
        "--data", csv, "--model", model, "--task", "mcm_edge_table",
        "--n_hidden", str(e["n_hidden"]), "--n_gnn_layers",
        str(e["n_gnn_layers"]), "--num_neighs", *map(str, e["num_neighs"]),
        "--batch_size", str(e["batch_size"]), "--seed", str(st["seed"]),
        "--lr", str(e["lr"]), "--dropout", "0", "--edge_capacity",
        str(e["edge_capacity"]), "--node_capacity", str(e["node_capacity"]),
        "--device", device, *(["--emlps"] if e["emlps"] else [])]))
    tr = Trainer(cfg, dataset or build_dataset(cfg))
    tr.model.load_state_dict(from_jax(random_variables(
        st["runs"][f"mcm_{model}"]["shapes"], st["var_seed"]), tr.model))
    set_rate(tr.model, 0.0)
    return tr


def mcm_moco_trainer(st: dict, csv: str, device: str):
    """The SSL CLI's pretrainer (mcm-lp, ``--moo moco``) at the record's
    flags (dropout 0), from the record's start."""
    from rmm_tpu_torch.cli import fused
    from rmm_tpu_torch.convert import from_jax, random_variables
    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.train.pretrain import PretrainTrainer

    m, run = st["moco"], st["runs"]["moco"]
    cfg = fused.config_from_args(fused.build_parser().parse_args([
        "--dataset", csv, "--mode", "mcm-lp", "--moo", "moco",
        "--channels", str(m["channels"]), "--num_layers",
        str(m["num_layers"]), "--num_neg_samples",
        str(m["num_neg_samples"]), "--batch_size", str(m["batch_size"]),
        "--khop_neighbors", *map(str, m["khop_neighbors"]), "--dropout",
        "0", "--lr", str(m["lr"]), "--weight_decay", str(m["weight_decay"]),
        "--eps", str(m["adam_eps"]), "--device", device])).replace(
        edge_capacity=run["edge_capacity"],
        node_capacity=run["node_capacity"], seed=st["seed"])
    tr = PretrainTrainer(cfg, build_dataset(cfg), "mcm-lp")
    tr.model.load_state_dict(from_jax(random_variables(
        run["shapes"], st["var_seed"]), tr.model))
    return tr


def moco_faults(lambd: list, y_norm: list, rec) -> tuple[list, dict]:
    """λ and the norms of y's rows after each step against the MCM record's
    MoCo run, by the limits above: (the faults, the errors)."""
    import numpy as np

    want, got = rec["moco/lambd"], np.stack(lambd)
    low = want.min(axis=1)
    tol = np.where(low > 0, MOCO_LAMBDA_RTOL * low, MOCO_LAMBDA_TOL)
    lam_err = np.abs(got - want).max(axis=1)
    y_err = (np.abs(np.stack(y_norm) - rec["moco/y_norm"])
             / rec["moco/y_norm"]).max(axis=1)
    faults = [f"λ after step {i + 1}: {got[i].tolist()}, the reference's "
              f"{want[i].tolist()} (limit {tol[i]})"
              for i in np.nonzero(lam_err > tol)[0]]
    faults += [f"y's row norms after step {i + 1} {y_err[i]} off "
               f"(limit {MOCO_Y_NORM_RTOL})"
               for i in np.nonzero(y_err > MOCO_Y_NORM_RTOL)[0]]
    return faults, {"lambd": got.tolist(), "jax_lambd": want.tolist(),
                    "lambd_abs_err": lam_err.tolist(),
                    "lambd_tol": tol.tolist(),
                    "y_norm_rel_err": y_err.tolist(),
                    "y_norm_rtol": MOCO_Y_NORM_RTOL}


def mcm_output_error(out, rec, prefix: str) -> float:
    """The largest error of a model's MCM outputs ``(num_out, cat_out[,
    mv_out])`` against the record's, each relative to its largest entry
    where that exceeds 1."""
    num_out, cat_out, *mv = out
    got = {"num": num_out, **{f"cat_{i}": c for i, c in enumerate(cat_out)}}
    if mv and mv[0] is not None:
        got["mv"] = mv[0]
    keys = {k[len(prefix) + 4:] for k in rec.files
            if k.startswith(prefix + "out/")}
    check(set(got) == keys, f"{prefix}: outputs {sorted(got)}, the "
          f"record's {sorted(keys)}")
    err = 0.0
    for key, t in got.items():
        want = rec[f"{prefix}out/{key}"]
        diff = float(abs(t.detach().cpu().numpy()[:len(want)] - want).max())
        err = max(err, diff / max(1.0, float(abs(want).max())))
    return err


def tabular_mcm_phase(card: str, csv: str) -> dict:
    """The tabular MCM CLI at its defaults on the config of record's data:
    one epoch plain, then one with ``--mask_vector --save_model`` and a
    resume from that epoch's checkpoint. Finite losses, accuracies in
    [0, 1], and per train step TABULAR_LAYERS split forwards, backwards and
    reduces, per evaluated batch TABULAR_LAYERS split forwards."""
    import torch

    from rmm_tpu_torch.cli import fttransformer

    runs = os.path.join(WORK, "tabular_runs")
    argv = ["--dataset", csv, "--epochs", "1", "--testing", "--wandb_dir",
            runs, "--device", "cuda"]
    k, out = TABULAR_LAYERS, {}
    for name, extra in (("plain", []),
                        ("mask_vector", ["--mask_vector", "--save_model"])):
        stats: dict = {}
        reset_counts()
        t0 = time.perf_counter()
        (ep,), best = fttransformer.main(argv + extra, stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        b = 200
        train_rows, val_rows, _ = stats["split_rows"]
        steps, evals = -(-train_rows // b), -(-val_rows // b)
        check(counts == route_counts(k * (steps + evals), k * steps),
              f"tabular {name}: launches {counts} for {steps} steps and "
              f"{evals} evaluated batches (expected {k} split forwards a "
              f"batch, {k} split backwards and reduces a step)")
        accs = [ep["val_accuracy"]] + ([ep["val_mv_accuracy"]]
                                       if "--mask_vector" in extra else [])
        check(math.isfinite(ep["loss"]) and math.isfinite(ep["val_rmse"])
              and all(0 <= a <= 1 for a in accs),
              f"tabular {name}: epoch {ep}")
        out[name] = {"steps": steps, "evaluated_batches": evals,
                     "launches": counts, "loss": ep["loss"],
                     "train_acc": ep["train_acc"],
                     "train_rmse": ep["train_rmse"],
                     **{key: v for key, v in ep.items()
                        if key.startswith("val_")},
                     "step_ms_median": ep.get("step_ms"),
                     "epoch_s": ep["sec"],
                     "train_rows_per_s": train_rows / ep["sec"],
                     "setup_s": stats["setup_s"], "fit_s": stats["fit_s"],
                     "wall_s": wall, "best": best}
    ck = os.path.join(stats["run_dir"], "0")
    check(all(os.path.exists(os.path.join(ck, f)) for f in
              ("model.pt", "optimizer.pt", "best_m.json", "meta.json")),
          f"no tabular checkpoint in {ck}")
    resumed, best = fttransformer.main(argv + ["--mask_vector",
                                               "--checkpoint", ck])
    check([h["epoch"] for h in resumed] == [1]
          and os.path.isdir(os.path.join(stats["run_dir"], "1")),
          "the tabular checkpoint did not resume at epoch 1")
    rec = {"phase": "tabular_mcm", "channels": 128,
           "layers": TABULAR_LAYERS, "heads": 8, "batch": 200,
           "dropout": 0.5, "attention_rows": [200, 6, 128, 8],
           "train_rows": train_rows, "runs": out,
           "resumed_epoch": resumed[0]["epoch"],
           "resumed_loss": resumed[0]["loss"], "resumed_best": best,
           "card": card, "ok": True}
    emit(rec)
    return rec


def mcm_edge_phase(card: str, csv: str) -> dict:
    """``--task mcm_edge_table`` on the card. tabgnn at the config of
    record trains one epoch through the training CLI (``--save_model``) on
    the MCM record's 16,384-row cut: a finite loss, ``[rmse, accuracy]``
    in range for val and test, the checkpoint's ``best_m.json`` holding
    the epoch's val ``[rmse, accuracy]`` and ``-1/`` the best model where
    the best rule says the epoch improves on ``[1000, -1]``, and 4 tiled
    calls each way a step and 4 tiled forwards an evaluated batch.
    tabgnnfused at C = 128, 3 layers trains through the trainer the
    training CLI builds on MCM_EDGE_BATCHES train and val batches of the
    config of record's data: fused_launches(3) split calls each way."""
    import numpy as np
    import torch

    from rmm_tpu_torch.cli import main as train_cli
    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.trainer import Trainer, mcm_improves
    from rmm_tpu_torch.utils.checkpoint import load_best_m
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    st = fixture_settings()
    out = {}

    # tabgnn: the training CLI for an epoch on the MCM record's cut
    cut = mcm_cuts(json.loads(str(np.load(MCM_FIXTURE)["settings"])),
                   WORK)["cut"]
    stats: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    (ep,), best = train_cli.main([
        "--data", cut, "--model", "tabgnn", *MCM_EDGE_RUNS["tabgnn"],
        "--task", "mcm_edge_table", "--seed", str(st["seed"]),
        "--sampler_threads", "4", "--epochs", "1", "--save_model",
        "--wandb_dir", os.path.join(WORK, "mcm_edge_runs"), "--device",
        "cuda"], stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    b = 200
    train_rows, val_rows, test_rows = stats["split_rows"]
    steps = -(-train_rows // b)
    evals = -(-val_rows // b) + -(-test_rows // b)
    check(counts == route_counts(4 * (steps + evals), 4 * steps, "tiled"),
          f"mcm_edge tabgnn: launches {counts} for {steps} steps and "
          f"{evals} evaluated batches (expected 4 tiled calls each way a "
          "step, 4 forwards a batch)")
    check(math.isfinite(ep["loss"]) and math.isfinite(ep["train_rmse"])
          and all(math.isfinite(ep[f"{k}_rmse"])
                  and 0 <= ep[f"{k}_acc"] <= 1 for k in ("val", "test"))
          and 0 <= ep["train_acc"] <= 1, f"mcm_edge tabgnn: epoch {ep}")
    saved = load_best_m(os.path.join(stats["run_dir"], "0"))
    val_m = [ep["val_rmse"], ep["val_acc"]]
    improved = mcm_improves(val_m, [1000.0, -1.0])
    check(ep["best"] == improved
          and saved == best == (val_m if improved else [1000.0, -1.0])
          and os.path.exists(os.path.join(stats["run_dir"], "-1",
                                          "model.pt")) == improved,
          f"mcm_edge tabgnn: best_m.json {saved}, fit's {best}, the "
          f"epoch's val {val_m}, improved {ep['best']}")
    out["tabgnn"] = {
        "through": "cli/main.py", "channels": 32, "layers": 2,
        "route": "tiled", "steps": steps, "evaluated_batches": evals,
        "loss": ep["loss"], "train_rmse": ep["train_rmse"],
        "train_acc": ep["train_acc"],
        **{f"{k}_{m}": ep[f"{k}_{m}"] for k in ("val", "test")
           for m in ("rmse", "acc")},
        "best_m": saved, "step_ms_median": ep.get("step_ms"),
        "epoch_s": ep["sec"], "train_rows_per_s": train_rows / ep["sec"],
        "setup_s": stats["setup_s"], "wall_s": wall,
        "cli_launches": counts, "launches_per_step": 4}

    # tabgnnfused: the CLI's trainer on the config of record's data, cut
    base = ["--data", csv, "--task", "mcm_edge_table", "--seed",
            str(st["seed"]), "--sampler_threads", "4", "--edge_capacity",
            str(st["edge_capacity"]), "--node_capacity",
            str(st["node_capacity"]), "--device", "cuda", "--model",
            "tabgnnfused", *MCM_EDGE_RUNS["tabgnnfused"]]
    t0 = time.perf_counter()
    cfg = config_from_args(create_parser().parse_args(base))
    dataset = build_dataset(cfg)
    data_s = time.perf_counter() - t0
    n = MCM_EDGE_BATCHES
    tr = Trainer(cfg, dataset)
    b = cfg.batch_size
    train, val, _ = (DatasetView(v.parent, v.indices[:n * b])
                     for v in dataset.edges.split())
    reset_counts()
    t1 = time.perf_counter()
    tm = tr.train_epoch(train, 0)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t1
    train_counts = read_counts()
    reset_counts()
    rmse, acc = tr.evaluate(val, "val")
    eval_counts = read_counts()
    k = fused_launches(cfg.n_gnn_layers)
    check(train_counts == route_counts(k * n, k * n)
          and eval_counts == route_counts(k * n, 0),
          f"mcm_edge tabgnnfused: launches {train_counts} for {n} steps and "
          f"{eval_counts} for {n} evaluated batches (expected {k} split "
          f"calls each way a step, {k} forwards a batch)")
    check(math.isfinite(tm["loss"]) and math.isfinite(tm["train_rmse"])
          and math.isfinite(rmse) and 0 <= tm["train_acc"] <= 1
          and 0 <= acc <= 1,
          f"mcm_edge tabgnnfused: {tm}, val rmse {rmse}, val acc {acc}")
    out["tabgnnfused"] = {
        "through": "the training CLI's Trainer", "channels": cfg.n_hidden,
        "layers": cfg.n_gnn_layers, "route": "split", "steps": n,
        "evaluated_batches": n, "loss": tm["loss"],
        "train_rmse": tm["train_rmse"], "train_acc": tm["train_acc"],
        "val_rmse": rmse, "val_acc": acc,
        "step_ms_median": tm.get("step_ms"), "train_wall_s": train_wall,
        "train_rows_per_s": n * b / train_wall, "data_s": data_s,
        "train_launches": train_counts, "eval_launches": eval_counts,
        "launches_per_step": k}
    del tr
    torch.cuda.empty_cache()
    rec = {"phase": "mcm_edge", "dropout": TRAIN_DROPOUT,
           "tabgnn_split_rows": [train_rows, val_rows, test_rows],
           "edge_capacity": st["edge_capacity"],
           "node_capacity": st["node_capacity"], "models": out,
           "card": card, "ok": True}
    emit(rec)
    return rec


def two_pulls_record(rng, dev) -> dict:
    """MoCo's two pulls on one graph, at the SSL target rows (13000x6x128/8,
    the SSL keep-mask): two ``torch.autograd.grad`` pulls from one forward
    of the attention Function give bitwise the gradients of one
    ``backward()`` of each loss alone on the same graph, the backward
    launching once a pull."""
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    b, s, c, h, rate = SSL_SHAPES[1]
    leaves = [t.requires_grad_() for t in random_inputs(rng, b, s, c, dev)]
    mask = keep_mask(rng, b, h, s, rate, dev)
    out = ca.fused_column_attention(*leaves, h, mask, rate)
    losses = [(out * random_inputs(rng, b, s, c, dev)[0]).sum()
              for _ in range(2)]
    reset_counts()
    pulls = [torch.autograd.grad(loss, leaves, retain_graph=True)
             for loss in losses]
    counts = read_counts()
    equal = []
    for loss, grads in zip(losses, pulls):
        for t in leaves:
            t.grad = None
        loss.backward(retain_graph=True)
        equal.append(all(torch.equal(t.grad, g)
                         for t, g in zip(leaves, grads)))
    check(all(equal), "two pulls from one forward differ from one "
          "backward() of each loss alone")
    check(counts == route_counts(0, 2),
          f"two pulls launched {counts} (expected 2 split backwards)")
    return {"shape": [b, s, c, h, rate], "bitwise_equal": equal,
            "launches": counts}


def ssl_moco_phase(card: str, csv: str) -> dict:
    """SSL pretraining (mcm-lp) with ``--moo moco`` at the SSL config of
    record on the config of record's data: SSL_BATCHES train and val
    batches, as ssl_train's. λ on the simplex; each step 10 split
    forwards, and one backward a call for each loss whose graph reaches it:
    each view's 5 calls reach its own loss alone, so 10 split backwards and
    reduces a step, as a --moo sum step's; the two-pulls check."""
    import numpy as np
    import torch

    from rmm_tpu_torch.frame.dataset import DatasetView

    st = fixture_settings()
    pulls = two_pulls_record(np.random.RandomState(16), torch.device("cuda"))
    t0 = time.perf_counter()
    tr = ssl_trainer(csv, SSL_ARGV + ["--sampler_threads", "4", "--moo",
                                      "moco"],
                     st["edge_capacity"], st["node_capacity"])
    setup_s = time.perf_counter() - t0
    n, b = SSL_BATCHES, tr.cfg.batch_size
    train, val, _ = tr.dataset.edges.split()
    train = DatasetView(train.parent, train.indices[:n * b])
    val = DatasetView(val.parent, val.indices[:n * b])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tm = tr.train_epoch(train, 0)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    vm = tr.evaluate(val, "val")
    eval_counts = read_counts()
    lambd = tr.moco.lambd.cpu().numpy().astype(np.float64)
    k = SSL_LAUNCHES
    check(train_counts == route_counts(k * n, k * n)
          and eval_counts == route_counts(k * n, 0),
          f"MoCo launches {train_counts} for {n} steps and {eval_counts} "
          f"for {n} evaluated batches (expected {k} split forwards, and a "
          "backward a call for the loss that reaches it: "
          f"{k} a step)")
    check(tr.moco.step == n and abs(lambd.sum() - 1) <= SIMPLEX_TOL
          and ((lambd >= 0) & (lambd <= 1)).all(),
          f"MoCo λ {lambd.tolist()} after {tr.moco.step} steps is off the "
          "simplex")
    check(math.isfinite(tm["loss"]) and 0 < vm["mrr"] <= 1
          and math.isfinite(vm["rmse"]) and 0 <= vm["accuracy"] <= 1,
          f"MoCo epoch {tm}, val {vm}")
    rows = train.tensor_frame.num_rows
    rec = {"phase": "ssl_moco", "mode": "mcm-lp", "moo": "moco",
           "steps": n, "eval_batches": n, "lambd": lambd.tolist(),
           "moco_step": tr.moco.step, "grad_dim": int(tr.moco.y.shape[1]),
           "train_launches": train_counts, "eval_launches": eval_counts,
           "bwd_per_step": train_counts["bwd"] / n,
           "sum_step_bwd": k, "two_pulls": pulls, "loss": tm["loss"],
           **{f"val_{key}": v for key, v in vm.items()},
           "step_ms_median": tm.get("step_ms"), "sample_ms": tm["sample_ms"],
           "train_wall_s": train_wall, "train_rows_per_s": rows / train_wall,
           "peak_memory_gb": peak / 1e9, "setup_s": setup_s, "card": card,
           "ok": True}
    emit(rec)
    del tr
    torch.cuda.empty_cache()
    return rec


def mcm_parity_phase(card: str) -> dict:
    """The masked-cell objectives on the card against the JAX CPU record
    ``mcm_record.npz`` (``tools/make_torch_port_mcm_fixture.py``, dropout
    0, scatter PNA sums): the tabular trainer plain and with the mask
    vector, ``mcm_edge_table`` for tabgnn, pna, cpna and tabgnnfused, and
    MoCo mcm-lp. From the record's start, each: the first validation
    batch's outputs within MCM_OUT_TOL, three steps by
    ``convert.check_record``'s float32 limits (``cpna`` at its
    ``CPNA_*``), the same parameters unmoved; under MoCo λ and the norms
    of y's rows after each step (``moco_faults``); the launches by
    route."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.convert import (check_record, load_record, loss_terms,
                                       torch_key)
    from rmm_tpu_torch.train.trainer import MCM_SUMS

    rec = load_record(MCM_FIXTURE)
    st = json.loads(str(rec["settings"]))
    csvs = mcm_cuts(st, WORK)
    n, out = st["steps"], {}

    def steps(model, step, batches):
        """The record's steps (``step(batch)`` → the loss and the step's
        sums by name): their loss terms, launches and unmoved
        parameters."""
        before = {k: v.clone() for k, v in model.state_dict().items()}
        model.train()
        reset_counts()
        terms = [loss_terms(*step(gb)) for gb in batches]
        counts = read_counts()
        state = model.state_dict()
        unmoved = {name for name, _ in model.named_parameters()
                   if torch.equal(state[name], before[name])}
        return terms, counts, unmoved

    def hold(run, model, terms, unmoved, lr, updates, width, kind=""):
        faults, summary = check_record(model.state_dict(), terms, rec,
                                       f"{run}/", lr, updates, width,
                                       model=kind)
        want = {torch_key(k)[0] for k in st["runs"][run].get("unmoved", [])}
        if "unmoved" in st["runs"][run] and unmoved != want:
            faults.append(f"unmoved parameters {sorted(unmoved)}, the "
                          f"reference's {sorted(want)}")
        check(not faults, f"{run} off the JAX record: " + "; ".join(faults))
        return summary

    edges = None
    for run, mv in (("tabular", False), ("tabular_mv", True)):
        tr = mcm_tabular_trainer(st, csvs["cut"], mv, "cuda", edges)
        edges = tr.edges
        train, val, _ = edges.split()
        tf, _, _, _ = next(tr._batches(val, False))
        reset_counts()
        with torch.no_grad():
            err = mcm_output_error(tr.model(tf), rec, f"{run}/")
        fwd_counts = read_counts()
        check(err <= MCM_OUT_TOL, f"{run}: output error {err}")
        def step(batch):
            loss, sums = tr._step(*batch[:2])
            return loss, dict(zip(MCM_SUMS, sums.tolist()))

        terms, counts, unmoved = steps(tr.model, step, list(
            itertools.islice(tr._batches(train, True, 0), n)))
        k = st["tabular"]["num_layers"]
        check(fwd_counts == route_counts(k, 0)
              and counts == route_counts(k * n, k * n),
              f"{run}: launches {fwd_counts} and {counts}")
        out[run] = {"output_err": err, "terms": terms,
                    "jax_terms": st["runs"][run]["terms"],
                    "launches": counts, "forward_launches": fwd_counts,
                    **hold(run, tr.model, terms, unmoved,
                           st["tabular"]["lr"], n,
                           st["tabular"]["channels"])}
        del tr
    dataset = None
    for model in st["edge_models"]:
        run = f"mcm_{model}"
        tr = mcm_edge_trainer(st, csvs["cut"], model, "cuda", dataset)
        dataset = tr.dataset
        train, val, _ = dataset.edges.split()
        gb = next(tr._batches(val, "val"))
        reset_counts()
        with torch.no_grad():
            err = mcm_output_error(tr.model(tr.edge_table, tr.node_table,
                                            gb.to(tr.device)), rec,
                                   f"{run}/")
        fwd_counts = read_counts()
        check(err <= MCM_OUT_TOL, f"{run}: output error {err}")
        def step(gb):
            loss, aux = tr._step(gb.to(tr.device))
            return loss, dict(zip(MCM_SUMS, aux["sums"].tolist()))

        terms, counts, unmoved = steps(tr.model, step, list(
            itertools.islice(tr._batches(train, "train", 0), n)))
        # C = 32: tabgnn's 2 layers x node and edge tokens and tabgnnfused's
        # fused_launches, all tiled; the GNN baselines none
        k = {"tabgnn": 4, "pna": 0, "cpna": 0, "tabgnnfused": fused_launches(
            st["edge"]["n_gnn_layers"])}[model]
        check(fwd_counts == route_counts(k, 0, "tiled")
              and counts == route_counts(k * n, k * n, "tiled"),
              f"{run}: launches {fwd_counts} and {counts}")
        out[run] = {"output_err": err, "terms": terms,
                    "jax_terms": st["runs"][run]["terms"],
                    "launches": counts, "forward_launches": fwd_counts,
                    **hold(run, tr.model, terms, unmoved, st["edge"]["lr"],
                           n, st["edge"]["n_hidden"], model)}
        del tr
    tr = mcm_moco_trainer(st, csvs["moco"], "cuda")
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", 0), n))
    neg0 = rec["moco/neg0"]
    check(np.array_equal(batches[0].neg_edge_index[:, :neg0.shape[1]],
                         neg0),
          "the MoCo batch's negatives differ from the JAX record's")
    lambd, y_norm = [], []

    def moco_step(gb):
        out = tr._step(gb.to(tr.device))
        lambd.append(tr.moco.lambd.cpu().numpy().astype(np.float64))
        y_norm.append(torch.linalg.vector_norm(tr.moco.y, dim=1).cpu()
                      .numpy().astype(np.float64))
        return out

    terms, counts, unmoved = steps(tr.model, moco_step, batches)
    faults, moco_summary = moco_faults(lambd, y_norm, rec)
    check(not faults, "MoCo off the JAX record: " + "; ".join(faults))
    k = SSL_LAUNCHES
    check(counts == route_counts(k * n, k * n),
          f"MoCo parity launches {counts}")
    out["moco"] = {"terms": terms, "jax_terms": st["runs"]["moco"]["terms"],
                   **moco_summary, "launches": counts,
                   **hold("moco", tr.model, terms, unmoved,
                          st["moco"]["lr"], 2 * n, st["moco"]["channels"],
                          "moco")}
    del tr
    torch.cuda.empty_cache()
    res = {"phase": "mcm_parity", "steps": n, "out_tol": MCM_OUT_TOL,
           "runs": out, "card": card, "ok": True}
    emit(res)
    return res


# The device sampler (--sampler device, graph/device_sampler.py): each
# split's CSR in device memory, each batch's k-hop subgraph (and, for
# pretraining, its negatives) drawn on the card from its seed ids.
# device_sampler times it alone at the config of record (capacities
# calibrated, frontier buffer too) on DEVICE_SAMPLER_BATCHES train batches
# against the host sampler on 4 threads; the device_* phases run the
# entry points with it.
DEVICE_SAMPLER_BATCHES = 50
DEVICE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                              "device_record.npz")
# Rel-H&M: a synthetic cut keeping the Kaggle H&M data's 23.2 transactions
# a customer and 13.0 customers an article (31,788,324 transactions cut
# ~485x for the time limit); 14 edge columns, S = 15 tokens with the CLS
HM_ROWS, HM_CUSTOMERS, HM_ARTICLES = 65536, 2829, 218
HM_S = 15
HM_SSL_BATCHES = 12
REL_HM_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                              "rel_hm_record.npz")
DATA_TOOLS = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                          "data_tools")
#: the parity records' sampled arrays, held bit for bit
SAMPLED = ("edge_gather", "edge_mask", "edge_index", "node_gather",
           "node_mask", "seed_mask")


def device_record() -> tuple:
    from rmm_tpu_torch.convert import load_record

    rec = load_record(DEVICE_FIXTURE)
    return rec, json.loads(str(rec["settings"]))


def device_record_data(st: dict, root: str | None = None) -> dict:
    """The device record's cuts (AML and Elliptic) under ``root`` (the
    build dir by default)."""
    root = root or WORK
    from rmm_tpu_torch.datasets import (write_synthetic_aml_csv,
                                        write_synthetic_node_dataset)

    d = st["data"]
    csv = write_synthetic_aml_csv(
        os.path.join(root, f"aml_{d['aml_rows']}.csv"),
        num_rows=d["aml_rows"], num_accounts=d["aml_rows"] // 16,
        seed=d["aml_seed"])
    elliptic = write_synthetic_node_dataset(
        os.path.join(root, f"elliptic_{d['node_nodes']}"),
        family="elliptic", num_nodes=d["node_nodes"],
        num_edges=d["node_edges"], num_feats=d["node_feats"],
        seed=d["node_seed"])
    return {"edge": csv, "mcm_lp": csv, "node": elliptic}


def check_sample(out: dict, sb, dg, b: int, split_ids, what: str):
    """The host sampler's contract on a device sample: the seed edges in
    lanes [0, B) in input order, every kept edge one of the split's (or a
    seed), nodes sorted-unique, local ids mapping back to the endpoints."""
    import torch

    eg, em, ei = out["edge_gather"], out["edge_mask"], out["edge_index"]
    ng, nm = out["node_gather"], out["node_mask"]
    real = sb.seed_mask
    check(torch.equal(em[:b], real) and torch.equal(eg[:b][real],
                                                    sb.seeds[:, 2][real]),
          f"{what}: the seed lanes are not the seeds in input order")
    kept = eg[b:][em[b:]]
    check(bool(torch.isin(kept, split_ids).all()),
          f"{what}: a kept edge is not an edge of the split")
    nodes = ng[nm]
    check(bool((nodes[1:] > nodes[:-1]).all()),
          f"{what}: the node ids are not sorted-unique")
    src, dst = dg.src.long(), dg.dst.long()
    check(bool(torch.equal(ng[ei[0][em]], src[eg[em]])
               and torch.equal(ng[ei[1][em]], dst[eg[em]])),
          f"{what}: the local edge index does not map back to the "
          "endpoints")


def device_sampler_phase(card: str, csv: str) -> dict:
    """The device sampler alone at the config of record on the card: the
    dataset calibrated as the training CLI does (edge, node and frontier
    buffers), the train split's CSR uploaded, DEVICE_SAMPLER_BATCHES train
    batches sampled on the device (CUDA events; the seed ids' pinned copy
    included) and on the host (the C++ engine on 4 threads, the host
    path's batches); the sampler's contract on every device batch; no
    host sync inside one (``torch.cuda.set_sync_debug_mode("error")``);
    drops counted at a tight edge capacity; on the device record's AML cut
    (every in-degree at most the fanouts 64/64) the edge sets and node
    order of the port's host sampler."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.datasets import IBMTransactionsAML
    from rmm_tpu_torch.graph import device_sampler as ds
    from rmm_tpu_torch.train.trainer import seed_batches, threaded_map
    from rmm_tpu_torch.utils.batch import graph_inputs
    from rmm_tpu_torch.utils.config import config_from_args, create_parser
    from rmm_tpu_torch.utils.device import resolve_device

    st = fixture_settings()
    cfg = config_from_args(create_parser().parse_args(
        record_argv(st, csv) + ["--sampler", "device", "--device", "cuda"]))
    dev = resolve_device(cfg.device)
    t0 = time.perf_counter()
    dataset = IBMTransactionsAML(csv, khop_neighbors=cfg.num_neighs)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ec, nc = dataset.calibrate_capacities(cfg.batch_size)
    calibrate_s = time.perf_counter() - t0
    check((ec, nc) == (st["edge_capacity"], st["node_capacity"]),
          f"calibrated capacities {ec}/{nc} vs the fixture's")
    fc = dataset.frontier_capacity
    fanouts = cfg.num_neighs
    t0 = time.perf_counter()
    dg = ds.DeviceGraph.from_store(dataset.graph, "train", dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    n, b = DEVICE_SAMPLER_BATCHES, cfg.batch_size
    sbs = list(itertools.islice(seed_batches(
        cfg, dataset.edges.split()[0], "train", 0), n))

    def sample(sb, edge_capacity=ec):
        d = sb.to(dev)
        return d, ds.sample_edges_device(
            dg, d.seeds, d.seed_mask, ds.batch_generator(sb.sampler_seed,
                                                         dev),
            fanouts, edge_capacity, nc, fc)

    sample(sbs[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sample(sbs[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outs = [sample(sb) for sb in sbs]
    end.record()
    enqueue_s = time.perf_counter() - t0
    end.synchronize()
    wall_s = time.perf_counter() - t0
    device_ms = start.elapsed_time(end) / n

    def host(item):
        i, sb = item
        by = np.concatenate([sb.y, sb.seeds.astype(np.float32)], axis=1)
        return graph_inputs(by, int(sb.seed_mask.sum()), dataset.graph,
                            "train", ec, nc, sb.sampler_seed)

    list(threaded_map(host, enumerate(sbs[:8]), 4))     # warm
    t0 = time.perf_counter()
    host_out = list(threaded_map(host, enumerate(sbs), 4))
    host_ms = 1e3 * (time.perf_counter() - t0) / n

    split_ids = torch.from_numpy(
        dataset.graph.sampler("train").edge_ids).to(dev)
    for i, (d, out) in enumerate(outs):
        check_sample(out, d, dg, b, split_ids, f"device batch {i}")
    dropped = int(sum(o["num_dropped"] for _, o in outs))
    node_dropped = int(sum(o["num_node_dropped"] for _, o in outs))
    kept = int(sum(o["edge_mask"].sum() for _, o in outs))
    host_kept = sum(int(g.edge_mask.sum()) for g in host_out)
    # drops counted, never silent: a tight edge buffer loses edges and
    # counts at least as many draws dropped (a draw can repeat an edge)
    _, loose = outs[0]
    n0 = int(loose["edge_mask"].sum())
    tight_cap = b + (n0 - b) // 2
    _, tight = sample(sbs[0], tight_cap)
    t_kept = int(tight["edge_mask"].sum())
    t_dropped = int(tight["num_dropped"]) - int(loose["num_dropped"])
    check(t_kept < n0 <= t_kept + t_dropped,
          f"a {tight_cap}-lane edge buffer kept {t_kept} of {n0} edges and "
          f"counted {t_dropped} dropped")

    # the deterministic regime: the port's host sampler's edges and nodes
    rst = device_record()[1]
    cut = device_record_data(rst)["edge"]
    small = IBMTransactionsAML(cut, khop_neighbors=tuple(rst["num_neighs"]))
    part = rst["parts"]["edge"]
    sdg = ds.DeviceGraph.from_store(small.graph, "train", dev)
    scfg = cfg.replace(num_neighs=tuple(rst["num_neighs"]),
                       batch_size=rst["batch_size"])
    for i, sb in enumerate(itertools.islice(seed_batches(
            scfg, small.edges.split()[0], "train", 0), 3)):
        d = sb.to(dev)
        out = ds.sample_edges_device(
            sdg, d.seeds, d.seed_mask, ds.batch_generator(sb.sampler_seed,
                                                          dev),
            scfg.num_neighs, part["edge_capacity"], part["node_capacity"],
            part["frontier_capacity"])
        sub = small.graph.sample_edges(sb.seeds, "train",
                                       part["edge_capacity"],
                                       part["node_capacity"], 7)
        em = out["edge_mask"].cpu().numpy()
        check(set(out["edge_gather"].cpu().numpy()[em].tolist())
              == set(sub.edge_ids[sub.edge_mask].tolist()),
              f"deterministic batch {i}: the edge set differs from the "
              "host sampler's")
        check(np.array_equal(
            out["node_gather"].cpu().numpy()[out["node_mask"].cpu().numpy()],
            sub.node_ids[sub.node_mask]),
            f"deterministic batch {i}: the node order differs from the "
            "host sampler's")
    rec = {"phase": "device_sampler", "rows": dataset.graph.num_edges,
           "batches": n, "batch": b, "fanouts": list(fanouts),
           "edge_capacity": ec, "node_capacity": nc,
           "frontier_capacity": fc, "device_ms_per_batch": device_ms,
           "device_wall_ms_per_batch": 1e3 * wall_s / n,
           "enqueue_ms_per_batch": 1e3 * enqueue_s / n,
           "host_ms_per_batch_4_threads": host_ms,
           "edges_per_batch": kept / n, "host_edges_per_batch":
               host_kept / n, "num_dropped": dropped,
           "num_node_dropped": node_dropped,
           "drop_rate": dropped / max(dropped + kept, 1),
           "tight_edge_capacity": tight_cap, "tight_kept": t_kept,
           "tight_dropped": t_dropped,
           "upload_s": upload_s, "calibrate_s": calibrate_s,
           "data_s": data_s, "no_host_sync": True,
           "deterministic_batches_equal": 3, "card": card, "ok": True}
    emit(rec)
    del outs, dg, sdg
    torch.cuda.empty_cache()
    return rec


def device_train_phase(card: str, csv: str, host_train: dict,
                       host_serve: dict) -> dict:
    """The training CLI at the config of record with ``--sampler device``
    for an epoch (``--testing --save_model``), then its checkpoint through
    the predict CLI with ``--sampler device`` over the test split: the
    train phase's launch counts (4 tiled forwards a batch, 4 backwards and
    reduces a step), finite losses, metrics and scores; train rows/s, the
    median step, the drop rate and served rows/s beside the host
    sampler's."""
    import numpy as np
    import torch

    from rmm_tpu_torch.cli import main as train_cli

    st = fixture_settings()
    argv = record_argv(st, csv) + [
        "--epochs", "1", "--testing", "--sampler", "device", "--save_model",
        "--wandb_dir", os.path.join(WORK, "runs_device"), "--device",
        "cuda"]
    stats: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    history, _ = train_cli.main(argv, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    (ep,) = history
    b = st["batch_size"]
    train_rows, val_rows, test_rows = stats["split_rows"]
    steps = -(-train_rows // b)
    evals = -(-val_rows // b) + -(-test_rows // b)
    check(counts == {"fwd": 4 * (steps + evals),
                     "fwd_tiled": 4 * (steps + evals), "fwd_split": 0,
                     "bwd": 4 * steps, "bwd_tiled": 4 * steps,
                     "bwd_split": 0, "reduce": 4 * steps, **NO_BF16},
          f"launches {counts} for {steps} device-sampled train steps and "
          f"{evals} evaluated batches")
    check(math.isfinite(ep["loss"]) and 0 <= ep["drop_rate"] <= 1,
          f"device-sampled epoch {ep}")
    for key in ("val_f1", "test_f1", "val_auc", "test_auc"):
        check(math.isfinite(ep[key]), f"{key} = {ep[key]}")
    run: dict = {}
    out, serve_counts, serve_wall = serve(record_argv(st, csv) + [
        "--sampler", "device", "--load_model",
        os.path.join(stats["run_dir"], "0"), "--split", "test", "--output",
        os.path.join(WORK, "device_preds.csv"), "--device", "cuda"], run)
    rows = len(out["id"])
    batches = -(-rows // b)
    check(rows == test_rows and len(np.unique(out["id"])) == rows
          and np.isfinite(out["score"]).all(),
          f"the device-sampled serve scored {rows} of {test_rows} rows")
    check(serve_counts["fwd"] == 4 * batches == serve_counts["fwd_tiled"],
          f"serve launches {serve_counts} for {batches} batches")
    rec = {"phase": "device_train", "train_rows": train_rows,
           "steps": steps, "evaluated_batches": evals, "launches": counts,
           "loss": ep["loss"], "val_f1": ep["val_f1"],
           "val_auc": ep["val_auc"], "test_f1": ep["test_f1"],
           "drop_rate": ep["drop_rate"], "epoch_s": ep["sec"],
           "train_rows_per_s": train_rows / ep["sec"],
           "step_ms_median": ep.get("step_ms"), "fit_s": stats["fit_s"],
           "setup_s": stats["setup_s"], "wall_s": wall,
           "frontier_capacity": stats.get("frontier_capacity"),
           "host_train_rows_per_s": host_train["train_rows_per_s"],
           "host_step_ms_median": host_train["step_ms_median"],
           "host_drop_rate": host_train["drop_rate"],
           "served_rows": rows, "serve_launches": serve_counts,
           "served_rows_per_s_predict": rows / run["predict_s"],
           "served_rows_per_s_wall": rows / serve_wall,
           "host_served_rows_per_s_predict":
               host_serve["rows_per_s_predict"],
           "card": card, "ok": True}
    emit(rec)
    return rec


def device_node_phase(card: str) -> dict:
    """Elliptic node classification with ``--sampler device`` on a cut of
    the synthetic Elliptic (:data:`ELLIPTIC_CUT_NODES`): ``tabgnn`` for an
    epoch through the training CLI (``node_cli``, the capacities and the
    frontier buffer calibrated), beside the host sampler's epoch on the
    same batches; then the predict CLI with ``--sampler device`` on its
    ``-1/`` checkpoint over the test split (``node_serve``: every labelled
    test node once, in order). node_train's launch counts: 2 split (the
    node tokens, S = 167: the long cores) and 2 tiled calls each way a
    step, the forwards an evaluated or served batch. The median step,
    train rows/s, the drop rate and served rows/s beside the host
    sampler's."""
    from rmm_tpu_torch.datasets import write_synthetic_node_dataset

    root = write_synthetic_node_dataset(
        os.path.join(WORK, "elliptic-cut"), num_nodes=ELLIPTIC_CUT_NODES,
        num_edges=ELLIPTIC_CUT_EDGES, num_feats=ELLIPTIC_FEATS, seed=0)
    host = node_cli(root, "tabgnn", node_counts, "--sampler", "host")
    run = node_cli(root, "tabgnn", node_counts, "--sampler", "device")
    check(0 < run["frontier_capacity"] <= run["node_capacity"]
          and (run["edge_capacity"], run["node_capacity"])
          == (host["edge_capacity"], host["node_capacity"]),
          f"device-sampled Elliptic capacities edge={run['edge_capacity']} "
          f"node={run['node_capacity']} frontier={run['frontier_capacity']}"
          f", the host run's edge={host['edge_capacity']} "
          f"node={host['node_capacity']}")
    served = node_serve(root, run)
    check(served["launches"] == node_counts(served["batches"], 0),
          f"launches {served['launches']} serving {served['batches']} "
          "device-sampled Elliptic batches")
    rec = {"phase": "device_node", "nodes": ELLIPTIC_CUT_NODES,
           "edges": ELLIPTIC_CUT_EDGES, "node_tokens": NODE_S,
           "channels": 32, "layers": 2, "heads": 8, "batch": 200,
           "fanouts": [100, 100], **run, "serve": served,
           "host_step_ms_median": host["step_ms_median"],
           "host_train_rows_per_s": host["train_rows_per_s"],
           "host_drop_rate": host["drop_rate"], "host_val_f1": host["val_f1"],
           "host_launches": host["launches"], "card": card, "ok": True}
    emit(rec)
    return rec


def device_ssl_phase(card: str, root: str, host: dict) -> dict:
    """The SSL CLI with ``--sampler device`` (k-hop subgraph and negatives
    on the card) for an epoch on the Ethereum cut, on eth_ssl's batches
    (``ssl_cli_epoch``): eth_ssl's launch counts and checks, the frontier
    buffer calibrated (above 0, at most the node buffer), the negatives'
    residual; the median step and train rows/s beside the host
    sampler's."""
    run = ssl_cli_epoch(root, "device_ssl_runs", "--sampler", "device")
    check(0 < run["frontier_capacity"] <= run["node_capacity"]
          and (run["edge_capacity"], run["node_capacity"])
          == (host["edge_capacity"], host["node_capacity"]),
          f"device-sampled SSL capacities edge={run['edge_capacity']} "
          f"node={run['node_capacity']} frontier={run['frontier_capacity']}"
          f", the host run's edge={host['edge_capacity']} "
          f"node={host['node_capacity']}")
    check(run["launches"] == host["launches"],
          f"device-sampled SSL launches {run['launches']}, the host run's "
          f"{host['launches']}")
    rec = {"phase": "device_ssl", **run,
           "negatives": run["split_rows"][0] * run["num_neg"],
           "host_step_ms_median": host["step_ms_median"],
           "host_train_rows_per_s": host["train_rows_per_s"],
           "host_sample_ms": host["sample_ms"],
           "host_val_mrr": host["val_mrr"], "card": card, "ok": True}
    emit(rec)
    return rec


def device_part_trainer(st: dict, data: dict, name: str,
                        device: str = "cuda"):
    """The port's trainer of a device-record part: device sampling, the
    record's capacities and start, dropout 0."""
    from rmm_tpu_torch.convert import from_jax, random_variables
    from rmm_tpu_torch.datasets import EllipticBitcoin, IBMTransactionsAML
    from rmm_tpu_torch.datasets.base import PretrainType
    from rmm_tpu_torch.nn.dropout import set_rate
    from rmm_tpu_torch.train.pretrain import PretrainTrainer
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import Config

    part = st["parts"][name]
    fanouts = tuple(st["num_neighs"])
    cfg = Config(model=part["model"], data=data[name],
                 n_hidden=st["n_hidden"], n_gnn_layers=st["n_gnn_layers"],
                 num_neighs=fanouts, batch_size=st["batch_size"],
                 dropout=0.0, seed=st["seed"], sampler="device",
                 device=device, lr=part["lr"],
                 edge_capacity=part["edge_capacity"],
                 node_capacity=part["node_capacity"],
                 frontier_capacity=part["frontier_capacity"])
    if name == "mcm_lp":
        dset = IBMTransactionsAML(data[name], khop_neighbors=fanouts,
                                  pretrain={PretrainType.MASK,
                                            PretrainType.LINK_PRED})
        tr = PretrainTrainer(cfg.replace(
            num_neg_samples=st["num_neg_samples"],
            weight_decay=st["weight_decay"]), dset, "mcm-lp")
        view = dset.edges.split()[0]
    elif name == "node":
        dset = EllipticBitcoin(data[name], khop_neighbors=fanouts)
        tr = Trainer(cfg.replace(task="node_classification"), dset)
        view = dset.nodes.split()[0]
    else:
        dset = IBMTransactionsAML(data[name], khop_neighbors=fanouts)
        tr = Trainer(cfg, dset)
        view = dset.edges.split()[0]
    tr.model.load_state_dict(from_jax(random_variables(
        part["shapes"], st["var_seed"]), tr.model))
    set_rate(tr.model, 0.0)
    return tr, view


def check_negatives(gb, num_neg: int, what: str):
    """Each real seed's negatives: the first half keep the source, the
    rest the destination, and none is an endpoint or a neighbour of
    either in the batch's subgraph."""
    import numpy as np

    neg = gb.neg_edge_index.cpu().numpy()
    ei = gb.edge_index.cpu().numpy()
    em = gb.edge_mask.cpu().numpy()
    pairs = set(zip(ei[0][em].tolist(), ei[1][em].tolist()))
    half = num_neg // 2
    for j in np.flatnonzero(gb.seed_mask.cpu().numpy()):
        s, d = int(ei[0, j]), int(ei[1, j])
        blk = neg[:, j * num_neg:(j + 1) * num_neg]
        check((blk[0, :half] == s).all() and (blk[1, half:] == d).all(),
              f"{what}: the negatives of seed {j} corrupt the wrong end")
        for v in np.concatenate([blk[1, :half], blk[0, half:]]).tolist():
            check(v not in (s, d) and not {(s, v), (v, s), (d, v),
                                           (v, d)} & pairs,
                  f"{what}: negative {v} of ({s}, {d}) is banned")


def replay_device_part(rec, st: dict, data: dict, name: str,
                       device: str = "cuda") -> dict:
    """One part of the device record on ``device``: the first three seed
    batches equal to the record's, each sampled array (int64 ids, bool
    masks) and drop count (``num_node_dropped`` from the sampler itself)
    equal to the record's, the port's own negatives (mcm-lp) outside the
    banned set, then three steps from the record's start (the mcm-lp steps
    fed the record's negatives) within ``convert.check_record``'s limits.
    Returns the launches, the loss terms and the limits' summary."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.convert import check_record, loss_terms
    from rmm_tpu_torch.graph import device_sampler as ds
    from rmm_tpu_torch.train.trainer import seed_batches
    from rmm_tpu_torch.utils.seeding import mix_seed

    tr, view = device_part_trainer(st, data, name, device)
    pretrain = name == "mcm_lp"
    node_task = name == "node"
    cfg = tr.cfg
    dgraph = ds.cached_dgraph(tr.dataset.graph, {}, "train", tr.device)
    sbs = itertools.islice(seed_batches(
        cfg, view, "train", st["epoch"], node_task,
        getattr(tr.dataset, "ignore_label", None)), st["steps"])
    reset_counts()
    tr.model.train()
    terms, residual = [], 0
    for i, sb in enumerate(sbs):
        p = f"{name}/batch{i}/"
        check(np.array_equal(sb.seeds, rec[f"{p}seeds"])
              and np.array_equal(sb.seed_mask, rec[f"{p}seed_mask_in"])
              and np.array_equal(sb.y, rec[f"{p}y"])
              and sb.sampler_seed == int(rec[f"{p}sampler_seed"]),
              f"{p}: the seed batch differs from the record's")
        d = sb.to(tr.device)
        res = tr._materialize_dev(d, dgraph)
        gb = res[0]
        for k in SAMPLED:
            got = getattr(gb, k)
            check(got.dtype == (torch.bool if "mask" in k else torch.int64)
                  and np.array_equal(got.cpu().numpy(), rec[p + k]),
                  f"{p}{k} differs from the record's")
        gen = ds.batch_generator(mix_seed(sb.sampler_seed, 1) if pretrain
                                 else sb.sampler_seed, tr.device)
        args = (gen, cfg.num_neighs, cfg.edge_capacity, cfg.node_capacity,
                cfg.frontier_capacity)
        out = (ds.sample_nodes_device(dgraph, d.seeds[:, 0], d.sample_mask,
                                      *args) if node_task else
               ds.sample_edges_device(dgraph, d.seeds, d.seed_mask, *args))
        check(int(res[1]) == int(rec[f"{p}num_dropped"])
              and int(res[2]) == int(rec[f"{p}kept"])
              and int(out["num_node_dropped"])
              == int(rec[f"{p}num_node_dropped"]),
              f"{p}: drop counts differ from the record's")
        if pretrain:
            residual += int(res[3])
            check_negatives(gb, st["num_neg_samples"], p)
            gb.neg_edge_index = torch.from_numpy(
                rec[f"{p}neg_edge_index"]).long().to(tr.device)
            terms.append(loss_terms(*tr._step(gb)))
        else:
            terms.append(loss_terms(tr._step(gb)[0], {}))
    if tr.device.type == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    updates = 2 * st["steps"] if pretrain else st["steps"]
    faults, summary = check_record(tr.model.state_dict(), terms, rec,
                                   f"{name}/", cfg.lr, updates,
                                   st["n_hidden"])
    check(not faults, f"device record {name}: {faults}")
    return {"launches": counts, "terms": terms, "neg_residual": residual,
            **summary}


def device_parity_phase(card: str) -> dict:
    """The device record (``device_record.npz``, the JAX package's device
    path on the CPU, ``tools/make_torch_port_device_fixture.py``) on the
    card, for its edge, node and mcm-lp parts (``replay_device_part``;
    every in-degree of its cuts is at most the fanout), each part's
    launches."""
    rec, st = device_record()
    data = device_record_data(st)
    out = {"phase": "device_parity", "parts": {}, "card": card}
    for name in ("edge", "node", "mcm_lp"):
        part = replay_device_part(rec, st, data, name)
        check(part["launches"]["fwd"] > 0 and part["launches"]["bwd"] > 0,
              f"device_parity {name}: no kernel launched "
              f"({part['launches']})")
        out["parts"][name] = part
    out["ok"] = True
    emit(out)
    return out


def rel_hm_trainer(st: dict, csv: str, name: str, device: str = "cuda"):
    """The port's trainer of a Rel-H&M record part (host sampling, the
    record's capacities and start, dropout 0)."""
    from rmm_tpu_torch.convert import from_jax, random_variables
    from rmm_tpu_torch.datasets import RelHM
    from rmm_tpu_torch.datasets.base import PretrainType
    from rmm_tpu_torch.nn.dropout import set_rate
    from rmm_tpu_torch.train.pretrain import PretrainTrainer
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import Config

    part = st["parts"][name]
    common = dict(data=csv, n_hidden=st["n_hidden"],
                  n_gnn_layers=st["n_gnn_layers"],
                  num_neighs=tuple(st["num_neighs"]),
                  batch_size=st["batch_size"], dropout=0.0, seed=st["seed"],
                  lr=part["lr"], device=device,
                  edge_capacity=part["edge_capacity"],
                  node_capacity=part["node_capacity"])
    ds = RelHM(root=csv, pretrain={PretrainType.MASK,
                                   PretrainType.LINK_PRED},
               khop_neighbors=common["num_neighs"])
    if name == "mcm_edge":
        tr = Trainer(Config(model="tabgnn", task="mcm_edge_table",
                            **common), ds)
    else:
        tr = PretrainTrainer(Config(
            model="tabgnnfused", num_neg_samples=st["num_neg_samples"],
            weight_decay=st["weight_decay"], **common), ds, "mcm-lp")
    tr.model.load_state_dict(from_jax(random_variables(
        part["shapes"], st["var_seed"]), tr.model))
    set_rate(tr.model, 0.0)
    return tr


def replay_rel_hm_part(rec, st: dict, csv: str, name: str,
                       device: str = "cuda") -> dict:
    """Three steps of a Rel-H&M record part (``mcm_edge``: tabgnn under
    ``--task mcm_edge_table``; ``mcm_lp``: the pretrainer, its first
    negatives equal to the record's) from the record's start on ``device``
    within ``convert.check_record``'s limits: the launches, the loss terms
    and the limits' summary."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.convert import check_record, loss_terms

    tr = rel_hm_trainer(st, csv, name, device)
    batches = list(itertools.islice(tr._batches(
        tr.dataset.edges.split()[0], "train", st["epoch"]), st["steps"]))
    reset_counts()
    tr.model.train()
    if name == "mcm_lp":
        check(np.array_equal(batches[0].neg_edge_index, rec["mcm_lp/neg0"]),
              "Rel-H&M record: the first negatives differ")
        terms = [loss_terms(*tr._step(g.to(tr.device))) for g in batches]
    else:
        terms = [loss_terms(tr._step(g.to(tr.device))[0], {})
                 for g in batches]
    if tr.device.type == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    updates = st["steps"] * (2 if name == "mcm_lp" else 1)
    faults, summary = check_record(tr.model.state_dict(), terms, rec,
                                   f"{name}/", tr.cfg.lr, updates,
                                   st["n_hidden"])
    check(not faults, f"Rel-H&M record {name}: {faults}")
    return {"launches": counts, "terms": terms, **summary}


def rel_hm_phase(card: str) -> dict:
    """Rel-H&M on the card: a synthetic cut of HM_ROWS transactions,
    HM_CUSTOMERS customers and HM_ARTICLES articles (S = 15 edge tokens);
    ``cli/main.py --model tabgnn --task mcm_edge_table`` at the config of
    record's widths for an epoch with ``--save_model`` (4 tiled calls each
    way a step, 4 forwards an evaluated batch); the pretrainer's mcm-lp at
    the SSL widths for HM_SSL_BATCHES train and val batches (10 split
    calls each way a step); both directions at the runs' token shapes
    against their plain versions (the edge tokens at C = 32, tiled, and
    the SSL context tokens at C = 128, split; masked and not); the
    record ``rel_hm_record.npz`` (its 800-row cut, C = 16): three steps of
    each within ``convert.check_record``'s limits."""
    import numpy as np
    import torch

    from rmm_tpu_torch.cli import fused
    from rmm_tpu_torch.cli import main as train_cli
    from rmm_tpu_torch.convert import load_record
    from rmm_tpu_torch.datasets import RelHM, write_synthetic_hm_csv
    from rmm_tpu_torch.datasets.base import PretrainType
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.pretrain import PretrainTrainer
    from rmm_tpu_torch.utils.checkpoint import load_best_m
    from rmm_tpu_torch.utils.device import resolve_device

    t0 = time.perf_counter()
    root = os.path.join(WORK, "rel-hm")
    os.makedirs(root, exist_ok=True)
    csv = write_synthetic_hm_csv(os.path.join(root, "hm.csv"),
                                 num_rows=HM_ROWS,
                                 num_customers=HM_CUSTOMERS,
                                 num_articles=HM_ARTICLES, seed=0)
    data_s = time.perf_counter() - t0
    st = fixture_settings()
    argv = ["--data", csv, "--model", "tabgnn", "--task", "mcm_edge_table",
            "--n_hidden", str(st["n_hidden"]), "--n_gnn_layers",
            str(st["n_gnn_layers"]), "--num_neighs",
            *map(str, st["num_neighs"]), "--batch_size",
            str(st["batch_size"]), "--epochs", "1", "--testing",
            "--sampler_threads", "4", "--save_model", "--wandb_dir",
            os.path.join(WORK, "rel_hm_runs"), "--device", "cuda"]
    stats: dict = {}
    reset_counts()
    history, best = train_cli.main(argv, stats)
    torch.cuda.synchronize()
    counts = read_counts()
    (ep,) = history
    b = st["batch_size"]
    train_rows, val_rows, test_rows = stats["split_rows"]
    steps = -(-train_rows // b)
    evals = -(-val_rows // b) + -(-test_rows // b)
    check(counts == {"fwd": 4 * (steps + evals),
                     "fwd_tiled": 4 * (steps + evals), "fwd_split": 0,
                     "bwd": 4 * steps, "bwd_tiled": 4 * steps,
                     "bwd_split": 0, "reduce": 4 * steps, **NO_BF16},
          f"Rel-H&M mcm_edge_table launches {counts} for {steps} steps "
          f"and {evals} evaluated batches")
    check(math.isfinite(ep["loss"]) and all(
        0 <= ep[k] <= 1 for k in ("train_acc", "val_acc", "test_acc"))
        and all(math.isfinite(ep[k]) for k in ("val_rmse", "test_rmse")),
        f"Rel-H&M epoch {ep}")
    check(load_best_m(os.path.join(stats["run_dir"], "0")) == best
          and os.path.isdir(os.path.join(stats["run_dir"], "-1")),
          "the Rel-H&M checkpoint lacks its best metrics or -1/")

    # the pretrainer's mcm-lp at the SSL widths
    cfg = fused.config_from_args(fused.build_parser().parse_args(
        ["--dataset", csv, *SSL_ARGV, "--sampler_threads", "4",
         "--device", "cuda"]))
    pds = RelHM(root=csv, pretrain={PretrainType.MASK,
                                    PretrainType.LINK_PRED},
                khop_neighbors=cfg.num_neighs)
    tr = PretrainTrainer(cfg, pds, "mcm-lp")
    n = HM_SSL_BATCHES
    train, val, _ = pds.edges.split()
    train = DatasetView(train.parent, train.indices[:n * b])
    val = DatasetView(val.parent, val.indices[:n * b])
    reset_counts()
    t0 = time.perf_counter()
    tm = tr.train_epoch(train, 0)
    torch.cuda.synchronize()
    ssl_wall = time.perf_counter() - t0
    ssl_counts = read_counts()
    reset_counts()
    vm = tr.evaluate(val, "val")
    ssl_eval = read_counts()
    k = SSL_LAUNCHES
    check(ssl_counts == {"fwd": k * n, "fwd_tiled": 0, "fwd_split": k * n,
                         "bwd": k * n, "bwd_tiled": 0, "bwd_split": k * n,
                         "reduce": k * n, **NO_BF16}
          and ssl_eval["fwd_split"] == k * n,
          f"Rel-H&M SSL launches {ssl_counts}, {ssl_eval}")
    check(math.isfinite(tm["loss"]) and 0 < vm["mrr"] <= 1
          and 0 <= vm["accuracy"] <= 1 and math.isfinite(vm["rmse"]),
          f"Rel-H&M SSL {tm}, {vm}")
    ssl_edges = tr.cfg.edge_capacity
    del tr
    torch.cuda.empty_cache()

    # the kernels at the runs' token shapes
    rng = np.random.RandomState(18)
    dev = resolve_device("cuda")
    e_cap = stats["edge_capacity"]
    shapes = [(e_cap, HM_S, 32, 8, TRAIN_DROPOUT), (e_cap, HM_S, 32, 8, 0.0),
              (ssl_edges - b, HM_S, 128, 8, SSL_DROPOUT),
              (ssl_edges - b, HM_S, 128, 8, 0.0)]
    # timed once (one warm repetition), to keep the run inside its limit
    kfwd = [fwd_record(rng, dev, *s, card, timing=OFF_PATH_TIMING)
            for s in shapes]
    kbwd = [bwd_record(rng, dev, *s, card, timing=OFF_PATH_TIMING)
            for s in shapes]

    # the record's three steps of each part
    hrec = load_record(REL_HM_FIXTURE)
    hst = json.loads(str(hrec["settings"]))
    d = hst["data"]
    cut = write_synthetic_hm_csv(os.path.join(root, "hm_cut.csv"),
                                 num_rows=d["rows"],
                                 num_customers=d["customers"],
                                 num_articles=d["articles"], seed=d["seed"])
    parity = {name: replay_rel_hm_part(hrec, hst, cut, name)
              for name in ("mcm_edge", "mcm_lp")}
    rec = {"phase": "rel_hm", "transactions": HM_ROWS,
           "customers": HM_CUSTOMERS, "articles": HM_ARTICLES,
           "edge_tokens": HM_S, "split_rows": stats["split_rows"],
           "steps": steps, "evaluated_batches": evals, "launches": counts,
           "edge_capacity": e_cap, "node_capacity": stats["node_capacity"],
           "loss": ep["loss"], "train_rmse": ep["train_rmse"],
           "train_acc": ep["train_acc"], "val_rmse": ep["val_rmse"],
           "val_acc": ep["val_acc"], "best": best, "epoch_s": ep["sec"],
           "train_rows_per_s": train_rows / ep["sec"],
           "step_ms_median": ep.get("step_ms"), "drop_rate": ep["drop_rate"],
           "ssl_steps": n, "ssl_launches": ssl_counts,
           "ssl_eval_launches": ssl_eval, "ssl_edge_capacity": ssl_edges,
           "ssl_loss": tm["loss"], "ssl_val_mrr": vm["mrr"],
           "ssl_val_accuracy": vm["accuracy"], "ssl_val_rmse": vm["rmse"],
           "ssl_step_ms_median": tm.get("step_ms"),
           "ssl_train_rows_per_s": train.tensor_frame.num_rows / ssl_wall,
           "parity": parity, "data_s": data_s, "card": card, "ok": True}
    emit(rec)
    return {**rec, "kernel_fwd": kfwd, "kernel_bwd": kbwd}


def data_tools_phase(card: str) -> dict:
    """The data tools with pandas and networkx blocked (a child process
    in which importing either fails): ``prepare_aml`` on the committed raw
    CSV in the Kaggle layout and ``export_eth`` on the committed
    ``MultiDiGraph`` pickle (networkx's cached views in it), each output
    byte for byte the JAX package's (``expected.json``,
    ``tools/make_torch_port_data_tools_fixture.py``), then read by the
    port's datasets."""
    import hashlib

    from rmm_tpu_torch.datasets import EthereumPhishing, IBMTransactionsAML

    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    with open(os.path.join(DATA_TOOLS, "expected.json")) as f:
        expected = json.load(f)
    out = os.path.join(WORK, "aml_prepared.csv")
    eth = os.path.join(WORK, "ethereum-phishing")
    code = (
        "import sys, time\n"
        "sys.modules['pandas'] = sys.modules['networkx'] = None\n"
        "from rmm_tpu_torch.datasets import export_eth, prepare_aml\n"
        "t0 = time.perf_counter()\n"
        f"prepare_aml.main([{os.path.join(DATA_TOOLS, 'raw_aml.csv')!r}, "
        f"{out!r}])\n"
        "t1 = time.perf_counter()\n"
        f"export_eth.main([{os.path.join(DATA_TOOLS, 'eth_graph.pkl')!r}, "
        f"{eth!r}])\n"
        "print(t1 - t0, time.perf_counter() - t1)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"the data tools failed: {res.stderr}")
    prepare_s, export_s = map(float, res.stdout.split()[-2:])
    check(sha(out) == expected["prepare_aml"]["sha256"],
          "prepare_aml's output differs from the reference's")
    for name in ("nodes.csv", "edges.csv"):
        check(sha(os.path.join(eth, name))
              == expected[f"export_eth/{name}"]["sha256"],
              f"export_eth's {name} differs from the reference's")
    aml = IBMTransactionsAML(out, khop_neighbors=(4, 4))
    eds = EthereumPhishing(eth, khop_neighbors=(4, 4))
    check(aml.graph.num_edges == expected["prepare_aml"]["rows"]
          and eds.nodes.num_rows == expected["export_eth/nodes.csv"]["rows"],
          "the prepared tables do not read back")
    rec = {"phase": "data_tools", "pandas_and_networkx": "blocked",
           "prepare_aml_rows": aml.graph.num_edges,
           "export_eth_accounts": eds.nodes.num_rows,
           "export_eth_transactions": eds.graph.num_edges,
           "prepare_aml_s": prepare_s, "export_eth_s": export_s,
           "card": card, "ok": True}
    emit(rec)
    return rec

# ---------------------------------------------------------------------------
# the text modality: Amazon Fashion reviews, the two downstream paths and
# the pure-LM finetune
# ---------------------------------------------------------------------------

TEXT_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                            "text_record.npz")
#: the synthetic Amazon Fashion of the text phases (the published
#: AMAZON_FASHION of Amazon Review Data 2018 has 883,636 reviews)
TEXT_DATA = dict(rows=32768, reviewers=8192, items=1024, seed=0)
TEXT_BATCH, LLM_BATCH = 256, 128     # the two CLIs' defaults
TEXT_LAYERS, LLM_LAYERS = 2, 2       # the FTTransformer's, the LM's
TEXT_DROPOUT = 0.1   # downstream_llm's default and the LMs' fixed dropout
#: (B, S, C, H) of the text paths' attention rows: the FTTransformer's
#: review tokens (7 columns and the CLS, C = 64, tiled), the downstream
#: LM's 64 token positions at C = 64/4 and finetune_llm's at 128/4 (split,
#: the long cores; the last one's backward one block an SM)
TEXT_SHAPES = [(TEXT_BATCH, 8, 64, 8), (TEXT_BATCH, 64, 64, 4),
               (LLM_BATCH, 64, 128, 4)]


def prepare_text_data() -> str:
    from rmm_tpu_torch.datasets.amazon_fashion import synthetic_amazon_fashion

    root = os.path.join(WORK, "amazon_fashion")
    os.makedirs(root, exist_ok=True)
    d = TEXT_DATA
    return synthetic_amazon_fashion(
        os.path.join(root, "reviews.csv"), num_rows=d["rows"],
        num_reviewers=d["reviewers"], num_items=d["items"], seed=d["seed"])


def kernel_text_phase(card: str) -> dict:
    """Both directions at the text paths' shapes (``TEXT_SHAPES``) against
    the plain twin, with the paths' 0.1 keep-mask (two calls bitwise
    equal) and without it, each timed once (records as the kernel
    phase's, the route held to ``route(c, s)``). First the attention
    cores' budget: the rows that fit half an SM keeping that budget (and
    so their plan: rows a block as ``core_rows`` gives them at half an SM)
    and finetune_llm's backward rows, past half an SM, one block an SM."""
    import numpy as np
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    block, sm = ca._card_smem()
    half = min(block, sm // 2 - 1024)
    budget = {"block_bytes": block, "sm_bytes": sm, "half_sm_bytes": half,
              "max_s_128_4": ca.max_s(128, 4), "shapes": {}}
    for b, s, c, h in TEXT_SHAPES:
        rows = ca.core_row_bytes(s, c, h)
        entry = {"row_bytes": list(rows)}
        if ca.route(c, s) == "split":
            fplan, bplan = ca.fwd_plan(b, s, c, h), ca.bwd_plan(b, s, c, h)
            entry.update(fwd_rows=fplan.rows, bwd_rows=bplan.rows,
                         budget=[ca.core_budget(r, block, sm) for r in rows])
            for r, got in zip(rows, (fplan.rows, bplan.rows)):
                if r <= half:   # a row that fit before keeps its plan
                    check(got == ca.core_rows(b, s, h, half // r),
                          f"{b}x{s}x{c}/{h}: rows {got} a block, not the "
                          "half-SM plan's")
        budget["shapes"][f"{b}x{s}x{c}/{h}"] = entry
    llm_bwd = ca.core_row_bytes(64, 128, 4)[1]
    check(half < llm_bwd <= block
          and ca.core_budget(llm_bwd, block, sm) == block
          and budget["max_s_128_4"] >= 64,
          f"finetune_llm's rows are not admitted one block an SM: {budget}")
    emit({"phase": "kernel_text_budget", **budget, "card": card})
    dev = torch.device("cuda")
    rng = np.random.RandomState(19)
    shapes = [(*shape, rate) for shape in TEXT_SHAPES
              for rate in (TEXT_DROPOUT, 0.0)]
    fwd = [fwd_record(rng, dev, *shape, card, repeat=shape[-1] > 0,
                      timing=OFF_PATH_TIMING) for shape in shapes]
    bwd = [bwd_record(rng, dev, *shape, card, repeat=shape[-1] > 0,
                      timing=OFF_PATH_TIMING) for shape in shapes]
    return {"fwd_tiled": fwd[:2], "bwd_tiled": bwd[:2], "fwd_long": fwd[2:],
            "bwd_long": bwd[2:], "budget": budget}


def text_counts(steps: int, evals: int, tiled: int, split: int) -> dict:
    """The launches of an epoch of ``steps`` steps and ``evals`` evaluated
    batches with ``tiled`` and ``split`` attention calls each way a step
    (forwards alone an evaluated batch)."""
    return {"fwd": (tiled + split) * (steps + evals),
            "fwd_tiled": tiled * (steps + evals),
            "fwd_split": split * (steps + evals),
            "bwd": (tiled + split) * steps, "bwd_tiled": tiled * steps,
            "bwd_split": split * steps, "reduce": (tiled + split) * steps,
            **NO_BF16}


def text_phase(card: str, csv: str, path: str) -> dict:
    """``cli/downstream_llm.py --text_path <path>`` for an epoch at its
    defaults (C = 64, 2 layers, batch 256, dropout 0.1): the
    FTTransformer's 2 tiled calls each way a step, and under ``finetune``
    the LM's 2 split calls (its one layer, once a text column; rows of 64
    tokens, the long cores); forwards alone an evaluated batch. A finite
    loss that falls from the first 10 steps to the last 10; val and test
    RMSE beside a constant prediction's; the materialization seconds, the
    step ms and rows/s."""
    import torch

    from rmm_tpu_torch.cli import downstream_llm

    argv = ["--dataset", csv, "--text_path", path, "--epochs", "1",
            "--testing", "--device", "cuda", "--wandb_dir",
            os.path.join(WORK, "text_runs")]
    stats: dict = {}
    reset_counts()
    history, best = downstream_llm.main(argv, stats)
    torch.cuda.synchronize()
    counts = read_counts()
    (ep,) = history
    train_rows, val_rows, test_rows = stats["split_rows"]
    steps = -(-train_rows // TEXT_BATCH)
    evals = -(-val_rows // TEXT_BATCH) + -(-test_rows // TEXT_BATCH)
    split = 2 if path == "finetune" else 0
    want = text_counts(steps, evals, TEXT_LAYERS, split)
    check(counts == want, f"text {path} launches {counts}, not {want}")
    losses = stats["step_losses"]
    first, last = (statistics.fmean(losses[:10]),
                   statistics.fmean(losses[-10:]))
    check(len(losses) == steps and all(map(math.isfinite, losses))
          and last < first,
          f"text {path}: {len(losses)} step losses, the first ten's mean "
          f"{first}, the last ten's {last}")
    check(all(math.isfinite(ep[k]) for k in ("val_rmse", "test_rmse")),
          f"text {path} epoch {ep}")
    train_s = ep["data_load"] + ep["transfer"] + ep["step"]
    rec = {"phase": f"text_{path}", "reviews": TEXT_DATA["rows"],
           "split_rows": stats["split_rows"], "steps": steps,
           "evaluated_batches": evals, "launches": counts,
           "loss": ep["loss"], "loss_first10": first, "loss_last10": last,
           "val_rmse": ep["val_rmse"], "test_rmse": ep["test_rmse"],
           "constant_rmse": stats["constant_rmse"], "best": best,
           "materialize_s": stats["materialize_s"],
           "setup_s": stats["setup_s"], "fit_s": stats["fit_s"],
           "step_ms_median": ep.get("step_ms"),
           "step_ms_wall": 1e3 * ep["step"] / steps,
           "train_rows_per_s": train_rows / train_s,
           "timers": {k: ep[k] for k in ("data_load", "transfer", "step")},
           "card": card, "ok": True}
    emit(rec)
    return rec


def finetune_llm_phase(card: str, csv: str) -> dict:
    """``cli/finetune_llm.py`` for an epoch at its defaults (hidden 128, 2
    layers, 4 heads, LoRA 8, 64 tokens, batch 128) with ``--save_model``:
    the LM's 2 split calls each way a step through the long cores at
    128x64x128/4 (the backward one block an SM), forwards alone an eval
    batch; finite train and eval MSE; the export read back
    (``load_finetuned``) gives the eval MSE again."""
    import numpy as np
    import torch

    from rmm_tpu_torch.cli import finetune_llm as fl
    from rmm_tpu_torch.ops import column_attention as ca

    export = os.path.join(WORK, "finetune_llm_export")
    argv = ["--dataset", csv, "--epochs", "1", "--device", "cuda",
            "--save_model", export, "--wandb_dir",
            os.path.join(WORK, "text_runs")]
    stats: dict = {}
    reset_counts()
    history = fl.main(argv, stats)
    torch.cuda.synchronize()
    counts = read_counts()
    (ep,) = history
    n = TEXT_DATA["rows"]
    n_train = int(n * 0.8)
    steps = n_train // LLM_BATCH
    evals = -(-(n - n_train) // LLM_BATCH)
    want = text_counts(steps, evals, 0, LLM_LAYERS)
    check(counts == want and ep["steps"] == steps,
          f"finetune_llm launches {counts} over {ep['steps']} steps, not "
          f"{want}")
    check(math.isfinite(ep["train_mse"]) and math.isfinite(ep["eval_mse"]),
          f"finetune_llm epoch {ep}")
    plan = ca.bwd_plan(LLM_BATCH, 64, 128, 4)
    # the export, read back, evaluates the same rows to the same MSE
    model = fl.load_finetuned(export, "cuda")
    ids, y = fl.read_dataset(csv)
    _, _, te_idx = fl.split(len(y), 0)
    reset_counts()
    again = fl.eval_mse(model, torch.from_numpy(ids).cuda(), y, te_idx,
                        LLM_BATCH)
    reload_counts = read_counts()
    check(abs(again - ep["eval_mse"]) <= 1e-5 * max(1.0, ep["eval_mse"]),
          f"finetune_llm export: eval MSE {again} against the run's "
          f"{ep['eval_mse']}")
    rec = {"phase": "finetune_llm", "reviews": n, "train_rows": n_train,
           "steps": steps, "eval_batches": evals, "launches": counts,
           "reload_launches": reload_counts, "train_mse": ep["train_mse"],
           "eval_mse": ep["eval_mse"], "reload_eval_mse": again,
           "label_var": float(np.var(y[te_idx].astype(np.float64))),
           "bwd_plan": plan._asdict(), "epoch_s": ep["sec"],
           "fit_s": stats["fit_s"], "step_ms_median": ep.get("step_ms"),
           "train_rows_per_s": steps * LLM_BATCH / ep["sec"],
           "card": card, "ok": True}
    emit(rec)
    return rec


def replay_text_part(rec, st: dict, root: str, name: str,
                     device: str = "cuda") -> dict:
    """Three steps of a text record part (``frozen``, ``finetune``: the
    downstream trainer on its 600-review data; ``finetune_llm``: the LM's
    CLI function for three one-step epochs on its 80 reviews) from the
    record's start on ``device``, dropout 0, within
    ``convert.check_record``'s float32 limits; the downstream parts' start
    predictions on the first validation batch within ``SCORE_TOL``
    (relative past 1: the served scores' limit; on the CPU the port lands
    5e-5 to 1e-4 from the record, float32 sums in another order),
    ``finetune_llm``'s eval MSE each epoch within the loss limits.
    Returns the launches, the loss terms and the limits' summary."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch.cli import finetune_llm as fl
    from rmm_tpu_torch.convert import LOSS_RTOL, check_record, from_jax, \
        random_variables
    from rmm_tpu_torch.datasets.amazon_fashion import (
        AmazonFashionDataset, synthetic_amazon_fashion)
    from rmm_tpu_torch.frame.stype import Stype
    from rmm_tpu_torch.nn.dropout import set_rate
    from rmm_tpu_torch.train.downstream_text import \
        TextTabularRegressionTrainer
    from rmm_tpu_torch.utils.config import Config

    os.makedirs(root, exist_ok=True)
    run = st["runs"][name]
    start = random_variables(run["shapes"], st["var_seed"])
    out = {}
    if name == "finetune_llm":
        d, m = st["llm_data"], st["llm"]
        csv = synthetic_amazon_fashion(
            os.path.join(root, "reviews_llm.csv"), num_rows=d["rows"],
            num_reviewers=d["reviewers"], num_items=d["items"],
            seed=d["seed"])
        model = fl.LLMRegressor(m["hidden"], m["num_layers"],
                                m["lora_rank"], m["max_length"], 0.0)
        start["params/head/w"] = np.zeros((m["hidden"], 1), np.float32)
        start["params/head/b"] = np.zeros(1, np.float32)
        model.load_state_dict(from_jax(start, model))
        reset_counts()
        history, model = fl.finetune_llm(
            csv, epochs=st["steps"], batch_size=m["batch_size"], lr=m["lr"],
            hidden=m["hidden"], num_layers=m["num_layers"],
            lora_rank=m["lora_rank"], max_length=m["max_length"],
            seed=m["seed"], device=device, model=model)
        terms = [{"loss": h["train_mse"]} for h in history]
        got = [h["eval_mse"] for h in history]
        want = rec["finetune_llm/eval_mse"]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        check(len(rel) == len(want) and rel[0] <= LOSS_RTOL[0]
              and max(rel) <= LOSS_RTOL[1],
              f"text record finetune_llm: eval MSE {got} against {list(want)}")
        out["eval_mse_rel_err"] = rel
        state, lr, width = model.state_dict(), m["lr"], m["hidden"]
    else:
        d, t = st["data"], st["downstream"]
        csv = synthetic_amazon_fashion(
            os.path.join(root, "reviews.csv"), num_rows=d["rows"],
            num_reviewers=d["reviewers"], num_items=d["items"],
            seed=d["seed"])
        finetune = name == "finetune"
        cfg = Config(model="fttransformer", data=csv,
                     batch_size=t["batch_size"], n_hidden=t["channels"],
                     n_gnn_layers=t["num_layers"], dropout=0.0, lr=t["lr"],
                     seed=st["seed"], device=device, epochs=1)
        ds = AmazonFashionDataset(
            csv, text_stype=(Stype.text_tokenized if finetune
                             else Stype.text_embedded))
        tr = TextTabularRegressionTrainer(cfg, ds, finetune_text=finetune,
                                          lora_rank=t["lora_rank"])
        tr.model.load_state_dict(from_jax(start, tr.model))
        set_rate(tr.model, 0.0)
        train, val, _ = ds.edges.split()
        reset_counts()
        with torch.inference_mode():
            tf, _, _ = next(tr._batches(val, False))
            pred = tr.model(tf).cpu().numpy()[:st["out_rows"]]
        want = rec[f"{name}/out/pred"]
        err = float(np.max(np.abs(pred - want) / np.maximum(np.abs(want),
                                                            1.0)))
        check(err <= SCORE_TOL, f"text record {name}: start predictions "
              f"off by {err} > {SCORE_TOL}")
        out["pred_max_err"] = err
        tr.model.train()
        terms = [{"loss": float(tr._step(tf, mask))} for tf, mask, _ in
                 itertools.islice(tr._batches(train, True), st["steps"])]
        state, lr, width = tr.model.state_dict(), cfg.lr, cfg.n_hidden
    if device == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    faults, summary = check_record(state, terms, rec, f"{name}/", lr, 0,
                                   width)
    check(not faults, f"text record {name}: {faults}")
    return {"launches": counts, "terms": terms, **out, **summary}


def text_parity_phase(card: str) -> dict:
    """The text record (``text_record.npz``,
    ``tools/make_torch_port_text_fixture.py``: C = 16, hidden 16, dropout
    0) on the card: three steps each of the frozen and finetune downstream
    paths and of ``finetune_llm`` (:func:`replay_text_part`); the
    launches by route (the LMs' 64-token rows split, the FTTransformer's
    tiled)."""
    from rmm_tpu_torch.convert import load_record

    rec = load_record(TEXT_FIXTURE)
    st = json.loads(str(rec["settings"]))
    root = os.path.join(WORK, "text_parity")
    parts = {name: replay_text_part(rec, st, root, name)
             for name in ("frozen", "finetune", "finetune_llm")}
    check(parts["frozen"]["launches"]["fwd_split"] == 0
          and parts["finetune"]["launches"]["bwd_split"] > 0
          and parts["finetune_llm"]["launches"]["bwd_tiled"] == 0,
          f"text record launches by route: "
          f"{ {k: v['launches'] for k, v in parts.items()} }")
    out = {"phase": "text_parity", "parts": parts, "card": card, "ok": True}
    emit(out)
    return out


# --precision bf16 across the model menu, the node tasks and the tabular
# and text trainers. Under bf16 a column-attention call runs the bf16 build
# where its tokens are bf16: the node tokens everywhere, the edge tokens of
# the node families (one dummy column) and the text LM's 64-token rows; the
# AML and Ethereum edge tokens, the review rows and the edge states that
# cpnatab's and tabgnninterleaved's calls take hold a float32 timestamp
# block, so those calls run the float32 build on bf16-valued weights. The
# record (``bf16_family_record.npz``, ``tools/make_torch_port_bf16_family_
# fixture.py``) holds every part at C = 16.
BF16_FAMILY_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                                   "bf16_family_record.npz")
BF16_BATCHES = 12     # train, val and served batches of the bf16 phases
#: bf16 column-attention calls a step of each family makes on the AML data,
#: each way (every call tiled): fttransformer's node tokens
FAMILY_BF16_CALLS = {"fttransformer": 2, "gin": 0, "pna": 0, "cpna": 0,
                     "cpnatab": 0, "tabgnninterleaved": 0}
#: the bf16 kernel shapes the slice puts on its paths, each with the path's
#: keep-mask and without it, timed once: the node families' node tokens
#: (ogbn-arxiv S = 130, MUSAE and LastFM S = 129) at the node lanes of a
#: 4,096-node batch, and the downstream LM's 64-token rows
BF16_PATH_SHAPES = [(4096, 129, 32, 8, TRAIN_DROPOUT), (4096, 129, 32, 8, 0.0),
                    (4096, 130, 32, 8, TRAIN_DROPOUT), (4096, 130, 32, 8, 0.0),
                    (256, 64, 64, 4, 0.1), (256, 64, 64, 4, 0.0)]


def read_routes() -> dict:
    """:func:`read_counts` with the bf16 launches by route: through the
    tiled kernels, the split route's long cores (S > 16) and in all
    through the split route, each way."""
    from rmm_tpu_torch.ops import column_attention as ca

    out = read_counts()
    for d in ("fwd", "bwd"):
        out[f"{d}_tiled_bf16"] = getattr(ca, f"{d}_tiled_bf16_launches")
        out[f"{d}_long_bf16"] = getattr(ca, f"{d}_long_bf16_launches")
        out[f"{d}_split_bf16"] = out[f"{d}_bf16"] - out[f"{d}_tiled_bf16"]
    return out


def bf16_counts(fwd: int, bwd: int, tiled: int = 0, tiled16: int = 0,
                long16: int = 0) -> dict:
    """The launches by route and dtype of ``fwd`` forwards and ``bwd``
    backwards of a path whose step makes ``tiled`` tiled calls each way,
    ``tiled16`` of them on bf16 tokens, and ``long16`` bf16 calls through
    the long cores."""
    out = {}
    for d, n in (("fwd", fwd), ("bwd", bwd)):
        out.update({d: (tiled + long16) * n, f"{d}_tiled": tiled * n,
                    f"{d}_split": long16 * n,
                    f"{d}_bf16": (tiled16 + long16) * n,
                    f"{d}_tiled_bf16": tiled16 * n,
                    f"{d}_long_bf16": long16 * n,
                    f"{d}_split_bf16": long16 * n})
    out["reduce"] = out["bwd"]
    return out


def bf16_trainer_pass(tr, table, n: int, expect) -> dict:
    """Up to ``n`` train, val and served batches of a trainer (the first
    ``n`` of each split of ``table``) on the card, the launch counts set
    to 0 just before each pass and read just after (:func:`read_routes`),
    held to ``expect(fwd, bwd)`` of its batches: a finite loss, f1 in [0,
    1], finite served scores; the median step, train and served rows/s."""
    import numpy as np
    import torch

    from rmm_tpu_torch.frame.dataset import DatasetView

    b = tr.cfg.batch_size
    train, val, test = (DatasetView(v.parent, v.indices[:n * b])
                        for v in table.split())
    n_tr, n_val, n_te = (-(-len(v.indices) // b)
                         for v in (train, val, test))
    reset_counts()
    t0 = time.perf_counter()
    tm = tr.train_epoch(train, 0)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = read_routes()
    reset_counts()
    vm = tr.evaluate(val, "val")
    eval_counts = read_routes()
    reset_counts()
    t0 = time.perf_counter()
    served = tr.predict(test, "test")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = read_routes()
    rows = len(served["id"])
    name = f"{tr.cfg.model} on {os.path.basename(tr.cfg.data)} (bf16)"
    check(math.isfinite(tm["loss"]) and 0 <= vm["f1"] <= 1 and rows > 0
          and np.isfinite(served.get("score", served["pred"])).all(),
          f"{name}: loss {tm['loss']}, val f1 {vm['f1']}, {rows} served "
          "rows or non-finite scores")
    for what, got, want in (("train", train_counts, expect(n_tr, n_tr)),
                            ("val", eval_counts, expect(n_val, 0)),
                            ("serve", serve_counts, expect(n_te, 0))):
        check(got == want, f"{name}: {what} launches {got}, not {want}")
    return {"steps": n_tr, "evaluated_batches": n_val,
            "served_batches": n_te, "loss": tm["loss"], "val_f1": vm["f1"],
            "step_ms_median": tm.get("step_ms"), "train_wall_s": train_wall,
            "train_rows_per_s": len(train.indices) / train_wall,
            "rows_per_s_predict": rows / serve_s, "served_rows": rows,
            "train_launches": train_counts, "eval_launches": eval_counts,
            "serve_launches": serve_counts,
            "launches_per_step": {k: train_counts[k] / n_tr for k in (
                "fwd", "fwd_bf16", "bwd", "bwd_bf16")}}


def family_bf16_phase(card: str, csv: str, f32: dict) -> dict:
    """Each family under ``--precision bf16`` at the supervised launcher's
    flags on the config of record's data (``family_train``'s loaded
    dataset): the trainer the training CLI builds, BF16_BATCHES train, val
    and test batches (:func:`bf16_trainer_pass`; ``FAMILY_CALLS`` tiled
    calls a step, ``FAMILY_BF16_CALLS`` of them bf16); ``pna``'s trained
    model saved as the CLI saves it (float32 masters, ``"precision":
    "bf16"`` in its meta) and served by the predict CLI with ``--precision
    bf16`` over the whole test split. Beside each: ``family_train``'s
    float32 step, rows/s and launches from the same run."""
    import numpy as np
    import torch

    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils import checkpoint
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    st = fixture_settings()
    dataset = f32["dataset"]
    argv = ["--data", csv, *FAMILY_ARGV, "--seed", str(st["seed"]),
            "--sampler_threads", "4", "--device", "cuda", "--precision",
            "bf16", "--edge_capacity", str(st["edge_capacity"]),
            "--node_capacity", str(st["node_capacity"])]
    out = {}
    for model in FAMILIES:
        cfg = config_from_args(create_parser().parse_args(
            argv + ["--model", model]))
        tr = Trainer(cfg, dataset)
        k, k16 = FAMILY_CALLS[model], FAMILY_BF16_CALLS[model]
        run = bf16_trainer_pass(tr, dataset.edges, BF16_BATCHES,
                                lambda f, b: bf16_counts(f, b, k, k16))
        if model == "pna":
            run_dir = os.path.join(WORK, "family_bf16")
            checkpoint.save_epoch(run_dir, 0, tr.model, tr.optimizer, 0.0,
                                  precision="bf16")
            ck = os.path.join(run_dir, "0")
            with open(os.path.join(ck, "meta.json")) as f:
                meta = json.load(f)
            saved = torch.load(os.path.join(ck, "model.pt"),
                               weights_only=True)
            check(meta["precision"] == "bf16" and all(
                v.dtype == torch.float32 for v in saved.values()
                if v.is_floating_point()),
                f"pna's bf16 checkpoint: meta {meta}, or not float32 masters")
            stats: dict = {}
            served, counts, wall = serve(argv + [
                "--model", "pna", "--load_model", ck, "--split", "test",
                "--output", os.path.join(WORK, "pna_bf16.csv")], stats)
            rows = len(served["id"])
            check(rows == dataset.edges.split()[2].tensor_frame.num_rows
                  and np.isfinite(served["score"]).all()
                  and counts == route_counts(0, 0),
                  f"pna bf16 served {rows} rows, launches {counts}")
            run["cli_serve"] = {"rows": rows, "launches": counts,
                                "rows_per_s_predict": rows
                                / stats["predict_s"],
                                "rows_per_s_wall": rows / wall}
        ref = f32["models"][model]
        run["f32"] = {key: ref.get(key) for key in (
            "step_ms_median", "train_rows_per_s", "rows_per_s_predict",
            "launches_per_step")}
        out[model] = run
        del tr
        torch.cuda.empty_cache()
    rec = {"phase": "family_bf16", "batches": BF16_BATCHES, "models": out,
           "card": card, "ok": True}
    emit(rec)
    return rec


def node_bf16_phase(card: str, roots: dict) -> dict:
    """Node classification under ``--precision bf16`` at the launcher's
    widths: ``tabgnn`` on ogbn-arxiv (node tokens S = 130 through the bf16
    long cores, edge tokens S = 2 through the bf16 tiled kernels, 2 of each
    a step each way) and ``pna`` on the Ethereum cut (no attention; bf16
    node states into float32 messages: the edges hold a timestamp),
    BF16_BATCHES train, val and served batches each
    (:func:`bf16_trainer_pass`)."""
    import torch

    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    out = {}
    for name, root, model, expect in (
            ("ogbn", roots["ogbn"], "tabgnn",
             lambda f, b: bf16_counts(f, b, 2, 2, 2)),
            ("eth", roots["eth_cut"], "pna",
             lambda f, b: bf16_counts(f, b))):
        cfg = config_from_args(create_parser().parse_args(node_argv(
            root, "--model", model, "--precision", "bf16")))
        ds = build_dataset(cfg)
        cfg = cfg.replace(n_classes=ds.n_classes)
        t0 = time.perf_counter()
        tr = Trainer(cfg, ds)
        setup_s = time.perf_counter() - t0
        out[name] = {"model": model, "setup_s": setup_s,
                     **bf16_trainer_pass(tr, ds.nodes, BF16_BATCHES,
                                         expect)}
        del tr
        torch.cuda.empty_cache()
    rec = {"phase": "node_bf16", "runs": out, "card": card, "ok": True}
    emit(rec)
    return rec


def text_bf16_phase(card: str, csv: str) -> dict:
    """The downstream text trainer under ``Config(precision="bf16")`` at
    ``text_phase``'s widths (C = 64, 2 layers, batch 256, dropout 0.1),
    frozen and finetune, BF16_BATCHES steps each: the review rows (S = 8,
    tiled) hold the float32 timestamp block; under ``finetune`` the LM's
    64-token rows run the bf16 long cores, 2 calls each way a step. A
    finite, falling loss; the step ms and rows/s."""
    import torch

    from rmm_tpu_torch.datasets.amazon_fashion import AmazonFashionDataset
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.frame.stype import Stype
    from rmm_tpu_torch.train.downstream_text import \
        TextTabularRegressionTrainer
    from rmm_tpu_torch.utils.config import Config

    out = {}
    for path in ("frozen", "finetune"):
        finetune = path == "finetune"
        ds = AmazonFashionDataset(csv, text_stype=(
            Stype.text_tokenized if finetune else Stype.text_embedded))
        cfg = Config(model="fttransformer", data=csv, batch_size=TEXT_BATCH,
                     n_hidden=64, n_gnn_layers=TEXT_LAYERS,
                     dropout=TEXT_DROPOUT, device="cuda", precision="bf16")
        tr = TextTabularRegressionTrainer(cfg, ds, finetune_text=finetune)
        train = ds.edges.split()[0]
        train = DatasetView(train.parent,
                            train.indices[:BF16_BATCHES * TEXT_BATCH])
        reset_counts()
        t0 = time.perf_counter()
        ep = tr.train_epoch(train)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_routes()
        long16 = 2 if finetune else 0
        want = bf16_counts(BF16_BATCHES, BF16_BATCHES, TEXT_LAYERS, 0,
                           long16)
        losses = tr.step_losses
        check(counts == want and all(map(math.isfinite, losses))
              and losses[-1] < losses[0],
              f"text {path} (bf16): launches {counts}, not {want}; losses "
              f"{losses}")
        out[path] = {"steps": BF16_BATCHES, "losses": losses,
                     "step_ms_median": ep.get("step_ms"), "wall_s": wall,
                     "train_rows_per_s": BF16_BATCHES * TEXT_BATCH / wall,
                     "launches": counts}
        del tr
        torch.cuda.empty_cache()
    rec = {"phase": "text_bf16", "paths": out, "card": card, "ok": True}
    emit(rec)
    return rec


def tabular_bf16_phase(card: str, csv: str) -> dict:
    """The tabular MCM trainer under ``Config(precision="bf16")`` at the
    tabular CLI's defaults (C = 128, 3 layers, batch 200) on the config of
    record's data, BF16_BATCHES steps: its rows hold the float32 timestamp
    block, so its 3 split calls each way a step run the float32 build on
    bf16-valued weights. Finite losses, float32 masters and AdamW state;
    the step ms and rows/s."""
    import torch

    from rmm_tpu_torch.cli import fttransformer
    from rmm_tpu_torch.datasets import IBMTransactionsAML
    from rmm_tpu_torch.datasets.base import PretrainType
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.tabular import TabularMCMTrainer

    cfg = fttransformer.config_from_args(fttransformer.build_parser(
    ).parse_args(["--dataset", csv, "--device", "cuda"])).replace(
        precision="bf16")
    edges = IBMTransactionsAML(root=csv, pretrain={PretrainType.MASK}).edges
    tr = TabularMCMTrainer(cfg, edges)
    train = edges.split()[0]
    train = DatasetView(train.parent,
                        train.indices[:BF16_BATCHES * cfg.batch_size])
    reset_counts()
    t0 = time.perf_counter()
    ep = tr.train_epoch(train, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_routes()
    k = TABULAR_LAYERS
    want = {**route_counts(k * BF16_BATCHES, k * BF16_BATCHES),
            **{f"{d}_{r}_bf16": 0 for d in ("fwd", "bwd")
               for r in ("tiled", "long", "split")}}
    masters = all(p.dtype == torch.float32 for p in tr.model.parameters())
    moments = all(v.dtype == torch.float32 for s in tr.optimizer.state.values()
                  for v in s.values() if torch.is_tensor(v)
                  and v.is_floating_point())
    check(counts == want and math.isfinite(ep["loss"]) and masters
          and moments, f"tabular bf16: launches {counts}, not {want}; loss "
          f"{ep['loss']}; float32 masters {masters}, AdamW state {moments}")
    rec = {"phase": "tabular_bf16", "channels": cfg.n_hidden,
           "steps": BF16_BATCHES, "loss": ep["loss"],
           "train_acc": ep["train_acc"], "train_rmse": ep["train_rmse"],
           "step_ms_median": ep.get("step_ms"), "wall_s": wall,
           "train_rows_per_s": BF16_BATCHES * cfg.batch_size / wall,
           "launches": counts, "card": card, "ok": True}
    emit(rec)
    return rec


def bf16_record_data(st: dict, root: str) -> dict:
    """The bf16 record's data under ``root``: the AML cut, the node cuts
    and the reviews, each written as the record's tool wrote it."""
    from rmm_tpu_torch.datasets import (write_synthetic_aml_csv,
                                        write_synthetic_node_dataset)
    from rmm_tpu_torch.datasets.amazon_fashion import synthetic_amazon_fashion

    os.makedirs(root, exist_ok=True)
    a = st["aml"]
    roots = {"aml": write_synthetic_aml_csv(
        os.path.join(root, "bf16_aml.csv"), num_rows=a["rows"],
        num_accounts=a["num_accounts"], seed=a["data_seed"])}
    for name, d in st["node_data"].items():
        roots[name] = write_synthetic_node_dataset(
            os.path.join(root, f"bf16_{d['dir']}_{d['nodes']}"),
            family=d["family"], num_nodes=d["nodes"], num_edges=d["edges"],
            num_feats=d["num_feats"], n_classes=d["n_classes"],
            seed=st["data_seed"])
    t = st["text_data"]
    roots["text"] = synthetic_amazon_fashion(
        os.path.join(root, "bf16_reviews.csv"), num_rows=t["rows"],
        num_reviewers=t["reviewers"], num_items=t["items"], seed=t["seed"])
    return roots


def bf16_part_limits(run: dict) -> dict:
    """``convert.check_record``'s ``model`` and ``messages`` for a part of
    the bf16 record: the CPNA rule for cpna and cpnatab, the bf16-sum rule
    where the reference's own bf16 sums moved its run (its ``sums_gap``,
    measured by the record's tool, is not zero: the run feeds bf16
    messages to the sums)."""
    gap = run.get("sums_gap") or {}
    return {"model": run.get("model", ""),
            "messages": "bf16-sums" if gap.get("param_max_abs_err", 0.0) > 0
            else "f32"}


def replay_bf16_part(rec, st: dict, roots: dict, name: str,
                     device: str = "cuda", skip: str = "",
                     hold: bool = True) -> dict:
    """A part of the bf16 record (``bf16_family_record.npz``) on
    ``device`` from the record's start under ``--precision bf16``, dropout
    0 (cpnatab's row attention and the text LM's too): the start's outputs
    on the recorded batch (the served ids equal; logits, MCM outputs or
    ratings within ``convert.BF16_OUT_TOL`` relative past 1), three steps
    by ``convert.check_record``'s bf16 limits for the part
    (:func:`bf16_part_limits`), the same parameters unmoved. Where the
    reference's sums are bf16, the part is held too to the reference's run
    with float32 sums (the record's ``<part>/f32sums/``), as the port sums
    (``messages="bf16"``'s limits). ``skip``
    plants a fault: that component's parameters keep their values through
    the last step. Returns the launches by route and dtype, the loss terms
    and the limits' summary; raises ``SmokeFailure`` on a fault, or with
    ``hold`` false returns the faults too."""
    import itertools

    import numpy as np
    import torch

    from rmm_tpu_torch import convert
    from rmm_tpu_torch.datasets import IBMTransactionsAML, build_dataset
    from rmm_tpu_torch.datasets.amazon_fashion import AmazonFashionDataset
    from rmm_tpu_torch.datasets.base import PretrainType
    from rmm_tpu_torch.frame.stype import Stype
    from rmm_tpu_torch.nn.dropout import set_rate
    from rmm_tpu_torch.train.downstream_text import \
        TextTabularRegressionTrainer
    from rmm_tpu_torch.train.tabular import TabularMCMTrainer
    from rmm_tpu_torch.train.trainer import MCM_SUMS, Trainer
    from rmm_tpu_torch.utils.config import (Config, config_from_args,
                                            create_parser)

    run = st["runs"][name]
    p = f"{name}/"
    start = convert.random_variables(run["shapes"], st["var_seed"])
    limits = bf16_part_limits(run)
    out_tol = convert.BF16_OUT_TOL
    kind = run["kind"]
    if kind == "trainer":
        argv = ["--data", roots[run["data"]], "--model", run["model"],
                "--task", run["task"], "--n_hidden", str(st["n_hidden"]),
                "--n_gnn_layers", str(st["n_gnn_layers"]), "--num_neighs",
                *map(str, st["num_neighs"]), "--batch_size",
                str(st["batch_size"]), "--seed", str(st["seed"]),
                "--precision", "bf16", "--dropout", "0", "--edge_capacity",
                str(run["edge_capacity"]), "--node_capacity",
                str(run["node_capacity"]), "--device", device,
                *run["flags"]]
        cfg = config_from_args(create_parser().parse_args(argv))
        ds = build_dataset(cfg)
        node = run["task"] == "node_classification"
        if node:
            cfg = cfg.replace(n_classes=ds.n_classes)
        tr = Trainer(cfg, ds)
        model, lr, width, updates = tr.model, cfg.lr, cfg.n_hidden, \
            st["steps"]
        model.load_state_dict(convert.from_jax(start, model))
        set_rate(model, 0.0)
        train, val, test = (ds.nodes if node else ds.edges).split()
        mcm = run["task"] == "mcm_edge_table"
        gb = next(tr._batches(val if mcm else test, "val" if mcm
                              else "test"))
        reset_counts()
        with torch.inference_mode():
            got = tr._logits(gb.to(tr.device))
        if mcm:
            outs = {"num": got[0], **{f"cat_{i}": c
                                      for i, c in enumerate(got[1])}}
        else:
            gather = gb.node_gather if node else gb.edge_gather
            ids = gather[:cfg.batch_size][gb.seed_mask]
            check(np.array_equal(ids, rec[f"{p}serve/id"]),
                  f"bf16 record {name}: served ids differ")
            outs = {"logits": got[torch.from_numpy(gb.seed_mask).to(
                got.device)]}

        def steps():
            model.train()
            for g in itertools.islice(tr._batches(train, "train", 0),
                                      st["steps"]):
                loss, aux = tr._step(g.to(tr.device))
                yield loss, (dict(zip(MCM_SUMS, aux["sums"].tolist()))
                             if mcm else {})
    elif kind == "tabular":
        csv = roots["aml"]
        cfg = Config(model="fttransformer", data=csv,
                     batch_size=run["batch_size"], n_hidden=run["channels"],
                     n_gnn_layers=run["num_layers"], dropout=0.0,
                     lr=run["lr"], weight_decay=run["weight_decay"],
                     adam_eps=run["adam_eps"], seed=st["seed"],
                     device=device, precision="bf16")
        edges = IBMTransactionsAML(root=csv,
                                   pretrain={PretrainType.MASK}).edges
        tr = TabularMCMTrainer(cfg, edges)
        model, lr, width, updates = tr.model, cfg.lr, cfg.n_hidden, 0
        model.load_state_dict(convert.from_jax(start, model))
        train, val, _ = edges.split()
        tf, _, _, _ = next(tr._batches(val, False))
        reset_counts()
        with torch.inference_mode():
            num_out, cat_out, _ = tr._forward(tf)
        outs = {"num": num_out, **{f"cat_{i}": c
                                   for i, c in enumerate(cat_out)}}

        def steps():
            model.train()
            for tf_, mask, _, _ in itertools.islice(
                    tr._batches(train, True, 0), st["steps"]):
                loss, sums = tr._step(tf_, mask)
                yield loss, dict(zip(MCM_SUMS, sums.tolist()))
    else:
        finetune = run["finetune"]
        csv = roots["text"]
        cfg = Config(model="fttransformer", data=csv,
                     batch_size=run["batch_size"], n_hidden=run["channels"],
                     n_gnn_layers=run["num_layers"], dropout=0.0,
                     lr=run["lr"], seed=st["seed"], device=device, epochs=1,
                     precision="bf16")
        ds = AmazonFashionDataset(csv, text_stype=(
            Stype.text_tokenized if finetune else Stype.text_embedded))
        tr = TextTabularRegressionTrainer(cfg, ds, finetune_text=finetune,
                                          lora_rank=run["lora_rank"])
        model, lr, width, updates = tr.model, cfg.lr, cfg.n_hidden, 0
        model.load_state_dict(convert.from_jax(start, model))
        set_rate(model, 0.0)
        train, val, _ = ds.edges.split()
        tf, _, _ = next(tr._batches(val, False))
        reset_counts()
        with torch.inference_mode():
            outs = {"pred": tr.predict(tf)}

        def steps():
            model.train()
            for tf_, mask, _ in itertools.islice(tr._batches(train, True),
                                                 st["steps"]):
                yield tr._step(tf_, mask), {}
    fwd_counts = read_routes()
    err = 0.0
    for key, t in outs.items():
        want = rec[f"{p}out/{key}" if key != "logits" else f"{p}serve/logits"]
        got = t.detach().float().cpu().numpy()[:len(want)]
        err = max(err, float(np.abs(got - want).max())
                  / max(1.0, float(np.abs(want).max())))
    check(err <= out_tol, f"bf16 record {name}: start outputs off by {err} "
          f"> {out_tol}")
    twin = f"{p}f32sums/"
    twin_err = None
    if limits["messages"] == "bf16-sums":
        # the reference's run with float32 sums, as the port's
        key = next(iter(outs))
        want = rec[f"{twin}serve/logits" if key == "logits"
                   else f"{twin}out/{key}"]
        got = outs[key].detach().float().cpu().numpy()[:len(want)]
        twin_err = float(np.abs(got - want).max()
                         / max(1.0, float(np.abs(want).max())))
        check(twin_err <= convert.BF16_OUT_TOL,
              f"bf16 record {name}: start outputs off the float32-sum run "
              f"by {twin_err} > {convert.BF16_OUT_TOL}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    frozen = [q for n_, q in model.named_parameters()
              if skip and n_.split(".")[0] == skip]
    reset_counts()
    terms = []
    for i, (loss, sums) in enumerate(steps()):
        if frozen and i == st["steps"] - 2:   # keep step 2's values
            kept = [q.detach().clone() for q in frozen]
        terms.append(convert.loss_terms(loss, sums))
    if frozen:
        with torch.no_grad():
            for q, k_ in zip(frozen, kept):
                q.copy_(k_)
    if device == "cuda":
        torch.cuda.synchronize()
    counts = read_routes()
    state = model.state_dict()
    faults, summary = convert.check_record(
        state, terms, rec, p, lr, updates, width, precision="bf16",
        **limits)
    if limits["messages"] == "bf16-sums":
        twin_faults, twin_summary = convert.check_record(
            state, terms, rec, twin, lr, updates, width, precision="bf16",
            model=limits["model"], messages="bf16")
        faults += [f"against the float32-sum run: {f}" for f in twin_faults]
        summary["f32sums"] = {"output_err": twin_err, **twin_summary}
    unmoved = {n_ for n_, _ in model.named_parameters()
               if torch.equal(state[n_], before[n_])}
    want_unmoved = {convert.torch_key(k)[0] for k in run["unmoved"]}
    if not skip and unmoved != want_unmoved:
        faults.append(f"unmoved parameters {sorted(unmoved)}, the "
                      f"reference's {sorted(want_unmoved)}")
    if hold:
        check(not faults, f"bf16 record {name}: " + "; ".join(faults))
    return {"output_err": err, "output_tol": out_tol, "limits": limits,
            "faults": faults,
            "terms": terms, "jax_terms": run["terms"],
            "forward_launches": fwd_counts, "launches": counts, **summary}


def bf16_family_parity_phase(card: str) -> dict:
    """The bf16 record on the card: every part (:func:`replay_bf16_part`)
    from the record's start, each held to its limits; the launches by
    route and dtype (MUSAE's node tokens, S = 129, and the text LM's
    64-token rows through the bf16 long cores)."""
    import torch

    from rmm_tpu_torch.convert import load_record

    rec = load_record(BF16_FAMILY_FIXTURE)
    st = json.loads(str(rec["settings"]))
    roots = bf16_record_data(st, os.path.join(WORK, "bf16_record"))
    parts = {}
    for name in st["runs"]:
        parts[name] = replay_bf16_part(rec, st, roots, name)
        torch.cuda.empty_cache()
    for name in ("musae_tabgnn", "text_finetune"):
        c = parts[name]["launches"]
        check(c["fwd_long_bf16"] > 0 and c["bwd_long_bf16"] > 0,
              f"bf16 record {name}: no bf16 long-core launch: {c}")
    res = {"phase": "bf16_family_parity", "parts": parts, "card": card,
           "ok": True}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# Widths past 128 and rows past max_s (the staged cores' longest row; longer
# ones take the long cores' direct form), and the profiling and sweep CLIs.

#: (B, S, C, H, dropout) of kernel_wide beside the shapes that wide_paths
#: gives the kernels (:func:`wide_shapes`), each with its keep-mask and
#: without it: 200 target rows at C = 512 (the SSL dropout),
#: 32768x6x130/10 (the narrow GEMMs at 10 heads), and rows past the old
#: max_s, through the direct form: 4096 lanes of Elliptic's 167 and of
#: ogbn-arxiv's 130 node tokens at --n_hidden 256, 600 tokens at C = 32
#: and :data:`WIDE_RAGGED` (the node path's dropout)
WIDE_EXTRA = [(200, 6, 512, 8, SSL_DROPOUT), (32768, 6, 130, 10, SSL_DROPOUT),
              (4096, NODE_S, 256, 8, TRAIN_DROPOUT),
              (4096, 130, 256, 8, TRAIN_DROPOUT),
              (256, 600, 32, 8, TRAIN_DROPOUT)]
#: a direct-form row whose last chunk of 32 keys holds 8 (520 tokens at
#: C = 256, 8 heads: two rounds of the forward's query groups), checked
#: with two calls bitwise equal as Elliptic's masked node rows are
WIDE_RAGGED = (256, 520, 256, 8, TRAIN_DROPOUT)
WIDE_C = 256
#: wide_paths' batches: the supervised float32 run's train and val batches;
#: its bf16 run's, the SSL run's and Elliptic's
WIDE_BATCHES, WIDE_SHORT_BATCHES = 24, 12
BENCH_ITERS, BENCH_SSL_ITERS = 20, 10


def read_direct() -> dict:
    """The launches whose attention core took the direct form, each way."""
    from rmm_tpu_torch.ops import column_attention as ca

    return {"fwd_direct": ca.fwd_direct_launches,
            "bwd_direct": ca.bwd_direct_launches}


@contextlib.contextmanager
def kernel_shapes():
    """Records the (B, S, C, H, dropout) of every column-attention forward
    on the card while it is open (the wrapper's ``column_attention_fwd``,
    which every call on a CUDA tensor runs, wrapped; the backward runs at
    its forward's shape), with x's dtype: a set of (shape, dtype)."""
    from rmm_tpu_torch.ops import column_attention as ca

    seen, fwd = set(), ca.column_attention_fwd

    def recorded(x, wqkv, bqkv, wout, bout, nhead, keep=None, rate=0.0,
                 plan=None):
        seen.add(((*x.shape, nhead, rate), str(x.dtype).split(".")[-1]))
        return fwd(x, wqkv, bqkv, wout, bout, nhead, keep, rate, plan)

    ca.column_attention_fwd = recorded
    try:
        yield seen
    finally:
        ca.column_attention_fwd = fwd


def wide_shapes(path_shapes) -> list:
    """kernel_wide's shapes: every (B, S, C, H, dropout) that wide_paths'
    runs at C = 256 gave the kernels (``path_shapes``, in order), then
    :data:`WIDE_EXTRA`, each with its keep-mask and without it, once."""
    out = []
    for b, s, c, h, p in [*sorted(map(tuple, path_shapes)), *WIDE_EXTRA,
                          WIDE_RAGGED]:
        for shape in ((b, s, c, h, p), (b, s, c, h, 0.0)):
            if shape not in out:
                out.append(shape)
    return out


def kernel_wide_phase(card: str, wide: dict) -> dict:
    """Both directions at :func:`wide_shapes` of ``wide`` (wide_paths'
    record: the shapes its runs gave the kernels), float32
    (``fwd_record``, ``bwd_record``) and bf16 (``bf16_pair``), against
    their plain twin and the library call; every shape through the split
    route, its core in the direct form exactly where S passes
    ``max_s(C, H)`` (the direct counters move there and nowhere else); two
    calls of each direction bitwise equal at the masked SSL lanes (staged),
    Elliptic's masked node rows and :data:`WIDE_RAGGED` (direct); each
    shape timed once; the inputs drawn on the card (:func:`card_inputs`).
    Returns the records by direction and dtype, in the order of the
    shapes, and the shapes."""
    import numpy as np
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    dev = torch.device("cuda")
    rng = np.random.RandomState(3)
    shapes = wide_shapes(wide["shapes"])
    repeat = (wide["ssl_lanes"], wide["elliptic_rows"], WIDE_RAGGED)
    check(all(tuple(r) in shapes for r in repeat),
          f"the repeated shapes {repeat} are not wide_paths' shapes")
    recs = {"fwd": [], "bwd": [], "fwd_bf16": [], "bwd_bf16": [],
            "shapes": shapes}
    for shape in shapes:
        b, s, c, h, rate = shape
        direct = s > ca.max_s(c, h)
        check(ca.route(c, s) == "split"
              and ca.fwd_plan(b, s, c, h).direct == direct
              and ca.bwd_plan(b, s, c, h).direct == direct,
              f"{b}x{s}x{c}/{h}: not the split route, or its core not "
              f"{'direct' if direct else 'staged'}")
        again = list(shape) in map(list, repeat)
        before = read_direct()
        recs["fwd"].append(fwd_record(rng, dev, *shape, card, again,
                                      OFF_PATH_TIMING, "kernel_wide",
                                      card_inputs))
        recs["bwd"].append(bwd_record(rng, dev, *shape, card, again,
                                      OFF_PATH_TIMING, "kernel_wide",
                                      card_inputs))
        f16, b16 = bf16_pair(rng, dev, *shape, card, again,
                             OFF_PATH_TIMING, "kernel_wide", card_inputs)
        recs["fwd_bf16"].append(f16)
        recs["bwd_bf16"].append(b16)
        moved = {k: v > before[k] for k, v in read_direct().items()}
        check(moved == {"fwd_direct": direct, "bwd_direct": direct},
              f"{b}x{s}x{c}/{h}: direct launches moved {moved}, the core "
              f"{'direct' if direct else 'staged'}")
    return recs


def wide_counts(fwd: int, bwd: int, split: int, direct: int = 0,
                bf16: int = 0) -> dict:
    """The launches of ``fwd`` forwards and ``bwd`` backwards of a path
    whose step makes ``split`` split calls each way (none tiled), ``direct``
    of them through the direct form and ``bf16`` of them on bf16 tokens."""
    return {"fwd": split * fwd, "fwd_tiled": 0, "fwd_split": split * fwd,
            "bwd": split * bwd, "bwd_tiled": 0, "bwd_split": split * bwd,
            "reduce": split * bwd, "fwd_bf16": bf16 * fwd,
            "bwd_bf16": bf16 * bwd, "fwd_direct": direct * fwd,
            "bwd_direct": direct * bwd}


def wide_pass(tr, n: int, name: str, calls: dict,
              falling: str | None = None) -> dict:
    """``n`` train steps of a trainer (``Trainer`` or ``PretrainTrainer``) on
    its first ``n`` train batches, one at a time (each step's loss and
    scalar terms kept on the card), then ``n`` val batches, the launch
    counts set to 0 just before each pass and read just after, held to
    :func:`wide_counts` of ``calls``; finite losses, and the loss (or the
    step's term ``falling``) with its mean over the last third of the steps
    below that over the first third; a metric in range. The median step on
    the device's clock, train rows/s, peak memory, and each scalar term by
    step (under MCM also its two losses as the total sums them:
    ``mcm_num``, the numerical RMSE, and ``mcm_cat``, the categorical
    cross-entropy)."""
    import statistics as stats

    import torch

    from rmm_tpu_torch.frame.dataset import DatasetView

    b = tr.cfg.batch_size
    table = (tr.seed_table() if hasattr(tr, "seed_table")
             else tr.dataset.edges)
    train, val, _ = (DatasetView(v.parent, v.indices[:n * b])
                     for v in table.split())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tr.model.train()
    losses, auxes, events = [], [], []
    t0 = time.perf_counter()
    for item in tr._stream(train, "train"):
        loss, aux = tr._step(item[0])
        losses.append(loss)
        auxes.append({k: v for k, v in aux.items() if v.dim() == 0})
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    tr.model.eval()
    losses = [float(v) for v in torch.stack(losses).float().cpu()]
    steps = {k: [float(v) for v in torch.stack([a[k] for a in auxes])
                 .double().cpu()] for k in auxes[0]}
    if "loss_n" in steps:
        steps["mcm_num"] = [math.sqrt(v / max(t, 1)) for v, t in
                            zip(steps["loss_n"], steps["t_n"])]
        steps["mcm_cat"] = [v / max(t, 1) for v, t in
                            zip(steps["loss_c"], steps["t_c"])]
    terms = steps[falling] if falling else losses
    train_wall = time.perf_counter() - t0
    train_counts = {**read_counts(), **read_direct()}
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    vm = tr.evaluate(val, "val")
    torch.cuda.synchronize()
    eval_counts = {**read_counts(), **read_direct()}
    n_steps, n_val = len(losses), -(-len(val.indices) // b)
    k = max(1, n_steps // 3)
    first, last = stats.fmean(terms[:k]), stats.fmean(terms[-k:])
    what = falling or "loss"
    check(all(math.isfinite(v) for v in losses + terms) and last < first,
          f"{name}: losses {losses}, {what} {terms}: not finite, or the "
          f"{what} not falling (first {k} steps' mean {first}, last {k}'s "
          f"{last})")
    metric = "mrr" if "mrr" in vm else "f1"
    check(0 <= vm[metric] <= 1, f"{name}: val {metric} {vm[metric]}")
    for run, got, want in (
            ("train", train_counts, wide_counts(n_steps, n_steps, **calls)),
            ("val", eval_counts, wide_counts(n_val, 0, **calls))):
        check(got == want, f"{name}: {run} launches {got}, not {want}")
    return {"steps": n_steps, "evaluated_batches": n_val, "losses": losses,
            "falling": what, f"{what}_first_third": first,
            f"{what}_last_third": last, "term_steps": steps,
            f"val_{metric}": vm[metric],
            "step_ms_median": stats.median(
                a.elapsed_time(e) for a, e in zip(events, events[1:])),
            "train_wall_s": train_wall,
            "train_rows_per_s": len(train.indices) / train_wall,
            "peak_memory_gb": peak / 1e9, "train_launches": train_counts,
            "eval_launches": eval_counts}


def wide_paths_phase(card: str, csv: str) -> dict:
    """The paths at C = 256, 8 heads, as their CLIs configure them:
    ``cli/main.py --model tabgnn --n_hidden 256`` on the config of record's
    data (4 split calls each way a step: the edge and node tokens of 2
    layers) for WIDE_BATCHES train and val batches, then at ``--precision
    bf16`` for WIDE_SHORT_BATCHES (2 of the 4 on bf16 node tokens);
    ``cli/fused.py --mode mcm-lp --channels 256`` at the SSL config's
    other flags (10 split calls each way a step), and beside it the same
    at the config's C = 128 (the spread of its loss terms at the width of
    record); ``tabgnn --n_hidden 256`` on device_node's Elliptic cut
    (S = 167 node tokens past max_s: 2 of its 4 split calls each way
    through the direct form), each WIDE_SHORT_BATCHES +
    WIDE_SHORT_BATCHES (:func:`wide_pass`). The record's ``shapes`` are
    those the runs at C = 256 gave the kernels (:func:`kernel_shapes`),
    ``dtypes`` their x dtypes by shape, ``ssl_lanes`` and
    ``elliptic_rows`` the masked SSL edge lanes' and Elliptic node rows'
    shapes among them."""
    import torch

    from rmm_tpu_torch.datasets import (build_dataset,
                                        write_synthetic_node_dataset)
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    st = fixture_settings()
    caps = ["--edge_capacity", str(st["edge_capacity"]),
            "--node_capacity", str(st["node_capacity"])]
    argv = ["--model", "tabgnn", "--n_hidden", str(WIDE_C),
            "--n_gnn_layers", "2", "--num_neighs", "100", "100",
            "--batch_size", "200", "--sampler_threads", "4",
            "--device", "cuda"]
    out = {"phase": "wide_paths", "channels": WIDE_C, "heads": 8,
           "card": card}
    cfg = config_from_args(create_parser().parse_args(
        ["--data", csv, *argv, *caps]))
    dataset = build_dataset(cfg)
    with kernel_shapes() as seen:
        for precision, n, bf16 in (("f32", WIDE_BATCHES, 0),
                                   ("bf16", WIDE_SHORT_BATCHES, 2)):
            tr = Trainer(cfg.replace(precision=precision), dataset)
            out[f"aml_{precision}"] = wide_pass(
                tr, n, f"tabgnn C={WIDE_C} ({precision})",
                dict(split=4, bf16=bf16))
            del tr
            torch.cuda.empty_cache()
        del dataset
        ssl_argv = list(SSL_ARGV)
        ssl_argv[ssl_argv.index("--channels") + 1] = str(WIDE_C)
        tr = ssl_trainer(csv, ssl_argv + ["--sampler_threads", "4"],
                         st["edge_capacity"], st["node_capacity"])
        # the LP loss falls; the sum moves with the MCM numerical term
        # (an RMSE over raw amounts) from batch to batch: its steps are in
        # the record, beside the same run's at C = 128 below
        out["ssl"] = wide_pass(tr, WIDE_SHORT_BATCHES,
                               f"mcm-lp C={WIDE_C}",
                               dict(split=SSL_LAUNCHES), falling="lp")
        lanes = (st["edge_capacity"], 6, WIDE_C, 8, tr.cfg.dropout)
        del tr
        torch.cuda.empty_cache()
        root = os.path.join(WORK, "elliptic-cut")
        if not os.path.isdir(root):
            write_synthetic_node_dataset(
                root, num_nodes=ELLIPTIC_CUT_NODES,
                num_edges=ELLIPTIC_CUT_EDGES, num_feats=ELLIPTIC_FEATS,
                seed=0)
        ecfg = config_from_args(create_parser().parse_args(["--data", root,
                                                            *argv]))
        tr = Trainer(ecfg, build_dataset(ecfg))
        out["elliptic"] = wide_pass(tr, WIDE_SHORT_BATCHES,
                                    f"Elliptic tabgnn C={WIDE_C}",
                                    dict(split=4, direct=2))
        rows = (tr.cfg.node_capacity, NODE_S, WIDE_C, 8, tr.cfg.dropout)
        out.update(elliptic_node_capacity=tr.cfg.node_capacity,
                   elliptic_edge_capacity=tr.cfg.edge_capacity)
        del tr
        torch.cuda.empty_cache()
    tr = ssl_trainer(csv, SSL_ARGV + ["--sampler_threads", "4"],
                     st["edge_capacity"], st["node_capacity"])
    out["ssl_c128"] = wide_pass(tr, WIDE_SHORT_BATCHES, "mcm-lp C=128",
                                dict(split=SSL_LAUNCHES), falling="lp")
    del tr
    torch.cuda.empty_cache()
    shapes = sorted({shape for shape, _ in seen})
    out.update(shapes=shapes, dtypes={
        "x".join(map(str, shape)): sorted(d for sh, d in seen if sh == shape)
        for shape in shapes}, ssl_lanes=lanes, elliptic_rows=rows)
    check(all(shape[2] == WIDE_C for shape in shapes)
          and lanes in shapes and rows in shapes,
          f"wide_paths gave the kernels {shapes}: not all at C = {WIDE_C}, "
          f"or without the SSL lanes {lanes} or Elliptic's rows {rows}")
    check(any(d == "bfloat16" for _, d in seen),
          "the bf16 run gave the kernels no bf16 tokens")
    out["ok"] = True
    emit(out)
    return out


def trace_kernels(path: str) -> dict:
    """The CUDA kernels of a Chrome trace by name: launches and device
    ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, ms = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, ms + e.get("dur", 0) / 1e3)
    return out


def bench_cli_phase(card: str, csv: str) -> dict:
    """The profiling CLI (``cli/benchmark.py``) at the config of record
    with ``--iters BENCH_ITERS --profile``: each phase's table printed, the
    Chrome trace under ``WORK`` parsed, the column-attention kernels among
    its CUDA events; launches as the iterations make them (a warm-up, 10
    traced and BENCH_ITERS timed, each a forward of 4 tiled calls and a
    step of 4 each way). Then ``--loop mcm-lp`` at the SSL widths for
    BENCH_SSL_ITERS (10 split calls each way a step, after a warm-up)."""
    import numpy as np
    import torch

    from rmm_tpu_torch.cli import benchmark

    st = fixture_settings()
    caps = ["--edge_capacity", str(st["edge_capacity"]),
            "--node_capacity", str(st["node_capacity"])]
    trace_dir = os.path.join(WORK, "trace")
    reset_counts()
    t0 = time.perf_counter()
    sup = benchmark.main(record_argv(st, csv) + caps + [
        "--sampler_threads", "4", "--iters", str(BENCH_ITERS), "--profile",
        "--trace_dir", trace_dir])
    wall = time.perf_counter() - t0
    counts = read_counts()
    iters = 1 + min(BENCH_ITERS, benchmark.PROFILE_ITERS) + BENCH_ITERS
    want = {"fwd": 8 * iters, "fwd_tiled": 8 * iters, "fwd_split": 0,
            "bwd": 4 * iters, "bwd_tiled": 4 * iters, "bwd_split": 0,
            "reduce": 4 * iters, **NO_BF16}
    check(counts == want, f"benchmark launches {counts}, not {want}")
    check(tuple(sup["phases"]) == benchmark.SUPERVISED_PHASES
          and all(np.isfinite(v) for p in sup["phases"].values()
                  for v in p.values())
          and sup["device"] == torch.cuda.get_device_name(0),
          f"benchmark summary {sup}")
    kernels = trace_kernels(sup["trace"])
    attention = {k: v for k, v in kernels.items()
                 if "column_attention" in k}
    check(any("fwd_tiled" in k for k in attention)
          and any("bwd_tiled" in k for k in attention),
          f"the trace's CUDA kernels name no column-attention kernel of "
          f"both directions: {sorted(kernels)[:20]}")
    reset_counts()
    ssl = benchmark.main([
        "--data", csv, "--model", "tabgnnfused", "--n_hidden", "128",
        "--n_gnn_layers", "3", "--batch_size", "200", "--num_neighs", "100",
        "100", *caps, "--iters", str(BENCH_SSL_ITERS), "--loop", "mcm-lp"])
    ssl_counts = read_counts()
    k = SSL_LAUNCHES * (1 + BENCH_SSL_ITERS)
    check(ssl_counts == route_counts(k, k),
          f"benchmark --loop mcm-lp launches {ssl_counts}, not "
          f"{route_counts(k, k)}")
    check(ssl["loop"] == "pretrain:mcm-lp" and ssl["rows_per_sec"] > 0,
          f"benchmark --loop mcm-lp summary {ssl}")
    out = {"phase": "bench_cli", "supervised": sup, "launches": counts,
           "wall_s": wall, "trace_bytes": os.path.getsize(sup["trace"]),
           "trace_kernels": len(kernels),
           "trace_attention_kernels": {k: {"launches": n, "device_ms": ms}
                                       for k, (n, ms) in attention.items()},
           "mcm_lp": ssl, "mcm_lp_launches": ssl_counts, "card": card,
           "ok": True}
    emit(out)
    return out


def sweep_phase(card: str) -> dict:
    """The sweep CLI (``cli/sweep.py``) on the config of record's
    16,384-row cut (``aml_train_record.npz``'s data): ``--kind supervised
    --trials 2 --epochs 1`` and ``--kind fused --trials 1 --epochs 1``,
    each at the CLI's other defaults; each writes a JSONL line a trial
    with the reference's keys, the params the reference's seed draws, and
    launches column-attention kernels both ways."""
    import numpy as np

    from rmm_tpu_torch.cli import sweep
    from rmm_tpu_torch.datasets import write_synthetic_aml_csv

    st = json.loads(str(np.load(TRAIN_FIXTURE)["settings"]))
    csv = write_synthetic_aml_csv(os.path.join(WORK, "aml_sweep.csv"),
                                  num_rows=st["rows"],
                                  num_accounts=st["num_accounts"],
                                  seed=st["data_seed"])
    out = {"phase": "sweep", "rows": st["rows"], "card": card}
    for kind, trials, metric in (("supervised", 2, "val_f1"),
                                 ("fused", 1, "val_mrr")):
        path = os.path.join(WORK, f"sweep_{kind}.jsonl")
        reset_counts()
        t0 = time.perf_counter()
        results, best = sweep.main([
            "--kind", kind, "--data", csv, "--trials", str(trials),
            "--epochs", "1", "--out", path, "--testing"])
        wall = time.perf_counter() - t0
        counts = read_counts()
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        rng = np.random.RandomState(0)
        space = (sweep.SUPERVISED_SPACE if kind == "supervised"
                 else sweep.FUSED_SPACE)
        check(lines == results and len(lines) == trials
              and all(set(r) == {"trial", "params", metric}
                      and 0 <= r[metric] <= 1 for r in lines)
              and [r["params"] for r in lines]
              == [sweep.sample_params(space, rng) for _ in range(trials)],
              f"{kind} sweep lines {lines}")
        check(counts["fwd"] > 0 and counts["bwd"] > 0,
              f"{kind} sweep launched no column attention: {counts}")
        out[kind] = {"lines": lines, "best": best, "wall_s": wall,
                     "launches": counts}
    out["ok"] = True
    emit(out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        sys.path.insert(0, ROOT)
        import rmm_tpu_torch  # noqa: F401
        from rmm_tpu_torch.ops.build import build_all

        card = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        emit({"phase": "device", "nvidia_smi": card, "kind": kind,
              "count": count, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]})
        t0 = time.perf_counter()
        logs = build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": [ln.strip() for log in logs.values()
                        for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]})
        seconds = {"build": time.perf_counter() - t0}

        def timed(name, fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            seconds[name] = time.perf_counter() - t
            return out

        kern = timed("kernel", kernel_phase, card)
        kern16 = timed("kernel_bf16", kernel_bf16_phase, card)
        try:
            csv = timed("data", prepare_data)
            serve_rec = timed("serve", serve_phase, card, csv)
            serve16 = timed("serve_bf16", serve_bf16_phase, card, csv)
            train_rec = timed("train", train_phase, card, csv)
            dsampler = timed("device_sampler", device_sampler_phase, card,
                             csv)
            dtrain = timed("device_train", device_train_phase, card, csv,
                           train_rec, serve_rec)
            timed("train_parity", train_parity_phase, card)
            family = timed("family_train", family_train_phase, card, csv)
            fparity = timed("family_parity", family_parity_phase, card)
            fam16 = timed("family_bf16", family_bf16_phase, card, csv,
                          family)
            parity16 = timed("train_parity_bf16", train_parity_bf16_phase,
                             card)
            ssl_rec = timed("ssl_train", ssl_train_phase, card, csv)
            ssl16 = timed("ssl_train_bf16", ssl_train_phase, card, csv,
                          "bf16")
            ssl_csv = ssl_parity_csv()
            timed("ssl_parity", ssl_parity_phase, card, ssl_csv)
            ssl_parity16 = timed("ssl_parity_bf16", ssl_parity_phase, card,
                                 ssl_csv, SSL_BF16_FIXTURE, "bf16")
            timed("ssl_cli", ssl_cli_phase, card, ssl_csv)
            transfer = timed("transfer", transfer_phase, card, csv,
                             ssl_rec["checkpoint"])
            timed("transfer_parity", transfer_parity_phase, card)
            tabular = timed("tabular_mcm", tabular_mcm_phase, card, csv)
            tab16 = timed("tabular_bf16", tabular_bf16_phase, card, csv)
            mcm_edge = timed("mcm_edge", mcm_edge_phase, card, csv)
            moco = timed("ssl_moco", ssl_moco_phase, card, csv)
            mcm_parity = timed("mcm_parity", mcm_parity_phase, card)
            node_root = timed("node_data", prepare_node_data)
            node = timed("node_train", node_train_phase, card, node_root)
            klong = timed("kernel_long", kernel_long_phase, card,
                          node["node_capacity"])
            node_serve = timed("node_serve", node_serve_phase, card,
                               node_root, node)
            dnode = timed("device_node", device_node_phase, card)
            node_parity = timed("node_parity", node_parity_phase, card)
            nf_roots = timed("node_family_data", prepare_node_family_data)
            eth = timed("eth_node", eth_node_phase, card, nf_roots["eth"])
            menu = timed("node_menu", node_menu_phase, card,
                         nf_roots["eth_cut"])
            eth_ssl = timed("eth_ssl", eth_ssl_phase, card,
                            nf_roots["eth_cut"])
            dssl = timed("device_ssl", device_ssl_phase, card,
                         nf_roots["eth_cut"], eth_ssl)
            families = timed("node_families", node_families_phase, card,
                             nf_roots)
            nf_parity = timed("node_family_parity", node_family_parity_phase,
                              card)
            node16 = timed("node_bf16", node_bf16_phase, card, nf_roots)
            dparity = timed("device_parity", device_parity_phase, card)
            hm = timed("rel_hm", rel_hm_phase, card)
            timed("data_tools", data_tools_phase, card)
            ktext = timed("kernel_text", kernel_text_phase, card)
            text_csv = timed("text_data", prepare_text_data)
            tfrozen = timed("text_frozen", text_phase, card, text_csv,
                            "frozen")
            tfine = timed("text_finetune", text_phase, card, text_csv,
                          "finetune")
            tllm = timed("finetune_llm", finetune_llm_phase, card, text_csv)
            tparity = timed("text_parity", text_parity_phase, card)
            text16 = timed("text_bf16", text_bf16_phase, card, text_csv)
            bparity = timed("bf16_family_parity", bf16_family_parity_phase,
                            card)
            wide = timed("wide_paths", wide_paths_phase, card, csv)
            kwide = timed("kernel_wide", kernel_wide_phase, card, wide)
            timed("bench_cli", bench_cli_phase, card, csv)
            timed("sweep", sweep_phase, card)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        emit({"phase": "seconds", **seconds,
              "total": time.perf_counter() - t_start})
        # the split launches of each path (the transfer's train, eval and
        # serve runs; ssl_train's train and eval runs)
        transfer_split = {
            "fwd": sum(transfer[f"{r}_launches"]["fwd_split"]
                       for r in ("train", "eval", "serve")),
            "bwd": transfer["train_launches"]["bwd_split"]}
        split_fwd = {"ssl_train": ssl_rec["train_launches"]["fwd"]
                     + ssl_rec["eval_launches"]["fwd"],
                     "transfer": transfer_split["fwd"]}
        split_bwd = {"ssl_train": ssl_rec["train_launches"]["bwd"],
                     "transfer": transfer_split["bwd"]}
        # the node path's launches by route: its node tokens (S = 167) split
        # through the long cores, its edge tokens tiled
        node_runs = {"node_train": [node["train_launches"],
                                    node["eval_launches"]],
                     "node_serve": [node_serve["launches"]],
                     "node_parity": [node_parity["serve_launches"],
                                     node_parity["launches"]]}

        def node_launches(key):
            return {path: sum(c[key] for c in runs)
                    for path, runs in node_runs.items()}

        node_fwd_split, node_bwd_split = (node_launches("fwd_split"),
                                          node_launches("bwd_split"))
        node_fwd_tiled, node_bwd_tiled = (node_launches("fwd_tiled"),
                                          node_launches("bwd_tiled"))
        # the families' launches by path (all tiled: family_counts)
        fam_fwd = {f"family_train {m}": sum(
            r[f"{run}_launches"]["fwd"] for run in ("train", "eval", "serve")
            if f"{run}_launches" in r) for m, r in family["models"].items()
            if FAMILY_CALLS[m]}
        fam_fwd["family_parity"] = sum(
            r["serve_launches"]["fwd"] + r["launches"]["fwd"]
            for r in fparity["models"].values())
        fam_bwd = {f"family_train {m}": r["train_launches"]["bwd"]
                   for m, r in family["models"].items() if FAMILY_CALLS[m]}
        fam_bwd["family_parity"] = sum(r["launches"]["bwd"]
                                       for r in fparity["models"].values())
        # the masked-cell paths' launches by path and route
        mcm_runs = {
            "tabular_mcm": [r["launches"] for r in tabular["runs"].values()],
            "mcm_edge": [r.get(f"{run}_launches", {})
                         for r in mcm_edge["models"].values()
                         for run in ("cli", "train", "eval")],
            "ssl_moco": [moco["train_launches"], moco["eval_launches"]],
            "mcm_parity": [c for r in mcm_parity["runs"].values()
                           for c in (r["launches"],
                                     r.get("forward_launches", {}))]}

        def mcm_launches(key):
            out = {path: sum(c.get(key, 0) for c in runs)
                   for path, runs in mcm_runs.items()}
            return {path: v for path, v in out.items() if v}

        mcm_fwd_tiled, mcm_bwd_tiled = (mcm_launches("fwd_tiled"),
                                        mcm_launches("bwd_tiled"))
        mcm_fwd_split, mcm_bwd_split = (mcm_launches("fwd_split"),
                                        mcm_launches("bwd_split"))
        # the node-classification paths of Ethereum phishing and of the
        # feature-node families by path and route: tiled (every Ethereum
        # token, the families' edge tokens and LastFM's record run) and
        # split (the families' node tokens past S = 16: the long cores);
        # the Ethereum SSL path's split calls at C = 128
        nf_runs = {
            "eth_node": [eth["launches"], eth["serve"]["launches"]],
            **{f"node_menu {m}": [r["launches"]]
               for m, r in menu["runs"].items()},
            **{f"node_families {f}": [r["launches"]]
               + ([r["serve"]["launches"]] if "serve" in r else [])
               for f, r in families.items()},
            **{f"node_family_parity {m}": [r["serve_launches"],
                                           r["launches"]]
               + r.get("repeat_launches", [])
               for m, r in nf_parity["runs"].items() if m != "ssl"}}
        eth_ssl_runs = {
            "eth_ssl": [eth_ssl["launches"]],
            "node_family_parity ssl": [nf_parity["runs"]["ssl"]["launches"]]}

        def by_path(runs, key):
            out = {path: sum(c[key] for c in cs) for path, cs in runs.items()}
            return {path: v for path, v in out.items() if v}

        nf_fwd_tiled, nf_bwd_tiled = (by_path(nf_runs, "fwd_tiled"),
                                      by_path(nf_runs, "bwd_tiled"))
        nf_fwd_long, nf_bwd_long = (by_path(nf_runs, "fwd_split"),
                                    by_path(nf_runs, "bwd_split"))
        eth_fwd_split, eth_bwd_split = (by_path(eth_ssl_runs, "fwd_split"),
                                        by_path(eth_ssl_runs, "bwd_split"))
        # the device-sampled paths and Rel-H&M by path and route: tiled
        # (device_train, device_node's and the device record's edge tokens,
        # the device record's C = 16 runs, Rel-H&M's mcm_edge_table and its
        # record), split at C = 128 (device_ssl, Rel-H&M's pretraining) and
        # the long cores (device_node's node tokens, the device record's
        # node part: S = 21)
        dev_runs = {
            "device_train": [dtrain["launches"], dtrain["serve_launches"]],
            "device_node": [dnode["launches"], dnode["serve"]["launches"],
                            dnode["host_launches"]],
            **{f"device_parity {p}": [r["launches"]]
               for p, r in dparity["parts"].items()},
            "rel_hm": [hm["launches"]],
            **{f"rel_hm parity {p}": [r["launches"]]
               for p, r in hm["parity"].items()}}
        dev_split_runs = {
            "device_ssl": [dssl["launches"]],
            "rel_hm ssl": [hm["ssl_launches"], hm["ssl_eval_launches"]]}
        dev_fwd_tiled, dev_bwd_tiled = (by_path(dev_runs, "fwd_tiled"),
                                        by_path(dev_runs, "bwd_tiled"))
        dev_fwd_long, dev_bwd_long = (by_path(dev_runs, "fwd_split"),
                                      by_path(dev_runs, "bwd_split"))
        dev_fwd_split, dev_bwd_split = (by_path(dev_split_runs, "fwd_split"),
                                        by_path(dev_split_runs, "bwd_split"))
        hm_fwd, hm_bwd = hm["kernel_fwd"], hm["kernel_bwd"]
        # the text paths by route: tiled (the FTTransformer's review
        # tokens), split past S = 16 (the LMs' 64-token rows: the long
        # cores)
        text_runs = {
            "text_frozen": [tfrozen["launches"]],
            "text_finetune": [tfine["launches"]],
            "finetune_llm": [tllm["launches"], tllm["reload_launches"]],
            "text_parity": [p["launches"]
                            for p in tparity["parts"].values()]}
        text_fwd_tiled, text_bwd_tiled = (by_path(text_runs, "fwd_tiled"),
                                          by_path(text_runs, "bwd_tiled"))
        text_fwd_long, text_bwd_long = (by_path(text_runs, "fwd_split"),
                                        by_path(text_runs, "bwd_split"))
        dev_fwd_tiled.update(text_fwd_tiled)
        dev_bwd_tiled.update(text_bwd_tiled)
        dev_fwd_long.update(text_fwd_long)
        dev_bwd_long.update(text_bwd_long)
        emit({"kernels": [
            kernel_entry("column_attention_fwd", 165, kern["fwd"],
                         kern["fwd"], {
                             "path": "main, node (edge tokens), families "
                                     "(fttransformer, tabgnninterleaved, "
                                     "cpnatab), mcm_edge (tabgnn), "
                                     "mcm_parity, Ethereum phishing node "
                                     "classification (every model with "
                                     "attention), the node families' edge "
                                     "tokens, device-sampled training and "
                                     "serving, Rel-H&M mcm_edge_table, "
                                     "the text paths' FTTransformer",
                             "launches": serve_rec["launches"]
                             + train_rec["launches"]["fwd"]
                             + sum(node_fwd_tiled.values())
                             + sum(fam_fwd.values())
                             + sum(mcm_fwd_tiled.values())
                             + sum(nf_fwd_tiled.values())
                             + sum(dev_fwd_tiled.values()),
                             "tiled_launches": serve_rec["tiled_launches"]
                             + train_rec["launches"]["fwd_tiled"]
                             + sum(node_fwd_tiled.values())
                             + sum(fam_fwd.values())
                             + sum(mcm_fwd_tiled.values())
                             + sum(nf_fwd_tiled.values())
                             + sum(dev_fwd_tiled.values()),
                             "launches_by_path": {
                                 "serve": serve_rec["launches"],
                                 "train": train_rec["launches"]["fwd"],
                                 **node_fwd_tiled, **fam_fwd,
                                 **mcm_fwd_tiled, **nf_fwd_tiled,
                                 **dev_fwd_tiled},
                             "rel_hm": shape_times(hm_fwd[:2]),
                             "text": shape_times(ktext["fwd_tiled"]),
                             "family": shape_times(kern["family_fwd"]),
                             "ports": shape_times(kern["ports_fwd"]),
                             # the float32 edge tokens at --precision bf16
                             "launches_under_bf16": sum(
                                 c["fwd_tiled"] - c["fwd_bf16"]
                                 for c in (serve16["launches"],
                                           parity16["launches"])),
                             "masked_ms": sum(r["kernel_ms"]
                                              for r in kern["fwd_masked"]),
                             "masked_plain_ms": sum(
                                 r["plain_ms"] for r in kern["fwd_masked"]),
                             "masked_bound_ms": bound(
                                 sum(r["bytes_ms"] for r in kern["fwd_masked"]),
                                 sum(r["ops_ms"] for r in kern["fwd_masked"]))[0]}),
            kernel_entry("column_attention_bwd", 178, kern["bwd"],
                         kern["bwd_unmasked"], {
                             "path": "main, node (edge tokens), families "
                                     "(fttransformer, tabgnninterleaved, "
                                     "cpnatab), mcm_edge (tabgnn), "
                                     "mcm_parity, Ethereum phishing node "
                                     "classification (every model with "
                                     "attention), the node families' edge "
                                     "tokens, device-sampled training, "
                                     "Rel-H&M mcm_edge_table, the text "
                                     "paths' FTTransformer",
                             "launches": train_rec["launches"]["bwd"]
                             + sum(node_bwd_tiled.values())
                             + sum(fam_bwd.values())
                             + sum(mcm_bwd_tiled.values())
                             + sum(nf_bwd_tiled.values())
                             + sum(dev_bwd_tiled.values()),
                             "tiled_launches":
                                 train_rec["launches"]["bwd_tiled"]
                             + sum(node_bwd_tiled.values())
                             + sum(fam_bwd.values())
                             + sum(mcm_bwd_tiled.values())
                             + sum(nf_bwd_tiled.values())
                             + sum(dev_bwd_tiled.values()),
                             "launches_by_path": {
                                 "train": train_rec["launches"]["bwd"],
                                 **node_bwd_tiled, **fam_bwd,
                                 **mcm_bwd_tiled, **nf_bwd_tiled,
                                 **dev_bwd_tiled},
                             "rel_hm": shape_times(hm_bwd[:2]),
                             "text": shape_times(ktext["bwd_tiled"]),
                             "family": shape_times(kern["family_bwd"]),
                             "ports": shape_times(kern["ports_bwd"]),
                             "reduce_launches":
                                 train_rec["launches"]["reduce"]
                             + sum(mcm_bwd_tiled.values())
                             + sum(nf_bwd_tiled.values())
                             + sum(dev_bwd_tiled.values()),
                             "max_rel_err": max(max(r["max_rel_err"].values())
                                                for r in kern["bwd"]),
                             "library_masked": False}),
            kernel_entry("column_attention_fwd_split", 165,
                         kern["ssl_fwd"], kern["ssl_fwd_unmasked"], {
                             "path": "ssl_train, transfer, tabular_mcm, "
                                     "mcm_edge (tabgnnfused), ssl_moco, "
                                     "mcm_parity, eth_ssl, "
                                     "node_family_parity (ssl), device_ssl, "
                                     "Rel-H&M mcm-lp",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "launches": sum(split_fwd.values())
                             + sum(mcm_fwd_split.values())
                             + sum(eth_fwd_split.values())
                             + sum(dev_fwd_split.values()),
                             "launches_by_path": {**split_fwd,
                                                  **mcm_fwd_split,
                                                  **eth_fwd_split,
                                                  **dev_fwd_split},
                             "split_launches":
                                 ssl_rec["train_launches"]["fwd_split"]
                                 + ssl_rec["eval_launches"]["fwd_split"]
                                 + transfer_split["fwd"]
                                 + sum(mcm_fwd_split.values())
                                 + sum(eth_fwd_split.values())
                                 + sum(dev_fwd_split.values()),
                             "rel_hm": shape_times(hm_fwd[2:]),
                             "core_max_abs_err": max(
                                 r["core_max_abs_err"]
                                 for r in kern["ssl_fwd"]),
                             # the SSL path's float32 tokens at bf16
                             "launches_under_bf16":
                                 ssl16["train_launches"]["fwd_split"]
                                 + ssl16["eval_launches"]["fwd_split"]
                                 + ssl_parity16["launches"]["fwd_split"],
                             "narrow": shape_times(kern["narrow_fwd"]),
                             "c100": shape_times([kern["c100_fwd"]]),
                             "transfer": shape_times(kern["transfer_fwd"]),
                             "library_masked": False}),
            kernel_entry("column_attention_bwd_split", 178,
                         kern["ssl_bwd"], kern["ssl_bwd_unmasked"], {
                             "path": "ssl_train, transfer, tabular_mcm, "
                                     "mcm_edge (tabgnnfused), ssl_moco "
                                     "(a pull a loss), mcm_parity, eth_ssl, "
                                     "node_family_parity (ssl), device_ssl, "
                                     "Rel-H&M mcm-lp",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "launches": sum(split_bwd.values())
                             + sum(mcm_bwd_split.values())
                             + sum(eth_bwd_split.values())
                             + sum(dev_bwd_split.values()),
                             "launches_by_path": {**split_bwd,
                                                  **mcm_bwd_split,
                                                  **eth_bwd_split,
                                                  **dev_bwd_split},
                             "split_launches":
                                 ssl_rec["train_launches"]["bwd_split"]
                                 + transfer_split["bwd"]
                                 + sum(mcm_bwd_split.values())
                                 + sum(eth_bwd_split.values())
                                 + sum(dev_bwd_split.values()),
                             "reduce_launches":
                                 ssl_rec["train_launches"]["reduce"]
                                 + transfer["train_launches"]["reduce"]
                                 + sum(mcm_bwd_split.values())
                                 + sum(eth_bwd_split.values())
                                 + sum(dev_bwd_split.values()),
                             "rel_hm": shape_times(hm_bwd[2:]),
                             "launches_under_bf16":
                                 ssl16["train_launches"]["bwd_split"]
                                 + ssl_parity16["launches"]["bwd_split"],
                             "max_rel_err": max(max(r["max_rel_err"].values())
                                                for r in kern["ssl_bwd"]),
                             "narrow": shape_times(kern["narrow_bwd"]),
                             "c100": shape_times([kern["c100_bwd"]]),
                             "transfer": shape_times(kern["transfer_bwd"]),
                             "library_masked": False}),
            kernel_entry("column_attention_fwd_long", 165,
                         klong["node_fwd"][:1], klong["node_fwd"][1:], {
                             "path": "node (node tokens, S = 167), the "
                                     "node families' node tokens (S = 129, "
                                     "130; the record's 18 and 129), "
                                     "device_node, device_parity (node, "
                                     "S = 21), the text LMs' 64-token rows "
                                     "(text_finetune, finetune_llm, "
                                     "text_parity)",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "core": "column_attention_fwd_core_long_kernel",
                             "launches": sum(node_fwd_split.values())
                             + sum(nf_fwd_long.values())
                             + sum(dev_fwd_long.values()),
                             "launches_by_path": {**node_fwd_split,
                                                  **nf_fwd_long,
                                                  **dev_fwd_long},
                             "families": shape_times(klong["family_fwd"]),
                             "core_max_abs_err": max(
                                 r["core_max_abs_err"]
                                 for r in klong["node_fwd"]),
                             "unmasked": shape_times(klong["node_fwd"][1:]),
                             "long": shape_times(klong["fwd"]),
                             "text": shape_times(ktext["fwd_long"]),
                             "library_masked": False}),
            kernel_entry("column_attention_bwd_long", 178,
                         klong["node_bwd"][:1], klong["node_bwd"][1:], {
                             "path": "node (node tokens, S = 167), the "
                                     "node families' node tokens (S = 129, "
                                     "130; the record's 18 and 129), "
                                     "device_node, device_parity (node, "
                                     "S = 21), the text LMs' 64-token rows "
                                     "(text_finetune, finetune_llm, "
                                     "text_parity)",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "core": "column_attention_bwd_core_long_kernel",
                             "launches": sum(node_bwd_split.values())
                             + sum(nf_bwd_long.values())
                             + sum(dev_bwd_long.values()),
                             "launches_by_path": {**node_bwd_split,
                                                  **nf_bwd_long,
                                                  **dev_bwd_long},
                             "families": shape_times(klong["family_bwd"]),
                             "max_rel_err": max(max(r["max_rel_err"].values())
                                                for r in klong["node_bwd"]),
                             "unmasked": shape_times(klong["node_bwd"][1:]),
                             "long": shape_times(klong["bwd"]),
                             "text": shape_times(ktext["bwd_long"]),
                             "text_budget": ktext["budget"],
                             "library_masked": False}),
            *bf16_entries(kern16, serve16, parity16, ssl16, ssl_parity16,
                          {"family": fam16, "node": node16,
                           "tabular": tab16, "text": text16,
                           "parity": bparity}),
            *wide_entries(kwide, wide)]})
        print(card, flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


def bf16_entries(kern16: dict, serve16: dict, parity16: dict, ssl16: dict,
                 ssl_parity16: dict, menu16: dict) -> list:
    """The ``kernels`` entries of the bf16 builds: the tiled pair at the
    main path's edge + node shapes (under --precision bf16 the path runs
    its node tokens through them, the edge tokens holding the float32
    timestamp block; so do fttransformer's node tokens and the node
    families' edge tokens) and the split pair at the SSL path's (whose
    tokens are float32 under bf16 too), whose launches are the long cores'
    on the node families' node tokens and the text LM's rows. ``menu16``:
    the phases of --precision bf16 across the menu (family_bf16,
    node_bf16, tabular_bf16, text_bf16, bf16_family_parity), whose
    launches count by route and dtype."""
    fwd, bwd = kern16["fwd"], kern16["bwd"]
    nn = len(NARROW_SHAPES)
    runs = {
        **{f"family_bf16 {m}": [r["train_launches"], r["eval_launches"],
                                r["serve_launches"]]
           for m, r in menu16["family"]["models"].items()},
        **{f"node_bf16 {n}": [r["train_launches"], r["eval_launches"],
                              r["serve_launches"]]
           for n, r in menu16["node"]["runs"].items()},
        "tabular_bf16": [menu16["tabular"]["launches"]],
        **{f"text_bf16 {p}": [r["launches"]]
           for p, r in menu16["text"]["paths"].items()},
        **{f"bf16_family_parity {n}": [r["forward_launches"], r["launches"]]
           for n, r in menu16["parity"]["parts"].items()}}

    def by_path(key):
        out = {path: sum(c[key] for c in cs) for path, cs in runs.items()}
        return {path: v for path, v in out.items() if v}

    tiled_fwd = {"serve_bf16": serve16["launches"]["fwd_bf16"],
                 "train_parity_bf16": parity16["launches"]["fwd_bf16"],
                 **by_path("fwd_tiled_bf16")}
    tiled_bwd = {"train_parity_bf16": parity16["launches"]["bwd_bf16"],
                 **by_path("bwd_tiled_bf16")}
    split_fwd = {"ssl_train_bf16": ssl16["train_launches"]["fwd_bf16"]
                 + ssl16["eval_launches"]["fwd_bf16"],
                 "ssl_parity_bf16": ssl_parity16["launches"]["fwd_bf16"],
                 **by_path("fwd_split_bf16")}
    split_bwd = {"ssl_train_bf16": ssl16["train_launches"]["bwd_bf16"],
                 "ssl_parity_bf16": ssl_parity16["launches"]["bwd_bf16"],
                 **by_path("bwd_split_bf16")}
    return [
        kernel_entry("column_attention_fwd_bf16", 165, fwd[0:2], fwd[0:2], {
            "path": "main, fttransformer (family_bf16), the node families' "
                    "edge tokens (node_bf16) at --precision bf16: the node "
                    "tokens", "dtype": "bf16",
            "launches": sum(tiled_fwd.values()),
            "launches_by_path": tiled_fwd,
            "masked_ms": sum(r["kernel_ms"] for r in fwd[2:4]),
            "masked_plain_ms": sum(r["plain_ms"] for r in fwd[2:4])}),
        kernel_entry("column_attention_bwd_bf16", 178, bwd[2:4], bwd[0:2], {
            "path": "main, fttransformer (family_bf16), the node families' "
                    "edge tokens (node_bf16) at --precision bf16: the node "
                    "tokens", "dtype": "bf16",
            "launches": sum(tiled_bwd.values()),
            "launches_by_path": tiled_bwd,
            "max_rel_err": max(max(r["max_rel_err"].values())
                               for r in bwd[2:4]),
            "library_masked": False}),
        kernel_entry("column_attention_fwd_split_bf16", 165, fwd[4:6],
                     fwd[6:8], {
                         "path": "the long cores at --precision bf16: the "
                                 "node families' node tokens (node_bf16, "
                                 "S = 130; the record's MUSAE, S = 129), "
                                 "the text LM's 64-token rows (text_bf16, "
                                 "the record's finetune); the SSL path's "
                                 "tokens are float32 under bf16",
                         "dtype": "bf16",
                         "includes": "rmm_tpu_torch/csrc/gemm_mma.cuh "
                                     "(C % 4 = 0), rmm_tpu_torch/csrc/"
                                     "gemm_f32.cuh (narrow)",
                         "launches": sum(split_fwd.values()),
                         "launches_by_path": split_fwd,
                         "long_launches_by_path": by_path("fwd_long_bf16"),
                         "narrow": shape_times(fwd[-nn:]),
                         "long": shape_times(kern16["long_fwd"]),
                         "paths": shape_times(kern16["path_fwd"]),
                         "library_masked": False}),
        kernel_entry("column_attention_bwd_split_bf16", 178, bwd[4:6],
                     bwd[6:8], {
                         "path": "the long cores at --precision bf16 (as "
                                 "the forward's)",
                         "dtype": "bf16",
                         "includes": "rmm_tpu_torch/csrc/gemm_mma.cuh "
                                     "(C % 4 = 0), rmm_tpu_torch/csrc/"
                                     "gemm_f32.cuh (narrow)",
                         "launches": sum(split_bwd.values()),
                         "launches_by_path": split_bwd,
                         "long_launches_by_path": by_path("bwd_long_bf16"),
                         "max_rel_err": max(max(r["max_rel_err"].values())
                                            for r in bwd[4:6]),
                         "narrow": shape_times(bwd[-nn:]),
                         "long": shape_times(kern16["long_bwd"]),
                         "paths": shape_times(kern16["path_bwd"]),
                         "library_masked": False})]


def wide_entries(kwide: dict, wide: dict) -> list:
    """The ``kernels`` entries of the wide widths (the split routes at
    C = 256, their cores staged) and of the long cores' direct form: each
    direction's record at wide_paths' SSL lanes at --channels 256 (0.5
    keep-mask; the library time unmasked), resp. at its Elliptic node rows
    at --n_hidden 256 (0.083), their launches on ``wide_paths`` by path,
    the other wide shapes' times beside, float32 and bf16."""

    def at(recs, shape, rate=None):
        shape = (*shape[:4], shape[4] if rate is None else rate)
        return [next(r for r in recs if (r["B"], r["S"], r["C"], r["H"],
                                         r["dropout"]) == shape)]

    runs = {"wide_paths tabgnn": [wide["aml_f32"], wide["aml_bf16"]],
            "wide_paths mcm-lp": [wide["ssl"]],
            "wide_paths elliptic": [wide["elliptic"]]}

    def by_path(key):
        out = {path: sum(r["train_launches"][key] + r["eval_launches"][key]
                         for r in rs) for path, rs in runs.items()}
        return {path: v for path, v in out.items() if v}

    entries = []
    for d, line in (("fwd", 165), ("bwd", 178)):
        recs, recs16 = kwide[d], kwide[f"{d}_bf16"]
        split, direct = by_path(f"{d}_split"), by_path(f"{d}_direct")
        staged = {p: n - direct.get(p, 0) for p, n in split.items()}
        entries += [
            kernel_entry(f"column_attention_{d}_wide", line,
                         at(recs, wide["ssl_lanes"]),
                         at(recs, wide["ssl_lanes"], 0.0), {
                             "path": "wide_paths: tabgnn at --n_hidden 256 "
                                     "(float32 and bf16), mcm-lp at "
                                     "--channels 256, Elliptic's edge "
                                     "tokens at --n_hidden 256",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh, "
                                         "rmm_tpu_torch/csrc/gemm_mma.cuh "
                                         "(bf16)",
                             "launches": sum(staged.values()),
                             "launches_by_path": staged,
                             "bf16_launches_by_path": by_path(f"{d}_bf16"),
                             "wide": shape_times([r for r in recs
                                                  if r["S"] <= 16]),
                             "bf16": shape_times(recs16),
                             "library_masked": False}),
            kernel_entry(f"column_attention_{d}_direct", line,
                         at(recs, wide["elliptic_rows"]),
                         at(recs, wide["elliptic_rows"], 0.0), {
                             "path": "wide_paths: Elliptic's node tokens "
                                     "(S = 167) at --n_hidden 256",
                             "core": f"column_attention_{d}_core_stream"
                                     "_kernel",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "launches": sum(direct.values()),
                             "launches_by_path": direct,
                             "long": shape_times([r for r in recs
                                                  if r["direct"]]),
                             "bf16": shape_times([r for r in recs16
                                                  if r["S"] > 16]),
                             "library_masked": False})]
    return entries


def shape_times(recs: list) -> dict:
    """A split entry's times at more shapes (the narrow ones, C not a
    multiple of 4; the transfer path's), by shape: kernel, plain, library
    (unmasked only) and bound ms, and the largest error."""
    return {f'{r["B"]}x{r["S"]}x{r["C"]}/{r["H"]} p={r["dropout"]}': {
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "max_abs_err": r["max_abs_err"]}
        for r in recs}


def kernel_entry(name: str, line: int, pair: list, lib_pair: list,
                 extra: dict) -> dict:
    """One ``kernels`` entry: an edge + node pair of records, which is what
    one layer of one batch launches (its bound from the pair's summed bytes
    and operations); ``lib_pair`` gives the library time."""
    bound_ms, by = bound(sum(r["bytes_ms"] for r in pair),
                         sum(r["ops_ms"] for r in pair))
    return {"name": name, "route": "cuda",
            "source": "rmm_tpu_torch/csrc/column_attention.cu",
            "replaces": f"rmm_tpu/ops/pallas/column_attention.py:{line}",
            "max_abs_err": max(r["max_abs_err"] for r in pair),
            "ms": sum(r["kernel_ms"] for r in pair),
            "plain_ms": sum(r["plain_ms"] for r in pair),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": sum(r["library_ms"] for r in lib_pair),
            "shapes": [[r[k] for k in "BSCH"] + [r["dropout"]]
                       for r in pair], **extra, "ok": True}


if __name__ == "__main__":
    sys.exit(main())
