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
             capacity, C = 128, a ragged batch, a numpy keep-mask); the
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
             without it). Each record names the route it took (tiled or
             split, by width and S, held to ``route(c, s)``), and two
             calls of each direction at the main path's masked edge shape,
             at the SSL and the transfer masked edge shapes and at the
             masked 32768x6x126/6 are bitwise equal. Max error (the
             backward's relative to each reference tensor's largest
             entry), kernel / plain / library times (CUDA events, warm,
             median) and the bound.
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
             at C = 32 and at C = 128, each with the 0.083 keep-mask and
             without it
             (records as the kernel phase's; two calls bitwise equal at the
             node shape).
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
             unmasked); the split route's GEMMs on the tensor cores at
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
(the bf16 records: ``tools/make_torch_port_bf16_fixture.py``).

Then the seconds each phase took, a ``{"kernels": [...]}`` line (an entry
per kernel, each with its ``path``: the main path's tiled kernels at C = 32
(with the node path's edge tokens and the families' calls, their launches
by path and their times at the families' shapes beside), the SSL and
transfer paths' split forward and backward at C = 128 (their launches by
path), with their times at the transfer and the narrow shapes beside, the split routes at S > 16
(the node path's node tokens: their times at the node shape and at the
other long shapes), and the bf16 builds of the tiled and split kernels,
likewise),
the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside it, the script fails and prints no result.
"""
from __future__ import annotations

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


def family_counts(model: str, fwd: int, bwd: int) -> dict:
    """The launches of ``fwd`` forwards and ``bwd`` backwards of a family,
    every one tiled, float32."""
    k = FAMILY_CALLS[model]
    return {"fwd": k * fwd, "fwd_tiled": k * fwd, "fwd_split": 0,
            "bwd": k * bwd, "bwd_tiled": k * bwd, "bwd_split": 0,
            "reduce": k * bwd, **NO_BF16}


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


def fwd_record(rng, dev, b, s, c, h, rate, card, repeat=False) -> dict:
    """The forward at one shape (seeded inputs, a keep-mask where ``rate``
    > 0) against its plain version on the card: the route it took (held to
    ``route(c, s)``), two calls bitwise equal where ``repeat``, the split
    forward's core alone against its twin, kernel / plain / library times
    and the bound."""
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    x, wqkv, bqkv, wout, bout = random_inputs(rng, b, s, c, dev)
    mask = None
    if rate > 0:
        mask = torch.from_numpy(rng.rand(b, h, s, s) >= rate).to(dev)
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
        k_ms = time_ms(lambda: ca.fused_column_attention(*args))
        p_ms = time_ms(lambda: ca.reference_column_attention(*args))
        lib_ms = None
        if mask is None:   # no library call takes an explicit keep-mask
            lib = (x, wqkv, bqkv, wout, bout, h)
            lib_err = float((library_attention(*lib) - ref).abs().max())
            check(lib_err <= KERNEL_TOL,
                  f"library attention disagrees: {lib_err}")
            lib_ms = time_ms(lambda: library_attention(*lib))
    t_bytes, t_ops = attention_floor(b, s, c, h, mask is not None)
    bound_ms, by = bound(t_bytes, t_ops)
    plan = ca.fwd_plan(b, s, c, h)
    rec = {"phase": "kernel", "kernel": "column_attention_fwd",
           "B": b, "S": s, "C": c, "H": h, "dropout": rate,
           "route": route, "rows": plan.rows, "blocks": plan.grid,
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


def bwd_record(rng, dev, b, s, c, h, rate, card, repeat=False) -> dict:
    """The backward (and its reduce) at one shape against
    ``torch.autograd.grad`` of the plain version: the route (held to
    ``route(c, s)``), two calls bitwise equal where ``repeat``, each
    gradient's error relative to its largest entry, kernel / plain /
    library times and the bound."""
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    inputs = random_inputs(rng, b, s, c, dev)
    do = random_inputs(rng, b, s, c, dev)[0]
    mask = None
    if rate > 0:
        mask = torch.from_numpy(rng.rand(b, h, s, s) >= rate).to(dev)
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
    k_ms = time_ms(lambda: ca.column_attention_bwd(*args))
    p_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True))
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
            lib_out, leaves, do, retain_graph=True))
        del lib_out, lib_dx
    plan = ca.bwd_plan(b, s, c, h)
    t_bytes, t_ops = attention_bwd_floor(b, s, c, h, mask is not None)
    bound_ms, by = bound(t_bytes, t_ops)
    rec = {"phase": "kernel", "kernel": "column_attention_bwd",
           "B": b, "S": s, "C": c, "H": h, "dropout": rate,
           "route": route, "rows": plan.rows,
           "blocks": plan.grid, "slices": plan.slices,
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
        (4099, 6, 64, 4, 0.3),       # numpy keep-mask, dropout 0.3
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
                      repeat=i == 2 or shape in repeat)
           for i, shape in enumerate(fwd_shapes)]
    bwd = [bwd_record(rng, dev, *shape, card,
                      repeat=i == 0 or shape in repeat)
           for i, shape in enumerate(bwd_shapes)]
    f = len(extra)
    fwd, fam_fwd = fwd[:-f], fwd[-f:]
    bwd, fam_bwd = bwd[:-f], bwd[-f:]
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
    cores take at C = 32 and at C = 128 (8 heads)."""
    from rmm_tpu_torch.ops import column_attention as ca

    shapes = [(node_capacity, NODE_S, 32, 8), (4096, 17, 32, 8),
              (4096, 65, 32, 8), (4096, 40, 128, 8),
              (4096, ca.max_s(32, 8), 32, 8),
              (4096, ca.max_s(128, 8), 128, 8)]
    return [(*shape, rate) for shape in shapes
            for rate in (TRAIN_DROPOUT, 0.0)]


def kernel_long_phase(card: str, node_capacity: int) -> dict:
    """Both directions at S > 16 against the plain twin on the card
    (:func:`long_shapes`), each through the split route; two calls of each
    direction bitwise equal at the node shape. Returns the records of the
    node shape (masked, then unmasked) and of the other shapes."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    shapes = long_shapes(node_capacity)
    fwd = [fwd_record(rng, dev, *shape, card, repeat=i < 2)
           for i, shape in enumerate(shapes)]
    bwd = [bwd_record(rng, dev, *shape, card, repeat=i < 2)
           for i, shape in enumerate(shapes)]
    check(all(r["route"] == "split" for r in fwd + bwd),
          "a row past 16 tokens did not take the split route")
    return {"node_fwd": fwd[:2], "node_bwd": bwd[:2], "fwd": fwd[2:],
            "bwd": bwd[2:]}


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


def kernel_bf16_phase(card: str) -> dict:
    """Both directions on bf16 x, do and weights against their plain twin
    on the same values: out and dx within one bf16 rounding, the float32
    weight and bias gradients at GRAD_TOL; two calls of each direction
    bitwise equal at the masked edge shapes, at C = 100 and at the masked
    node shape past S = 16; kernel / plain / library
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
    repeat_at = {shapes[2], shapes[4], shapes[8], NARROW_SHAPES[0], long[0]}
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    recs = {"fwd": [], "bwd": [], "long_fwd": [], "long_bwd": []}
    for b, s, c, h, rate in shapes + long:
        key = "long_" if s > 16 else ""
        x, *weights = (t.bfloat16() for t in random_inputs(rng, b, s, c,
                                                           dev))
        do = random_inputs(rng, b, s, c, dev)[0].bfloat16()
        masters = [w.float() for w in weights]   # the weights' values
        mask = None
        if rate > 0:
            mask = torch.from_numpy(rng.rand(b, h, s, s) >= rate).to(dev)
        args = (x, *weights, h, mask, rate)
        repeat = (b, s, c, h, rate) in repeat_at
        kind = ca.route(c, s)
        check(kind == "split" or ((b, s, c, h, rate) not in NARROW_SHAPES
                                  and s <= 16),
              f"bf16 {b}x{s}x{c}/{h} does not take the split route")
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
            k_ms = time_ms(lambda: ca.fused_column_attention(*args))
            p_ms = time_ms(lambda: ca.reference_column_attention(
                x, *masters, h, mask, rate))
            lib_ms = None
            if mask is None:
                lib = (x, *weights, h)
                lib_err = float((library_attention(*lib).float()
                                 - ref.float()).abs().max())
                check(lib_err <= LIBRARY_BF16_TOL * float(
                    ref.float().abs().max()),
                      f"bf16 library attention disagrees: {lib_err}")
                lib_ms = time_ms(lambda: library_attention(*lib))
        t_bytes, t_ops = attention_floor(b, s, c, h, mask is not None, 2,
                                         PEAK_BF16_FLOP_PER_S)
        bound_ms, by = bound(t_bytes, t_ops)
        rec = {"phase": "kernel_bf16", "kernel": "column_attention_fwd",
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
        recs[key + "fwd"].append(rec)
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
        k_ms = time_ms(lambda: ca.column_attention_bwd(*bargs))
        p_ms = time_ms(lambda: torch.autograd.grad(ref, leaves, do,
                                                   retain_graph=True))
        lib_ms = None
        if mask is None:
            lib_leaves = [x.detach().requires_grad_()] + [
                w.detach().requires_grad_() for w in weights]
            lib_out = library_attention(*lib_leaves, h)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, lib_leaves, do, retain_graph=True))
            del lib_out, lib_leaves
        t_bytes, t_ops = attention_bwd_floor(b, s, c, h, mask is not None, 2,
                                             PEAK_BF16_FLOP_PER_S)
        bound_ms, by = bound(t_bytes, t_ops)
        rec = {"phase": "kernel_bf16", "kernel": "column_attention_bwd",
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
        recs[key + "bwd"].append(rec)
        del x, do, weights, masters, mask, got, leaves, ref, want
        torch.cuda.empty_cache()
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

    import numpy as np

    from rmm_tpu_torch.convert import check_record, from_jax, loss_terms, \
        random_variables
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = np.load(TRAIN_BF16_FIXTURE)
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
    import numpy as np

    rec = np.load(path)
    st = json.loads(str(rec["settings"]))
    return rec, {**st, **st["ssl"]} if "ssl" in st else st


def ssl_trainer(csv: str, argv: list[str], edge_capacity: int,
                node_capacity: int, seed: int = 1):
    """The port's PretrainTrainer on the card, configured by the SSL CLI's
    parser from ``argv`` (the SSL config of record's flags)."""
    from rmm_tpu_torch.cli import fused
    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.train.pretrain import PretrainTrainer

    cfg = fused.config_from_args(fused.build_parser().parse_args(
        ["--dataset", csv, *argv, "--device", "cuda"])).replace(
        edge_capacity=edge_capacity, node_capacity=node_capacity, seed=seed)
    return PretrainTrainer(cfg, build_dataset(cfg), "mcm-lp")


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

    import numpy as np
    import torch

    from rmm_tpu_torch.convert import (check_record, from_jax, loss_terms,
                                       random_variables, torch_key)
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.checkpoint import load_components
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = np.load(TRANSFER_FIXTURE)
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
            "test_ids": labelled[:, 1].astype(np.int64)}


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

    from rmm_tpu_torch.convert import (check_record, from_jax, loss_terms,
                                       random_variables, torch_key)
    from rmm_tpu_torch.datasets import (build_dataset,
                                        write_synthetic_node_dataset)
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = np.load(NODE_FIXTURE)
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

    from rmm_tpu_torch.convert import (check_record, from_jax, loss_terms,
                                       random_variables, torch_key)
    from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
    from rmm_tpu_torch.nn.dropout import set_rate
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec = np.load(FAMILY_FIXTURE)
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
            timed("train_parity", train_parity_phase, card)
            family = timed("family_train", family_train_phase, card, csv)
            fparity = timed("family_parity", family_parity_phase, card)
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
            node_root = timed("node_data", prepare_node_data)
            node = timed("node_train", node_train_phase, card, node_root)
            klong = timed("kernel_long", kernel_long_phase, card,
                          node["node_capacity"])
            node_serve = timed("node_serve", node_serve_phase, card,
                               node_root, node)
            node_parity = timed("node_parity", node_parity_phase, card)
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
        emit({"kernels": [
            kernel_entry("column_attention_fwd", 165, kern["fwd"],
                         kern["fwd"], {
                             "path": "main, node (edge tokens), families "
                                     "(fttransformer, tabgnninterleaved, "
                                     "cpnatab)",
                             "launches": serve_rec["launches"]
                             + train_rec["launches"]["fwd"]
                             + sum(node_fwd_tiled.values())
                             + sum(fam_fwd.values()),
                             "tiled_launches": serve_rec["tiled_launches"]
                             + train_rec["launches"]["fwd_tiled"]
                             + sum(node_fwd_tiled.values())
                             + sum(fam_fwd.values()),
                             "launches_by_path": {
                                 "serve": serve_rec["launches"],
                                 "train": train_rec["launches"]["fwd"],
                                 **node_fwd_tiled, **fam_fwd},
                             "family": shape_times(kern["family_fwd"]),
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
                                     "cpnatab)",
                             "launches": train_rec["launches"]["bwd"]
                             + sum(node_bwd_tiled.values())
                             + sum(fam_bwd.values()),
                             "tiled_launches":
                                 train_rec["launches"]["bwd_tiled"]
                             + sum(node_bwd_tiled.values())
                             + sum(fam_bwd.values()),
                             "launches_by_path": {
                                 "train": train_rec["launches"]["bwd"],
                                 **node_bwd_tiled, **fam_bwd},
                             "family": shape_times(kern["family_bwd"]),
                             "reduce_launches":
                                 train_rec["launches"]["reduce"],
                             "max_rel_err": max(max(r["max_rel_err"].values())
                                                for r in kern["bwd"]),
                             "library_masked": False}),
            kernel_entry("column_attention_fwd_split", 165,
                         kern["ssl_fwd"], kern["ssl_fwd_unmasked"], {
                             "path": "ssl_train, transfer",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "launches": sum(split_fwd.values()),
                             "launches_by_path": split_fwd,
                             "split_launches":
                                 ssl_rec["train_launches"]["fwd_split"]
                                 + ssl_rec["eval_launches"]["fwd_split"]
                                 + transfer_split["fwd"],
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
                             "path": "ssl_train, transfer",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "launches": sum(split_bwd.values()),
                             "launches_by_path": split_bwd,
                             "split_launches":
                                 ssl_rec["train_launches"]["bwd_split"]
                                 + transfer_split["bwd"],
                             "reduce_launches":
                                 ssl_rec["train_launches"]["reduce"]
                                 + transfer["train_launches"]["reduce"],
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
                             "path": "node (node tokens, S = 167)",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "core": "column_attention_fwd_core_long_kernel",
                             "launches": sum(node_fwd_split.values()),
                             "launches_by_path": node_fwd_split,
                             "core_max_abs_err": max(
                                 r["core_max_abs_err"]
                                 for r in klong["node_fwd"]),
                             "unmasked": shape_times(klong["node_fwd"][1:]),
                             "long": shape_times(klong["fwd"]),
                             "library_masked": False}),
            kernel_entry("column_attention_bwd_long", 178,
                         klong["node_bwd"][:1], klong["node_bwd"][1:], {
                             "path": "node (node tokens, S = 167)",
                             "includes": "rmm_tpu_torch/csrc/gemm_f32.cuh",
                             "core": "column_attention_bwd_core_long_kernel",
                             "launches": sum(node_bwd_split.values()),
                             "launches_by_path": node_bwd_split,
                             "max_rel_err": max(max(r["max_rel_err"].values())
                                                for r in klong["node_bwd"]),
                             "unmasked": shape_times(klong["node_bwd"][1:]),
                             "long": shape_times(klong["bwd"]),
                             "library_masked": False}),
            *bf16_entries(kern16, serve16, parity16, ssl16, ssl_parity16)]})
        print(card, flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


def bf16_entries(kern16: dict, serve16: dict, parity16: dict, ssl16: dict,
                 ssl_parity16: dict) -> list:
    """The ``kernels`` entries of the bf16 builds: the tiled pair at the
    main path's edge + node shapes (under --precision bf16 the path runs
    its node tokens through them, the edge tokens holding the float32
    timestamp block) and the split pair at the SSL path's (whose tokens
    are float32 under bf16 too: the split bf16 kernels run in the kernel
    phase alone)."""
    fwd, bwd = kern16["fwd"], kern16["bwd"]
    nn = len(NARROW_SHAPES)
    tiled_fwd = {"serve_bf16": serve16["launches"]["fwd_bf16"],
                 "train_parity_bf16": parity16["launches"]["fwd_bf16"]}
    split_fwd = {"ssl_train_bf16": ssl16["train_launches"]["fwd_bf16"]
                 + ssl16["eval_launches"]["fwd_bf16"],
                 "ssl_parity_bf16": ssl_parity16["launches"]["fwd_bf16"]}
    return [
        kernel_entry("column_attention_fwd_bf16", 165, fwd[0:2], fwd[0:2], {
            "path": "main at --precision bf16: the node tokens",
            "dtype": "bf16", "launches": sum(tiled_fwd.values()),
            "launches_by_path": tiled_fwd,
            "masked_ms": sum(r["kernel_ms"] for r in fwd[2:4]),
            "masked_plain_ms": sum(r["plain_ms"] for r in fwd[2:4])}),
        kernel_entry("column_attention_bwd_bf16", 178, bwd[2:4], bwd[0:2], {
            "path": "main at --precision bf16: the node tokens",
            "dtype": "bf16", "launches": parity16["launches"]["bwd_bf16"],
            "launches_by_path": {
                "train_parity_bf16": parity16["launches"]["bwd_bf16"]},
            "max_rel_err": max(max(r["max_rel_err"].values())
                               for r in bwd[2:4]),
            "library_masked": False}),
        kernel_entry("column_attention_fwd_split_bf16", 165, fwd[4:6],
                     fwd[6:8], {
                         "path": "kernel phase (the SSL path's tokens are "
                                 "float32 under bf16)",
                         "dtype": "bf16",
                         "includes": "rmm_tpu_torch/csrc/gemm_mma.cuh "
                                     "(C % 4 = 0), rmm_tpu_torch/csrc/"
                                     "gemm_f32.cuh (narrow)",
                         "launches": sum(split_fwd.values()),
                         "launches_by_path": split_fwd,
                         "narrow": shape_times(fwd[-nn:]),
                         "long": shape_times(kern16["long_fwd"]),
                         "library_masked": False}),
        kernel_entry("column_attention_bwd_split_bf16", 178, bwd[4:6],
                     bwd[6:8], {
                         "path": "kernel phase (the SSL path's tokens are "
                                 "float32 under bf16)",
                         "dtype": "bf16",
                         "includes": "rmm_tpu_torch/csrc/gemm_mma.cuh "
                                     "(C % 4 = 0), rmm_tpu_torch/csrc/"
                                     "gemm_f32.cuh (narrow)",
                         "launches": ssl16["train_launches"]["bwd_bf16"]
                         + ssl_parity16["launches"]["bwd_bf16"],
                         "max_rel_err": max(max(r["max_rel_err"].values())
                                            for r in bwd[4:6]),
                         "narrow": shape_times(bwd[-nn:]),
                         "long": shape_times(kern16["long_bwd"]),
                         "library_masked": False})]


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
