#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and hold it to account.

Usage (from the repository root, on a machine with one CUDA card)::

    python3 chip_smoke.py                 # full size: 1,710,670 Porto taxi trips
    python3 chip_smoke.py --n-traj 20000  # a cut, printed as {"reduced": ...}

Phases, each fatal on failure (nothing is caught):

1. the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started together);
2. the file path, with every kernel's launch count set to 0 just before:
   ``write_file`` of a Hilbert-sorted, checksummed float64 Porto-taxi file
   with three extra columns (``duration_s`` float32 reaches the page-stats
   kernel), then five ``read_columnar`` calls on ``device="cuda"``: bbox
   reads with ``refine=True`` at about 1 %, 10 % and 50 % record
   selectivity, one adding ``filter=Range("duration_s", ...)``, one with
   ``keep_on_device=True``. Each read is held exactly (bit patterns) against
   a numpy oracle computed from the generated columns, independent of both
   packages' readers. Every kernel must have launched at least once;
3. each kernel against its plain PyTorch version on the same CUDA tensors,
   the page stream's escape resolution and descriptor expansion
   (``csrc/stream_expand.cu``) against the plain host resolution and
   expansion of every stream below (the resolution also on pages of token
   widths 1, W - 1 and 8 over wild bits, see :func:`escape_cases`), and the
   decode's plain version fed that host expansion, never the card's,
   at the main path's shapes and on adversarial inputs (W = 32 and 64,
   escapes, raw pages, NaN, ±inf, ±0, denormals, NaN and all-NaN pages;
   for the decode also a 4.2 M value page with one anchor, all-anchor
   streams, 1, 1,057 and 2,115 stream blocks, two calls back to back and
   four threads calling at once, see :func:`decode_cases`; for the page
   min/max also a 1<<20-value page, 10,000 empty pages among real ones,
   ragged bounds and values 4 and 12 bytes off a 16-byte boundary, calls
   back to back and from four threads, see :func:`minmax_page_cases`);
   the tolerance is exact equality of bit patterns. Times come from CUDA
   events around ten calls after warm-up (``kernel_ms``) and from a
   ``torch.profiler`` trace of ten more (``device_ms``: the kernels' own
   time, without host dispatch);
4. the LM path, with every launch count set to 0 just before: qwen3-8b at
   its published widths and depth (36 layers, d_model 4096, 32/8 heads,
   head_dim 128, qk-norm, vocab 151936; bf16 compute over float32
   parameters drawn on the card from a seeded generator) with
   ``attn_impl="flash"``: ``forward`` on (2, 4096) tokens (train_4k's
   sequence length, its batch of 256 cut to 2) must launch the flash kernel
   once per layer; a ``BatchedServer(max_batch=4, max_len=256)`` then
   answers 8 requests of 16-64 random tokens, 16 new tokens each, as a
   functional check; a second server (``max_batch=32``) answers 128 such
   requests of 128 new tokens, submitted at once, and its wall time,
   tokens/s and TTFT / latency percentiles are the serving measurement. The
   logits are held against the same forward with the plain attention
   (``attn_impl="ref"``) and both against a float32 forward (see
   :func:`lm_path` for the rules). A ``torch.profiler`` trace of one more
   forward and of one decode step (batch 32) splits their device time by
   kernel group. Then the float32 route, every count set to 0 just before:
   the same forward in float32 compute with ``attn_impl="flash"`` must
   launch the split-TF32 flash kernel once per layer (and the sm90 kernel
   never) and lie no farther from the float32 plain forward than the bf16
   plain forward does;
5. both flash kernels against their plain version through ``ops.attention``
   (see :func:`check_flash` for the tolerances): bf16 (the sm90 ``wgmma``
   kernel) and float32 (the split-TF32 ``mma.sync`` kernel) at the LM
   path's shape and at the reference's six test shapes (GQA, rectangular,
   single-token, ragged, non-causal), float32 also at two causal shapes
   with Sq > Sk, whose rows that see no key must be exactly 0; then the
   times at the LM shape of the sm90 kernel, the plain version and SDPA (a
   yardstick the port never calls) on bf16 inputs, and of the split-TF32
   kernel, the plain version and SDPA on float32 ones. The float32
   library's tensor-core instructions (``HMMA`` in ``cuobjdump -sass``)
   are counted.

Between phases 3 and 4 run the four paths added after them, in the order
3a, 3c, 3d, 3b (3c and 3d read the lake 3a writes):

3a. the dataset path, with every launch count set to 0 just before:
    ``write_dataset`` of the same Porto columns and extras into 16
    Hilbert-partitioned shards on ``device="cuda"``, then five
    ``SpatialDatasetScanner(max_workers=4).scan`` calls on ``"cuda"`` with
    the file path's boxes, filter and ``keep_on_device``. Each scan is held
    exactly against the numpy oracle in the dataset's record order (one
    global Hilbert sort split 16 ways), and its ``ReadStats`` (shards and
    pages read and total, records) against the oracle's own shard and page
    layout. Kernels 1-3 and the expansion must each launch;
3b. the codec path, with every launch count set to 0 just before:
    ``compress_array`` then ``decompress_array`` on the card of the Porto x
    and y columns cast to float32, exact to the bit, with the compressed
    size against the host paper-exact ``fp_delta_encode`` of the same
    array. Then both codec kernels against their plain versions at that
    shape and on adversarial blocks (see :func:`codec_blocks`; and 1, 7
    and 5,000 blocks drawn from them), exact in all six encode outputs and
    the decoded bits; and the decode on streams encode never writes
    (:func:`decode_malformed`: repeated live exception slots, which sum,
    positions and counts out of range, unknown widths), exact against the
    plain version;
3c. the serve path, over the lake of 3a, with every launch count set to 0
    just before each server: ``SpatialQueryServer(device="cuda",
    cache_rgs=32, max_wave=64)`` answers 1, 16 and 32 bbox queries (boxes
    cycling 1, 5, 10, 25 and 50 % record selectivity, the reference serve
    benchmark's traffic), each count on a fresh server; the 32-query server
    then answers the same 32 boxes again, which must decode nothing (no
    ``device.refine_multi_launch`` span, no kernel launch: the row groups
    come from the cache on the card). Every query is held exactly against
    the dataset oracle (coordinates, extras, ``ReadStats``); after
    ``invalidate()`` the device memory must be back at its level from
    before the server. The five distinct boxes as solo sequential
    ``scan(refine=True, parallel=False)`` calls give the unshared baseline.
    Kernels 1 and 2 must launch in each wave of decodes; every counter is
    read after every wave and summed into ``launches_serve``. Kernels 1
    and 2 are then timed once at the serve tier's own shape (a whole row
    group's first device chunk, ``serve_shape`` on their kernel lines),
    held against their plain versions there;
3d. the data feed, every count set to 0 just before: ``Prefetcher(
    TrajectoryBatcher([lake], GeoTokenizer(PORTO_BBOX, order=6),
    seq_len=128, global_batch=16, bbox=<the 10 % box>, loop=False))`` (the
    reference pipeline benchmark's settings) run to its end on ``"cuda"``,
    then the same on ``"host"``: every batch equal bit for bit, kernels 1
    and 2 launched on the card and nothing on the host.

After phase 5 runs phase 4c, the other LM families, every launch count set
to 0 just before it (read after it: ``launches_families`` on the kernel
lines, kernel 6's summed with phase 4's into ``launches``):

4c. (a) spatial-lm (the paper's Mamba2 trajectory LM, at
    ``GeoTokenizer(PORTO_BBOX, order=6)``'s vocab of 4,099, float32, seeded
    weights) serving the lake: the first 16 batches of 3d's
    ``TrajectoryBatcher`` on ``"cuda"`` (kernels 1 and 2 launch) give 256
    prompts of 16 tokens (BOS + 15 cells, as ``examples/serve_lm.py``
    sends); ``BatchedServer(max_batch=32, max_len=192)`` answers all of
    them at once with 64 new tokens each (wall, tokens/s, TTFT and latency
    percentiles). The first wave's prefill logits are held against the same
    call on the CPU, and the share of the first wave's greedy tokens equal
    to a CPU server's is printed (see :func:`spatial_lm_serve`);
    (b) each other family alone at its published widths and depth (arctic
    at 2 of 35 layers), bf16 compute over the config's ``param_dtype``,
    freed before the next: ``forward`` on (2, 4096) (whisper with 2,048
    frames, pixtral with 256 patches and 3,840 tokens) launches kernel 6
    once per attention call where ``attn_impl="flash"`` (whisper's 24
    encoder calls non-causal), its logits held against the plain attention
    and a float32 forward; prefill + one decode step against the forward in
    float32; a ``BatchedServer(max_batch=4)`` answers 8 requests; at full
    width qwen2-moe's ``moe_block`` against a compute-all-experts loop and
    mamba2's ``ssm_forward`` against its stepped recurrence (see
    :func:`family_run`). One ``lm_family`` line each.

Last runs phase 4d, training, over the same lake, every launch count set to
0 just before it. ``launches_train`` on the kernel lines counts its training
paths: (a) up to the end of its fault drill, then (b) and (c); the step
timings after (a)'s drill read a batcher of their own, counted apart as
``measurement_launches``:

4d. (a) spatial-lm at its published widths (12 Mamba2 layers, d_model 512,
    d_state 64, headdim 32, tied embeddings, float32; vocab 4,099 as the
    training CLI sets it) trained by ``run_train_loop`` from seeded weights
    with AdamW at the CLI's defaults (seq 256, global batch 8, lr 3e-4, 200
    steps, a compressed checkpoint every 50), fed by the CLI's own feed,
    ``Prefetcher(trajectory_batcher(lake, device="cuda"))``, whose batcher
    reads with no box, as the reference's CLI does, so each shard read
    decodes on the card and is not refined (kernel 1 must launch, kernel 2
    must not). The
    first step's loss and every gradient leaf are held against the same
    step on the CPU (see :func:`train_path`); the last logged loss must be
    below the first; the last checkpoint, decoded on the host, must equal
    the card's parameters and optimizer state bit for bit; a second run to
    250 steps must resume at 200; a run with ``fail_at_step`` must raise
    and a rerun resume from its last checkpoint. Printed: steps/s,
    tokens/s, one step's device split, the checkpoint's ratio and write
    seconds, the feed's stalls, and a step at (32, 512);
    (b) qwen3-8b at its published widths, 2 of its 36 layers, bf16 compute
    over float32 parameters, ``attn_impl="ref"``, its shipped
    ``remat="full"``: AdamW for 5 steps on one
    repeated (2, 4096) synthetic batch, accumulated over 2 microbatches of
    one (the config's ``grad_accum`` of 16, clamped to the batch); the loss
    must fall, the first loss lie within phase 4's bf16 noise of a
    float32-compute loss, and the first step's gradient leaves within 2^-4
    (normwise) of float32-compute ones (see :func:`dense_train`); peak
    memory beside its reckoning;
    (c) internlm2-1.8b as shipped (``remat="full"``, ``"blocked"``
    attention) at its published widths and full depth, 24 layers: the
    ``remat`` modes none, full and selective side by side at 4 layers and
    (1, 4096), gradients equal within the floor of two none runs; then 3
    AdamW steps on one (2, 4096) batch (2 microbatches of 1), the loss
    falling and the peak under 80 GB and its reckoning (see
    :func:`remat_train`);
    (d) a backward through ``attn_impl="flash"`` must raise on the card.

Then phase 4e, the mesh, every count set to 0 just before each of its
paths (``launches_mesh`` on the kernel lines):

4e. (a) the training CLI for spatial-lm at its defaults over the lake, 20
    steps with a checkpoint at 10, started plainly and under ``torchrun
    --nproc-per-node 1`` with ``--mesh-data 1 --mesh-model 1`` (a one-rank
    NCCL group; each run a child process, ``--train-child``, which reports
    its kernel counts): the mesh run's logged losses within 2e-4 of the
    plain run's, kernel 1 launched on the mesh and kernel 2 not (the feed
    reads with no box); then in this process
    the same step on the one-rank mesh beside the plain step, timed in turns
    (the mesh's DTensor dispatch is what the difference measures);
    (b) qwen3-8b at its published widths, 2 of its 36 layers, bf16 compute,
    ``attn_impl="flash"``: ``forward`` on (2, 4096) and the prefill step on
    the one-rank mesh (parameters placed as views of the same storage), the
    logits against the unsharded call's and the next tokens equal; kernel 6
    launches once per layer in each, inside ``local_map``;
    (c) the dry run (``repro_torch.launch.dryrun``) of qwen3-8b ``train_4k``
    (calibrated from one and two layers) and ``decode_32k`` (every layer),
    and of mamba2-130m and minicpm3-4b ``train_4k`` (calibrated), on a fake
    group of 256 ranks, (16, 16): their roofline lines. It runs on the CPU
    in a child process (``--dryrun-child``) started before phase 3b;
    (d) the roofline share of phase 4d's three measured steps (spatial-lm,
    qwen3-8b at 2 layers, internlm2-1.8b at 24): their FLOPs and bytes
    counted on one device on fake tensors, the bound at the card's peaks
    over the measured step time, and the fake tensors' peak beside the
    card's.

Last, phase 4f, the examples, every count set to 0 just before each
example (``launches_examples`` on the kernel lines, summed over the six):

4f. each twin under ``examples/torch/`` (quickstart, trace_scan,
    serve_queries, spatial_analytics, train_trajectory_lm, serve_lm) run in
    this process as ``__main__`` at the reference examples' defaults with
    ``--device cuda``, its working and temporary directory a fresh one
    removed after it (see :func:`examples_path`). Each must exit normally;
    the four data examples must launch kernel 1, the three with
    ``refine=True`` scans kernel 2, and print the same facts (timings and
    paths masked, :func:`example_facts`) as the same example run with
    ``--device host``, which must launch nothing; trace_scan's exported
    ``scan_trace.json`` must hold a ``device.*`` span; train_trajectory_lm
    asserts its own falling loss; serve_lm must answer its 8 requests.

Every line is one JSON object (the training loop's own log lines go to
standard error). The kernel names are printed early under
``kernel_names``, so the only line keyed ``kernels`` is the per-kernel
table, printed just before the last line, ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's sources beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_N_TRAJ = 1_710_670          # ECML/PKDD 2015 taxi-trajectory challenge trips
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 peak outside the tensor cores (data sheet)
TF32_FLOPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core peak (data sheet)
KERNEL_LIBS = ("stream_expand", "fp_delta_decode", "segminmax_refine", "page_minmax",
               "flash_attention", "flash_attention_sm90", "miniblock")
FILE_KERNELS = ("fp_delta.decode_stream", "minmax.segminmax_refine", "minmax.page_minmax",
                "fp_delta.expand_stream", "fp_delta.escape_resolve")
CODEC_KERNELS = ("fp_delta.encode_blocks", "fp_delta.decode_blocks")
LM_KERNELS = ("flash_attention.flash_attention_sm90",)
F32_FLASH = "flash_attention.flash_attention_f32"   # the float32 route: its own forward
DATASET_SHARDS = 16            # ~107 k trips, ~5 M points a shard: a typical lake file
DATASET_WORKERS = 4
LM_CONFIG = "qwen3-8b"
LM_BATCH, LM_SEQ, LM_FULL_BATCH = 2, 4096, 256   # train_4k: seq 4096, global batch 256
# Serving: prompts of 16-64 tokens (a tokenized trip prefix, as examples/serve_lm.py
# sends, up to a whole Porto trip of about 48 points) in a cache of 256 positions.
SERVE_MAX_LEN = 256
SERVE_CHECK_REQUESTS = 8                        # functional check, max_batch 4, 16 new tokens
# requests (cut from 256 to keep the script inside its time limit: four full
# batches), max_batch, max_new_tokens
SERVE_LOAD = (128, 32, 128)
# Serve path: the reference serve benchmark's traffic (benchmarks/bench_serve.py):
# boxes cycle these record selectivities; the whole lake fits in the cache.
QUERY_FRACS = (0.01, 0.05, 0.10, 0.25, 0.50)
# the reference's 256 cut to half a wave (64 until the script neared its time limit)
SERVE_COUNTS = (1, 16, 32)
SERVE_MAX_WAVE, SERVE_CACHE_RGS = 64, 32
SERVE_SPANS = ("device.h2d", "device.refine_multi_launch", "device.refine_cached",
               "device.gather")
# Data feed: the reference pipeline benchmark's settings (benchmarks/bench_pipeline.py)
FEED_SEQ, FEED_BATCH = 128, 16
# spatial-lm serving the lake (examples/serve_lm.py's prompts: BOS + 15 cells, a
# 192-position cache): the first 16 feed batches, 256 prompts, 64 new tokens each
SPATIAL_PROMPTS = (16, 16)                       # feed batches, prompt tokens
SPATIAL_LOAD = (32, 192, 64)                     # max_batch, max_len, max_new_tokens
# the other families at their published widths: (config, attn_impl, depth cut or None).
# Flash where kernel 6 takes the heads; minicpm3's MLA (q/k 96 wide, v 64) keeps its
# shipped "blocked"; mamba2 has no attention. Arctic's 480 B parameters cannot fit
# one card: 2 of its 35 layers (55 GB of bf16).
FAMILY_RUNS = (("mamba2-130m", "ref", None), ("zamba2-1.2b", "flash", None),
               ("qwen2-moe-a2.7b", "flash", None), ("minicpm3-4b", "blocked", None),
               ("whisper-medium", "flash", None), ("pixtral-12b", "flash", None),
               ("arctic-480b", "flash", 2))
FAMILY_FRAMES = 2048            # whisper: 4096 positions' audio after its 2x downsample
FAMILY_DECODE_SEQ = 256
# Training (phase 4d): spatial-lm at the training CLI's defaults
# (src/repro/launch/train.py: seq 256, global batch 8, lr 3e-4, 200 steps,
# a compressed checkpoint every 50), then a resume to 250 and a fault drill
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS, TRAIN_CKPT_EVERY = 256, 8, 3e-4, 200, 50
TRAIN_RESUME_TO = 250
TRAIN_FAIL = (255, 260)                          # injected failure at, then run to
TRAIN_WIDE = (32, 512, 5)                        # batch, seq, timed steps of the wide timing
# qwen3-8b trained at published widths: 2 of its 36 layers, train_4k's sequence
DENSE_TRAIN = (2, 2, 4096, 5)                    # layers, batch, seq, steps
# internlm2-1.8b (arXiv:2403.17297) as shipped (remat "full", "blocked"
# attention) at full depth and train_4k's sequence, batch cut 256 to 2; the
# remat modes side by side at 4 of its 24 layers
REMAT_TRAIN = ("internlm2-1.8b", 2, 4096, 3)     # config, batch, seq, steps
REMAT_COMPARE = (4, 1, 4096)                     # layers, batch, seq
# The mesh (phase 4e): the training CLI for 20 steps, a checkpoint at 10, on a
# one-rank NCCL mesh; qwen3-8b at DENSE_TRAIN's cut sharded; the dry run of
# DRYRUN_CELLS on a fake group of 256 ranks, in a child process on the CPU
MESH_STEPS, MESH_CKPT_EVERY, MESH_TIMED_STEPS = 20, 10, 10
MESH_CHILD_TIMEOUT = 300
# the dry run's cells (config, shape, counting): qwen3-8b's two, then one cell
# of each repaired mesh fault, mamba2-130m (a sequence once put on 'model') and
# minicpm3-4b (40 heads, which 'model' does not divide)
DRYRUN_CELLS = ((LM_CONFIG, "train_4k", "calibrated"), (LM_CONFIG, "decode_32k", "direct"),
                ("mamba2-130m", "train_4k", "calibrated"),
                ("minicpm3-4b", "train_4k", "calibrated"))
DRYRUN_TIMEOUT = 900
# Phase 4f: the six example twins under examples/torch/ at the reference's defaults
EXAMPLES = ("quickstart", "trace_scan", "serve_queries", "spatial_analytics",
            "train_trajectory_lm", "serve_lm")
DATA_EXAMPLES = EXAMPLES[:4]                     # held against their --device host runs
REFINE_EXAMPLES = ("trace_scan", "serve_queries", "spatial_analytics")   # refine=True scans
SERVE_LM_REQUESTS = 8                            # examples/serve_lm.py's --requests default
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise Failure(what)


def ragged(starts, counts) -> np.ndarray:
    """Concatenated ``arange(s, s + c)`` per pair (the oracle's own gather)."""
    counts = np.asarray(counts, np.int64)
    if counts.sum() == 0:
        return np.zeros(0, np.int64)
    excl = np.cumsum(counts) - counts
    return (np.repeat(np.asarray(starts, np.int64) - excl, counts)
            + np.arange(int(counts.sum()), dtype=np.int64))


def ibits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)


# ---------------------------------------------------------------- the data
def make_data(n_traj: int, seed: int):
    from repro_torch.data.synthetic import porto_taxi_like

    cols = porto_taxi_like(n_traj=n_traj, seed=seed)
    rng = np.random.default_rng(seed + 1)
    starts = cols.record_value_starts()
    npts = np.diff(np.append(starts, cols.n_values))
    extra = {
        # trip start, seconds since 2013-07-01 (the challenge's first day)
        "timestamp": (1372636800 + rng.integers(0, 365 * 86400, n_traj)).astype(np.int64),
        "taxi_id": rng.integers(20000001, 20000449, n_traj).astype(np.int64),
        "duration_s": (15.0 * (npts - 1)).astype(np.float32),
    }
    schema = {"timestamp": "<i8", "taxi_id": "<i8", "duration_s": "<f4"}
    return cols, npts, extra, schema


def file_order(cols, row_group_records: int) -> np.ndarray:
    """Input record index of each record in file order: the writer sorts each
    row group by the Hilbert key of record bbox centres (stable)."""
    from repro_torch.core.sfc import sort_keys
    from repro_torch.core.writer import record_centroids

    n = cols.n_records
    parts = []
    for r0 in range(0, n, row_group_records):
        r1 = min(n, r0 + row_group_records)
        sub = cols.slice_records(r0, r1)
        if r1 - r0 > 1:
            cx, cy = record_centroids(sub)
            perm = np.argsort(sort_keys(cx, cy, "hilbert", 16), kind="stable")
        else:
            perm = np.arange(r1 - r0)
        parts.append(r0 + perm)
    return np.concatenate(parts)


class Oracle:
    """Expected read results from the generated columns alone."""

    def __init__(self, cols, npts, extra, order):
        starts = cols.record_value_starts()
        self.x, self.y = cols.x, cols.y
        self.starts, self.npts, self.extra, self.order = starts, npts, extra, order
        self.xmin = np.minimum.reduceat(cols.x, starts)[order]
        self.xmax = np.maximum.reduceat(cols.x, starts)[order]
        self.ymin = np.minimum.reduceat(cols.y, starts)[order]
        self.ymax = np.maximum.reduceat(cols.y, starts)[order]

    def keep(self, bbox, rng_filter=None) -> np.ndarray:
        x0, y0, x1, y1 = bbox
        k = (self.xmin <= x1) & (self.xmax >= x0) & (self.ymin <= y1) & (self.ymax >= y0)
        if rng_filter is not None:
            col, lo, hi = rng_filter
            v = self.extra[col][self.order]
            k &= (v >= lo) & (v <= hi)
        return k

    def expect(self, keep) -> dict:
        """The records ``keep`` selects: their coordinate bits and extras."""
        sel = self.order[keep]
        iv = ragged(self.starts[sel], self.npts[sel])
        return {"n": int(keep.sum()), "x": ibits(self.x[iv]), "y": ibits(self.y[iv]),
                "extra": {k: ibits(np.ascontiguousarray(v[sel])) for k, v in self.extra.items()}}

    def check(self, res, keep, what: str) -> int:
        """Hold a read's result exactly to the records ``keep`` selects."""
        return self.check_expected(res, self.expect(keep), what)

    def check_expected(self, res, want: dict, what: str) -> int:
        """:meth:`check` against an :meth:`expect` computed once."""
        geo, extras, stats = res
        n = want["n"]
        require(stats.records_returned == n,
                f"{what}: {stats.records_returned} records returned, oracle {n}")
        geo = geo.coords_to_host()
        require(np.array_equal(ibits(geo.x), want["x"]), f"{what}: x bits differ")
        require(np.array_equal(ibits(geo.y), want["y"]), f"{what}: y bits differ")
        for k, v in want["extra"].items():
            require(np.array_equal(ibits(np.ascontiguousarray(extras[k])), v),
                    f"{what}: extra {k!r} differs")
        return n


def selectivity_bbox(oracle: Oracle, target: float):
    """A box from the data's lower-left corner whose record selectivity is
    near ``target`` (the quantile box of the README's refine sweep)."""
    cx = (oracle.xmin + oracle.xmax) / 2
    cy = (oracle.ymin + oracle.ymax) / 2
    f = float(np.sqrt(target))
    return (float(oracle.xmin.min()), float(oracle.ymin.min()),
            float(np.quantile(cx, f)), float(np.quantile(cy, f)))


# ---------------------------------------------------------------- timing
def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 10, warmup: int = 2):
    """Device time per call of ``fn``: the durations of the kernels and
    memsets it launched, summed over a ``torch.profiler`` trace of
    ``iters`` back-to-back calls. Beside :func:`cuda_ms` (events around
    the same calls), it splits device time from host dispatch. A trace that
    shows no device activity is taken again, twice at most; then the time
    is None ("not measured") and a line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
    emit({"device_ms": "not measured: three profiler traces showed no device activity"})
    return None


def hmma_count(lib: str):
    """Tensor-core (HMMA) instructions in a built kernel library, from
    ``cuobjdump -sass`` beside ``nvcc``; None where the toolkit has none."""
    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_build._lib_path(lib))], capture_output=True,
                          text=True, check=True).stdout
    return sum("HMMA" in ln for ln in sass.splitlines())


def read_split(tracer, wall_s: float) -> dict:
    """Host plan / H2D / device / D2H seconds of one traced read. Launches
    are asynchronous: device time lands in the span that waits for it
    (the record-mask transfer in device.refine_launch)."""
    tot = {r["name"]: r["total_ms"] / 1e3 for r in tracer.summary()}
    h2d = tot.get("device.h2d", 0.0)
    dev = tot.get("device.decode_launch", 0.0) + tot.get("device.refine_launch", 0.0)
    d2h = tot.get("device.gather", 0.0)
    return {"wall_s": wall_s, "host_plan_s": wall_s - h2d - dev - d2h,
            "h2d_s": h2d, "device_s": dev, "d2h_s": d2h}


# ---------------------------------------------------------------- main path
def main_path(data, path: Path, counters) -> dict:
    import torch

    from repro_torch import obs
    from repro_torch.core.filters import Range
    from repro_torch.core.reader import SpatialParquetReader
    from repro_torch.core.writer import write_file

    cols, npts, extra, schema = data
    order = file_order(cols, 1 << 20)
    oracle = Oracle(cols, npts, extra, order)
    boxes = {f"refine_{int(t * 100)}pct": selectivity_bbox(oracle, t)
             for t in (0.01, 0.10, 0.50)}
    rng_filter = ("duration_s", 300.0, 900.0)

    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    write_file(path, columns=cols, extra=extra, extra_schema=schema,
               sort="hilbert", checksums=True, device=DEVICE)
    write_s = time.perf_counter() - t0
    reads = {}
    with SpatialParquetReader(path) as r:
        plan = [(name, dict(bbox=b, refine=True), oracle.keep(b))
                for name, b in boxes.items()]
        b10 = boxes["refine_10pct"]
        plan.append(("refine_10pct_filter",
                     dict(bbox=b10, refine=True, filter=Range(*rng_filter)),
                     oracle.keep(b10, rng_filter)))
        plan.append(("refine_10pct_keep_on_device",
                     dict(bbox=b10, refine=True, keep_on_device=True),
                     oracle.keep(b10)))
        for name, kw, keep in plan:
            tracer = obs.enable()
            t0 = time.perf_counter()
            res = r.read_columnar(device=DEVICE, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            obs.disable()
            n = oracle.check(res, keep, name)
            st = res[2]
            reads[name] = {**read_split(tracer, wall), "records": n,
                           "selectivity": n / oracle.order.size,
                           "pages_read": st.pages_read, "pages_total": st.pages_total,
                           "bytes_read": st.bytes_read, "bytes_total": st.bytes_total}
    launches = {c.kname: c.launches for c in counters}
    for name in FILE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the file path")
    return {"write_s": write_s, "file_bytes": path.stat().st_size,
            "n_records": int(cols.n_records), "n_points": int(cols.n_values),
            "reads": reads, "launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "_oracle": oracle, "_boxes": boxes}


# ---------------------------------------------------------------- kernel checks
def rg0_stream(path: Path, oracle: Oracle):
    """The first fused launch of row group 0, built as the reader builds it."""
    from repro_torch.core.pages import PageMeta, page_stream_plan
    from repro_torch.core.reader import SpatialParquetReader
    from repro_torch.kernels.fp_delta import build_page_stream, build_refine_aux, chunk_plan_pairs

    with SpatialParquetReader(path) as r:
        rg = r.footer["row_groups"][0]
        plans, pairs = [], []
        for mx, my in zip(rg["x_pages"], rg["y_pages"]):
            for m in (mx, my):
                meta = PageMeta.from_dict(m)
                blob = r._source.read_at(meta.offset, meta.nbytes)
                plans.append(page_stream_plan(blob, meta, r.coord_dtype, r.codec))
            pairs.append((mx["rec_start"], mx["rec_start"] + mx["rec_count"]))
        vcounts = oracle.npts[oracle.order[: rg["n_records"]]]
        for kind, cplans, cpairs, (rl, rh) in chunk_plan_pairs(plans, pairs):
            if kind == "dev":
                stream = build_page_stream(cplans)
                aux = build_refine_aux(stream, [(a - rl, b - rl) for a, b in cpairs],
                                       vcounts[rl:rh])
                d = oracle.extra["duration_s"][oracle.order[: rg["n_records"]]]
                ebounds = np.array([p["rec_start"] for p in rg["x_pages"]]
                                   + [rg["n_records"]], np.int64)
                return stream, aux, d, ebounds
    raise Failure("row group 0 has no device chunk")


def adversarial_pages(rng, dtype, n: int) -> list[np.ndarray]:
    """Pages with escapes, raw pages and NaN/±inf/±0/denormal values."""
    smooth = (np.cumsum(rng.normal(0, 1e-4, n)) + 41.1).astype(dtype)
    spiky = smooth.copy()
    hits = rng.integers(0, n, max(n // 50, 4))
    spiky[hits] = rng.normal(0, 1e30, len(hits)).astype(dtype)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0,
                         np.finfo(dtype).smallest_subnormal,
                         -np.finfo(dtype).smallest_subnormal], dtype)
    spiky[rng.integers(0, n, 40)] = rng.choice(specials, 40)
    uint = np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64
    wild = rng.integers(0, np.iinfo(uint).max, n, dtype=uint, endpoint=True).view(dtype)
    return [smooth, spiky, wild]


def adversarial_stream(rng, dtype):
    """A stream of fp_delta pages (escape-free, escaped, all-escape) and a raw
    page, with per-record segmentation for the refine kernel."""
    from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan
    from repro_torch.core.pages import PageMeta, page_stream_plan
    from repro_torch.kernels.fp_delta import build_page_stream, build_refine_aux

    plans, pairs, vcounts, values = [], [], [], []
    r = 0
    for page in adversarial_pages(rng, dtype, 3000) + ["raw"]:
        if isinstance(page, str):
            page = rng.normal(-8.6, 1.0, 2500).astype(dtype)
            page[::97] = np.nan
            px, py = page, page[::-1].copy()
            metas = [PageMeta(0, p.nbytes, len(p), 0, 0, 0.0, 0.0, "raw", 0, 0) for p in (px, py)]
            plans += [page_stream_plan(p.tobytes(), m, np.dtype(dtype), "none")
                      for p, m in zip((px, py), metas)]
        else:
            px, py = page, np.roll(page, 7)
            for p in (px, py):
                payload, _ = fp_delta_encode(p)
                plans.append(fp_delta_plan(payload, len(p), np.dtype(dtype)))
        c = rng.integers(0, 60, 200)
        c = c[np.cumsum(c) <= len(px)]
        c = np.append(c, len(px) - c.sum())
        vcounts.append(c)
        pairs.append((r, r + len(c)))
        r += len(c)
        values += [px, py]
    stream = build_page_stream(plans)
    aux = build_refine_aux(stream, pairs, np.concatenate(vcounts))
    return stream, aux, values


def adversarial_pages_minmax(rng):
    """float32 column + page bounds: ±0 both orders, NaN pages, all-NaN
    pages, empty pages, infs and denormals."""
    tiny = np.finfo(np.float32).smallest_subnormal
    pages = [np.array([0.0, -0.0], np.float32), np.array([-0.0, 0.0], np.float32),
             np.array([1.0, np.nan, -3.0], np.float32), np.full(5, np.nan, np.float32),
             np.zeros(0, np.float32), np.array([np.inf, -np.inf, tiny, -tiny], np.float32),
             np.array([-np.nan, 2.0], np.float32),
             rng.normal(0, 1e3, 100_000).astype(np.float32)]
    v = np.concatenate(pages)
    bounds = np.concatenate([[0], np.cumsum([len(p) for p in pages])]).astype(np.int64)
    return v, bounds


def minmax_page_cases(rng) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """Kernel 3's large-page cases as (name, float32 values, int64 bounds): a
    single page of 1<<20 values, 10,000 empty pages among 400 real ones
    (with NaN, ±0, ±inf and denormals), bounds that start and end off
    16-byte boundaries with ±0 in both orders."""
    tiny = np.finfo(np.float32).smallest_subnormal
    out = []
    v = rng.normal(-3, 1e3, 1 << 20).astype(np.float32)
    out.append(("one_page_1M", v, np.array([0, v.size], np.int64)))
    sizes = np.zeros(10_400, np.int64)
    sizes[rng.choice(sizes.size, 400, replace=False)] = rng.integers(1, 6000, 400)
    v = rng.normal(5, 1e2, int(sizes.sum())).astype(np.float32)
    v[rng.integers(0, v.size, 300)] = np.array([np.nan, -0.0, 0.0, tiny, -tiny, np.inf],
                                               np.float32)[rng.integers(0, 6, 300)]
    out.append(("empty_10000", v, np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)))
    v = rng.normal(0, 1, 70_001).astype(np.float32)
    v[[5, 9, 4099, 4100]] = [-0.0, 0.0, 0.0, -0.0]
    out.append(("misaligned_bounds", v,
                np.array([3, 9, 4098, 4101, 4101, 30_001, 69_998], np.int64)))
    return out


def anchor_free_plan(rng, dtype, n: int):
    """One fp_delta page of ``n`` values whose bit patterns step by at most
    3000: no escapes, so its first value is its only anchor and the
    decode's carry runs through every tile of the stream."""
    from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan

    it = np.int32 if np.dtype(dtype).itemsize == 4 else np.int64
    base = np.array([40.7], dtype).view(it)[0]
    x = (base + np.cumsum(rng.integers(-3000, 3000, n))).astype(it).view(dtype)
    payload, _ = fp_delta_encode(x)
    plan = fp_delta_plan(payload, n, np.dtype(dtype))
    require(int(np.sum(plan.flags)) == 0, "anchor_free_plan: the page has escapes")
    return plan


def decode_cases(rng):
    """Adversarial streams for kernel 1 and the expansion beyond the main
    and mixed-page ones, as (name, page stream, blocks kept or None): per
    width, a 4.2 M value page with one anchor (the look-back chains over
    about 2,000 tiles), an all-anchor stream of raw pages, and a longer
    stream of escaped, NaN and wild pages before an anchor-free one, whole
    and cut to one stream block (half a tile), 1,057 and 2,115 blocks
    (partial last tiles; 529 and 1,058 tiles, which no grid of whole SMs
    divides)."""
    from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan
    from repro_torch.core.pages import PageMeta, page_stream_plan
    from repro_torch.kernels.fp_delta import build_page_stream

    out = []
    for dt in (np.float32, np.float64):
        wname = f"w{np.dtype(dt).itemsize * 8}"
        out.append((f"long_carry_chain_{wname}",
                    build_page_stream([anchor_free_plan(rng, dt, 4_200_000)]), None))
        raw = rng.normal(-8.6, 1.0, 300_000).astype(dt)
        meta = PageMeta(0, raw.nbytes, len(raw), 0, 0, 0.0, 0.0, "raw", 0, 0)
        plan = page_stream_plan(raw.tobytes(), meta, np.dtype(dt), "none")
        out.append((f"all_anchors_{wname}", build_page_stream([plan, plan]), None))
        plans = [fp_delta_plan(fp_delta_encode(p)[0], len(p), np.dtype(dt))
                 for p in adversarial_pages(rng, dt, 3000)]
        long = build_page_stream(plans + [anchor_free_plan(rng, dt, 2200 * 1024)])
        out.append((f"mixed_long_{wname}", long, None))
        for nb in (1, 1057, 2115):
            out.append((f"n_blocks_{nb}_{wname}", long, nb))
    return out


def escape_cases(rng):
    """Streams for the escape resolution beyond the main and mixed-page
    ones, as (name, page stream): per width, pages at token width 1 (the
    marker a single one), W - 1, and 8 over wild bits (nearly every delta
    escapes; runs of 8 ones far outnumber the tokens)."""
    from repro_torch.core.fp_delta import fp_delta_encode, fp_delta_plan
    from repro_torch.kernels.fp_delta import build_page_stream

    out = []
    for dt in (np.float32, np.float64):
        w = np.dtype(dt).itemsize * 8
        uint = np.uint32 if w == 32 else np.uint64
        smooth = (np.cumsum(rng.normal(0, 1e-4, 40_000)) + 40.7).astype(dt)
        wild = rng.integers(0, np.iinfo(uint).max, 40_000, dtype=uint, endpoint=True).view(dt)
        pages = [(np.repeat(smooth[::5], 5), 1), (wild, w - 1), (wild, 8)]
        plans = [fp_delta_plan(fp_delta_encode(x, n)[0], len(x), np.dtype(dt)) for x, n in pages]
        out.append((f"token_widths_w{w}", build_page_stream(plans)))
    return out


def mismatches(a, b) -> tuple[int, float]:
    """Positions whose bit patterns differ, and the largest |difference| of
    the patterns read as integers (0 when they agree)."""
    import torch

    a = a.reshape(-1)
    b = b.reshape(-1)
    if a.dtype.is_floating_point:
        a = a.view(torch.int32 if a.element_size() == 4 else torch.int64)
        b = b.view(torch.int32 if b.element_size() == 4 else torch.int64)
    diff = a != b
    n = int(diff.sum())
    err = float((a[diff].double() - b[diff].double()).abs().max()) if n else 0.0
    return n, err


def segminmax_library_route(bits, x_start, y_start, counts, valid, qkeys, width):
    """The nearest library route to kernel 2 on its inputs, for its
    ``library_ms``: a callable that computes the order keys of ``bits``,
    runs ``scatter_reduce`` with ``amin`` and with ``amax`` (two calls) over
    them by slot (record, coordinate), and makes the box compare; and what
    sets it apart from the kernel."""
    import torch

    from repro_torch.kernels.minmax import ref as mr

    n = counts.shape[0]
    owner, xpos = mr._ragged_index(x_start, counts)
    _, ypos = mr._ragged_index(y_start, counts)
    # positions that belong to no record reduce into a spare slot
    slot = torch.full((bits.shape[0],), 2 * n, dtype=torch.int64, device=bits.device)
    slot[xpos] = 2 * owner
    slot[ypos] = 2 * owner + 1
    qx0, qx1, qy0, qy1 = (mr._signed(q) for q in qkeys)
    lo, hi = mr._I64_MIN, mr._I64_MAX

    def route():
        keys = mr.float_order_keys(bits, width)
        mn = torch.full((2 * n + 1,), hi, dtype=torch.int64, device=bits.device)
        mx = torch.full((2 * n + 1,), lo, dtype=torch.int64, device=bits.device)
        mn = mn.scatter_reduce_(0, slot, keys, "amin")[:-1].view(n, 2)
        mx = mx.scatter_reduce_(0, slot, keys, "amax")[:-1].view(n, 2)
        return (valid & (mn[:, 0] <= qx1) & (mx[:, 0] >= qx0)
                & (mn[:, 1] <= qy1) & (mx[:, 1] >= qy0))

    diff = ("torch scatter_reduce amin and amax over a (record, coordinate) slot index "
            "built once outside the timing, then the box compare; no NaN fence, no "
            "(R, 4) min/max output")
    return route, diff


def check_kernels(path: Path, main: dict) -> list[dict]:
    import torch

    from repro_torch.kernels.fp_delta import kernel as fk, ref as fr, stream_from_numpy
    from repro_torch.kernels.fp_delta.ops import expand_stream_ref
    from repro_torch.kernels.minmax import bbox_query_keys, keys64
    from repro_torch.kernels.minmax import kernel as mk, ref as mr

    oracle = main["_oracle"]
    rng = np.random.default_rng(7)
    stream, aux, dur, ebounds = rg0_stream(path, oracle)
    table = []

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    resolve_row = check_escape_resolve(stream, put, np.random.default_rng(23))

    # ---- the expansion: each stream's token descriptors written on the card
    ds = stream_from_numpy(stream, aux, device=DEVICE)
    cases = [("main", ds)]
    streams = [("main", stream, None)]
    for dt in (np.float32, np.float64):
        s, a, _ = adversarial_stream(rng, dt)
        name = f"adversarial_w{np.dtype(dt).itemsize * 8}"
        cases.append((name, stream_from_numpy(s, a, device=DEVICE)))
        streams.append((name, s, None))
    streams += decode_cases(np.random.default_rng(17))
    checks, plain = [], {}  # kernel 1's operands from the card, and from the host
    bad, err = 0, 0.0
    uploaded = dict(cases)
    for name, s, nb in streams:
        d = uploaded[name] if name in uploaded else stream_from_numpy(s, device=DEVICE)
        cut = slice(None) if nb is None else slice(0, nb)
        host = (s.tok_off, s.nbits, s.anchor)  # the plain host expansion
        card = (d.tok_off, d.nbits, d.anchor)
        torch.cuda.synchronize()
        if nb is None:
            m = 0
            for c, h in zip(card, host):
                mi, ei = mismatches(c, put(h))
                m, err = m + mi, max(err, ei)
            emit({"check": "fp_delta.expand_stream", "case": name,
                  "positions": int(d.tok_off.numel()), "pages": int(s.page_table.shape[1]),
                  "escapes": int(s.escapes.size), "width": s.width, "mismatches": m})
            bad += m
        checks.append((name, (d.words32, *(t[cut].contiguous() for t in card), d.width)))
        plain[name] = (d.words32, *(put(h[cut]) for h in host), s.width)
    n = ds.n_values
    table_t, esc_t = put(stream.page_table), put(stream.escapes)
    positions = stream.shape[0] * stream.shape[1]

    def expand():
        return fk.expand_stream(table_t, esc_t, n, stream.width, stream.shape[0])

    k_ms = cuda_ms(expand)
    k_dev = device_ms(expand)
    p_ms = cuda_ms(lambda: expand_stream_ref(stream), iters=3, warmup=1)
    bytes_moved = 12 * positions + stream.page_table.nbytes + stream.escapes.nbytes
    expand_row = dict(name="fp_delta.expand_stream", route="cuda",
                      source="src/repro_torch/csrc/stream_expand.cu",
                      replaces="src/repro/kernels/fp_delta/ops.py::build_page_stream (host)",
                      mismatches=bad, max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=None,
                      shape={"values": n, "positions": positions,
                             "pages": int(stream.page_table.shape[1]),
                             "escapes": int(stream.escapes.size), "width": stream.width})

    # ---- kernel 1: page-stream decode, held against its plain version on
    # the host's expansion of the same stream
    bad, err = 0, 0.0

    def held(label, name, args, got) -> None:
        nonlocal bad, err
        m, e = mismatches(got, fr.decode_stream_ref(*plain[name]))
        emit({"check": "fp_delta.decode_stream", "case": label, "positions": int(args[1].numel()),
              "width": args[4], "mismatches": m})
        bad, err = bad + m, max(err, e)

    for name, args in checks:
        got = fk.decode_stream(*args)
        torch.cuda.synchronize()
        held(name, name, args, got)
    # two calls queued back to back, then four threads at once (the scanner's
    # pattern), three rounds: each call zeroes its own tile statuses
    two = [checks[0], checks[3]]
    outs = [fk.decode_stream(*a) for _, a in two]
    torch.cuda.synchronize()
    for i, ((name, a), got) in enumerate(zip(two, outs)):
        held(f"back_to_back_{i}", name, a, got)
    four = [checks[i] for i in (0, 1, 2, 3)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        for r in range(3):
            outs = list(pool.map(lambda c: fk.decode_stream(*c[1]), four))
            torch.cuda.synchronize()
            for i, ((name, a), got) in enumerate(zip(four, outs)):
                held(f"four_threads_round{r}_{i}", name, a, got)
    args = (ds.words32, ds.tok_off, ds.nbits, ds.anchor, ds.width)
    n = ds.n_values
    # the packed words up to the end of the last token (the buffer's pow2 tail is not read)
    last_bit = int((stream.tok_off.reshape(-1)[:n].astype(np.int64)
                    + stream.nbits.reshape(-1)[:n]).max())
    words_used = -(-last_bit // 32) * 4
    k_ms = cuda_ms(lambda: fk.decode_stream(*args))
    k_dev = device_ms(lambda: fk.decode_stream(*args))
    p_ms = cuda_ms(lambda: fr.decode_stream_ref(*args), iters=3, warmup=1)
    bytes_moved = words_used + 12 * n + n * ds.width // 8
    table.append(dict(name="fp_delta.decode_stream", route="cuda",
                      source="src/repro_torch/csrc/fp_delta_decode.cu",
                      replaces="src/repro/kernels/fp_delta/kernel.py:159",
                      mismatches=bad, max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=None,
                      shape={"values": n, "positions": int(ds.tok_off.numel()),
                             "packed_word_bytes": words_used, "width": ds.width}))

    # ---- kernel 2: per-record min/max + bbox survivor test
    bbox = main["_boxes"]["refine_10pct"]
    rcases = []
    for name, d in cases:
        bits = fk.decode_stream(d.words32, d.tok_off, d.nbits, d.anchor, d.width)
        dt = np.float32 if d.width == 32 else np.float64
        q = keys64(bbox_query_keys(bbox if name == "main" else (-1.0, -2.0, 42.0, 41.5), dt))
        rcases.append((name, (bits, d.x_start, d.y_start, d.counts, d.valid, q, d.width)))
    bad, err = 0, 0.0
    for name, rargs in rcases:
        kk, km = mk.segminmax_refine(*rargs)
        pk, pm = mr.segminmax_refine_ref(*rargs)
        torch.cuda.synchronize()
        m1, e1 = mismatches(kk.to(torch.int32), pk.to(torch.int32))
        m2, e2 = mismatches(km, pm)
        emit({"check": "minmax.segminmax_refine", "case": name,
              "records": int(rargs[3].shape[0]), "kept": int(kk.sum()),
              "mismatches": m1 + m2})
        bad, err = bad + m1 + m2, max(err, e1, e2)
    rargs = rcases[0][1]
    n_rec = int(rargs[3].shape[0])
    k_ms = cuda_ms(lambda: mk.segminmax_refine(*rargs))
    k_dev = device_ms(lambda: mk.segminmax_refine(*rargs))
    p_ms = cuda_ms(lambda: mr.segminmax_refine_ref(*rargs), iters=3, warmup=1)
    lib, lib_diff = segminmax_library_route(*rargs)
    l_ms = cuda_ms(lib)
    lib_keep = lib()
    torch.cuda.synchronize()
    # the route has no NaN fence: on the Porto stream (no NaN) it keeps what the kernel keeps
    require(torch.equal(lib_keep.to(torch.int32), mk.segminmax_refine(*rargs)[0].to(torch.int32)),
            "the library route of kernel 2 keeps other records than the kernel")
    vals = 2 * int(aux.counts.sum())
    bytes_moved = vals * ds.width // 8 + n_rec * (8 * 3 + 1) + n_rec * (1 + 32)
    table.append(dict(name="minmax.segminmax_refine", route="cuda",
                      source="src/repro_torch/csrc/segminmax_refine.cu",
                      replaces="src/repro/kernels/minmax/kernel.py:93",
                      mismatches=bad, max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=l_ms, library_route=lib_diff,
                      shape={"records": n_rec, "values": vals, "width": ds.width}))

    # ---- kernel 3: per-page min/max of a float32 column
    pcases = [("main", dur, ebounds), ("adversarial", *adversarial_pages_minmax(rng))]
    pcases += minmax_page_cases(rng)
    bad, err = 0, 0.0
    held_pairs = []

    def held_pages(name, vt, bt, got) -> None:
        nonlocal bad, err
        pmn, pmx = mr.page_minmax_ref(vt, bt)
        m1, e1 = mismatches(got[0], pmn)
        m2, e2 = mismatches(got[1], pmx)
        emit({"check": "minmax.page_minmax", "case": name, "pages": int(bt.numel()) - 1,
              "values": int(vt.numel()), "mismatches": m1 + m2})
        bad, err = bad + m1 + m2, max(err, e1, e2)

    for name, v, b in pcases:
        bt = torch.from_numpy(b).to(DEVICE)
        # the values pointer 0, 4 and 12 bytes off a 16-byte boundary
        for off in (0,) if name == "main" else (0, 1, 3):
            buf = torch.empty(len(v) + off, dtype=torch.float32, device=DEVICE)
            buf[off:] = torch.from_numpy(np.ascontiguousarray(v))
            vt = buf[off:]
            got = mk.page_minmax(vt, bt)
            torch.cuda.synchronize()
            held_pages(f"{name}_off{off}" if name != "main" else name, vt, bt, got)
            if off == 0:
                held_pairs.append((name, vt, bt))
    # calls queued back to back, then four threads at once, three rounds
    outs = [mk.page_minmax(vt, bt) for _, vt, bt in held_pairs]
    torch.cuda.synchronize()
    for (name, vt, bt), got in zip(held_pairs, outs):
        held_pages(f"back_to_back_{name}", vt, bt, got)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for r in range(3):
            outs = list(pool.map(lambda c: mk.page_minmax(c[1], c[2]), held_pairs))
            torch.cuda.synchronize()
            for (name, vt, bt), got in zip(held_pairs, outs):
                held_pages(f"four_threads_round{r}_{name}", vt, bt, got)
    vt, bt = held_pairs[0][1:]
    lengths = bt[1:] - bt[:-1]
    k_ms = cuda_ms(lambda: mk.page_minmax(vt, bt))
    k_dev = device_ms(lambda: mk.page_minmax(vt, bt))
    p_ms = cuda_ms(lambda: mr.page_minmax_ref(vt, bt))
    l_ms = cuda_ms(lambda: (torch.segment_reduce(vt, "min", lengths=lengths),
                            torch.segment_reduce(vt, "max", lengths=lengths)))
    n_pages = len(ebounds) - 1
    bytes_moved = 4 * len(dur) + 8 * (n_pages + 1) + 8 * n_pages
    table.append(dict(name="minmax.page_minmax", route="cuda",
                      source="src/repro_torch/csrc/page_minmax.cu",
                      replaces="src/repro/kernels/minmax/kernel.py:53",
                      mismatches=bad, max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                      bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                      bound_by="bytes", library_ms=l_ms,
                      shape={"values": len(dur), "pages": n_pages}))
    table.append(expand_row)
    table.append(resolve_row)
    return table


def check_escape_resolve(stream, put, rng) -> dict:
    """The escape resolution on the card against the plain host resolution:
    row group 0's first chunk, the adversarial and decode streams and
    :func:`escape_cases`, each on a fresh upload; then its times at the
    chunk's shape (the plain version re-resolves every page's escapes, as
    the host did before the kernel)."""
    import torch

    from repro_torch.core.fp_delta import resolve_escapes
    from repro_torch.kernels.fp_delta import kernel as fk, stream_from_numpy

    streams = [("main", stream)]
    streams += [(f"adversarial_w{np.dtype(dt).itemsize * 8}", adversarial_stream(rng, dt)[0])
                for dt in (np.float32, np.float64)]
    streams += [(name, s) for name, s, nb in decode_cases(np.random.default_rng(17)) if nb is None]
    streams += escape_cases(np.random.default_rng(19))
    bad = 0
    for name, s in streams:
        d = stream_from_numpy(s, device=DEVICE)
        esc, nbad = fk.escape_resolve(d.words32, put(s.page_table), s.n_escapes, s.width)
        torch.cuda.synchronize()
        m, _ = mismatches(esc, put(s.escapes)) if s.n_escapes else (0, 0.0)
        m += int(nbad.item()) + int(d.bad.item())
        emit({"check": "fp_delta.escape_resolve", "case": name,
              "pages": int(s.page_table.shape[1]), "escapes": s.n_escapes,
              "n_star": sorted({p.n for p in s.plans}), "width": s.width, "mismatches": m})
        bad += m
    words = stream_from_numpy(stream, device=DEVICE).words32
    n_used = sum(len(w) for w in stream.word_parts)
    table_t = put(stream.page_table)

    def resolve():
        return fk.escape_resolve(words, table_t, stream.n_escapes, stream.width)

    k_ms = cuda_ms(resolve)
    k_dev = device_ms(resolve)
    p_ms = cuda_ms(lambda: [resolve_escapes(p) for p in stream.plans], iters=3, warmup=1)
    bytes_moved = 8 * n_used + stream.page_table.nbytes + 4 * stream.n_escapes
    return dict(name="fp_delta.escape_resolve", route="cuda",
                source="src/repro_torch/csrc/stream_expand.cu",
                replaces="none: src/repro/core/fp_delta.py::fp_delta_plan resolves on the host",
                mismatches=bad, max_abs_err=0.0, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                bytes=bytes_moved, bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None,
                shape={"values": stream.n_values, "pages": int(stream.page_table.shape[1]),
                       "escapes": stream.n_escapes, "n_star": sorted({p.n for p in stream.plans}),
                       "word_bytes": 8 * n_used, "width": stream.width})


# ---------------------------------------------------------------- dataset path
def dataset_order(cols) -> np.ndarray:
    """Input record index of each record in dataset order: the writer sorts
    all records once by the Hilbert key of their bbox centres (stable) and
    splits that order into shards, concatenated in manifest order."""
    from repro_torch.core.sfc import sort_keys
    from repro_torch.core.writer import record_centroids

    cx, cy = record_centroids(cols)
    return np.argsort(sort_keys(cx, cy, "hilbert", 16), kind="stable")


class DatasetOracle(Oracle):
    """The file oracle in dataset order, plus the shard and page layout the
    writer produces (``np.array_split`` into shards; pages of whole records
    up to ``page_values`` values, a record larger than that alone), from
    which the expected ``ReadStats`` of a bbox scan follow."""

    def __init__(self, cols, npts, extra, order, n_shards: int, page_values: int):
        super().__init__(cols, npts, extra, order)
        sizes = [len(c) for c in np.array_split(np.arange(order.size), n_shards)]
        self.shard_starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        counts = npts[order]
        starts = []
        for s0, size in zip(self.shard_starts, sizes):
            ends = np.cumsum(counts[s0:s0 + size])   # value end of each record
            r = 0
            while r < size:
                base = ends[r - 1] if r else 0
                nxt = int(np.searchsorted(ends, base + page_values, side="right"))
                nxt = min(max(nxt, r + 1), size)
                starts.append(s0 + r)
                r = nxt
        self.page_starts = np.array(starts, np.int64)
        self.page_shard = np.searchsorted(self.shard_starts, self.page_starts, side="right") - 1
        self.dur = extra["duration_s"][order]

    def stats(self, bbox, rng_filter=None) -> dict:
        x0, y0, x1, y1 = bbox

        def hits(starts):
            red = lambda f, a: f.reduceat(a, starts)   # noqa: E731
            k = ((red(np.minimum, self.xmin) <= x1) & (red(np.maximum, self.xmax) >= x0)
                 & (red(np.minimum, self.ymin) <= y1) & (red(np.maximum, self.ymax) >= y0))
            if rng_filter is not None:
                _, lo, hi = rng_filter
                k &= (red(np.maximum, self.dur) >= lo) & (red(np.minimum, self.dur) <= hi)
            return k

        shard_hit = hits(self.shard_starts)
        pages = hits(self.page_starts) & shard_hit[self.page_shard]
        return {"shards_total": int(shard_hit.size), "shards_read": int(shard_hit.sum()),
                "pages_total": int(self.page_starts.size), "pages_read": int(pages.sum())}


def scan_split(tracer, wall_s: float) -> dict:
    """Seconds of one traced scan: its wall time, and the per-shard spans
    summed over the worker threads (so the split adds up to the summed shard
    time, not to the wall): host plan, H2D, device, D2H (as read_split)."""
    tot = {r["name"]: r["total_ms"] / 1e3 for r in tracer.summary()}
    h2d = tot.get("device.h2d", 0.0)
    dev = tot.get("device.decode_launch", 0.0) + tot.get("device.refine_launch", 0.0)
    d2h = tot.get("device.gather", 0.0)
    shards = tot.get("shard", 0.0)
    return {"wall_s": wall_s, "shard_thread_s": shards, "host_plan_thread_s": shards - h2d - dev - d2h,
            "h2d_thread_s": h2d, "device_thread_s": dev, "d2h_thread_s": d2h}


def dataset_path(data, root: Path, main: dict, counters) -> dict:
    """Phase 3a: the sharded dataset tier over the same Porto columns."""
    import torch

    from repro_torch import obs
    from repro_torch.core.filters import Range
    from repro_torch.dataset import SpatialDatasetScanner, write_dataset

    cols, npts, extra, schema = data
    oracle = DatasetOracle(cols, npts, extra, dataset_order(cols), DATASET_SHARDS, 131072)
    boxes = main["_boxes"]
    rng_filter = ("duration_s", 300.0, 900.0)

    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    manifest = write_dataset(root, columns=cols, extra=extra, n_shards=DATASET_SHARDS,
                             sort="hilbert", device=DEVICE)
    write_s = time.perf_counter() - t0
    require(manifest.extra_schema == schema, f"manifest extra schema {manifest.extra_schema}")
    require(manifest.n_shards == DATASET_SHARDS, f"{manifest.n_shards} shards written")
    scanner = SpatialDatasetScanner(root, max_workers=DATASET_WORKERS)
    b10 = boxes["refine_10pct"]
    plan = [(name, dict(bbox=b, refine=True), None) for name, b in boxes.items()]
    plan.append(("refine_10pct_filter", dict(bbox=b10, refine=True, filter=Range(*rng_filter)),
                 rng_filter))
    plan.append(("refine_10pct_keep_on_device", dict(bbox=b10, refine=True, keep_on_device=True),
                 None))
    scans = {}
    for name, kw, flt in plan:
        tracer = obs.enable()
        t0 = time.perf_counter()
        res = scanner.scan(device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        obs.disable()
        if kw.get("keep_on_device"):
            require(res[0].x.bits.device.type == torch.device(DEVICE).type,
                    f"{name}: coordinates left the device")
        n = oracle.check(res, oracle.keep(kw["bbox"], flt), f"dataset {name}")
        st = res[2]
        want = oracle.stats(kw["bbox"], flt)
        got = {k: getattr(st, k) for k in want}
        require(got == want, f"dataset {name}: ReadStats {got}, oracle {want}")
        require(not st.failures, f"dataset {name}: failed shards {st.failures}")
        scans[name] = {**scan_split(tracer, wall), "records": n,
                       "selectivity": n / oracle.order.size, **got,
                       "bytes_read": st.bytes_read, "bytes_total": st.bytes_total}
    launches = {c.kname: c.launches for c in counters}
    for name in FILE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the dataset path")
    return {"write_s": write_s, "shards": manifest.n_shards,
            "shard_records": [s.n_records for s in manifest.shards],
            "dataset_bytes": sum(s.file_bytes for s in manifest.shards),
            "scans": scans, "launches": launches, "_oracle": oracle}


# ---------------------------------------------------------------- serve path
def serve_path(oracle: DatasetOracle, root: Path, counters) -> dict:
    """Phase 3c: the multi-query bbox server over the Porto lake, with the
    reference serve benchmark's traffic (boxes cycling ``QUERY_FRACS``)."""
    import torch

    from repro_torch import obs
    from repro_torch.dataset import SpatialDatasetScanner
    from repro_torch.serve import SpatialQueryServer

    boxes = [selectivity_bbox(oracle, f) for f in QUERY_FRACS]
    wants = [oracle.expect(oracle.keep(b)) for b in boxes]
    stats_want = [oracle.stats(b) for b in boxes]
    scanner = SpatialDatasetScanner(root, max_workers=DATASET_WORKERS)
    stat_keys = tuple(stats_want[0])

    def check(qs, what):
        for i, q in qs:
            oracle.check_expected((q.geo, q.extras, q.stats), wants[i], f"{what} q{q.qid}")
            got = {k: getattr(q.stats, k) for k in stat_keys}
            require(got == stats_want[i], f"{what} q{q.qid}: ReadStats {got}, oracle {stats_want[i]}")

    def wave(srv, n, what):
        tracer = obs.enable()
        t0 = time.perf_counter()
        qs = [(i % len(boxes), srv.submit(boxes[i % len(boxes)])) for i in range(n)]
        srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        obs.disable()
        check(qs, what)
        tot = {r["name"]: r["total_ms"] / 1e3 for r in tracer.summary()}
        split = {k: tot.get(k, 0.0) for k in SERVE_SPANS}
        counts = {k: len(tracer.spans(k)) for k in ("device.refine_multi_launch",
                                                    "device.refine_cached")}
        m = srv.metrics()
        # two host parts of host_plan_s: whole-row-group reads with their
        # stream building (misses only), and each query's result assembly
        host = {"rg_read_s": tot.get("rg.read_full", 0.0), "finalize_s": tot.get("serve.query", 0.0)}
        return {"served_s": wall, "host_plan_s": wall - sum(split.values()), **host, **split,
                **{k: m[k] for k in ("queries", "waves", "rg_touches", "rg_decodes",
                                     "shared_decode_ratio", "cache_hits", "cache_misses",
                                     "cache_evictions", "cache_entries")},
                "latency_p50_s": m.get("latency_p50"), "latency_p99_s": m.get("latency_p99"),
                "span_counts": counts,
                "records_returned": sum(q.stats.records_returned for _, q in qs)}

    out = {"query_fracs": list(QUERY_FRACS), "boxes": boxes, "max_wave": SERVE_MAX_WAVE,
           "cache_rgs": SERVE_CACHE_RGS, "by_query_count": {}}
    total = dict.fromkeys((c.kname for c in counters), 0)
    for n in SERVE_COUNTS:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        for c in counters:
            c.launches = 0
        srv = SpatialQueryServer(scanner, device=DEVICE, cache_rgs=SERVE_CACHE_RGS,
                                 max_wave=SERVE_MAX_WAVE)
        require(srv.device == DEVICE, f"the server runs on {srv.device!r}")
        row = wave(srv, n, f"serve {n}")
        launches = {c.kname: c.launches for c in counters}
        for name in FILE_KERNELS[:2]:
            require(launches[name] > 0, f"kernel {name} was not launched by the {n}-query wave")
        for name in total:
            total[name] += launches[name]
        row["launches"] = launches
        torch.cuda.synchronize()
        row["cache_device_bytes"] = torch.cuda.memory_allocated() - mem0
        if n == SERVE_COUNTS[-1]:
            # the same boxes again: every row group is a cache hit
            for c in counters:
                c.launches = 0
            hit = wave(srv, n, f"serve {n} (second wave)")
            require(hit["rg_decodes"] == row["rg_decodes"],
                    f"the second wave decoded {hit['rg_decodes'] - row['rg_decodes']} row groups")
            require(hit["span_counts"]["device.refine_multi_launch"] == 0
                    and hit["span_counts"]["device.refine_cached"] > 0,
                    f"the second wave's device spans: {hit['span_counts']}")
            launches = {c.kname: c.launches for c in counters}
            require(not any(launches.values()), f"the second wave launched {launches}")
            for name in total:
                total[name] += launches[name]
            row["second_wave"] = hit
        srv.invalidate()
        torch.cuda.synchronize()
        freed = torch.cuda.memory_allocated()
        require(freed == mem0, f"after invalidate() {freed - mem0} device bytes remain")
        srv.close()
        out["by_query_count"][str(n)] = row
        emit({"serve_wave": {"queries": n, **row}})
        del srv
    # the unshared baseline: each distinct box as a solo sequential scan
    t0 = time.perf_counter()
    for i, b in enumerate(boxes):
        res = scanner.scan(b, refine=True, device=DEVICE, parallel=False)
        torch.cuda.synchronize()
        oracle.check_expected(res, wants[i], f"sequential {QUERY_FRACS[i]}")
        del res
    out["sequential_s"] = time.perf_counter() - t0
    out["launches"] = total
    out["kernel_times"] = serve_shape_kernels(scanner, boxes[2])
    return out


def serve_shape_kernels(scanner, bbox) -> dict:
    """Kernels 1 and 2 timed at the shape the serve tier gives them: the
    first device chunk of a whole row group (shard 0, row group 0) read by
    ``read_row_group``, where the file path's launches cover a bbox's pages
    only. Each is held once against its plain version at this shape; these
    launches are not counted as the serve tier's."""
    import torch

    from repro_torch.kernels.fp_delta import kernel as fk, ref as fr, stream_from_numpy
    from repro_torch.kernels.minmax import bbox_query_keys, keys64
    from repro_torch.kernels.minmax import kernel as mk, ref as mr

    with scanner.open_shard(0) as r:
        data = r.read_row_group(0, device=DEVICE)
    ch = next((c for c in data.chunks if c.kind == "dev"), None)
    require(ch is not None, "shard 0 row group 0 has no device chunk")
    ds = stream_from_numpy(ch.stream, ch.aux, device=DEVICE)
    out = {}

    args = (ds.words32, ds.tok_off, ds.nbits, ds.anchor, ds.width)
    got = fk.decode_stream(*args)
    bad, err = mismatches(got, fr.decode_stream_ref(*args))
    n = ds.n_values
    last_bit = int((ch.stream.tok_off.reshape(-1)[:n].astype(np.int64)
                    + ch.stream.nbits.reshape(-1)[:n]).max())
    words_used = -(-last_bit // 32) * 4
    bytes_moved = words_used + 12 * n + n * ds.width // 8
    out["fp_delta.decode_stream"] = dict(
        mismatches=bad, max_abs_err=err, ms=cuda_ms(lambda: fk.decode_stream(*args)),
        device_ms=device_ms(lambda: fk.decode_stream(*args)), bytes=bytes_moved,
        bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
        shape={"values": n, "positions": int(ds.tok_off.numel()),
               "packed_word_bytes": words_used, "width": ds.width})

    q = keys64(bbox_query_keys(bbox, np.float32 if ds.width == 32 else np.float64))
    rargs = (got, ds.x_start, ds.y_start, ds.counts, ds.valid, q, ds.width)
    kk, km = mk.segminmax_refine(*rargs)
    pk, pm = mr.segminmax_refine_ref(*rargs)
    torch.cuda.synchronize()
    m1, e1 = mismatches(kk.to(torch.int32), pk.to(torch.int32))
    m2, e2 = mismatches(km, pm)
    n_rec = int(ds.counts.shape[0])
    vals = 2 * int(ch.aux.counts.sum())
    bytes_moved = vals * ds.width // 8 + n_rec * (8 * 3 + 1) + n_rec * (1 + 32)
    out["minmax.segminmax_refine"] = dict(
        mismatches=m1 + m2, max_abs_err=max(e1, e2),
        ms=cuda_ms(lambda: mk.segminmax_refine(*rargs)),
        device_ms=device_ms(lambda: mk.segminmax_refine(*rargs)), bytes=bytes_moved,
        bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
        shape={"records": n_rec, "values": vals, "width": ds.width})
    for name, row in out.items():
        require(row["mismatches"] == 0,
                f"{name}: kernel disagrees with its plain version at the serve shape")
    return out


# ---------------------------------------------------------------- data feed
def feed_path(root: Path, bbox, counters) -> dict:
    """Phase 3d: the trajectory data feed (the reference pipeline bench's
    settings) on the card and on the host; batches equal bit for bit."""
    from repro_torch.data.pipeline import Prefetcher, TrajectoryBatcher
    from repro_torch.data.synthetic import PORTO_BBOX
    from repro_torch.data.tokenizer import GeoTokenizer

    out, batches = {}, {}
    for device in (DEVICE, "host"):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        it = Prefetcher(TrajectoryBatcher(
            [root], GeoTokenizer(PORTO_BBOX, order=6), seq_len=FEED_SEQ,
            global_batch=FEED_BATCH, bbox=bbox, loop=False, seed=0, device=device))
        batches[device] = [b["tokens"] for b in it]
        wall = time.perf_counter() - t0
        n_tok = sum(b.size for b in batches[device])
        out[device] = {"batches": len(batches[device]), "tokens": n_tok, "wall_s": wall,
                       "tokens_per_s": n_tok / wall, "stalls": it.stalls,
                       "launches": {c.kname: c.launches for c in counters}}
    got, want = batches[DEVICE], batches["host"]
    require(len(got) == len(want) > 0, f"{len(got)} batches on the card, {len(want)} on the host")
    require(all(np.array_equal(g, w) for g, w in zip(got, want)),
            "the card's batches differ from the host's")
    launches = out[DEVICE]["launches"]
    for name in FILE_KERNELS[:2]:
        require(launches[name] > 0, f"kernel {name} was not launched by the data feed")
    require(not any(out["host"]["launches"].values()), "the host feed launched a kernel")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- codec path
def codec_path(cols, counters) -> dict:
    """Phase 3b: ``compress_array``/``decompress_array`` of the Porto x and
    y columns as float32 (the reference bench's ``x32``) on the card."""
    import torch

    from repro_torch.core.fp_delta import fp_delta_encode
    from repro_torch.kernels.fp_delta import compress_array, decompress_array

    arrays = {"x32": cols.x.astype(np.float32), "y32": cols.y.astype(np.float32)}
    out = {}
    for c in counters:
        c.launches = 0
    for name, a in arrays.items():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        buf = compress_array(a, device=DEVICE)
        ev[1].record()
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev[2].record()
        back = decompress_array(buf, a.shape, np.float32, device=DEVICE)
        ev[3].record()
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        require(back.dtype == np.float32 and back.shape == a.shape, f"codec {name}: {back.dtype} {back.shape}")
        require(np.array_equal(back.view(np.int32), a.view(np.int32)), f"codec {name}: bits differ")
        out[name] = {"values": int(a.size), "raw_bytes": int(a.nbytes), "compressed_bytes": len(buf),
                     "ratio": a.nbytes / len(buf), "compress_wall_s": enc_s,
                     "decompress_wall_s": dec_s, "compress_events_ms": ev[0].elapsed_time(ev[1]),
                     "decompress_events_ms": ev[2].elapsed_time(ev[3])}
    launches = {c.kname: c.launches for c in counters}
    for name in CODEC_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the codec path")
    for name, a in arrays.items():
        t0 = time.perf_counter()
        exact, _ = fp_delta_encode(a)
        mini = out[name]["compressed_bytes"] - 16        # FPD2 header: magic, n_values, n_blocks
        out[name].update(exact_bytes=len(exact), exact_encode_s=time.perf_counter() - t0,
                         miniblock_vs_exact_penalty_pct=100.0 * (mini / len(exact) - 1.0))
    return {"arrays": out, "launches": launches, "_x32": arrays["x32"]}


def codec_blocks(rng) -> list[tuple[str, np.ndarray, tuple | None]]:
    """Adversarial miniblocks as uint32 patterns (n, 1024), each with the
    (width, exception count) it must encode to, or None."""
    import torch

    from repro_torch.kernels.fp_delta.ops import _pad_to_blocks
    from repro_torch.kernels.fp_delta.ref import WIDTHS

    def from_zig(z):
        z = np.asarray(z, np.uint32).copy()
        z[0] = 0
        d = (z >> np.uint32(1)) ^ (np.uint32(0) - (z & np.uint32(1)))
        return np.uint32(0x42240000) + np.cumsum(d, dtype=np.uint32)

    def bits(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)

    cases = [("random_int32", rng.integers(0, 2 ** 32, (4, 1024), dtype=np.uint64)
              .astype(np.uint32), (32, 0)),
             ("constant", np.full((1, 1024), np.float32(2.5)).view(np.uint32), (0, 0))]
    for w in WIDTHS:
        cases.append((f"width_{w}", from_zig(bits(1 << (w - 1), 1 << w, 1024))[None], (w, 0)))
    for k, want in ((64, (4, 64)), (65, (20, 0))):
        z = bits(8, 16, 1024)
        z[rng.choice(np.arange(1, 1024), k, replace=False)] = bits(1 << 19, 1 << 20, k)
        cases.append((f"outliers_{k}", from_zig(z)[None], want))
    z = np.ones(1024, np.uint32)            # cost(1) = 1024 + 48*64 = cost(4): keeps 1
    z[rng.choice(np.arange(1, 1024), 64, replace=False)] = bits(8, 16, 64)
    cases.append(("cost_tie", from_zig(z)[None], (1, 64)))
    sp = (np.cumsum(rng.normal(0, 1e-4, 2048)) + 41.1).astype(np.float32).view(np.uint32)
    specials = np.array([0x7FC00001, 0xFFA00005, 0x7F800001, 0x7F800000, 0xFF800000, 0x0,
                         0x80000000, 0x1, 0x80000001, 0x007FFFFF], np.uint32)
    sp[rng.integers(0, sp.size, 40)] = specials[rng.integers(0, specials.size, 40)]
    cases.append(("nan_inf_zero_denormal", sp.reshape(2, 1024), None))
    ragged = (np.cumsum(rng.normal(0, 1e-3, 3 * 1024 + 333)) - 8.6).astype(np.float32)
    cases.append(("ragged_last_block",
                  _pad_to_blocks(torch.from_numpy(ragged))[0].numpy().view(np.uint32), None))
    return cases


def decode_malformed(enc, rng) -> list[tuple[str, list]]:
    """Decode inputs that encode never writes, cut from six encoded blocks
    ``enc``: repeated live exception slots (three on one position, a pair
    whose sum wraps, all 64 on one position), positions -1, 1024, 65535 and
    -2^31, exception counts -1, 0, 64 and 255 over random slots with ten
    repeats, and widths outside the format (5, 33, -1, 7, 255)."""
    import torch

    def i32(a):
        return torch.tensor(np.asarray(a, np.int64).astype(np.int32), device=DEVICE)

    def fresh():
        return [t[:6].clone() for t in enc]

    out = []
    a = fresh()
    a[3][0, :5] = i32([17, 17, 17, 900, 900])
    a[4][0, :5] = i32([5, 9, -2, 2 ** 31 - 1, 2 ** 31 - 1])
    a[5][0] = 5
    a[3][1, :] = 3
    a[4][1, :] = i32(rng.integers(-2 ** 31, 2 ** 31, 64))
    a[5][1] = 64
    out.append(("repeated_slots", a))
    a = fresh()
    a[3][2, :6] = i32([-1, 1024, 65535, 0, 1023, -2 ** 31])
    a[4][2, :6] = i32(rng.integers(-2 ** 31, 2 ** 31, 6))
    a[5][2] = 6
    out.append(("positions_out_of_range", a))
    for c in (-1, 0, 64, 255):
        a = fresh()
        a[3][:] = i32(rng.integers(0, 1024, (6, 64)))
        a[3][:, 10:20] = 500
        a[4][:] = i32(rng.integers(-2 ** 31, 2 ** 31, (6, 64)))
        a[5][:] = c
        out.append((f"count_{c}", a))
    a = fresh()
    a[1][:] = i32([5, 33, -1, 7, 255, 32])
    out.append(("widths_outside_format", a))
    return out


def check_codec(codec: dict) -> list[dict]:
    """Both codec kernels against their plain versions at the codec path's
    shape and on :func:`codec_blocks`; exact equality, then times."""
    import torch

    from repro_torch.kernels.fp_delta import kernel as fk, ref as fr
    from repro_torch.kernels.fp_delta.ops import _pad_to_blocks

    main_blocks = _pad_to_blocks(torch.from_numpy(codec["_x32"]).to(DEVICE))[0]
    cases = [("main_x32", main_blocks, None)]
    blocks = codec_blocks(np.random.default_rng(11))
    cases += [(n, torch.from_numpy(b.view(np.float32)).to(DEVICE), want) for n, b, want in blocks]
    # 1 and 7 miniblocks (fewer than the grid's warps) and 5,000 (more than
    # its warps hold at once), drawn from the adversarial blocks
    pool = np.concatenate([b for _, b, _ in blocks])
    pick = np.random.default_rng(12)
    cases += [(f"blocks_{k}", torch.from_numpy(pool[pick.integers(0, len(pool), k)]
                                               .view(np.float32)).to(DEVICE), None)
              for k in (1, 7, 5000)]
    bad_e = bad_d = 0
    err_e = err_d = 0.0
    for name, blocks, want in cases:
        ko = fk.encode_blocks(blocks)
        po = fr.encode_blocks_ref(blocks)
        kd = fk.decode_blocks(*ko)
        pd = fr.decode_blocks_ref(*ko)
        torch.cuda.synchronize()
        me_all = [mismatches(a, b) for a, b in zip(ko, po)]
        md_all = [mismatches(kd, pd), mismatches(kd, blocks)]
        me, md = sum(m for m, _ in me_all), sum(m for m, _ in md_all)
        err_e = max([err_e] + [e for _, e in me_all])
        err_d = max([err_d] + [e for _, e in md_all])
        line = {"check": "fp_delta.miniblock", "case": name, "blocks": int(blocks.shape[0]),
                "encode_mismatches": me, "decode_mismatches": md}
        if blocks.shape[0] <= 4:
            line["widths"] = ko[1].tolist()
            line["exc_count"] = ko[5].tolist()
        if want is not None:
            got = (int(ko[1][0]), int(ko[5][0]))
            require(got == want, f"miniblock {name}: (width, exceptions) {got}, designed {want}")
        emit(line)
        bad_e, bad_d = bad_e + me, bad_d + md
    n = int(main_blocks.shape[0])
    enc = fk.encode_blocks(main_blocks)
    # streams outside encode's contract: the kernel sums repeated live
    # slots as the plain version (and the reference) does
    for name, args in decode_malformed(enc, np.random.default_rng(13)):
        m, e = mismatches(fk.decode_blocks(*args), fr.decode_blocks_ref(*args))
        emit({"check": "fp_delta.decode_malformed", "case": name, "blocks": 6,
              "mismatches": m})
        bad_d, err_d = bad_d + m, max(err_d, e)
    widths, counts = enc[1].to(torch.int64), enc[5].to(torch.int64)
    e_ms = cuda_ms(lambda: fk.encode_blocks(main_blocks))
    e_dev = device_ms(lambda: fk.encode_blocks(main_blocks))
    ep_ms = cuda_ms(lambda: fr.encode_blocks_ref(main_blocks), iters=3, warmup=1)
    d_ms = cuda_ms(lambda: fk.decode_blocks(*enc))
    d_dev = device_ms(lambda: fk.decode_blocks(*enc))
    dp_ms = cuda_ms(lambda: fr.decode_blocks_ref(*enc), iters=3, warmup=1)
    # encode: 4 B a value in; packed words, three int32 scalars and 2 x 64 slots out
    e_bytes = n * (4096 + 4096 + 12 + 2 * 64 * 4)
    # decode: valid payload words, live exception slots and the scalars in; 4 B a value out
    d_bytes = int(widths.sum()) * 32 * 4 + int(counts.sum()) * 8 + n * 12 + n * 4096
    shape = {"blocks": n, "values": n * 1024, "mean_width": float(widths.double().mean()),
             "exceptions": int(counts.sum())}
    row = dict(route="cuda", source="src/repro_torch/csrc/miniblock.cu", library_ms=None,
               bound_by="bytes", shape=shape)
    return [dict(row, name=CODEC_KERNELS[0], replaces="src/repro/kernels/fp_delta/kernel.py:102",
                 mismatches=bad_e, max_abs_err=err_e, ms=e_ms, device_ms=e_dev,
                 plain_ms=ep_ms, bytes=e_bytes, bound_ms=e_bytes / HBM_BYTES_PER_S * 1e3),
            dict(row, name=CODEC_KERNELS[1], replaces="src/repro/kernels/fp_delta/kernel.py:233",
                 mismatches=bad_d, max_abs_err=err_d, ms=d_ms, device_ms=d_dev,
                 plain_ms=dp_ms, bytes=d_bytes, bound_ms=d_bytes / HBM_BYTES_PER_S * 1e3)]


# ---------------------------------------------------------------- LM path
def diff_stats(a, b, rows: int = 1024) -> dict:
    """Largest |a - b|, that over max |b|, and the share of positions whose
    argmax agree, over the last axis; in row chunks to bound the float32
    temporaries."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    mx = bmax = 0.0
    agree = 0
    for i in range(0, a2.shape[0], rows):
        x, y = a2[i:i + rows].float(), b2[i:i + rows].float()
        mx = max(mx, float((x - y).abs().max()))
        bmax = max(bmax, float(y.abs().max()))
        agree += int((x.argmax(-1) == y.argmax(-1)).sum())
    return {"max_abs": mx, "max_rel": mx / bmax, "top1_agree": agree / a2.shape[0]}


def tensors(tree) -> list:
    """The leaves of a nested dict of tensors."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    return [tree]


def device_split(fn) -> dict:
    """Device time of one call of ``fn`` by kernel group, from a
    ``torch.profiler`` trace: the flash kernel, cuBLAS matrix products, and
    everything else (casts, norms, RoPE, softmax, copies); and the share of
    the call's wall time in which some kernel ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"flash_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        name = e.name.lower()
        if "flash_fwd" in name:
            key = "flash_ms"
        elif any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            key = "gemm_ms"
        else:
            key = "other_ms"
        groups[key] += us / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):          # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    require(spans, "the profiler saw no device activity")
    return {**groups, "kernels": len(spans), "wall_ms": wall_us / 1e3,
            "device_busy_share": busy / wall_us}


def lm_path(args, counters) -> dict:
    """qwen3-8b forward (flash) and batched serving; the checks of phase 4.

    Logit tolerance. bf16 rounds at other places on the flash and plain
    paths (the kernel rounds the unnormalised P of each key tile to bf16,
    the plain path the normalised P), and 36 layers carry those roundings
    to the logits. Both paths
    are therefore held against a float32 forward of the same weights and
    tokens, and the flash logits must lie within twice the plain path's own
    distance to it: max |flash - plain| <= 2 * max |plain - float32|. If
    the flash path is no less faithful to float32 than the plain one, this
    holds by the triangle inequality.

    First tokens. Each request's first token must equal the argmax of the
    plain ``forward`` over its prompt alone, or score within the plain
    path's measured bf16 noise (max |plain - float32|) of that argmax: the
    server prefills a right-padded wave of 4 slots, whose bf16 products are
    rounded in other orders than a batch of one.
    """
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import BatchedServer

    base = get_config(LM_CONFIG)
    model = build_model(dataclasses.replace(base, attn_impl="flash"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(args.seed, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tensors(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tensors(params))
    rng = np.random.default_rng(args.seed + 2)
    tokens = rng.integers(0, base.vocab, (LM_BATCH, LM_SEQ)).astype(np.int32)
    model.forward(params, {"tokens": tokens[:1, :128]})   # cuBLAS handles, first launches
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    flash, _, _ = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    fwd_launches = {c.kname: c.launches for c in counters}
    require(tuple(flash.shape) == (LM_BATCH, LM_SEQ, base.vocab)
            and flash.dtype == torch.bfloat16, f"forward gave {flash.dtype} {tuple(flash.shape)}")
    require(bool(torch.isfinite(flash).all()), "forward gave non-finite logits")
    require(fwd_launches[LM_KERNELS[0]] == base.n_layers,
            f"{fwd_launches[LM_KERNELS[0]]} flash launches in one forward, "
            f"expected {base.n_layers}")
    require(fwd_launches[F32_FLASH] == 0, "the bf16 forward reached the float32 flash kernel")

    def serve(n_req, max_batch, new_tokens):
        """Submit ``n_req`` prompts of 16-64 random tokens at once and run
        the server until it drains; check every answer."""
        lens = rng.integers(16, 65, n_req)
        prompts = [rng.integers(3, base.vocab, int(n)).astype(np.int32) for n in lens]
        srv = BatchedServer(model.cfg, params, max_batch=max_batch, max_len=SERVE_MAX_LEN)
        obs.enable()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            srv.submit(p, max_new_tokens=new_tokens, rid=i)
        done = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hists = obs.snapshot()["histograms"]
        obs.disable()
        require(sorted(r.rid for r in done) == list(range(n_req)),
                f"served rids {sorted(r.rid for r in done)}, expected 0..{n_req - 1}")
        require(all(1 <= len(r.out_tokens) <= new_tokens for r in done),
                f"token counts {sorted({len(r.out_tokens) for r in done})}")
        for h in ("serve.ttft_s", "serve.latency_s"):
            require(hists[h]["count"] == n_req, f"{h} holds {hists[h]['count']} observations")
        return srv, done, wall

    # the functional check: a few requests whose first tokens are checked below
    srv, done, _ = serve(SERVE_CHECK_REQUESTS, 4, 16)
    launches = {c.kname: c.launches for c in counters}
    for name in LM_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the LM path")
    del srv
    # the load: enough requests and batch for latency percentiles to mean something
    srv, load_done, load_s = serve(*SERVE_LOAD)
    n_tok = sum(len(r.out_tokens) for r in load_done)
    ttft = np.array([r.t_first - r.t_submit for r in load_done])
    lat = np.array([r.t_done - r.t_submit for r in load_done])
    qs = {"p50": 50, "p90": 90, "p99": 99}
    load = {"requests": len(load_done), "max_batch": SERVE_LOAD[1],
            "max_new_tokens": SERVE_LOAD[2], "new_tokens": n_tok, "wall_s": load_s,
            "tokens_per_s": n_tok / load_s,
            "ttft_s": {k: float(np.percentile(ttft, q)) for k, q in qs.items()},
            "latency_s": {k: float(np.percentile(lat, q)) for k, q in qs.items()}}
    peak_path = torch.cuda.max_memory_allocated()
    split = {"forward": device_split(lambda: model.forward(params, {"tokens": tokens}))}
    srv.submit(load_done[0].prompt, max_new_tokens=3, rid=SERVE_LOAD[0])
    srv._fill_slots()
    split["decode_step"] = device_split(srv._decode_once)
    del srv
    emit({"lm_device_split": split})

    plain_model = build_model(dataclasses.replace(base, attn_impl="ref"))
    t0 = time.perf_counter()
    plain, _, _ = plain_model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    f32_model = build_model(dataclasses.replace(base, attn_impl="ref", dtype="float32"))
    t0 = time.perf_counter()
    full, _, _ = f32_model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    flash_plain = diff_stats(flash, plain)
    plain_f32 = diff_stats(plain, full)
    flash_f32 = diff_stats(flash, full)
    tol = 2 * plain_f32["max_abs"]
    emit({"lm_logits": {"flash_vs_plain": flash_plain, "plain_vs_float32": plain_f32,
                        "flash_vs_float32": flash_f32, "tolerance_max_abs": tol,
                        "tolerance_rel": tol / float(plain.float().abs().max())}})
    require(flash_plain["max_abs"] <= tol,
            f"flash logits differ from the plain path by {flash_plain['max_abs']} > {tol}")
    del flash, plain

    # the float32 route: the same forward in float32 compute with the flash
    # kernel, every count set to 0 just before; it launches the split-TF32
    # kernel once a layer and must lie no farther from the float32 plain
    # forward than the bf16 plain forward does
    f32_flash_model = build_model(dataclasses.replace(base, attn_impl="flash", dtype="float32"))
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    f32_flash, _, _ = f32_flash_model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    f32_flash_s = time.perf_counter() - t0
    f32_launches = {c.kname: c.launches for c in counters}
    require(f32_launches[F32_FLASH] == base.n_layers and f32_launches[LM_KERNELS[0]] == 0,
            f"the float32 forward launched {f32_launches[F32_FLASH]} float32 and "
            f"{f32_launches[LM_KERNELS[0]]} bf16 flash kernels, expected {base.n_layers} and 0")
    require(f32_flash.dtype == torch.float32 and bool(torch.isfinite(f32_flash).all()),
            f"the float32 flash forward gave {f32_flash.dtype} or non-finite logits")
    f32_route = {"forward_s": f32_flash_s, "launches": f32_launches,
                 "vs_float32_plain": diff_stats(f32_flash, full),
                 "tolerance_max_abs": plain_f32["max_abs"]}
    emit({"lm_float32_route": f32_route})
    require(f32_route["vs_float32_plain"]["max_abs"] <= plain_f32["max_abs"],
            f"float32 flash logits differ from the float32 plain forward by "
            f"{f32_route['vs_float32_plain']['max_abs']} > {plain_f32['max_abs']}")
    del f32_flash, full

    noise = plain_f32["max_abs"]
    exact, worst = 0, 0.0
    for r in sorted(done, key=lambda r: r.rid):
        lg, _, _ = plain_model.forward(params, {"tokens": r.prompt[None]})
        last = lg[0, -1].float()
        tok = r.out_tokens[0]
        gap = float(last.max() - last[tok])
        exact += int(int(last.argmax()) == tok)
        worst = max(worst, gap)
        require(gap <= noise, f"request {r.rid}: first token {tok} scores {gap} below the "
                              f"forward's argmax, beyond the bf16 noise {noise}")
    first = {"exact": exact, "of": len(done), "largest_gap": worst, "allowed_gap": noise}
    peak = torch.cuda.max_memory_allocated()
    del params, model, plain_model, f32_model, f32_flash_model
    torch.cuda.empty_cache()
    return {"config": LM_CONFIG, "n_params": n_params, "param_bytes": param_bytes,
            "init_s": init_s, "forward_s": forward_s, "forward_tokens": LM_BATCH * LM_SEQ,
            "plain_forward_s": plain_s, "float32_forward_s": f32_s, "float32_route": f32_route,
            "forward_launches": fwd_launches, "launches": launches, "device_split": split,
            "serve_check": {"requests": len(done),
                            "prompt_lens": [len(r.prompt) for r in
                                            sorted(done, key=lambda r: r.rid)],
                            "new_tokens": sum(len(r.out_tokens) for r in done),
                            "first_token": first},
            "serve_load": load,
            "max_memory_allocated_path": peak_path, "max_memory_allocated": peak}


FLASH_SHAPES = [  # tests/test_kernels.py of the reference: (b, hq, hkv, sq, sk, d, causal)
    (2, 4, 4, 128, 128, 64, True),
    (1, 8, 2, 256, 256, 64, True),
    (2, 2, 2, 128, 128, 32, False),
    (1, 4, 4, 128, 384, 64, True),
    (1, 2, 2, 1, 128, 64, True),
    (1, 2, 2, 100, 128, 64, True),
]
# causal, Sq > Sk: rows r < Sq - Sk see no key (float32 only; the bf16
# kernel's are held by tests/test_torch_cuda.py)
F32_DARK_SHAPES = [(1, 2, 2, 200, 128, 64, True), (1, 4, 2, 300, 128, 128, True)]


def family_flash_shapes() -> list[tuple[str, tuple]]:
    """(label, (b, hq, hkv, sq, sk, d, causal)) of every flash call that
    phase 4c's forwards make: each flash family's causal self-attention over
    ``LM_SEQ`` positions (zamba2's shared block, whisper's decoder) and
    whisper's non-causal encoder over ``FAMILY_FRAMES`` frames."""
    from repro_torch.configs import get_config

    out = []
    for name, impl, _ in FAMILY_RUNS:
        if impl != "flash":
            continue
        cfg = get_config(name)
        heads = (LM_BATCH, cfg.n_heads, cfg.n_kv_heads)
        d = cfg.resolved_head_dim
        out.append((name, (*heads, LM_SEQ, LM_SEQ, d, True)))
        if cfg.family == "encdec":
            out.append((f"{name}_encoder", (*heads, FAMILY_FRAMES, FAMILY_FRAMES, d, False)))
    return out


def check_flash(seed: int) -> list[dict]:
    """Phase 5: both flash kernels against their plain version through
    ``ops.attention``, at the LM path's shape, at every shape that phase
    4c's forwards give the bf16 kernel (:func:`family_flash_shapes`), and at
    the reference's shapes; their times at the LM path's shape.

    Tolerances. Every element of a kernel's output is held to the float32
    plain version on the same input values. bf16 (the sm90 kernel) rounds
    P to bf16 before P.V, which moves each term by at most u = 2^-8 of
    itself, and rounds its output once, so
    |got - want32| <= 2^-8 |want32| + (2^-8 + 2^-15) A + 1e-5 with A the
    plain version's softmax-weighted mean of |v| (2^-15 A: second-order
    terms; 1e-5: float32 sum order). The reference's 3e-2 against the bf16
    plain version (which also rounds P) is checked too, as its parity
    number. float32 (the split-TF32 kernel): 1e-5 at the LM shape, the
    reference's 2e-5 at its six shapes; at the two Sq > Sk shapes
    (:data:`F32_DARK_SHAPES`) the rows r < Sq - Sk, which see no key, must
    be exactly 0 (the TPU kernel skips their front-padded block whole) and
    the others lie within 2e-5.

    Bounds at the LM shape: bf16 by operations at the tensor cores' bf16
    peak. The float32 kernel forms each product from three TF32 passes, so
    its bound is 3 x flops at the TF32 peak (or its bytes, whichever is
    larger); the CUDA-core figure (flops at the float32 peak outside the
    tensor cores, the bound of the kernel it replaced) is kept beside it.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention, attention_plain, kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 3)
    cfg = get_config(LM_CONFIG)
    main_shape = (LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_SEQ, LM_SEQ,
                  cfg.resolved_head_dim, True)

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        # (B, S, H, D) as the model holds them, handed over as (B, H, S, D) views
        def one(h, s):
            a = torch.from_numpy(rng.normal(0, 1, (b, s, h, d)).astype(np.float32))
            return a.to(DEVICE, dtype).transpose(1, 2)
        return one(hq, sq), one(hkv, sk), one(hkv, sk)

    def name(sh, dt):
        return f"{dt}_{'x'.join(map(str, sh[:6]))}{'' if sh[6] else '_noncausal'}"

    cases = [("main_bf16", main_shape, torch.bfloat16), ("main_f32", main_shape, torch.float32)]
    cases += [(f"{fam}_bf16", sh, torch.bfloat16) for fam, sh in family_flash_shapes()]
    cases += [(name(sh, dt), sh, dtype) for dt, dtype in (("bf16", torch.bfloat16),
                                                         ("f32", torch.float32))
              for sh in FLASH_SHAPES]
    cases += [(name(sh, "f32_dark"), sh, torch.float32) for sh in F32_DARK_SHAPES]
    bad = {torch.bfloat16: 0, torch.float32: 0}
    err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for case, (b, hq, hkv, sq, sk, d, causal), dt in cases:
        q, k, v = qkv(b, hq, hkv, sq, sk, d, dt)
        got = attention(q, k, v, causal=causal).float()
        want = attention_plain(q.float(), k.float(), v.float(), causal=causal)
        dark = max(sq - sk, 0) if causal else 0   # rows that see no key
        dark_zero = bool((got[:, :, :dark] == 0).all())
        got, want = got[:, :, dark:], want[:, :, dark:]
        diff = (got - want).abs()
        if dt == torch.bfloat16:
            a = attention_plain(q.float(), k.float(), v.float().abs(), causal=causal)[:, :, dark:]
            tol = 2.0 ** -8 * want.abs() + (2.0 ** -8 + 2.0 ** -15) * a + 1e-5
            rule = "2^-8 |want32| + (2^-8 + 2^-15) A + 1e-5"
            del a
        else:
            tol = torch.full_like(want, 1e-5 if case == "main_f32" else 2e-5)
            rule = "1e-5" if case == "main_f32" else "2e-5"
        e = float(diff.max())
        share = float((diff / tol).max())
        line = {"check": "flash_attention", "case": case, "dtype": str(dt).split(".")[-1],
                "shape": [b, hq, hkv, sq, sk, d], "causal": causal, "max_abs_err": e,
                "tolerance": rule, "largest_share_of_tol": share}
        ok = share <= 1.0
        if dark:
            line["rows_without_keys"] = {"rows": dark, "all_zero": dark_zero}
            ok = ok and dark_zero
        if dt == torch.bfloat16:
            pe = float((got - attention_plain(q, k, v, causal=causal).float()[:, :, dark:])
                       .abs().max())
            line["vs_bf16_plain"] = {"max_abs_err": pe, "tolerance": 3e-2}
            ok = ok and pe <= 3e-2
        emit(line)
        bad[dt] += int(not ok)
        err[dt] = max(err[dt], e)
        if case == "main_bf16":
            main = (q, k, v)
        del got, want, diff, tol
    q, k, v = main
    q32, k32, v32 = (t.float() for t in main)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = float((sdpa(q, k, v, is_causal=True, enable_gqa=True).float()
                     - attention_plain(q, k, v).float()).abs().max())
    # turns: sm90, SDPA, sm90 again
    k_ms = cuda_ms(lambda: kernel.flash_attention_sm90(q, k, v, causal=True), iters=20)
    l_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), iters=20)
    k_ms2 = cuda_ms(lambda: kernel.flash_attention_sm90(q, k, v, causal=True), iters=20)
    k_dev = device_ms(lambda: kernel.flash_attention_sm90(q, k, v, causal=True))
    f32_ms = cuda_ms(lambda: kernel.flash_attention_f32(q32, k32, v32, causal=True), iters=5,
                     warmup=1)
    f32_dev = device_ms(lambda: kernel.flash_attention_f32(q32, k32, v32, causal=True), iters=5,
                        warmup=1)
    f32_lib_ms = cuda_ms(lambda: sdpa(q32, k32, v32, is_causal=True, enable_gqa=True), iters=5,
                         warmup=1)
    p_ms = cuda_ms(lambda: attention_plain(q, k, v), iters=3, warmup=1)
    f32_p_ms = cuda_ms(lambda: attention_plain(q32, k32, v32), iters=3, warmup=1)
    b, hq, hkv, sq, sk, d, _ = main_shape
    pairs = sq * (sq + 1) // 2                 # visible (row, col) pairs per head, Sq = Sk
    flops = 2 * 2 * d * pairs * b * hq         # QK^T and P.V, a multiply and an add each
    bytes_moved = 2 * (2 * q.numel() + k.numel() + v.numel())   # bf16 q, k, v read; o written
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, bytes_moved / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    # the float32 kernel: float32 operands, each product three TF32 passes
    f32_ops, f32_bytes = 3 * flops / TF32_FLOPS_PER_S, 2 * bytes_moved / HBM_BYTES_PER_S
    f32_bound = {"split_tf32_ms": f32_ops * 1e3, "bytes_ms": f32_bytes * 1e3,
                 "cuda_cores_ms": flops / FP32_FLOPS_PER_S * 1e3,
                 "hmma_instructions": hmma_count("flash_attention")}
    emit({"flash_attention_times_ms": {
        "sm90_bf16": [k_ms, k_ms2], "split_tf32_float32": f32_ms, "sdpa_bf16": l_ms,
        "sdpa_float32": f32_lib_ms, "plain_bf16": p_ms, "plain_float32": f32_p_ms,
        "bound": bound_ms, "bound_float32": f32_bound, "shape": list(main_shape)}})
    require(f32_bound["hmma_instructions"] != 0,
            "the float32 flash library holds no tensor-core (HMMA) instruction")
    require(bad[torch.float32] == 0, "the float32 flash kernel disagrees with its plain version")
    row = dict(route="cuda", replaces="src/repro/kernels/flash_attention/kernel.py:82", flops=flops)
    shape = {"b": b, "hq": hq, "hkv": hkv, "s": sq, "d": d}
    return [dict(row, name=LM_KERNELS[0], source="src/repro_torch/csrc/flash_attention_sm90.cu",
                 mismatches=bad[torch.bfloat16], max_abs_err=err[torch.bfloat16],
                 ms=min(k_ms, k_ms2), device_ms=k_dev, plain_ms=p_ms, bytes=bytes_moved,
                 bound_ms=bound_ms, bound_by="operations" if t_ops >= t_bytes else "bytes",
                 library_ms=l_ms, library_max_abs_err=lib_err,
                 tflops=flops / min(k_ms, k_ms2) / 1e9, shape=dict(shape, dtype="bfloat16")),
            dict(row, name=F32_FLASH, source="src/repro_torch/csrc/flash_attention.cu",
                 mismatches=bad[torch.float32], max_abs_err=err[torch.float32], ms=f32_ms,
                 device_ms=f32_dev, plain_ms=f32_p_ms, bytes=2 * bytes_moved,
                 bound_ms=max(f32_ops, f32_bytes) * 1e3,
                 bound_by="operations" if f32_ops >= f32_bytes else "bytes",
                 bound_detail=dict(f32_bound, route="split TF32: 3 x flops at 495 TFLOP/s"),
                 library_ms=f32_lib_ms, tflops=flops / f32_ms / 1e9,
                 shape=dict(shape, dtype="float32"))]


# ---------------------------------------------------------------- LM families
def spatial_lm_serve(args, lake: Path, bbox, counters) -> dict:
    """Phase 4c (a): spatial-lm, at the tokenizer's vocab, serving trajectory
    continuations whose prompts are read from the Porto lake on the card.

    Tolerance of the prefill logits against the same call on the CPU
    (float32 both, TF32 off): 1e-4 of max |logits|. The two take the same
    float32 sums in other orders; a product of length K rounds by about
    sqrt(K) * 2^-24 of its scale (K <= 1024 here: 2e-6), and 12 layers of
    about six products in series give sqrt(72) * 2e-6 = 1.6e-5, so 1e-4
    leaves a margin of six.
    """
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TrajectoryBatcher
    from repro_torch.data.synthetic import PORTO_BBOX
    from repro_torch.data.tokenizer import GeoTokenizer
    from repro_torch.models import build_model, params_to
    from repro_torch.serve import BatchedServer

    n_batches, prompt_len = SPATIAL_PROMPTS
    max_batch, max_len, new_tokens = SPATIAL_LOAD
    tok = GeoTokenizer(PORTO_BBOX, order=6)
    cfg = dataclasses.replace(get_config("spatial-lm"), vocab=tok.vocab)
    t0 = time.perf_counter()
    it = iter(TrajectoryBatcher([lake], tok, seq_len=FEED_SEQ, global_batch=FEED_BATCH,
                                bbox=bbox, loop=False, seed=0, device=DEVICE))
    batches = [next(it) for _ in range(n_batches)]
    it.close()
    read_s = time.perf_counter() - t0
    read_launches = {c.kname: c.launches for c in counters}
    for name in FILE_KERNELS[:2]:
        require(read_launches[name] > 0, f"kernel {name} was not launched by the prompt read")
    prompts = [row[:prompt_len] for b in batches for row in b["tokens"].reshape(-1, FEED_SEQ)]
    require(len(prompts) == n_batches * FEED_BATCH and all(p[0] == 1 for p in prompts),
            "the prompts are not BOS-led trip prefixes")

    model = build_model(cfg)
    params = model.init(args.seed, device=DEVICE)
    srv = BatchedServer(cfg, params, max_batch=max_batch, max_len=max_len)
    obs.enable()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        srv.submit(p, max_new_tokens=new_tokens, rid=i)
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    obs.disable()
    require(sorted(r.rid for r in done) == list(range(len(prompts))),
            "the spatial-lm server did not answer every request")
    require(all(1 <= len(r.out_tokens) <= new_tokens and max(r.out_tokens) < cfg.vocab
                for r in done), "a spatial-lm answer has a bad length or token")
    n_tok = sum(len(r.out_tokens) for r in done)
    ttft = np.array([r.t_first - r.t_submit for r in done])
    lat = np.array([r.t_done - r.t_submit for r in done])
    qs = {"p50": 50, "p99": 99}

    # hold: the first wave's prefill on the card against the same call on the CPU
    wave = np.stack(prompts[:max_batch])
    cpu_params = params_to(params, "cpu")
    logits = {}
    for dev, ps in ((DEVICE, params), ("cpu", cpu_params)):
        cache = model.init_cache(max_batch, max_len, device=dev)
        cache["pos"] = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        logits[dev], _ = model.forward_with_cache(ps, {"tokens": wave}, cache)
    want = logits["cpu"].float()
    err = float((logits[DEVICE].float().cpu() - want).abs().max())
    tol = 1e-4 * float(want.abs().max())
    # the same first wave served on the CPU: the share of greedy tokens that agree
    cpu_srv = BatchedServer(cfg, cpu_params, max_batch=max_batch, max_len=max_len)
    for i, p in enumerate(prompts[:max_batch]):
        cpu_srv.submit(p, max_new_tokens=new_tokens, rid=i)
    on_cpu = {r.rid: r.out_tokens for r in cpu_srv.run()}
    on_card = {r.rid: r.out_tokens for r in done if r.rid < max_batch}
    pairs = [(a, b) for i in on_cpu for a, b in zip(on_card[i], on_cpu[i])]
    out = {"config": "spatial-lm", "vocab": cfg.vocab, "prompts": len(prompts),
           "prompt_len": prompt_len, "read_s": read_s, "read_launches": read_launches,
           "max_batch": max_batch, "max_len": max_len, "max_new_tokens": new_tokens,
           "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_s": {k: float(np.percentile(ttft, q)) for k, q in qs.items()},
           "latency_s": {k: float(np.percentile(lat, q)) for k, q in qs.items()},
           "prefill_vs_cpu": {"max_abs": err, "tolerance_max_abs": tol,
                              "tolerance": "1e-4 max |cpu logits|"},
           "greedy_tokens_equal_cpu": sum(a == b for a, b in pairs) / len(pairs),
           "first_tokens_equal_cpu": sum(on_card[i][0] == on_cpu[i][0] for i in on_cpu)
           / len(on_cpu)}
    emit({"spatial_lm_serve": out})
    require(err <= tol, f"spatial-lm prefill logits differ from the CPU's by {err} > {tol}")
    del srv, cpu_srv, params, logits
    return out


def family_batch(cfg, rng, b: int, s: int, frames: int) -> dict:
    """``s`` positions: a vlm's patches in front of its tokens, an encdec's
    ``frames`` audio frames beside them."""
    n_tok = s - cfg.vision_tokens if cfg.family == "vlm" else s
    out = {"tokens": rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (b, frames, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(0, 1, (b, cfg.vision_tokens, cfg.frontend_dim)).astype(
            np.float32)
    return out


def row_max_abs(a, b, rows: int = 1024):
    """max |a - b| over the last axis, one value per position."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return np.concatenate([(a2[i:i + rows].float() - b2[i:i + rows].float()).abs()
                           .amax(-1).cpu().numpy() for i in range(0, a2.shape[0], rows)])


def moe_full_width_check(cfg, params, rng) -> dict:
    """qwen2-moe's layer-0 ``moe_block`` on 64 tokens, dropless, float32,
    against a loop that computes every routed expert of every token
    (``tests/test_moe.py``'s ``dense_reference``). Tolerance: 1e-4 of
    max |reference| (float32 sums in other orders)."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.models.moe import moe_block, top_k

    c = dataclasses.replace(cfg, dtype="float32",
                            moe=dataclasses.replace(cfg.moe,
                                                    capacity_factor=float(cfg.moe.n_experts)))
    lp = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
          for k, v in params["layers"]["moe"].items()}
    x = torch.from_numpy(rng.normal(0, 1, (1, 64, cfg.d_model)).astype(np.float32)).to(DEVICE)
    got, _ = moe_block(c, lp, x)
    got, xs = got[0], x[0]
    logits = xs @ lp["router"]
    e_pad = lp["router"].shape[1]
    logits = logits.masked_fill(torch.arange(e_pad, device=DEVICE) >= cfg.moe.n_experts, -1e30)
    gv, gi = top_k(torch.softmax(logits, -1), cfg.moe.top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(xs)
    for t in range(xs.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(gi[t, j])
            h = F.silu(xs[t] @ lp["w_gate"][e]) * (xs[t] @ lp["w_up"][e])
            want[t] += gv[t, j] * (h @ lp["w_down"][e])
    sh = lp["shared"]
    want += (F.silu(xs @ sh["w_gate"]) * (xs @ sh["w_up"])) @ sh["w_down"]
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max())
    require(err <= tol, f"moe_block differs from the compute-all-experts loop by {err} > {tol}")
    return {"tokens": 64, "max_abs": err, "tolerance_max_abs": tol}


def ssd_full_width_check(cfg, params, rng) -> dict:
    """mamba2-130m's layer-0 ``ssm_forward`` on (1, 256), float32 products,
    against ``ssm_decode_step`` stepped token by token (the chunked dual
    form against the recurrence, ``tests/test_ssm.py``). Tolerance: 1e-4 of
    max |forward| (float32 sums in other orders)."""
    import dataclasses

    import torch

    from repro_torch.models import ssm

    c = dataclasses.replace(cfg, dtype="float32", ssd_matmul_dtype="float32")
    lp = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    x = torch.from_numpy(rng.normal(0, 0.5, (1, 256, cfg.d_model)).astype(np.float32)).to(DEVICE)
    full, _ = ssm.ssm_forward(c, lp, x)
    cache = ssm.init_ssm_cache(c, 1, torch.float32, DEVICE)
    steps = []
    for t in range(x.shape[1]):
        y, cache = ssm.ssm_decode_step(c, lp, x[:, t:t + 1], cache)
        steps.append(y[:, 0])
    err = float((full - torch.stack(steps, 1)).abs().max())
    tol = 1e-4 * float(full.abs().max())
    require(err <= tol, f"ssm_forward differs from the stepped recurrence by {err} > {tol}")
    return {"positions": 256, "max_abs": err, "tolerance_max_abs": tol}


def family_run(args, name: str, impl: str, depth: int | None, sm90) -> dict:
    """Phase 4c (b): one family at its published widths: the forward and its
    checks, the decode check, a short serve, and the full-width checks.

    Logits. The forward (attention ``impl``) and the same forward with the
    plain attention are both held against a float32 forward of the same
    weights and tokens: max |impl - plain| <= 2 max |plain - float32| (the
    rule of :func:`lm_path`). A MoE routes each token in float32 on bf16
    activations, and bf16 can flip a near-tie between two experts; a flip
    moves that position's logits by a whole expert's output, and flips
    cascade through the layers, so any two bf16 paths drift apart by about
    as much as bf16 and float32 do (qwen2-moe: top-1 agreement 0.825
    between flash and plain, 0.827 between plain and float32). So for the
    MoE families the bound must hold at 99.9 % of positions, and the top-1
    agreement of the two bf16 paths has a floor of 0.9 times that of the
    plain path with float32: room for the sampling of 8,192 positions,
    while a fault in the attention would take agreement towards 0. The
    kernel itself is held element by element at each of these forwards'
    attention shapes in phase 5 (:func:`family_flash_shapes`); this rule is
    the end-to-end check on top of that.

    Launches. ``path_launches`` counts the forward's and the short serve's
    (whose cached attention takes the plain path, as the reference's does);
    the encoder alone, the timed and the profiled forwards and the timed
    decode step are counted apart as ``measurement_launches``.

    Decode. A float32 forward over S positions against a float32 prefill of
    S - 1 (an SSM's in whole chunks, then the rest) and one decode step:
    ``tests/test_models.py``'s 2e-3 relative. As there, everything is
    float32, the SSD's intra-chunk products too (the recurrence of a decode
    step has no bf16 products to match), and the MoE families run dropless
    (capacity_factor = n_experts).
    """
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, flash_calls
    from repro_torch.models import model as model_mod
    from repro_torch.serve import BatchedServer

    base = get_config(name)
    cfg = dataclasses.replace(base, attn_impl=impl, n_layers=depth or base.n_layers)
    model = build_model(cfg)
    rng = np.random.default_rng(args.seed + 4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(args.seed, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tensors(params)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    batch = family_batch(cfg, rng, LM_BATCH, LM_SEQ, FAMILY_FRAMES)

    c0 = sm90.launches
    got, aux, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    launches = sm90.launches - c0
    require(tuple(got.shape) == (LM_BATCH, LM_SEQ, cfg.vocab) and got.dtype == torch.bfloat16,
            f"{name}: forward gave {got.dtype} {tuple(got.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: forward gave non-finite logits")
    require(launches == flash_calls(cfg),
            f"{name}: {launches} flash launches in one forward, expected {flash_calls(cfg)}")
    line = {"config": name, "attn_impl": impl, "n_layers": cfg.n_layers,
            "param_dtype": cfg.param_dtype, "n_params": sum(t.numel() for t in leaves),
            "param_gb": param_bytes / 1e9, "init_s": init_s, "forward_launches": launches,
            "aux": {k: float(v) for k, v in aux.items()}}
    # measurement runs (the encoder alone, the timed and the profiled
    # forwards): their launches are reported apart, not as the path's
    n_path = sm90.launches
    if cfg.family == "encdec":
        model_mod._encode(cfg, params, batch)
        torch.cuda.synchronize()
        line["encoder_noncausal_launches"] = sm90.launches - n_path
        require(line["encoder_noncausal_launches"] == cfg.n_encoder_layers,
                f"{name}: the encoder launched {line['encoder_noncausal_launches']} times")
    line["forward_ms"] = cuda_ms(lambda: model.forward(params, batch), iters=1, warmup=0)
    line["device_split"] = device_split(lambda: model.forward(params, batch))
    measured = sm90.launches - n_path
    sm90.launches = n_path

    plain, _, _ = build_model(dataclasses.replace(cfg, attn_impl="ref")).forward(params, batch)
    f32_model = build_model(dataclasses.replace(cfg, attn_impl="ref", dtype="float32"))
    full, _, _ = f32_model.forward(params, batch)
    torch.cuda.synchronize()
    got_plain, plain_f32 = diff_stats(got, plain), diff_stats(plain, full)
    tol = 2 * plain_f32["max_abs"]
    rule = {"impl_vs_plain": got_plain, "plain_vs_float32": plain_f32,
            "impl_vs_float32": diff_stats(got, full), "tolerance_max_abs": tol}
    if cfg.moe is not None:
        rows = row_max_abs(got, plain)
        rule["share_within_tolerance"] = float((rows <= tol).mean())
        rule["top1_floor"] = 0.9 * plain_f32["top1_agree"]
        ok = (rule["share_within_tolerance"] >= 0.999
              and got_plain["top1_agree"] >= rule["top1_floor"])
    else:
        ok = got_plain["max_abs"] <= tol
    line["logits"] = rule
    del got, plain, full

    # decode: float32, S - 1 prefilled then one step, against the forward's last row
    s_dec = 64 if name == "arctic-480b" else FAMILY_DECODE_SEQ
    dcfg = dataclasses.replace(cfg, attn_impl="ref", dtype="float32", ssd_matmul_dtype="float32")
    if cfg.moe is not None:
        dcfg = dataclasses.replace(dcfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    dmodel = build_model(dcfg)
    s_tot = s_dec + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    db = family_batch(dcfg, rng, LM_BATCH, s_tot, FAMILY_DECODE_SEQ // 2)
    last, _, _ = dmodel.forward(params, db)
    last = last[:, -1]
    toks = db["tokens"]
    cut = toks.shape[1] - 1
    if cfg.ssm is not None:
        cut = cut // cfg.ssm.chunk * cfg.ssm.chunk
    cache = dmodel.init_cache(LM_BATCH, s_tot, device=DEVICE)
    _, cache = dmodel.forward_with_cache(params, dict(db, tokens=toks[:, :cut]), cache)
    if cut < toks.shape[1] - 1:
        _, cache = dmodel.forward_with_cache(params, {"tokens": toks[:, cut:-1]}, cache)
    step, _ = dmodel.decode_step(params, toks[:, -1:], cache)
    dec_rel = float((step[:, -1] - last).abs().max() / last.abs().max())
    line["decode_vs_forward"] = {"positions": s_tot, "max_rel": dec_rel, "tolerance_rel": 2e-3}
    del cache, last, step

    # serve: a few requests through the card's server, then one timed decode step
    srv = BatchedServer(cfg, params, max_batch=SERVE_CHECK_REQUESTS // 2, max_len=SERVE_MAX_LEN)
    t0 = time.perf_counter()
    for i, n in enumerate(rng.integers(16, 65, SERVE_CHECK_REQUESTS)):
        srv.submit(rng.integers(3, cfg.vocab, int(n)).astype(np.int32), max_new_tokens=16, rid=i)
    done = srv.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    require(sorted(r.rid for r in done) == list(range(SERVE_CHECK_REQUESTS))
            and all(1 <= len(r.out_tokens) <= 16 for r in done),
            f"{name}: the server did not answer every request")
    line["path_launches"] = sm90.launches - c0
    n_path = sm90.launches
    srv.submit(done[0].prompt, max_new_tokens=3, rid=SERVE_CHECK_REQUESTS)
    srv._fill_slots()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv._decode_once()
    torch.cuda.synchronize()
    line["decode_step_wall_ms"] = (time.perf_counter() - t0) * 1e3
    line["measurement_launches"] = measured + sm90.launches - n_path
    sm90.launches = n_path
    line["serve_check"] = {"requests": len(done), "wall_s": serve_s,
                           "new_tokens": sum(len(r.out_tokens) for r in done)}
    del srv
    if name == "qwen2-moe-a2.7b":
        line["moe_block_check"] = moe_full_width_check(cfg, params, rng)
    if name == "mamba2-130m":
        line["ssd_check"] = ssd_full_width_check(cfg, params, rng)
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit({"lm_family": line})
    require(ok, f"{name}: logits outside the rule: {rule}")
    require(dec_rel <= 2e-3, f"{name}: decode differs from the forward by {dec_rel} relative")
    del params, leaves
    torch.cuda.empty_cache()
    return line


def expandable_segments(on: bool) -> None:
    """Switch the caching allocator's expandable segments at run time."""
    import torch

    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setting or torch.cuda.memory._set_allocator_settings)(f"expandable_segments:{on}")


def families_path(args, lake: Path, bbox, counters) -> dict:
    """Phase 4c: spatial-lm serving the lake, then each other family alone.

    The phase runs with expandable segments, the phases before it with the
    default allocator. Arctic's float32 check forward needs about 77 GB of
    the card right after pixtral's tree was freed; with fixed segments, an
    H100 run of this phase ran out of memory there with 9.6 GiB reserved
    but unallocated (fragments of the earlier trees)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    expandable_segments(True)
    for c in counters:
        c.launches = 0
    out = {"spatial_lm": spatial_lm_serve(args, lake, bbox, counters)}
    torch.cuda.empty_cache()
    out["families"] = {}
    sm90 = next(c for c in counters if c.kname == LM_KERNELS[0])
    for name, impl, depth in FAMILY_RUNS:
        t0 = time.perf_counter()
        before = torch.cuda.memory_allocated()
        line = family_run(args, name, impl, depth, sm90)
        line["wall_s"] = time.perf_counter() - t0
        line["memory_left_bytes"] = torch.cuda.memory_allocated() - before
        out["families"][name] = {k: line[k] for k in ("forward_ms", "forward_launches",
                                                        "path_launches", "param_gb", "wall_s",
                                                        "memory_left_bytes")}
        # the next tree needs the card to itself
        require(line["memory_left_bytes"] < 1 << 28,
                f"{name} left {line['memory_left_bytes']} bytes allocated on the card")
    out["launches"] = {c.kname: c.launches for c in counters}
    torch.cuda.empty_cache()
    expandable_segments(False)
    return out


# ---------------------------------------------------------------- training
def _bits_equal(a, b) -> bool:
    """Same dtype, shape and bit pattern (NaN-safe)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.cpu().view(iv), b.cpu().view(iv))


def _counts(counters) -> dict:
    return {c.kname: c.launches for c in counters}


def train_path(args, lake: Path, work: Path, counters) -> dict:
    """Phase 4d: training on the card (see the module docstring).

    Tolerance of the first step against the CPU port (float32 both, TF32
    off, the same weights and batch): the loss within 1e-4 of itself, and
    each gradient leaf within 1e-4 of its own largest magnitude. Both take
    the same float32 sums in other orders. A product of length K rounds by
    about sqrt(K) * 2^-24 of its scale (K <= 2048 here: 2.7e-6); 12 layers
    carry about six products in series forward and twelve backward, so
    sqrt(216) * 2.7e-6 = 4e-5 reaches a gradient, and 1e-4 leaves a margin
    of 2.5 (the JAX and PyTorch CPU paths of the same step differ by at
    most 1e-5 a leaf).
    """
    import contextlib
    import dataclasses
    import itertools

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.launch.train import trajectory_batcher
    from repro_torch.models import build_model, flatten_with_paths, params_to
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_loop import make_train_step, run_train_loop, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    for c in counters:
        c.launches = 0
    t_phase = time.perf_counter()
    # the CLI's own feed (its batcher reads with no box, as the reference's
    # does: each shard read decodes on the card, kernel 1, and is not refined)
    batcher = trajectory_batcher(lake, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                 seed=args.seed, device=DEVICE)
    feed = Prefetcher(batcher)
    base = get_config("spatial-lm")
    cfg = dataclasses.replace(base, vocab=max(base.vocab, batcher.tok.vocab))
    model = build_model(cfg)
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=min(100, TRAIN_STEPS // 10 + 1),
                   total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    first = next(feed)
    first_batch_s = time.perf_counter() - t0
    require(first["tokens"].shape == (1, TRAIN_BATCH, TRAIN_SEQ),
            f"feed batch of shape {first['tokens'].shape}")

    # the first step's loss and gradients on the card against the CPU port
    params = model.init(args.seed, device=DEVICE)
    n_params = sum(t.numel() for t in tensors(params))
    micro = {"tokens": first["tokens"][0]}
    grad_fn = value_and_grad(model.loss)
    (loss_card, _), g_card = grad_fn(params, micro)
    (loss_cpu, _), g_cpu = grad_fn(params_to(params, "cpu"), micro)
    g_card, g_cpu = dict(flatten_with_paths(g_card)), dict(flatten_with_paths(g_cpu))
    worst = max((float((g_card[k].cpu() - g_cpu[k]).abs().max())
                 / max(float(g_cpu[k].abs().max()), 1e-30), k) for k in g_cpu)
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    first_step = {"loss_card": float(loss_card), "loss_cpu": float(loss_cpu),
                  "loss_rel": loss_rel, "grad_leaves": len(g_cpu),
                  "grad_worst_rel": worst[0], "grad_worst_leaf": worst[1],
                  "tolerance": "1e-4 of the loss; 1e-4 of each leaf's max |cpu grad|"}
    emit({"train_first_step": first_step})
    require(loss_rel <= 1e-4, f"first loss on the card {float(loss_card)} vs CPU {float(loss_cpu)}")
    require(worst[0] <= 1e-4, f"gradient {worst[1]} differs from the CPU's by {worst[0]}")
    del params, g_card, g_cpu

    ckdir = work / "ckpt"
    mgr = CheckpointManager(ckdir, compress=True, keep=3)

    def train(steps, data, **kw):
        with contextlib.redirect_stdout(sys.stderr):     # the loop's log lines
            t0 = time.perf_counter()
            state, hist = run_train_loop(
                cfg, oc, data, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps,
                checkpoint_mgr=mgr, checkpoint_every=TRAIN_CKPT_EVERY, log_every=10,
                rng_seed=args.seed, device=DEVICE, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mgr.wait()
        return state, hist, wall, time.perf_counter() - t0

    state, hist, wall, wall_saved = train(TRAIN_STEPS, itertools.chain([first], feed))
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    run = {"steps": TRAIN_STEPS, "wall_s": wall, "wall_with_last_write_s": wall_saved,
           "steps_per_s": TRAIN_STEPS / wall, "tokens_per_s": tokens / wall,
           "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
           "first_loss_vs_check": abs(hist[0]["loss"] - float(loss_card)),
           "feed_stalls": feed.stalls, "first_batch_s": first_batch_s}
    require(hist[0]["step"] == 0 and hist[-1]["step"] == TRAIN_STEPS - 1, "bad loop history")
    require(all(np.isfinite(h["loss"]) for h in hist), "a logged loss is not finite")
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"the loss did not fall: {hist[0]['loss']} -> {hist[-1]['loss']}")
    require(run["first_loss_vs_check"] <= 1e-5 * abs(float(loss_card)),
            "the loop's first loss is not the checked step's")
    # the last checkpoint, decoded on the host, against the card's state
    saves = [st.write_s for st in mgr.history]
    ratio = mgr.last_stats.ratio
    step, host = mgr.load_host()
    card = {"params": state.params, "opt_state": state.opt_state}
    fh, fc = dict(flatten_with_paths(host)), dict(flatten_with_paths(card))
    require(step == TRAIN_STEPS and set(fh) == set(fc), f"checkpoint step {step}, keys differ")
    bad = [k for k in fc if not _bits_equal(fh[k], fc[k])]
    require(not bad, f"checkpoint leaves differ from the card's state: {bad[:5]}")
    run["checkpoint"] = {"saves": len(saves), "write_s": saves,
                         "write_s_mean": sum(saves) / len(saves), "ratio": ratio,
                         "raw_bytes": mgr.last_stats.raw_bytes,
                         "stored_bytes": mgr.last_stats.stored_bytes,
                         "leaves": len(fc), "bit_equal": True}
    del state, host, card, fh, fc

    # resume to 250, then a run that fails and a rerun from its last checkpoint
    _, hist2, wall2, _ = train(TRAIN_RESUME_TO, feed)
    require(hist2[0]["step"] == TRAIN_STEPS, f"resumed at step {hist2[0]['step']}")
    fail_at, fail_to = TRAIN_FAIL
    try:
        train(fail_to, feed, fail_at_step=fail_at)
    except RuntimeError as e:
        require(f"injected failure at step {fail_at}" in str(e), f"unexpected error {e}")
    else:
        raise Failure("the run with fail_at_step did not raise")
    _, hist4, _, _ = train(fail_to, feed)
    require(hist4[0]["step"] == TRAIN_RESUME_TO and mgr.latest_step() == fail_to,
            f"the rerun resumed at {hist4[0]['step']}, latest checkpoint {mgr.latest_step()}")
    run["resume"] = {"resumed_at": hist2[0]["step"], "steps": TRAIN_RESUME_TO - TRAIN_STEPS,
                     "wall_s": wall2, "fail_at": fail_at,
                     "rerun_resumed_at": hist4[0]["step"]}
    # the training path ends here; nothing below reads from its feed (its
    # producer runs at most a queue's depth ahead, inside the shard it holds)
    run["launches"] = path = _counts(counters)
    run["feed_stalls"] = feed.stalls
    require(path[FILE_KERNELS[0]] > 0,
            f"kernel {FILE_KERNELS[0]} was not launched by the training feed")
    require(path[FILE_KERNELS[1]] == 0,
            f"kernel {FILE_KERNELS[1]} ran on the training feed, which reads with no box")

    # one step's device split, and the wide shape's step time (a batcher of
    # its own, whose shard read is counted apart as measurement_launches)
    params = model.init(args.seed + 1, device=DEVICE)
    opt = opt_init(oc, params)
    step_fn, _ = make_train_step(cfg, oc, TRAIN_BATCH, TRAIN_SEQ, device=DEVICE)
    b = first
    step_fn(params, opt, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step_fn(params, opt, b)
    torch.cuda.synchronize()
    run["step_ms"] = (time.perf_counter() - t0) / 10 * 1e3    # no feed, no checkpoint
    run["step_tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / run["step_ms"] * 1e3
    run["step_split"] = device_split(lambda: step_fn(params, opt, b))
    wb, ws, wn = TRAIN_WIDE
    wide_fn, _ = make_train_step(cfg, oc, wb, ws, device=DEVICE)
    wide_it = iter(trajectory_batcher(lake, seq=ws, global_batch=wb, seed=args.seed + 1,
                                      device=DEVICE))
    wide = [next(wide_it) for _ in range(wn + 1)]
    torch.cuda.reset_peak_memory_stats()
    wide_fn(params, opt, wide[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wbatch in wide[1:]:
        wide_fn(params, opt, wbatch)
    torch.cuda.synchronize()
    wide_s = (time.perf_counter() - t0) / wn
    run["wide"] = {"batch": wb, "seq": ws, "steps": wn, "step_ms": wide_s * 1e3,
                   "tokens_per_s": wb * ws / wide_s,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    after = _counts(counters)
    run["measurement_launches"] = {k: after[k] - path[k] for k in path}
    del params, opt, step_fn, wide_fn, wide
    out = {"config": "spatial-lm", "vocab": cfg.vocab, "n_params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "spatial_lm": run}
    emit({"train_spatial_lm": run})
    torch.cuda.empty_cache()

    out["dense"] = dense_train(args)
    out["remat"] = remat_train(args)
    out["flash_under_grad"] = flash_under_grad()
    # (b) to (d) are training paths too: what they launch joins (a)'s count
    end = _counts(counters)
    require(all(end[k] == after[k] for k in (*LM_KERNELS, F32_FLASH)),
            "(b), (c) or (d) launched the flash kernel")
    out["launches"] = {k: path[k] + end[k] - after[k] for k in path}
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def dense_train(args) -> dict:
    """Phase 4d (b): qwen3-8b at its published widths, 2 of its 36 layers,
    bf16 compute over float32 parameters, AdamW on one repeated batch.

    The first loss is held to a float32-compute loss on the same batch and
    weights by phase 4's bf16 noise: each token's loss is logsumexp(z) -
    z_gold, and both terms move by at most max |z_bf16 - z_f32|, so the mean
    moves by at most twice the measured largest logit difference.

    The first step's gradients (its first microbatch) are held, leaf by
    leaf, to the float32-compute gradients on the same weights and tokens:
    ||g_bf16 - g_f32|| / ||g_f32|| <= 2^-4. Each bf16 rounding moves a value
    by at most u = 2^-8 of itself; a leaf's gradient passes through about
    R = 64 roundings in series (some 14 per layer forward and as many
    backward, for 2 layers, plus the head and the loss); independent
    roundings add in quadrature, so a leaf differs by about sqrt(R) * u =
    2^-5 of its norm, and the bound allows twice that. A gradient that the
    bf16 path drops or breaks differs by about its whole norm."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_token_iter
    from repro_torch.models import build_model, flatten_with_paths
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    layers, b, s, steps = DENSE_TRAIN
    cfg = dataclasses.replace(get_config(LM_CONFIG), n_layers=layers, attn_impl="ref")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(args.seed, device=DEVICE)
    pbytes = sum(t.numel() * t.element_size() for t in tensors(params))
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    step_fn, bstruct = make_train_step(cfg, oc, b, s, device=DEVICE)
    accum = bstruct["tokens"][0][0]     # the config's accumulation, clamped to the batch
    # params, m, v, float32 grads (and their running sum when accumulating);
    # a microbatch's bf16 logits and their gradient, the float32 exp the
    # loss keeps and its gradient
    reckoned = (3 + (2 if accum > 1 else 1)) * pbytes + b * s * cfg.vocab // accum * 12
    toks = next(synthetic_token_iter(cfg.vocab, seq_len=s, global_batch=b,
                                     seed=args.seed))["tokens"][0]
    with torch.no_grad():
        z16, _, _ = model.forward(params, {"tokens": toks})
        f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        z32, _, _ = f32.forward(params, {"tokens": toks})
        noise = float((z16.float() - z32).abs().max())
        del z16, z32
        loss32 = float(f32.loss(params, {"tokens": toks})[0])
    micro = {"tokens": toks[: b // accum]}          # the step's first microbatch
    _, g16 = value_and_grad(model.loss)(params, micro)
    _, g32 = value_and_grad(f32.loss)(params, micro)
    grad_rel = {k: float((g.float() - w).norm() / w.norm())
                for (k, g), (_, w) in zip(flatten_with_paths(g16), flatten_with_paths(g32))}
    del g16, g32
    opt = opt_init(oc, params, cfg.opt_state_dtype)
    batch = {"tokens": toks.reshape(bstruct["tokens"][0])}
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    out = {"config": LM_CONFIG, "n_layers": layers, "batch": b, "seq": s,
           "grad_accum": accum, "param_gb": pbytes / 1e9, "losses": losses, "step_s": step_s,
           "float32_first_loss": loss32, "logits_noise_max_abs": noise,
           "first_loss_tolerance": 2 * noise,
           "grad_rel_norm": grad_rel, "grad_rel_norm_max": max(grad_rel.values()),
           "grad_tolerance": 2 ** -4,
           "reckoned_peak_gb": reckoned / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"train_dense": out})
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(losses[-1] < losses[0], f"the qwen3-8b loss did not fall: {losses}")
    require(abs(losses[0] - loss32) <= 2 * noise,
            f"first bf16 loss {losses[0]} vs float32 {loss32}, beyond 2 x {noise}")
    bad = {k: r for k, r in grad_rel.items() if not r <= 2 ** -4}
    require(not bad, f"bf16 gradients differ from the float32 ones beyond 2^-4: {bad}")
    del params, opt, step_fn, model
    torch.cuda.empty_cache()
    return out


def remat_train(args) -> dict:
    """Phase 4d (c): internlm2-1.8b as shipped (``remat="full"``,
    ``attn_impl="blocked"``), bf16 compute over float32 parameters, trained
    at its published widths and full depth, 24 layers, on one card.

    First the three ``remat`` modes side by side at 4 of its 24 layers and
    (1, 4096): one forward and backward each (``value_and_grad``), in the
    order none, none again, full, selective. The gradients of full and
    selective must equal none's leaf by leaf within the floor that the two
    runs of none show (``max |a - b| / max |b|`` over the leaves; 0 where
    the card repeats itself bit for bit), and so must the losses.

    Then 3 AdamW steps of ``make_train_step`` on one synthetic (2, 4096)
    batch: the config's ``grad_accum`` of 16 clamps to 2 microbatches of 1.
    The loss must fall. The peak is held under the card's 80 GB and under
    its reckoning: the float32 parameters, both moments, the gradient sum
    and the microbatch's gradients (5 x P); one bf16 input (1, 4096, 2048)
    a layer, which is all ``"full"`` keeps through the forward; one layer's
    recompute set, from the 4-layer runs (none holds 4 sets, full 4 inputs
    and 1 set: set = (peak_none - peak_full + 4 x input) / 3); and the
    microbatch's logits with the float32 terms of the loss and their
    gradient, 12 bytes a logit (as :func:`dense_train` counts them). Without
    ``remat`` the same step would keep 24 sets."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_token_iter
    from repro_torch.models import build_model, flatten_with_paths
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    name, b, s, steps = REMAT_TRAIN
    cfg = get_config(name)
    require(cfg.remat == "full" and cfg.attn_impl == "blocked",
            f"{name} ships remat {cfg.remat!r} and attention {cfg.attn_impl!r}")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    # the modes side by side at 4 layers: one forward and backward each
    layers, cb, cs = REMAT_COMPARE
    small = dataclasses.replace(cfg, n_layers=layers)
    params = build_model(small).init(args.seed, device=DEVICE)
    toks = next(synthetic_token_iter(cfg.vocab, seq_len=cs, global_batch=cb,
                                     seed=args.seed))["tokens"][0]
    runs, grads = {}, {}
    for run in ("none", "none_again", "full", "selective"):
        model = build_model(dataclasses.replace(small, remat=run.split("_")[0]))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (loss, _), g = value_and_grad(model.loss)(params, {"tokens": toks})
        torch.cuda.synchronize()
        runs[run] = {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss),
                     "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9}
        grads[run] = dict(flatten_with_paths(g))
        del g, loss

    def worst(run):
        return max(float((grads[run][k].float() - w.float()).abs().max())
                   / max(float(w.float().abs().max()), 1e-30) for k, w in grads["none"].items())

    floor = worst("none_again")
    for run in runs:
        runs[run]["grad_worst_rel"] = worst(run)
        runs[run]["bit_equal_leaves"] = sum(_bits_equal(grads[run][k], w)
                                            for k, w in grads["none"].items())
        runs[run]["loss_diff"] = abs(runs[run]["loss"] - runs["none"]["loss"])
    leaves = len(grads["none"])
    del grads, params
    torch.cuda.empty_cache()
    layer_input = cb * cs * cfg.d_model * 2
    layer_set = (runs["none"]["peak_gb"] - runs["full"]["peak_gb"]) * 1e9 + layers * layer_input
    layer_set /= layers - 1
    compare = {"n_layers": layers, "batch": cb, "seq": cs, "leaves": leaves, "runs": runs,
               "floor": floor, "loss_floor": runs["none_again"]["loss_diff"],
               "layer_set_gb": layer_set / 1e9,
               "note": "peak_gb: above what was allocated before the run; the first none run "
                       "is the first call at these shapes"}
    emit({"remat_compare": compare})
    for run in ("full", "selective"):
        require(runs[run]["grad_worst_rel"] <= floor,
                f"remat={run}: gradients {runs[run]['grad_worst_rel']} from none's, beyond the "
                f"floor {floor} of two none runs")
        require(runs[run]["loss_diff"] <= compare["loss_floor"],
                f"remat={run}: loss {runs[run]['loss']} vs none's {runs['none']['loss']}")

    # 3 steps at full depth, (2, 4096), as shipped
    model = build_model(cfg)
    params = model.init(args.seed, device=DEVICE)
    pbytes = sum(t.numel() * t.element_size() for t in tensors(params))
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    step_fn, bstruct = make_train_step(cfg, oc, b, s, device=DEVICE)
    accum, mb, _ = bstruct["tokens"][0]
    require(accum == 2 and mb == 1, f"accumulation {accum} x {mb}, expected 2 x 1")
    reckoned = {"state": 5 * pbytes, "layer_inputs": cfg.n_layers * mb * s * cfg.d_model * 2,
                "layer_set": layer_set, "logits": mb * s * cfg.vocab * 12}
    opt = opt_init(oc, params, cfg.opt_state_dtype)
    toks = next(synthetic_token_iter(cfg.vocab, seq_len=s, global_batch=b,
                                     seed=args.seed))["tokens"][0]
    batch = {"tokens": toks.reshape(accum, mb, s)}
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    out = {"config": name, "n_layers": cfg.n_layers, "remat": cfg.remat,
           "attn_impl": cfg.attn_impl, "batch": b, "seq": s, "grad_accum": accum,
           "param_gb": pbytes / 1e9, "losses": losses, "step_s": step_s,
           "reckoned_gb": {k: v / 1e9 for k, v in reckoned.items()},
           "reckoned_peak_gb": sum(reckoned.values()) / 1e9, "peak_gb": peak / 1e9,
           "compare": compare, "wall_s": time.perf_counter() - t_phase}
    emit({"train_remat": {k: v for k, v in out.items() if k != "compare"}})
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(losses[-1] < losses[0], f"the {name} loss did not fall: {losses}")
    require(peak < 80e9, f"{name} peaked at {peak / 1e9} GB, over the card's 80 GB")
    require(peak <= sum(reckoned.values()),
            f"{name} peaked at {peak / 1e9} GB, over its reckoning {out['reckoned_gb']}")
    del params, opt, step_fn, model
    torch.cuda.empty_cache()
    return out


def flash_under_grad() -> dict:
    """Phase 4d (d): a backward through ``attn_impl="flash"`` raises on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import value_and_grad

    cfg = dataclasses.replace(get_config(LM_CONFIG).reduced(), attn_impl="flash")
    model = build_model(cfg)
    params = model.init(0, device=DEVICE)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    try:
        value_and_grad(model.loss)(params, {"tokens": toks})
    except RuntimeError as e:
        require("no backward" in str(e), f"unexpected error {e}")
        return {"raised": True, "message": str(e)}
    finally:
        torch.cuda.synchronize()
    raise Failure("a backward through the flash kernel did not raise on the card")


# ---------------------------------------------------------------- the mesh
def dryrun_child() -> int:
    """Phase 4e (c) and (d)'s counts, on the CPU in a process of its own
    (``chip_smoke.py --dryrun-child``, started before phase 3b, the codec,
    so that it runs beside the card's phases): the dry run of
    ``DRYRUN_CELLS`` on a fake group of 256 ranks, and the FLOPs and bytes
    of phase 4d's three measured steps on one device, counted on fake
    tensors. Its result is the line that starts with ``DRYRUN``."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.synthetic import PORTO_BBOX
    from repro_torch.data.tokenizer import GeoTokenizer
    from repro_torch.launch.dryrun import fake_group, one_device_counts, run_cell
    from repro_torch.launch.mesh import production_shape

    keep = ("chips", "counting", "compile_s", "sharding_fallbacks", "memory",
            "memory_categories", "cost_raw",
            "collectives", "roofline", "model_flops_global", "model_flops_per_chip",
            "useful_flops_ratio", "whole_flops_share")
    out = {"cells": {}}
    t_all = time.perf_counter()
    with fake_group(production_shape().size):
        for arch, shape, counting in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, multi_pod=False, counting=counting)
            out["cells"][f"{arch} {shape}"] = {**{k: rec[k] for k in keep},
                                               "wall_s": time.perf_counter() - t0}
    out["cells_wall_s"] = time.perf_counter() - t_all
    vocab = GeoTokenizer(PORTO_BBOX, order=6).vocab        # the training CLI's
    spatial = dataclasses.replace(get_config("spatial-lm"), vocab=vocab)
    layers, b, s, _ = DENSE_TRAIN
    dense = dataclasses.replace(get_config(LM_CONFIG), n_layers=layers, attn_impl="ref")
    out["steps"] = {
        "spatial_lm": {"dtype": spatial.dtype, **one_device_counts(
            spatial, ShapeConfig("train_4d", TRAIN_SEQ, TRAIN_BATCH, "train"))},
        "qwen3_8b_2_layers": {"dtype": dense.dtype, **one_device_counts(
            dense, ShapeConfig("train_4d", s, b, "train"))}}
    name, b, s, _ = REMAT_TRAIN
    full = get_config(name)
    out["steps"]["internlm2_1_8b"] = {"dtype": full.dtype, **one_device_counts(
        full, ShapeConfig("train_4d", s, b, "train"))}
    print("DRYRUN " + json.dumps(out), flush=True)
    return 0


def start_dryrun(work: Path):
    """Start :func:`dryrun_child` on the CPU (no card: CUDA_VISIBLE_DEVICES
    empty), its output into a file. Returns (process, log path)."""
    import os

    import atexit

    log = work / "dryrun_child.log"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT / "src"))
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-child"],
                                stdout=fh, stderr=subprocess.STDOUT, env=env)

    def stop():          # a failed phase before 4e leaves no process behind
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, log


def train_child(argv) -> int:
    """``repro_torch.launch.train.main(argv)`` in a process of its own
    (``chip_smoke.py --train-child ...``, plainly or under ``torchrun``),
    then its kernel launch counts on a line of their own."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fp_delta import kernel as fk
    from repro_torch.kernels.minmax import kernel as mk
    from repro_torch.launch import train

    train.main(argv)
    emit({"train_child": {"launches": {FILE_KERNELS[0]: fk.decode_stream.launches,
                                       FILE_KERNELS[1]: mk.segminmax_refine.launches,
                                       FILE_KERNELS[3]: fk.expand_stream.launches,
                                       FILE_KERNELS[4]: fk.escape_resolve.launches}}})
    return 0


def _run_train_child(argv, work: Path, name: str, torchrun: bool) -> dict:
    """One training CLI run in a child process; its logged losses, the mesh
    line, its launch counts and wall time."""
    import os

    cmd = [sys.executable]
    if torchrun:
        cmd += ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1"]
    cmd += [str(ROOT / "chip_smoke.py"), "--train-child", *argv]
    log = work / f"{name}.log"
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        r = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT, timeout=MESH_CHILD_TIMEOUT,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    text = log.read_text()
    require(r.returncode == 0, f"the {name} training run failed:\n{text[-3000:]}")
    losses = {int(ln.split()[2]): float(ln.split()[3].split("=")[1])
              for ln in text.splitlines() if ln.startswith("[train] step ")}
    child = next(json.loads(ln)["train_child"] for ln in text.splitlines()
                 if ln.startswith('{"train_child"'))
    mesh = [ln for ln in text.splitlines() if ln.startswith("[train] mesh")]
    return {"losses": losses, "launches": child["launches"], "wall_s": wall,
            "mesh_line": mesh[0] if mesh else None}


def _alternate_ms(fns: dict, steps: int) -> dict:
    """Step ms of each function, timed in turns (a, b, b, a) of ``steps``
    calls each, after two warm-up calls of each."""
    import torch

    for fn in fns.values():
        fn()
        fn()
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fns[n]()
        torch.cuda.synchronize()
        times[n].append((time.perf_counter() - t0) / steps * 1e3)
    return {n: sum(t) / len(t) for n, t in times.items()}


def mesh_path(args, lake: Path, work: Path, counters, trn: dict, dry) -> dict:
    """Phase 4e: the mesh (see the module docstring).

    Tolerances. (a) The CLI's losses on the one-rank mesh against the plain
    run's, each logged to 4 decimals: within 2e-4 (the printing's 5e-5 on
    each side, plus float32 sum-order noise far below it; the same kernels
    run on the same tensors, so equal prints are expected). (b) The sharded
    bf16 logits against the unsharded call's: the same kernels on the same
    tensors, so bit-equality is expected; held within 2^-8 of the largest
    |logit| (one bf16 rounding), the number printed beside it; the prefill's
    next tokens exactly equal."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import step_share
    from repro_torch.launch.train import trajectory_batcher
    from repro_torch.models import build_model, flatten_with_paths
    from repro_torch.sharding.dtensor import full, mesh_scope
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_loop import (make_prefill_step, make_train_step, mesh_layout,
                                              place)

    t_phase = time.perf_counter()
    out: dict = {}
    # (a) the training CLI on a one-rank NCCL mesh against the plain CLI
    cli = ["--arch", "spatial-lm", "--data-dir", str(lake), "--steps", str(MESH_STEPS),
           "--ckpt-every", str(MESH_CKPT_EVERY), "--device", DEVICE]
    plain = _run_train_child(cli + ["--ckpt-dir", str(work / "cli_plain")], work,
                             "cli_plain", torchrun=False)
    sharded = _run_train_child(cli + ["--ckpt-dir", str(work / "cli_mesh"), "--mesh-data", "1",
                                      "--mesh-model", "1"], work, "cli_mesh", torchrun=True)
    require(sharded["mesh_line"] is not None and "backend nccl" in sharded["mesh_line"],
            f"the torchrun run did not train on an NCCL mesh: {sharded['mesh_line']}")
    require(plain["mesh_line"] is None, "the plain run made a mesh")
    logged = [k for k in range(MESH_STEPS) if k % 10 == 0 or k == MESH_STEPS - 1]
    require(sorted(sharded["losses"]) == sorted(plain["losses"]) == logged,
            f"logged steps {sorted(sharded['losses'])} / {sorted(plain['losses'])}")
    loss_diff = max(abs(sharded["losses"][k] - plain["losses"][k]) for k in plain["losses"])
    require(loss_diff <= 2e-4, f"mesh losses {sharded['losses']} vs plain {plain['losses']}")
    saves = [f"step_{k:08d}" for k in range(MESH_CKPT_EVERY, MESH_STEPS + 1, MESH_CKPT_EVERY)]
    for d in ("cli_plain", "cli_mesh"):
        require(sorted(p.name for p in (work / d).iterdir() if p.name.startswith("step_"))
                == saves, f"{d}: checkpoints {saves} missing")
    require(sharded["launches"][FILE_KERNELS[0]] > 0,
            f"kernel {FILE_KERNELS[0]} was not launched on the mesh")
    require(sharded["launches"][FILE_KERNELS[1]] == 0,
            f"kernel {FILE_KERNELS[1]} ran on the mesh's feed, which reads with no box")
    out["cli"] = {"plain": plain, "mesh": sharded, "loss_max_abs_diff": loss_diff,
                  "tolerance": "2e-4 on each logged loss (4 decimals printed)"}
    emit({"mesh_cli": out["cli"]})

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        # (a) the step's time on the mesh beside the plain step, in turns,
        # on one batch from the CLI's feed (its shard read counted apart)
        torch.backends.cuda.matmul.allow_tf32 = False
        before = _counts(counters)
        batcher = trajectory_batcher(lake, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                     seed=args.seed, device=DEVICE)
        batch = next(iter(batcher))
        base = get_config("spatial-lm")
        cfg = dataclasses.replace(base, vocab=max(base.vocab, batcher.tok.vocab))
        model = build_model(cfg)
        oc = OptConfig(lr=TRAIN_LR, warmup_steps=min(100, TRAIN_STEPS // 10 + 1),
                       total_steps=TRAIN_STEPS)
        layout = mesh_layout(cfg, mesh, oc)
        p1 = model.init(args.seed + 2, device=DEVICE)
        o1 = opt_init(oc, p1)
        p2 = place(model.init(args.seed + 2, device=DEVICE), mesh, layout.params)
        o2 = place(opt_init(oc, p1), mesh, layout.opt_state)
        step1, _ = make_train_step(cfg, oc, TRAIN_BATCH, TRAIN_SEQ, device=DEVICE)
        step2, _ = make_train_step(cfg, oc, TRAIN_BATCH, TRAIN_SEQ, device=DEVICE, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step2(p2, o2, batch)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        ms = _alternate_ms({"plain": lambda: step1(p1, o1, batch),
                            "mesh": lambda: step2(p2, o2, batch)}, MESH_TIMED_STEPS)
        out["step"] = {"config": "spatial-lm", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                       "plain_step_ms": ms["plain"], "mesh_step_ms": ms["mesh"],
                       "mesh_over_plain_ms": ms["mesh"] - ms["plain"],
                       "mesh_first_step_ms": first_ms,
                       "phase_4d_step_ms": trn["spatial_lm"]["step_ms"],
                       "measurement_launches": {k: v - before[k]
                                                for k, v in _counts(counters).items()}}
        emit({"mesh_step": out["step"]})
        del p1, o1, p2, o2, step1, step2, batcher
        torch.cuda.empty_cache()

        # (b) qwen3-8b, 2 of 36 layers, bf16, flash: the sharded forward and
        # prefill against the unsharded calls on the same tensors
        layers, b, s, _ = DENSE_TRAIN
        qcfg = dataclasses.replace(get_config(LM_CONFIG), n_layers=layers, attn_impl="flash")
        qmodel = build_model(qcfg)
        params = qmodel.init(args.seed, device=DEVICE)
        toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, qcfg.vocab, (b, s)).astype(np.int32))
        prefill1, _, cache1 = make_prefill_step(qcfg, b, s, device=DEVICE)
        prefill2, _, cache2 = make_prefill_step(qcfg, b, s, device=DEVICE, mesh=mesh)
        with torch.no_grad():
            z1 = qmodel.forward(params, {"tokens": toks})[0]
            t1 = prefill1(params, {"tokens": toks}, cache1())[0]
        pm = place(params, mesh, mesh_layout(qcfg, mesh).params)
        shared = all(d.to_local().data_ptr() == t.data_ptr() for (_, d), (_, t)
                     in zip(flatten_with_paths(pm), flatten_with_paths(params)))
        require(shared, "placing on the one-rank mesh copied a parameter")
        for c in counters:
            c.launches = 0
        with torch.no_grad(), mesh_scope():
            z2 = full(qmodel.forward(pm, {"tokens": toks})[0])
        t2 = prefill2(pm, {"tokens": toks}, cache2())[0]
        torch.cuda.synchronize()
        path = _counts(counters)
        diff = float((z2.float() - z1.float()).abs().max())
        bound = 2.0 ** -8 * float(z1.float().abs().max())
        sm90 = LM_KERNELS[0]
        fwd_ms = {}
        for name, fn in (("plain", lambda: qmodel.forward(params, {"tokens": toks})),
                         ("mesh", lambda: qmodel.forward(pm, {"tokens": toks}))):
            with torch.no_grad(), mesh_scope():
                fwd_ms[name] = cuda_ms(fn, iters=3, warmup=1)
        after = _counts(counters)
        out["lm"] = {"config": LM_CONFIG, "n_layers": layers, "batch": b, "seq": s,
                     "attn_impl": "flash", "dtype": qcfg.dtype, "storage_shared": shared,
                     "logits_max_abs_diff": diff, "logits_bit_equal": bool(torch.equal(z1, z2)),
                     "tolerance": bound, "prefill_tokens_equal": bool(torch.equal(t1, t2)),
                     "launches": path, "forward_ms": fwd_ms,
                     "measurement_launches": {k: after[k] - path[k] for k in path}}
        emit({"mesh_lm": out["lm"]})
        require(diff <= bound, f"sharded logits differ by {diff} (bound {bound})")
        require(out["lm"]["prefill_tokens_equal"], "sharded prefill tokens differ")
        require(path[sm90] == 2 * layers, f"kernel 6 launched {path[sm90]} times on the mesh")
        del params, pm, z1, z2, qmodel
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (c) the dry run's roofline lines, from the child started before 4c
    proc, log = dry
    t0 = time.perf_counter()
    rc = proc.wait(timeout=DRYRUN_TIMEOUT)
    text = log.read_text()
    require(rc == 0, f"the dry run failed:\n{text[-3000:]}")
    res = json.loads(next(ln for ln in text.splitlines() if ln.startswith("DRYRUN "))[7:])
    out["dryrun"] = {**res["cells"], "cells_wall_s": res["cells_wall_s"],
                     "waited_s": time.perf_counter() - t0}
    for cell, rec in res["cells"].items():
        arch, shape = cell.split()
        emit({"roofline_line": {"config": arch, "shape": shape, "mesh": [16, 16],
                                **rec["roofline"], "memory": rec["memory"],
                                "memory_categories": rec["memory_categories"],
                                "useful_flops_ratio": rec["useful_flops_ratio"],
                                "whole_flops_share": rec["whole_flops_share"],
                                "counting": rec["counting"], "wall_s": rec["wall_s"]}})
        require(rec["roofline"]["bound_s"] > 0 and rec["memory"]["peak_hbm_bytes"] > 0,
                f"dry run of {cell}: empty counts")
    emit({"dryrun_child": {"cells_wall_s": res["cells_wall_s"],
                           "waited_s": out["dryrun"]["waited_s"]}})
    # (d) phase 4d's measured steps against their roofline bounds on one card
    dense_s = trn["dense"]["step_s"][1:]
    remat_s = trn["remat"]["step_s"][1:]
    measured = {"spatial_lm": trn["spatial_lm"]["step_ms"] / 1e3,
                "qwen3_8b_2_layers": sum(dense_s) / len(dense_s),
                "internlm2_1_8b": sum(remat_s) / len(remat_s)}
    # the card's peak of each counted step (spatial-lm's (8, 256) step has none)
    peaks = {"spatial_lm": None, "qwen3_8b_2_layers": trn["dense"]["peak_gb"],
             "internlm2_1_8b": trn["remat"]["peak_gb"]}
    out["step_shares"] = {k: {**step_share(measured[k], c["flops"], c["bytes"], c["dtype"]),
                              "flops": c["flops"], "bytes": c["bytes"], "dtype": c["dtype"],
                              "fake_peak_gb": c["peak"] / 1e9, "card_peak_gb": peaks[k]}
                          for k, c in res["steps"].items()}
    emit({"roofline_share": out["step_shares"]})
    out["launches"] = {**{k: 0 for k in path}, **sharded["launches"], sm90: path[sm90]}
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------- examples
def example_facts(name: str, text: str) -> list[str]:
    """The facts an example prints, with its timings and paths masked: every
    line but those of ``trace_scan``, where the stage table, latencies and
    the kernel line are timings or device-specific and only the scan line and
    the pruned bytes per level are facts."""
    import re

    lines = [ln for ln in text.splitlines() if ln.strip()]
    if name == "trace_scan":
        lines = [ln for ln in lines if ln.startswith(("scan:", "bytes pruned"))]
    return [re.sub(r"(?<![\w.])/\S+", "<path>",
                   re.sub(r"\s*\d+(?:\.\d+)?\s?ms\b", " <t>ms", ln)) for ln in lines]


def run_example(name: str, argv: list[str], work: Path) -> dict:
    """Run ``examples/torch/<name>.py`` in this process as ``__main__`` with
    ``sys.argv`` set, its working directory and temporary directory a fresh
    one under ``work`` (removed after). Returns its standard output (also
    copied to standard error for the log), wall seconds and, for
    ``trace_scan``, the names of the spans in the trace it exported."""
    import contextlib
    import io
    import os
    import runpy
    import shutil

    script = ROOT / "examples" / "torch" / f"{name}.py"
    tmp = Path(tempfile.mkdtemp(prefix=f"{name}_", dir=work))
    saved = (sys.argv, os.getcwd(), tempfile.tempdir, os.environ.get("TMPDIR"))
    buf = io.StringIO()
    sys.argv = [str(script), *argv]
    os.chdir(tmp)
    tempfile.tempdir = os.environ["TMPDIR"] = str(tmp)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(script), run_name="__main__")
        wall = time.perf_counter() - t0
        spans = None
        if name == "trace_scan":
            trace = json.loads((tmp / "scan_trace.json").read_text())
            spans = sorted({e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"})
    finally:
        sys.argv, cwd, tempfile.tempdir, old_tmp = saved
        os.chdir(cwd)
        if old_tmp is None:
            os.environ.pop("TMPDIR", None)
        else:
            os.environ["TMPDIR"] = old_tmp
        sys.stderr.write(f"--- examples/torch/{name}.py {' '.join(argv)}\n{buf.getvalue()}")
        shutil.rmtree(tmp, ignore_errors=True)
    return {"stdout": buf.getvalue(), "wall_s": wall, "spans": spans}


def examples_path(work: Path, counters) -> dict:
    """Phase 4f: the six example twins (``examples/torch/``) at the
    reference examples' defaults with ``--device cuda``, in this process,
    every launch count set to 0 just before each; the four data examples
    again with ``--device host`` (the numpy path), whose facts must equal
    the card's as text (timings and paths masked)."""
    import torch

    t_phase = time.perf_counter()
    out: dict = {"by_example": {}}
    total = {c.kname: 0 for c in counters}
    for name in EXAMPLES:
        for c in counters:
            c.launches = 0
        run = run_example(name, ["--device", DEVICE], work)
        launches = _counts(counters)
        for k, v in launches.items():
            total[k] += v
        row = {"wall_s": run["wall_s"], "launches": launches}
        if name in DATA_EXAMPLES:
            for c in counters:
                c.launches = 0
            host = run_example(name, ["--device", "host"], work)
            require(not any(_counts(counters).values()),
                    f"examples/torch/{name}.py --device host launched a kernel")
            got, want = example_facts(name, run["stdout"]), example_facts(name, host["stdout"])
            row.update(host_wall_s=host["wall_s"], facts=got)
            require(got and got == want,
                    f"examples/torch/{name}.py: the card's facts {got} differ from the "
                    f"host's {want}")
            require(launches[FILE_KERNELS[0]] > 0,
                    f"examples/torch/{name}.py did not launch kernel 1")
        if name in REFINE_EXAMPLES:
            require(launches[FILE_KERNELS[1]] > 0,
                    f"examples/torch/{name}.py did not launch kernel 2")
        if name == "trace_scan":
            row["trace_spans"] = run["spans"]
            require(any(n.startswith("device.") for n in run["spans"]),
                    f"scan_trace.json holds no device.* span: {run['spans']}")
            row["kernel_line"] = next(ln for ln in run["stdout"].splitlines()
                                      if ln.startswith("kernels:"))
        if name == "train_trajectory_lm":
            row["loss_line"] = next(ln for ln in run["stdout"].splitlines()
                                    if ln.startswith("[train] loss"))
        if name == "serve_lm":
            served = next(ln for ln in run["stdout"].splitlines() if ln.startswith("[serve]"))
            row["serve_line"] = served
            require(int(served.split()[1]) == SERVE_LM_REQUESTS,
                    f"examples/torch/serve_lm.py answered {served}")
        out["by_example"][name] = row
        emit({"example": {"name": name, **row}})
        torch.cuda.empty_cache()
    out["launches"] = total
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------- entry
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-traj", type=int, default=FULL_N_TRAJ,
                    help="trips to generate (default: the published 1,710,670)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as ak
    from repro_torch.kernels.fp_delta import kernel as fk
    from repro_torch.kernels.minmax import kernel as mk

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit({"gpu": gpu})
    t_start = time.perf_counter()
    _build.build_all(KERNEL_LIBS)
    emit({"build_s": time.perf_counter() - t_start})
    for lib in ("flash_attention_sm90", "flash_attention", "fp_delta_decode", "miniblock",
                "page_minmax", "stream_expand"):
        ptxas = [ln.strip() for ln in _build.logs.get(lib, "").splitlines()
                 if any(w in ln for w in ("entry function", "spill", "Used", "arning"))]
        if ptxas:
            emit({f"ptxas_{lib}": ptxas})
    counters = [fk.decode_stream, mk.segminmax_refine, mk.page_minmax, fk.expand_stream,
                fk.escape_resolve,
                fk.encode_blocks, fk.decode_blocks, ak.flash_attention_sm90,
                ak.flash_attention_f32]
    names = list(FILE_KERNELS + CODEC_KERNELS + LM_KERNELS) + [F32_FLASH]
    for c, name in zip(counters, names):
        c.kname = name
    emit({"kernel_names": names})
    reduced = {"lm": {"config": LM_CONFIG, "shape": "train_4k", "seq_len": LM_SEQ,
                      "global_batch": [LM_FULL_BATCH, LM_BATCH],
                      "serve_load_requests": [256, SERVE_LOAD[0]]},
               "serve": {"query_counts": [[1, 16, 256], list(SERVE_COUNTS)],
                         "sequential_queries": [SERVE_COUNTS[-1], len(QUERY_FRACS)]},
               "families": {"shape": "train_4k", "global_batch": [LM_FULL_BATCH, LM_BATCH],
                            **{name: {"n_layers": [get_config(name).n_layers, depth]}
                               for name, _, depth in FAMILY_RUNS if depth},
                            "arctic-480b_decode_check_positions": [FAMILY_DECODE_SEQ, 64]},
               "train": {"qwen3-8b": {"n_layers": [get_config(LM_CONFIG).n_layers,
                                                   DENSE_TRAIN[0]],
                                      "global_batch": [LM_FULL_BATCH, DENSE_TRAIN[1]]},
                         REMAT_TRAIN[0]: {"global_batch": [LM_FULL_BATCH, REMAT_TRAIN[1]],
                                          "compare_n_layers": [
                                              get_config(REMAT_TRAIN[0]).n_layers,
                                              REMAT_COMPARE[0]]}},
               "mesh": {"qwen3-8b": {"n_layers": [get_config(LM_CONFIG).n_layers,
                                                  DENSE_TRAIN[0]],
                                     "global_batch": [LM_FULL_BATCH, DENSE_TRAIN[1]]},
                        "ranks": [4, 1], "cli_steps": [TRAIN_STEPS, MESH_STEPS]}}
    if args.n_traj != FULL_N_TRAJ:
        reduced["n_traj"] = [FULL_N_TRAJ, args.n_traj]
    emit({"reduced": reduced})

    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    data = make_data(args.n_traj, args.seed)
    emit({"gen_s": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "porto_taxi.spqf"
        main = main_path(data, path, counters)
        emit({"main_path": {k: v for k, v in main.items() if not k.startswith("_")}})
        table = check_kernels(path, main)
        t0 = time.perf_counter()
        lake = Path(tmp) / "porto_lake"
        ds = dataset_path(data, lake, main, counters)
        ds["wall_s"] = time.perf_counter() - t0
        emit({"dataset_path": {k: v for k, v in ds.items() if not k.startswith("_")}})
        t0 = time.perf_counter()
        serve = serve_path(ds["_oracle"], lake, counters)
        serve["wall_s"] = time.perf_counter() - t0
        emit({"serve_path": {k: v for k, v in serve.items() if k != "by_query_count"}})
        t0 = time.perf_counter()
        feed = feed_path(lake, main["_boxes"]["refine_10pct"], counters)
        feed["wall_s"] = time.perf_counter() - t0
        emit({"feed_path": feed})
        del ds
        # phase 4e's dry run counts on the CPU beside phases 3b to 4d
        dry = start_dryrun(Path(tmp))
        t0 = time.perf_counter()
        codec = codec_path(data[0], counters)
        codec["wall_s"] = time.perf_counter() - t0
        emit({"codec_path": {k: v for k, v in codec.items() if not k.startswith("_")}})
        table += check_codec(codec)
        codec_launches = codec["launches"]
        del data, codec
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lm = lm_path(args, counters)
        lm["wall_s"] = time.perf_counter() - t0
        emit({"lm_path": lm})
        table += check_flash(args.seed)
        # phase 4c reads its prompts from the lake of 3a, so it runs before the
        # lake is removed
        t0 = time.perf_counter()
        fam = families_path(args, lake, main["_boxes"]["refine_10pct"], counters)
        fam["wall_s"] = time.perf_counter() - t0
        emit({"families_path": fam})
        # phase 4d trains from the same lake
        trn = train_path(args, lake, Path(tmp), counters)
        emit({"train_path": {k: v for k, v in trn.items() if k in ("config", "vocab",
                                                                    "n_params", "launches",
                                                                    "wall_s")}})
        # phase 4e: the mesh, every count set to 0 just before each of its paths
        msh = mesh_path(args, lake, Path(tmp), counters, trn, dry)
        emit({"mesh_path": {"wall_s": msh["wall_s"], "launches": msh["launches"]}})
        # phase 4f: the example twins, every count set to 0 just before each
        exm = examples_path(Path(tmp), counters)
        emit({"examples": {"wall_s": exm["wall_s"], "launches": exm["launches"],
                           **{n: {"wall_s": r["wall_s"], "launches": r["launches"]}
                              for n, r in exm["by_example"].items()}}})
    launches = {**{n: main["launches"][n] for n in FILE_KERNELS},
                **{n: codec_launches[n] for n in CODEC_KERNELS},
                **{n: lm["launches"][n] + fam["launches"][n] for n in LM_KERNELS},
                F32_FLASH: lm["float32_route"]["launches"][F32_FLASH]}
    launches_serve = {n: serve["launches"][n] for n in launches}
    serve_shape = serve["kernel_times"]
    launches_feed = {n: feed["launches"][n] for n in launches}
    launches_4c = {n: fam["launches"][n] for n in launches}
    launches_train = {n: trn["launches"][n] for n in launches}
    launches_mesh = {n: msh["launches"].get(n, 0) for n in launches}
    launches_examples = {n: exm["launches"][n] for n in launches}
    for row in table:
        emit({"kernel": row["name"], "mismatches": row["mismatches"],
              "kernel_ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
              "library_ms": row["library_ms"], "launches": launches[row["name"]],
              "launches_serve": launches_serve[row["name"]],
              "launches_feed": launches_feed[row["name"]],
              "launches_families": launches_4c[row["name"]],
              "launches_train": launches_train[row["name"]],
              "launches_mesh": launches_mesh[row["name"]],
              "launches_examples": launches_examples[row["name"]],
              "shape": row["shape"], "bytes": row["bytes"],
              **({"serve_shape": serve_shape[row["name"]]}
                 if row["name"] in serve_shape else {})})
    for row in table:
        require(row["mismatches"] == 0, f"{row['name']}: kernel disagrees with its plain version")
    flash = next(r for r in table if r["name"] == LM_KERNELS[0])
    emit({"flash_attention_rate": {"tflops": flash["tflops"],
                                   "share_of_bound": flash["bound_ms"] / flash["ms"],
                                   "sdpa_max_abs_err_vs_plain": flash["library_max_abs_err"]}})
    emit({"total_s": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{**{k: (launches[r["name"]] if k == "launches" else r[k]) for k in keys},
                       "launches_serve": launches_serve[r["name"]],
                       "launches_feed": launches_feed[r["name"]],
                       "launches_families": launches_4c[r["name"]],
                       "launches_train": launches_train[r["name"]],
                       "launches_mesh": launches_mesh[r["name"]],
                       "launches_examples": launches_examples[r["name"]],
                       **({"bound_detail": r["bound_detail"]} if "bound_detail" in r else {}),
                       **({"serve_shape": {k: serve_shape[r["name"]][k]
                                           for k in ("ms", "device_ms", "bound_ms")}}
                          if r["name"] in serve_shape else {})} for r in table]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-child"]:
        sys.exit(dryrun_child())
    if sys.argv[1:2] == ["--train-child"]:
        sys.exit(train_child(sys.argv[2:]))
    sys.exit(main())
