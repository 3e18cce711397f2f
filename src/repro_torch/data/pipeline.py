"""Training data pipeline: Spatial Parquet data lake -> sharded token batches.

Flow: SpatialParquetReader (range-filter pushdown + page pruning, the paper's
§4 index in the serving path of training) -> GeoTokenizer -> fixed-length
sequence packing -> double-buffered prefetch thread -> per-step batches shaped
``(accum, micro_batch, seq)``.

Sources may be single ``.spqf`` files *or* sharded dataset directories
(``repro_torch.dataset``): datasets are expanded to their shard files up front —
pruned by the batcher's bbox via the manifest's shard MBRs — so the epoch
permutation stripes over *shards*, not whole files. Smaller shuffle units
mean better mixing and a bounded working set per read.

Straggler mitigation (host level): the prefetch queue is bounded; if the
producer stalls past ``stall_timeout`` the consumer re-serves the previous
batch and increments a counter instead of blocking the whole step loop — on a
multi-host pod this is the difference between one slow VM and a global stall.
Producer *failures* are not stalls: a worker-thread exception is forwarded
through the queue and re-raised by ``__next__`` promptly, not after a
timeout, so a corrupt shard surfaces as the real error at the step loop.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch._device import torch_device
from repro_torch.core.reader import SpatialParquetReader

from .tokenizer import GeoTokenizer


def expand_sources(sources, bbox=None) -> list[str]:
    """Expand dataset directories into shard file paths; files pass through.

    Shards of a dataset are pruned by ``bbox`` against the manifest MBRs
    (shard-level index) before any shard is opened; plain file paths are
    never pruned here — the reader's page index handles them.
    """
    from repro_torch.dataset import SpatialDatasetScanner, is_dataset

    out: list[str] = []
    for src in sources:
        if is_dataset(src):
            out.extend(SpatialDatasetScanner(src).shard_paths(bbox))
        else:
            out.append(str(src))
    return out


class TrajectoryBatcher:
    """Packs tokenized trajectories into LM batches.

    ``device="cuda"`` (the default) serves each shard read through the fused
    device scan (``read_columnar(device="cuda", refine=True,
    keep_on_device=True)``): decode and bbox refinement run on the card and
    the batcher receives device-resident
    :class:`~repro_torch.core.columnar.TorchCoords` — the only host
    materialization is the single survivor-coordinate transfer at tokenize
    time, so pruned records never cross the bus. ``"cpu"`` runs the same
    chain on CPU tensors, ``"host"`` the reader's numpy path. Batches are
    bit-identical across the three.
    """

    def __init__(self, files, tokenizer: GeoTokenizer, *, seq_len: int,
                 global_batch: int, accum: int = 1, bbox=None, seed: int = 0,
                 loop: bool = True, device: str = "cuda"):
        if device not in ("cuda", "cpu", "host"):
            raise ValueError(
                f"device must be 'cuda', 'cpu' or 'host', got {device!r}")
        if device != "host":
            torch_device(device)  # "cuda" without a card raises here
        self.files = expand_sources(files, bbox)
        if not self.files:
            raise ValueError(
                "TrajectoryBatcher has no input shards/files"
                + (" (bbox pruned every shard)" if bbox is not None else "")
            )
        self.tok = tokenizer
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.accum = accum
        self.bbox = bbox
        self.rng = np.random.default_rng(seed)
        self.loop = loop
        self.device = device

    def _token_stream(self):
        device_kw = {"device": self.device,
                     "keep_on_device": self.device != "host"}
        while True:
            order = self.rng.permutation(len(self.files))
            for fi in order:
                with SpatialParquetReader(self.files[fi]) as r:
                    # project to geometry only: skips decoding (and reading)
                    # every extra column the tokenizer never looks at
                    cols, _, _ = r.read_columnar(
                        bbox=self.bbox, refine=True, columns=("geometry",),
                        **device_kw,
                    )
                    if cols is None or cols.n_records == 0:
                        continue
                    # the zero-copy handoff boundary: device-resident columns
                    # materialize survivors exactly once, here
                    mat = self.tok.encode_trajectories(
                        cols.coords_to_host(), self.seq_len)
                    for row in self.rng.permutation(len(mat)):
                        yield mat[row]
            if not self.loop:
                return

    def __iter__(self):
        stream = self._token_stream()
        mb = self.global_batch // self.accum
        while True:
            rows = []
            try:
                for _ in range(self.global_batch):
                    rows.append(next(stream))
            except StopIteration:
                return
            toks = np.stack(rows).reshape(self.accum, mb, self.seq_len)
            yield {"tokens": toks.astype(np.int32)}


class _ProducerFailure:
    """In-queue envelope carrying a worker-thread exception to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Bounded-queue background producer with stall skip-and-reuse.

    Worker exceptions are delivered in-band (after any items already
    buffered) and re-raised by ``__next__`` as soon as they are dequeued —
    the consumer never waits out ``stall_timeout`` for a producer that is
    already dead, and the failure is never silently converted into an early
    ``StopIteration``.
    """

    def __init__(self, iterable, depth: int = 4, stall_timeout: float = 30.0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(iterable)
        self._done = object()
        self._last = None
        self._exc: BaseException | None = None
        self._finished = False
        self.stalls = 0
        self.stall_timeout = stall_timeout
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
            self._q.put(_ProducerFailure(e))
        else:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._exc is not None:
            raise self._exc  # producer already failed; keep failing
        if self._finished:
            raise StopIteration  # exhaustion is sticky too: no reuse-as-stall
        try:
            item = self._q.get(timeout=self.stall_timeout)
        except queue.Empty:
            if self._last is None:
                item = self._q.get()  # nothing to reuse yet: block
            else:
                self.stalls += 1
                return self._last
        if isinstance(item, _ProducerFailure):
            self._exc = item.exc
            raise self._exc
        if item is self._done:
            self._finished = True
            raise StopIteration
        self._last = item
        return item


def synthetic_token_iter(vocab: int, *, seq_len: int, global_batch: int,
                         accum: int = 1, seed: int = 0, family: str = "dense",
                         cfg=None):
    """Structured synthetic batches for benchmarks and per-arch smoke runs."""
    rng = np.random.default_rng(seed)
    mb = global_batch // accum
    while True:
        t = rng.integers(3, vocab, (accum, mb, 1), dtype=np.int64)
        seqs = [t]
        for _ in range(seq_len - 1):
            seqs.append((seqs[-1] * 31 + 7) % (vocab - 3) + 3)
        batch = {"tokens": np.concatenate(seqs, -1).astype(np.int32)}
        if cfg is not None and cfg.family == "encdec":
            batch["frames"] = rng.normal(
                0, 1, (accum, mb, seq_len // cfg.frontend_downsample,
                       cfg.frontend_dim or cfg.d_model)
            ).astype(np.float32)
        if cfg is not None and cfg.family == "vlm":
            batch["tokens"] = batch["tokens"][..., : seq_len - cfg.vision_tokens]
            batch["patches"] = rng.normal(
                0, 1, (accum, mb, cfg.vision_tokens, cfg.frontend_dim)
            ).astype(np.float32)
        yield batch
