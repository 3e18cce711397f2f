"""End-to-end driver on the PyTorch/CUDA port: geospatial data lake ->
train a trajectory LM (the twin of ``examples/train_trajectory_lm.py``).

Builds a Porto-taxi-like Spatial Parquet data lake, then trains the
``spatial-lm`` Mamba2 architecture on tokenized GPS trajectories with
checkpointing — the paper's format feeding the framework's training loop.
With ``--device cuda`` (the default) the feed decodes each shard on the card
and the model trains there; ``--device cpu`` runs both on the CPU.

    PYTHONPATH=src python examples/torch/train_trajectory_lm.py \
        --steps 200 --n-traj 4000 [--arch spatial-lm] [--full-size] [--device cuda|cpu]

``--full-size`` trains the ~100M-parameter variant (12L/768d). The model
trains on one device (``mesh=None``), the port's single-device path.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--n-traj", type=int, default=3000)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--arch", default="spatial-lm")
    ap.add_argument("--full-size", action="store_true",
                    help="~100M params (12L/768d) instead of the CPU-friendly size")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.core.pages import best_codec
    from repro_torch.core.writer import write_file
    from repro_torch.data.pipeline import Prefetcher, TrajectoryBatcher
    from repro_torch.data.synthetic import PORTO_BBOX, porto_taxi_like
    from repro_torch.data.tokenizer import GeoTokenizer
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import run_train_loop

    # ---- 1. build the data lake (two Spatial Parquet shards)
    lake = tempfile.mkdtemp(prefix="geolake_")
    files = []
    for shard in range(2):
        cols = porto_taxi_like(n_traj=args.n_traj // 2, seed=shard)
        p = os.path.join(lake, f"porto_{shard}.spqf")
        write_file(p, columns=cols, sort="hilbert", codec=best_codec(), device=args.device)
        files.append(p)
    lake_mb = sum(os.path.getsize(p) for p in files) / 1e6
    print(f"[lake] {len(files)} shards, {lake_mb:.1f} MB at {lake}")

    # ---- 2. tokenizer + pipeline
    tok = GeoTokenizer(PORTO_BBOX, order=6)
    cfg = get_config(args.arch)
    if args.full_size:
        cfg = dataclasses.replace(cfg, n_layers=12, d_model=768)
    cfg = dataclasses.replace(cfg, vocab=tok.vocab)
    data = Prefetcher(TrajectoryBatcher(
        files, tok, seq_len=args.seq, global_batch=args.global_batch, device=args.device))

    # ---- 3. train with checkpoint/restart
    oc = OptConfig(lr=3e-3, warmup_steps=max(args.steps // 10, 1),
                   total_steps=args.steps)
    ckpt_dir = args.ckpt_dir or os.path.join(lake, "ckpt")
    mgr = CheckpointManager(ckpt_dir, compress=True, keep=2)
    state, history = run_train_loop(
        cfg, oc, iter(data), global_batch=args.global_batch,
        seq=args.seq, steps=args.steps, checkpoint_mgr=mgr,
        checkpoint_every=max(args.steps // 3, 1), log_every=10, device=args.device,
    )
    mgr.wait()
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[train] loss {first:.3f} -> {last:.3f} over {args.steps} steps")
    print(f"[ckpt] compression ratio {mgr.last_stats.ratio:.2f}x "
          f"({mgr.last_stats.stored_bytes/1e6:.1f} MB stored)")
    assert last < first, "training must reduce loss"


if __name__ == "__main__":
    main()
